"""Optional step profiler on ``torch.profiler``.

Counterpart: ``preset_gen_vae_tpu/utils/profile.py:16-77`` (reference:
utils/profile.py:6-37), with its compile-out pattern:
``get_optional_profiler`` returns a real profiler or a no-op with the same
interface, so the train loop stays free of conditionals. ``ActualProfiler``
records CPU activity, and CUDA activity when the run trains on the card;
``start()`` / ``stop()`` bound the window (``stop()`` waits for the card
first, so that the window holds its steps whole), ``export()`` writes it as
a Chrome trace to ``<log_dir>/trace.json``. ``record_function`` is
``torch.profiler.record_function``: a named span in the trace.
"""

from __future__ import annotations

import contextlib
import pathlib
from typing import Dict, Optional

import torch


class NoProfiler:
    """No-op, same interface (reference: utils/profile.py:28-37)."""

    enabled = False

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def start(self):
        pass

    def stop(self):
        pass

    def record_function(self, name: str):
        return contextlib.nullcontext()


class ActualProfiler:
    """A ``torch.profiler`` window over the scoped region (reference:
    utils/profile.py:17-25), as a context manager or by ``start()`` /
    ``stop()``."""

    enabled = True

    def __init__(self, log_dir, args: Optional[Dict] = None, device="cpu"):
        self.trace_path = pathlib.Path(log_dir) / "trace.json"
        self.args = args or {}
        self.device = torch.device(device)
        self.profile = None  # the torch.profiler.profile of the last window

    def start(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profile = torch.profiler.profile(activities=activities)
        self.profile.start()

    def stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profile.stop()

    def export(self) -> pathlib.Path:
        """Writes the last window as a Chrome trace; -> its path."""
        self.trace_path.parent.mkdir(parents=True, exist_ok=True)
        self.profile.export_chrome_trace(str(self.trace_path))
        return self.trace_path

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def record_function(self, name: str):
        return torch.profiler.record_function(name)


def get_optional_profiler(profiler_args: Optional[Dict], log_dir=None, device="cpu"):
    """(reference: utils/profile.py:6-14)"""
    if profiler_args and profiler_args.get("enabled", False):
        return ActualProfiler(log_dir, profiler_args, device)
    return NoProfiler()
