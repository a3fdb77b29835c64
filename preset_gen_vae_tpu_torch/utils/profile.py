"""Optional step profiler on ``torch.profiler``, and the port's spans.

Counterpart: ``preset_gen_vae_tpu/utils/profile.py:16-77`` (reference:
utils/profile.py:6-37), with its compile-out pattern:
``get_optional_profiler`` returns a real profiler or a no-op with the same
interface, so the train loop stays free of conditionals. ``ActualProfiler``
records CPU activity, and CUDA activity when the run trains on the card;
``start()`` / ``stop()`` bound the window (``stop()`` waits for the card
first, so that the window holds its steps whole), ``export()`` writes it as
a Chrome trace to ``<log_dir>/trace.json``.

``Spans`` times what the train loop and the evaluation pass do, always: a
span is a name, a host start and end (``time.perf_counter``), its parent
(the span open around it) and an id (the epoch, or the evaluation pass),
kept in memory; ``totals`` sums each name's inclusive and self seconds
(its duration less what its child spans cover), count and counters over
the ids asked for. While a ``torch.profiler`` records (this module's
profiler or any other), a span also opens a ``record_function`` of its
name, so that it sits in the trace on the clock of the card's kernels and
copies; otherwise none is opened. A device span also records a CUDA event
on the current stream at each end; ``read_device()`` reads their elapsed
time, and is called only after a synchronisation that the caller already
makes (a fetch to the host), so that a span adds no wait for the card.
"""

from __future__ import annotations

import pathlib
import time
from typing import Dict, Iterable, List, Optional

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


def get_optional_profiler(profiler_args: Optional[Dict], log_dir=None, device="cpu"):
    """(reference: utils/profile.py:6-14)"""
    if profiler_args and profiler_args.get("enabled", False):
        return ActualProfiler(log_dir, profiler_args, device)
    return NoProfiler()


class Span:
    """One span of a ``Spans``, a context manager; made by ``Spans.span``."""

    __slots__ = ("spans", "name", "parent", "id", "start", "end", "child_s", "counts",
                 "events", "device_s", "host_only", "_annotation")

    def __init__(self, spans: "Spans", name: str, id, device: bool, host_only: bool):
        self.spans, self.name, self.id, self.host_only = spans, name, id, host_only
        self.parent = self.start = self.end = None
        self.child_s, self.counts, self.device_s = 0.0, {}, None
        self.events = ((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                       if device and spans.cuda else None)
        self._annotation = None

    def __enter__(self) -> "Span":
        if self.spans._open:
            self.parent = self.spans._open[-1]
            if self.id is None:
                self.id = self.parent.id
        if torch._C._autograd._profiler_enabled():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        if self.events is not None:
            self.events[0].record()
        self.spans._open.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter()
        self.spans._open.pop()
        if self.events is not None:
            self.events[1].record()
            self.spans._unread.append(self)
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        if self.parent is not None:
            self.parent.child_s += self.end - self.start
        self.spans.records.append(self)
        return False

    def count(self, key: str, n: int = 1) -> None:
        """Adds ``n`` to the span's counter ``key`` (steps, say)."""
        self.counts[key] = self.counts.get(key, 0) + n

    def elapsed(self) -> float:
        """Seconds since the span opened."""
        return time.perf_counter() - self.start

    @property
    def s(self) -> float:
        return self.end - self.start


class Spans:
    """The spans of one call on ``device``; see the module's docstring.
    ``span(name, id=None, device=False, host_only=False)`` opens a span
    (``with``); ``id`` defaults to the parent's; ``device`` records the CUDA
    events (none off the card); ``host_only`` marks a span during which
    nothing is queued on the card, so that ``totals`` can add up the time
    the card waits on the host alone."""

    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self.records: List[Span] = []  # closed spans, in the order they closed
        self._open: List[Span] = []
        self._unread: List[Span] = []  # closed device spans whose events are unread

    def span(self, name: str, id=None, device: bool = False, host_only: bool = False) -> Span:
        return Span(self, name, id, device, host_only)

    def read_device(self) -> None:
        """Reads the elapsed time of every closed device span's events; call
        only once the card has passed them (after a fetch to the host on the
        current stream), where reading them waits for nothing."""
        for span in self._unread:
            span.device_s = span.events[0].elapsed_time(span.events[1]) / 1e3
            span.events = None
        self._unread = []

    def totals(self, ids: Optional[Iterable] = None) -> Dict[str, Dict]:
        """Per name, over the spans whose id is in ``ids`` (all where None):
        ``s`` (inclusive seconds), ``self_s``, ``n`` (spans), ``device_s``
        where its spans recorded events, each counter's sum, and
        ``host_only: True`` on a host-only name."""
        keep = None if ids is None else set(ids)
        out: Dict[str, Dict] = {}
        for span in self.records:
            if keep is not None and span.id not in keep:
                continue
            t = out.setdefault(span.name, {"s": 0.0, "self_s": 0.0, "n": 0})
            t["s"] += span.s
            t["self_s"] += span.s - span.child_s
            t["n"] += 1
            if span.device_s is not None:
                t["device_s"] = t.get("device_s", 0.0) + span.device_s
            for k, v in span.counts.items():
                t[k] = t.get(k, 0) + v
            if span.host_only:
                t["host_only"] = True
        return out
