"""The traced run's device timeline: ``torch.profiler`` (CPU and CUDA
activity) around a call, with a marker on each side of the measured window
so that the window can be found in the trace's own clock.

``Tracer.mark(name)`` records a zero-work ``record_function`` span and the
host clock at that moment; ``Tracer.read(start, end)`` takes the window
between two host-clock times, maps it onto the trace through the first
marker, and returns the device's busy seconds there (the union of its
kernel, copy and fill intervals), the window's length, the device
operations that took most time and the longest idle gaps, each named by
the host-side event that was running when the gap began. The raw events
are read from the profiler's results without building its per-event
Python objects, so that a window of a million kernels stays cheap."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from .work import busy_union, idle_gaps

TOP = 10


class Tracer:
    def __init__(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
            record_shapes=False, with_stack=False)
        self.marks: Dict[str, float] = {}

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        return self.prof.__exit__(*exc)

    def mark(self, name: str) -> float:
        """Records the marker ``name``; -> the host clock (perf_counter s)."""
        with torch.profiler.record_function(f"portbench.{name}"):
            t = time.perf_counter()
        self.marks[name] = t
        return t

    def _events(self):
        results = self.prof.profiler.kineto_results
        return results.events() if results is not None else []

    def read(self, start: float, end: float) -> Optional[dict]:
        """Busy seconds, window seconds and the breakdown of the window
        [``start``, ``end``] (host perf_counter seconds); None where the
        trace holds no device activity."""
        events = self._events()
        anchor_name, anchor_host = next(iter(self.marks.items()))
        anchor = [e.start_ns() for e in events if e.name() == f"portbench.{anchor_name}"]
        if not anchor:
            return None
        t0 = anchor[0] + (start - anchor_host) * 1e9
        t1 = anchor[0] + (end - anchor_host) * 1e9
        device, host = [], []
        by_name: Dict[str, float] = defaultdict(float)
        for e in events:
            a = e.start_ns()
            b = a + e.duration_ns()
            if b < t0 or a > t1:
                continue
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if _annotation(e):  # a span around device work, not device work
                    continue
                device.append((a, b))
                by_name[e.name()] += (min(b, t1) - max(a, t0)) / 1e9
            else:
                host.append((a, b, e.name()))
        if not device:
            return None
        busy = busy_union(device, t0, t1) / 1e9
        gaps = idle_gaps(device, t0, t1)[:TOP]
        return {
            "busy_s": busy, "window_s": (t1 - t0) / 1e9,
            "device_ops": sorted(([n, s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:TOP],
            "idle_gaps": [[_host_at(host, g0), (g1 - g0) / 1e9] for g0, g1 in gaps],
        }


def _annotation(e) -> bool:
    test = getattr(e, "is_user_annotation", None)
    return bool(test()) if test is not None else "annotation" in str(e.activity_type())


def _host_at(host: List, t: float) -> str:
    """The name of the innermost host event running at ``t``."""
    best, best_start = "host idle or untraced", None
    for a, b, name in host:
        if a <= t <= b and (best_start is None or a > best_start):
            best, best_start = name, a
    return best
