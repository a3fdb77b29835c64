"""The yardstick's arithmetic: the card's published peaks, the work that the
corpus pass's kernels must do whatever computes it, the roofline bound of
that work, and the device's busy time from a profiler trace.

``logmel_work``, ``fm_exact_work``, ``fm_control_work`` and ``bound`` are
copies of ``chip_smoke.py``'s functions of the same names, made to take
plain sizes instead of the program's objects; ``busy_union`` is the
interval union of ``chip_smoke.py:trace_busy``."""

from __future__ import annotations

import math
from typing import Iterable, List, Tuple

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet,
# dense rates without sparsity).
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

CTL_WIDTH = 94  # f32 columns of the FM render's packed control row
BLOCK = 32  # samples a control tick


def num_frames(num_samples: int, n_fft: int, hop: int) -> int:
    """Frames of a centre-padded STFT."""
    return 1 + num_samples // hop


def logmel_work(B: int, S: int, n_fft: int, hop: int, n_mels: int, mel_nonzeros: int):
    """(bytes, flops) that the log-mel function itself must move and
    compute, whatever algorithm computes it: the waveforms and the mel
    filterbank's nonzeros, with each filter's first bin and offset, read
    once, the output written once; per frame a real-input FFT (2.5 n log2 n
    flops), the magnitude (3 flops per bin) and the mel product over the
    filterbank's nonzeros (a multiply-add each). The log is not counted."""
    n_bins = n_fft // 2 + 1
    T = num_frames(S, n_fft, hop)
    fb_elems = mel_nonzeros + 2 * n_mels + 1
    nbytes = 4 * (B * S + fb_elems + B * n_mels * T)
    per_frame = 2.5 * n_fft * math.log2(n_fft) + 3 * n_bins + 2 * mel_nonzeros
    return nbytes, B * T * per_frame


def fm_exact_work(B: int, n_samples: int):
    """(bytes, flops) of the exact render: each item's packed control row
    read once and its waveform written once; per item and sample the six
    operators (31 f32 operations each) and the feedback history, carrier
    sum, normalisation, clip and fade (12)."""
    return 4 * B * (CTL_WIDTH + n_samples), B * n_samples * (6 * 31 + 12)


def fm_control_work(B: int, n_ticks: int):
    """(bytes, flops) of the control pass: the packed rows read once, the
    (T, B, 6) amplitudes, phase starts and increments and the (T, B) pitch
    factor written once; ~205 operations an item and tick."""
    return 4 * B * (CTL_WIDTH + n_ticks * 19), B * n_ticks * 205


def bound_s(works: Iterable[Tuple[float, float]], flop_per_s: float = F32_FLOP_PER_S) -> float:
    """The least time the card could take for the works, each bound by the
    larger of its bytes over the memory's rate and its operations over
    ``flop_per_s``, summed."""
    return sum(max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s) for nbytes, flops in works)


def busy_union(intervals: List[Tuple[float, float]], start: float, end: float) -> float:
    """Length of the union of ``intervals`` (start, end) clipped to
    [``start``, ``end``]."""
    busy, cursor = 0.0, start
    for a, b in sorted(intervals):
        a, b = max(a, cursor), min(b, end)
        if b > a:
            busy, cursor = busy + b - a, b
    return busy


def idle_gaps(intervals: List[Tuple[float, float]], start: float, end: float):
    """The gaps (start, end) inside [``start``, ``end``] that no interval
    covers, longest first."""
    gaps, cursor = [], start
    for a, b in sorted(intervals):
        if a > cursor and a <= end:
            gaps.append((cursor, min(a, end)))
        cursor = max(cursor, b)
        if cursor >= end:
            break
    if cursor < end:
        gaps.append((cursor, end))
    return sorted(gaps, key=lambda g: g[0] - g[1])

