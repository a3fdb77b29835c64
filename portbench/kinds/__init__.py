"""The general runners, one per traffic kind (``traffic/<mix>.json`` names
its kind), and what they share: the outcome of a run, the checks against
the cell's limits and the corpus pass's roofline bound."""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, Optional, Tuple

from .. import work


class PhaseLog:
    """Each phase's wall seconds on standard error, as the run goes."""

    def __init__(self, t_start: float):
        self.t = self.t0 = t_start

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"portbench: {phase} {now - self.t:.2f} s (at {now - self.t0:.2f} s)",
              file=sys.stderr, flush=True)
        self.t = now


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    ctx: Dict  # what the per-layer readers read
    checks: List[Tuple[str, float, float]]  # (number, reading, limit)
    peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[Dict] = None


def configs(cell, seed: int, runs_root):
    """(ModelConfig, TrainConfig) of the port and of the frozen reference
    from the cell's configuration file, with the run's seed, its run name
    and its runs directory."""
    from preset_gen_vae_tpu_torch import config as cfg

    from ..reference import presets as rp

    run_name = f"portbench_{cell.name}"
    model_c, train_c = cfg.load_config(cell.config_path)
    model_c = dataclasses.replace(model_c, run_name=run_name, logs_root_dir=str(runs_root),
                                  allow_erase_run=True)
    train_c = dataclasses.replace(train_c, seed=int(seed), verbosity=0)
    fmc, ftc = rp.load_configs(cell.config_path)
    fmc = dataclasses.replace(fmc, run_name=run_name, logs_root_dir=str(runs_root))
    ftc = dataclasses.replace(ftc, seed=int(seed), verbosity=0)
    return model_c, train_c, fmc, ftc


def trace_fields(timeline: Optional[Dict]) -> Dict:
    """``Outcome``'s trace fields from ``Tracer.read``'s result, or None."""
    if not timeline:
        return {}
    return {"busy_s": timeline["busy_s"], "window_s": timeline["window_s"],
            "breakdown": {"device_ops": timeline["device_ops"],
                          "idle_gaps": timeline["idle_gaps"]}}


def make_checks(limits: Dict[str, float], readings: Dict[str, float]):
    """(name, reading, limit) of each limited number; a number the run did
    not read is NaN, which fails."""
    return [(name, float(readings.get(name, float("nan"))), float(limit))
            for name, limit in limits.items()]


def corpus_bound_s(model_c, n_presets: int) -> float:
    """The least time the card could take for the corpus pass's kernels,
    whatever computes them: F1 and F2 over every (preset, note) row, then
    K1 over their waveforms (``work.py``)."""
    from ..reference.frozen.ops.mel import mel_filterbank
    from ..reference.presets import samples_per_note

    rows = n_presets * len(model_c.midi_notes)
    n_samples = samples_per_note(model_c)
    n_fft, hop = model_c.stft_args
    fb = mel_filterbank(model_c.sampling_rate, n_fft, model_c.mel_bins)
    return work.bound_s([
        work.fm_control_work(rows, n_samples // work.BLOCK),
        work.fm_exact_work(rows, n_samples),
        work.logmel_work(rows, n_samples, n_fft, hop, model_c.mel_bins, int((fb != 0).sum())),
    ])
