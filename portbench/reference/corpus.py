"""The reference's check of the served corpus: a sample of presets, drawn
from the seed, rendered again on the host (the frozen plain control pass
and feed-forward operators in float32, the feedback loop as a NumPy loop
over the samples in float32, the same operations in the same order as the
port's plain feedback loop), turned into log-mels in float64 from the
frozen processor's tables, normalised, and held against the program's
served rows.

The normalisation's constants are the corpus's minimum and maximum, which
only a render of the whole corpus could give again. The reference takes
the program's (``spec_stats``) and checks them apart: the served corpus's
own extremes must then be -1 and +1. ``corpus_row_mean_gap`` is the larger
of the worst sampled row's mean absolute gap over its pixels and that
extremes' gap, in the normalised units the model reads. The worst single
pixel (``corpus_row_max_gap``) is printed beside it and not compared: where
a preset's feedback loop is ill-conditioned, one float32 rounding apart
moves a few pixels of its row by up to 0.4 (the reference's own loop in
float32 against float64 does)."""

from __future__ import annotations

import numpy as np
import torch

from .frozen.ops.spectrogram import SpectrogramConfig, SpectrogramProcessor
from .frozen.synth import fm_torch as ffm


def sample_presets(n_presets: int, seed: int, k: int) -> np.ndarray:
    """``k`` preset rows drawn from ``seed`` without repetition, ascending."""
    rng = np.random.default_rng([int(seed), 0xC0])
    return np.sort(rng.choice(n_presets, size=min(k, n_presets), replace=False))


def _loop_numpy(phases: torch.Tensor, amps: torch.Tensor, alg: torch.Tensor,
                fb_amt: torch.Tensor) -> torch.Tensor:
    """The frozen ``feedback_loop_pass`` in NumPy float32: (B, N)."""
    B, _, N = phases.shape
    rows = ffm.algorithm_rows()[alg.long().numpy()]
    length = rows[:, ffm.ALG_LOOP_LEN]
    idx = np.clip(rows[:, ffm.ALG_LOOP_OPS:ffm.ALG_LOOP_OPS + 3], 0, None)
    on = (fb_amt != 0).numpy()
    out = np.zeros((N, B), dtype=np.float32)
    if not on.any():
        return torch.from_numpy(out.T.copy())
    b = np.arange(B)[:, None]
    ph_all, am_all = phases.numpy(), amps.numpy()
    ph = np.ascontiguousarray(ph_all[b, idx].transpose(1, 2, 0))  # (3, N, B)
    am = np.ascontiguousarray(am_all[b, idx].transpose(1, 2, 0))
    n_loop = int(length[on].max())
    longer = [length > j for j in range(n_loop)]
    fb = fb_amt.numpy().astype(np.float32)
    two_pi, mod_scale, half = np.float32(ffm.TWO_PI), np.float32(ffm.MOD_SCALE), np.float32(0.5)
    fb1 = np.zeros(B, dtype=np.float32)
    fb2 = np.zeros(B, dtype=np.float32)
    for n in range(N):
        y = half * (fb1 + fb2) * fb
        for j in range(n_loop):
            y_j = np.sin(two_pi * (ph[j, n] + y * mod_scale)) * am[j, n]
            y = y_j if j == 0 else np.where(longer[j], y_j, y)
        fb2, fb1 = fb1, y
        out[n] = y
    out[:, ~on] = 0.0
    return torch.from_numpy(out.T.copy())


def render(presets: np.ndarray, pitches, velocities, note_on_s: float, total_s: float,
           sample_rate: int) -> torch.Tensor:
    """(B, N) float32 waveforms of the exact render, on the host."""
    d, alg, fb_amt, n_carriers, ctl, n_ticks = ffm._prepare(
        torch.from_numpy(np.asarray(presets, dtype=np.float32)), np.asarray(pitches),
        np.asarray(velocities), total_s, sample_rate, "exact")
    amps_t, _, starts, incs = ffm.control_pass(ctl, n_ticks, int(note_on_s * sample_rate),
                                               sample_rate)
    phases, amps = ffm.sample_phases(starts, incs), ffm.upsample_amps(amps_t)
    loop_out = _loop_numpy(phases, amps, alg, fb_amt)
    sample = ffm.feedforward_pass(phases, amps, alg, fb_amt, loop_out)
    return ffm.fade_and_volume(sample, n_carriers, d["master_volume"], sample_rate)


def log_mel(model_c, wav: torch.Tensor) -> torch.Tensor:
    """(B, H, W) dB in float64 from the frozen processor's DFT and mel
    tables, on the host."""
    proc = SpectrogramProcessor(SpectrogramConfig(
        n_fft=model_c.stft_args[0], fft_hop=model_c.stft_args[1],
        min_dB=model_c.spectrogram_min_dB, n_mel_bins=model_c.mel_bins,
        sample_rate=model_c.sampling_rate), device="cpu")
    frames = proc.frame(wav.double())
    re, im = frames @ proc.cos_m.double(), frames @ proc.sin_m.double()
    mag = torch.sqrt(re * re + im * im)
    if proc.use_mel:
        mag = mag @ proc.mel_fb.double()
    return (20.0 * torch.log10(torch.clamp(mag, min=proc.floor_amp))).transpose(-1, -2)


def reference_rows(model_c, presets: np.ndarray, bf16_audio: bool = False) -> torch.Tensor:
    """(k, n_notes, H, W) float64 raw dB of ``presets``, every note of the
    configuration, all notes in one render; ``bf16_audio`` is the
    control's rounding."""
    note_on, note_off = model_c.note_duration
    notes = [tuple(n) for n in model_c.midi_notes]
    k = len(presets)
    wav = render(np.concatenate([presets] * len(notes)),
                 [p for p, _ in notes for _ in range(k)], [v for _, v in notes for _ in range(k)],
                 float(note_on), float(note_on + note_off), int(model_c.sampling_rate))
    if bf16_audio:
        wav = wav.to(torch.bfloat16).float()
    spec = log_mel(model_c, wav)
    return spec.reshape(len(notes), k, *spec.shape[1:]).transpose(0, 1)


def readings(model_c, served: torch.Tensor, stats: dict, presets: np.ndarray, seed: int,
             k: int, bf16_audio: bool = False) -> dict:
    """``corpus_row_mean_gap`` of the served corpus ``served`` (P, n_notes,
    H, W, the program's, normalised) on ``k`` presets drawn from ``seed``,
    and ``corpus_row_max_gap`` beside it."""
    rows = sample_presets(len(presets), seed, k)
    raw = reference_rows(model_c, presets[rows], bf16_audio)
    lo, hi = float(stats["min"]), float(stats["max"])
    want = (raw - lo) / ((hi - lo) / 2.0) - 1.0
    got = served[torch.from_numpy(rows).to(served.device)].double().cpu()
    lo_s, hi_s = torch.aminmax(served)
    extremes = max(abs(float(lo_s) + 1.0), abs(float(hi_s) - 1.0))
    gap = (got - want).abs()
    return {"corpus_row_mean_gap": max(float(gap.mean(dim=(2, 3)).max()), extremes),
            "corpus_row_max_gap": max(float(gap.max()), extremes),
            "corpus_rows_compared": float(len(rows) * raw.shape[1])}
