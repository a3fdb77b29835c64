"""Waveform -> log-(mel-)spectrogram frontend, the plain PyTorch version of
kernel K1.

Counterpart: ``preset_gen_vae_tpu/ops/spectrogram.py`` (the plain XLA
path). Numerics match the reference's torch frontend (reference:
utils/audio.py:20-92): symmetric Hann window, zero center padding,
magnitude normalized by max|rFFT(window)|, Slaney mel filterbank with
norm=None, and 20*log10(max(S, 10^(min_dB/20))): framing by ``unfold``,
the windowed DFT as two matmuls against the (n_fft, n_bins) cos / -sin
matrices with the window and norm folded in, magnitude, the mel matmul and
the log floor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .mel import mel_filterbank


def hann_window(n_fft: int) -> np.ndarray:
    """Symmetric (periodic=False) Hann window, matching torch.hann_window
    (reference: utils/audio.py:30)."""
    n = np.arange(n_fft, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / (n_fft - 1)))


def spectrogram_norm_factor(n_fft: int) -> float:
    """max |rFFT(hann_window)| (reference: utils/audio.py:31)."""
    return float(np.abs(np.fft.rfft(hann_window(n_fft))).max())


def windowed_dft_matrices(n_fft: int):
    """(n_fft, n_bins) cos / -sin rDFT matrices with the Hann window and the
    1/norm magnitude normalization folded in, as float32."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w = hann_window(n_fft)[:, None]
    norm = spectrogram_norm_factor(n_fft)
    # cast, then divide: the rounding of the JAX package's constants
    cos_m = (np.cos(ang) * w).astype(np.float32) / norm
    sin_m = (-np.sin(ang) * w).astype(np.float32) / norm
    return cos_m.astype(np.float32), sin_m.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SpectrogramConfig:
    n_fft: int = 1024
    fft_hop: int = 256
    min_dB: float = -120.0
    n_mel_bins: int = -1  # <= 0 disables mel
    sample_rate: int = 22050
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None  # None -> sr/2


class SpectrogramProcessor:
    """(B, num_samples) f32 waveforms -> (B, n_out, T) log spectrograms,
    n_out = n_mel_bins, or n_fft//2 + 1 when mel is off; the constants live
    on ``device``."""

    def __init__(self, config: SpectrogramConfig, device="cuda"):
        device = resolve_device(device)
        self.config = config
        self.n_fft = config.n_fft
        self.hop = config.fft_hop
        self.floor_amp = float(10.0 ** (config.min_dB / 20.0))
        cos_m, sin_m = windowed_dft_matrices(config.n_fft)
        self.cos_m = torch.from_numpy(cos_m).to(device)
        self.sin_m = torch.from_numpy(sin_m).to(device)
        self.use_mel = config.n_mel_bins > 0
        self.mel_fb = None  # (n_bins, n_mels)
        if self.use_mel:
            fb = mel_filterbank(config.sample_rate, config.n_fft, config.n_mel_bins,
                                fmin=config.mel_fmin, fmax=config.mel_fmax)
            self.mel_fb = torch.from_numpy(np.ascontiguousarray(fb.T)).to(device)

    @property
    def n_out(self) -> int:
        return self.config.n_mel_bins if self.use_mel else self.n_fft // 2 + 1

    def frame(self, x: torch.Tensor) -> torch.Tensor:
        """(B, num_samples) -> (B, T, n_fft) zero-center-padded frames."""
        pad = self.n_fft // 2
        return torch.nn.functional.pad(x, (pad, pad)).unfold(-1, self.n_fft, self.hop)

    def magnitude(self, x: torch.Tensor) -> torch.Tensor:
        """(B, num_samples) -> (B, T, n_bins) normalized |STFT|."""
        frames = self.frame(x.float())
        re = torch.matmul(frames, self.cos_m)
        im = torch.matmul(frames, self.sin_m)
        return torch.sqrt(re * re + im * im)

    def linear_to_log_scale(self, spec: torch.Tensor) -> torch.Tensor:
        """(reference: utils/audio.py:52-54)"""
        return 20.0 * torch.log10(torch.clamp(spec, min=self.floor_amp))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        mag = self.magnitude(x)
        if self.use_mel:
            mag = torch.matmul(mag, self.mel_fb)
        return self.linear_to_log_scale(mag).transpose(-1, -2)
