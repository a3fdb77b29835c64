"""Waveform -> log-(mel-)spectrogram frontend, with kernel K1 behind it.

Counterparts: ``preset_gen_vae_tpu/ops/spectrogram.py`` (the plain XLA
path) and ``preset_gen_vae_tpu/ops/pallas_mel.py:_pallas_logmel`` (the
fused TPU kernel, K1). Numerics match the reference's torch frontend
(reference: utils/audio.py:20-92): symmetric Hann window, zero center
padding, magnitude normalized by max|rFFT(window)|, Slaney mel filterbank
with norm=None, and 20*log10(max(S, 10^(min_dB/20))).

``SpectrogramProcessor.__call__`` is K1's wrapper. A tensor on the CPU goes
through ``plain``, the plain PyTorch version: framing by ``unfold``, the
windowed DFT as two f32 matmuls against the (n_fft, n_bins) cos / -sin
matrices with the window and norm folded in, magnitude, the mel matmul and
the log floor, all in f32. A tensor on the card launches the hand-written
CUDA kernel ``csrc/logmel.cu`` (built with nvcc at first use, bound with
ctypes) or raises; it never falls back to ``plain``. On the card ``plain``
is only a reference for comparisons, and its callers keep
``torch.backends.cuda.matmul.allow_tf32`` off (PyTorch's default) so that
its matmuls stay in full f32.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import shutil
from typing import Optional

import numpy as np
import torch

from .. import _native
from .mel import mel_filterbank

# launches of each hand-written kernel, counted by its wrapper at the launch
LAUNCHES = {"logmel": 0}


def hann_window(n_fft: int) -> np.ndarray:
    """Symmetric (periodic=False) Hann window, matching torch.hann_window
    (reference: utils/audio.py:30)."""
    n = np.arange(n_fft, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / (n_fft - 1)))


def spectrogram_norm_factor(n_fft: int) -> float:
    """max |rFFT(hann_window)| (reference: utils/audio.py:31)."""
    return float(np.abs(np.fft.rfft(hann_window(n_fft))).max())


def num_frames(num_samples: int, n_fft: int, hop: int) -> int:
    """Frame count of a center-padded STFT (torch.stft center=True)."""
    return 1 + (num_samples + 2 * (n_fft // 2) - n_fft) // hop


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
    n_out = n_mel_bins, or n_fft//2 + 1 when mel is off.

    ``precision='exact'`` computes in f32; ``'fast'`` rounds every product
    input to bf16 and accumulates in f32 (the Pallas kernel's bf16 mode,
    accurate to about 1 dB above -60 dB). The constants live on ``device``.
    """

    def __init__(self, config: SpectrogramConfig, device="cpu",
                 precision: str = "exact"):
        if precision not in ("exact", "fast"):
            raise ValueError(f"precision={precision!r}")
        self.config = config
        self.precision = precision
        self.n_fft = config.n_fft
        self.hop = config.fft_hop
        self.norm_factor = spectrogram_norm_factor(config.n_fft)
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

    # ---------------- the plain PyTorch version ----------------

    def frame(self, x: torch.Tensor) -> torch.Tensor:
        """(B, num_samples) -> (B, T, n_fft) zero-center-padded frames."""
        pad = self.n_fft // 2
        return torch.nn.functional.pad(x, (pad, pad)).unfold(-1, self.n_fft, self.hop)

    def magnitude(self, x: torch.Tensor) -> torch.Tensor:
        """(B, num_samples) -> (B, T, n_bins) normalized |STFT|."""
        frames, cos_m, sin_m = self.frame(x.float()), self.cos_m, self.sin_m
        if self.precision == "fast":
            frames, cos_m, sin_m = (_bf16_round(t) for t in (frames, cos_m, sin_m))
        re = torch.matmul(frames, cos_m)
        im = torch.matmul(frames, sin_m)
        return torch.sqrt(re * re + im * im)

    def linear_to_log_scale(self, spec: torch.Tensor) -> torch.Tensor:
        """(reference: utils/audio.py:52-54)"""
        return 20.0 * torch.log10(torch.clamp(spec, min=self.floor_amp))

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """K1's plain version, on any device."""
        mag = self.magnitude(x)
        if self.precision == "fast":
            mag = _bf16_round(mag)
        if self.use_mel:
            fb = _bf16_round(self.mel_fb) if self.precision == "fast" else self.mel_fb
            mag = torch.matmul(mag, fb)
        return self.linear_to_log_scale(mag).transpose(-1, -2)

    # ---------------- K1's wrapper ----------------

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return self.plain(x)
        if x.device.type != "cuda":
            raise ValueError(f"no log-mel kernel for device {x.device}")
        return self._launch(x)

    def _launch(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
            raise ValueError(
                f"kernel takes a contiguous (B, S) float32 tensor, got "
                f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}"
            )
        for name, c in (("cos", self.cos_m), ("sin", self.sin_m), ("mel", self.mel_fb)):
            if c is not None and c.device != x.device:
                raise ValueError(f"{name} constants on {c.device}, input on {x.device}")
        B, S = x.shape
        if B == 0 or S == 0:
            raise ValueError(f"empty input {tuple(x.shape)}")
        T = num_frames(S, self.n_fft, self.hop)
        out = torch.empty((B, self.n_out, T), dtype=torch.float32, device=x.device)
        fb = self.mel_fb
        with torch.cuda.device(x.device):  # the launch targets the current device
            err = _logmel_library().logmel_launch(
                x.data_ptr(), B, S, self.cos_m.data_ptr(), self.sin_m.data_ptr(),
                fb.data_ptr() if fb is not None else None,
                fb.shape[1] if fb is not None else 0,
                out.data_ptr(), self.n_fft, self.hop, T, self.floor_amp,
                int(self.precision == "fast"),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"logmel kernel launch failed: cudaError_t {err}")
        LAUNCHES["logmel"] += 1
        return out


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


LOGMEL_SOURCE = _native.REPO_ROOT / "preset_gen_vae_tpu_torch" / "csrc" / "logmel.cu"


def logmel_build_command():
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@functools.lru_cache(maxsize=None)
def _logmel_library() -> ctypes.CDLL:
    """Builds (first use only) and loads K1. Never called at import."""
    lib = ctypes.CDLL(str(_native.build_shared_library(
        "logmel", logmel_build_command(), [LOGMEL_SOURCE])))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.logmel_launch.restype = i
    lib.logmel_launch.argtypes = [p, i, i, p, p, p, i, p, i, i, i, ctypes.c_float, i, p]
    return lib


def normalize_min_max(spec: torch.Tensor, stats) -> torch.Tensor:
    """Dataset-stats min/max normalization to [-1, 1]
    (reference: abstractbasedataset.py:129-131)."""
    smin, smax = stats
    return -1.0 + (spec - smin) / ((smax - smin) / 2.0)


def denormalize(spec: torch.Tensor, mode: Optional[str], stats: dict) -> torch.Tensor:
    """(reference: abstractbasedataset.py:340-345)"""
    if mode == "min_max":
        return (spec + 1.0) * ((stats["max"] - stats["min"]) / 2.0) + stats["min"]
    if mode == "mean_std":
        return spec * stats["std"] + stats["mean"]
    return spec
