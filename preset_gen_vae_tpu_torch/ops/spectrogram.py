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
CUDA kernel ``csrc/logmel.cu`` (a real FFT in shared memory; built with
nvcc at first use, bound with ctypes) or raises; it never falls back to
``plain``. The kernel takes the tables of ``fft_tables`` and the mel
filterbank as contiguous runs (``mel_runs``). On the card ``plain`` is only
a reference for comparisons, and its callers keep
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
from ..device import resolve_device
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


def fft_tables(n_fft: int, dtype):
    """K1's tables, computed in float64 and cast to ``dtype`` once: the
    window with the norm folded in, w[n]/norm, (n_fft,); the twiddles of the
    n_fft/2-point complex FFT, e^(-2 pi i m/(n_fft/2)), (n_fft/2, 2) as
    (re, im); the split's twiddles e^(-2 pi i k/n_fft) for k = 0..n_fft/2,
    (n_fft/2 + 1, 2)."""
    half = n_fft // 2

    def unit(m, n):
        ang = -2.0 * np.pi * m / n
        return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(dtype)

    window = (hann_window(n_fft) / spectrogram_norm_factor(n_fft)).astype(dtype)
    return window, unit(np.arange(half), half), unit(np.arange(half + 1), n_fft)


def mel_runs(fb: np.ndarray):
    """(n_bins, n_mels) filterbank -> (start, length, weights): filter m
    weighs bins start[m] .. start[m] + length[m] - 1 by the next length[m]
    entries of ``weights`` (filters in order). Raises ValueError when a
    filter's nonzeros are not one contiguous run of bins."""
    start, length, weights = [], [], []
    for m, col in enumerate(np.asarray(fb, dtype=np.float32).T):
        nz = np.flatnonzero(col)
        lo = int(nz[0]) if nz.size else 0
        if nz.size and nz[-1] - lo + 1 != nz.size:
            raise ValueError(f"mel filter {m} is not one contiguous run of bins: {nz.tolist()}")
        start.append(lo)
        length.append(nz.size)
        weights.append(col[lo:lo + nz.size])
    return (np.array(start, dtype=np.int32), np.array(length, dtype=np.int32),
            np.concatenate(weights).astype(np.float32))


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

    ``precision='exact'``: the plain version computes in f32, the kernel
    runs its FFT in f64; ``'fast'`` rounds every product input to bf16 and
    accumulates in f32 (the Pallas kernel's bf16 mode, accurate to about
    1 dB above -60 dB). The constants live on ``device``, the card unless
    the caller asks for the CPU; without a card the default raises.
    """

    def __init__(self, config: SpectrogramConfig, device="cuda",
                 precision: str = "exact"):
        if precision not in ("exact", "fast"):
            raise ValueError(f"precision={precision!r}")
        device = resolve_device(device)
        self.config = config
        self.precision = precision
        self.n_fft = config.n_fft
        self.hop = config.fft_hop
        self.norm_factor = spectrogram_norm_factor(config.n_fft)
        self.floor_amp = float(10.0 ** (config.min_dB / 20.0))
        cos_m, sin_m = windowed_dft_matrices(config.n_fft)
        self.cos_m = torch.from_numpy(cos_m).to(device)
        self.sin_m = torch.from_numpy(sin_m).to(device)
        tables = fft_tables(config.n_fft, np.float32 if precision == "fast" else np.float64)
        self.window, self.twiddles, self.split_twiddles = (
            torch.from_numpy(t).to(device) for t in tables)
        self.use_mel = config.n_mel_bins > 0
        self.mel_fb = None  # (n_bins, n_mels)
        self.mel_start = self.mel_off = self.mel_w = None
        if self.use_mel:
            fb = mel_filterbank(config.sample_rate, config.n_fft, config.n_mel_bins,
                                fmin=config.mel_fmin, fmax=config.mel_fmax)
            self.mel_fb = torch.from_numpy(np.ascontiguousarray(fb.T)).to(device)
            start, length, weights = mel_runs(fb.T)
            off = np.concatenate([[0], np.cumsum(length)]).astype(np.int32)
            self.mel_start, self.mel_off, self.mel_w = (
                torch.from_numpy(t).to(device) for t in (start, off, weights))
        self._grid_caps = {}  # device index -> the kernel's persistent grid size

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
        consts = {"window": self.window, "twiddles": self.twiddles,
                  "split twiddles": self.split_twiddles, "mel runs": self.mel_w}
        for name, c in consts.items():
            if c is not None and c.device != x.device:
                raise ValueError(f"{name} on {c.device}, input on {x.device}")
        B, S = x.shape
        if B == 0 or S == 0:
            raise ValueError(f"empty input {tuple(x.shape)}")
        # the TMA copies need 16-byte aligned spans: rows and hops of whole float4s
        if (self.n_fft != KERNEL_N_FFT or self.hop % 4 or S % 4 or x.data_ptr() % 16
                or self.n_out > KERNEL_MAX_MELS and self.use_mel):
            raise ValueError(
                f"kernel takes n_fft={KERNEL_N_FFT}, at most {KERNEL_MAX_MELS} mels, "
                f"hop % 4 == 0, S % 4 == 0 and a 16-byte aligned input; got "
                f"n_fft={self.n_fft}, n_out={self.n_out}, hop={self.hop}, S={S}, "
                f"address % 16 = {x.data_ptr() % 16}")
        T = num_frames(S, self.n_fft, self.hop)
        out = torch.empty((B, self.n_out, T), dtype=torch.float32, device=x.device)
        mel = [t.data_ptr() if t is not None else None
               for t in (self.mel_start, self.mel_off, self.mel_w)]
        n_mels = self.n_out if self.use_mel else 0
        n_weights = self.mel_w.numel() if self.use_mel else 0
        fast = int(self.precision == "fast")
        lib = _logmel_library()
        with torch.cuda.device(x.device):  # the launch targets the current device
            cap = self._grid_caps.get(x.device.index)
            if cap is None:  # once per device: the blocks that fit, times the SMs
                per_sm = lib.logmel_blocks_per_sm(self.hop, n_mels, n_weights, fast)
                if per_sm == 0:
                    raise RuntimeError(f"no block of the logmel kernel fits on {x.device}")
                sms = torch.cuda.get_device_properties(x.device).multi_processor_count
                cap = self._grid_caps[x.device.index] = per_sm * sms
            err = lib.logmel_launch(
                x.data_ptr(), B, S, self.hop, T, self.window.data_ptr(),
                self.twiddles.data_ptr(), self.split_twiddles.data_ptr(), *mel, n_mels,
                n_weights, out.data_ptr(), self.floor_amp, fast, cap,
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


KERNEL_N_FFT = 1024  # the frame length csrc/logmel.cu is written for
KERNEL_MAX_MELS = 384  # its mel pass keeps 3 x 8 results per thread
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
    lib.logmel_launch.argtypes = [p, i, i, i, i, p, p, p, p, p, p, i, i, p, ctypes.c_float, i, i,
                                  p]
    lib.logmel_blocks_per_sm.restype = i
    lib.logmel_blocks_per_sm.argtypes = [i, i, i, i]
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
