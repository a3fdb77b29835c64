"""Audio similarity metrics, batched over waveform pairs on the caller's
device.

Counterpart: ``preset_gen_vae_tpu/evaluation/similarity.py:30-151``
(reference: utils/audio.py:95-161): MAE of log10|STFT| (eps -80 dB on
un-normalized magnitudes), spectral convergence (Frobenius-relative STFT
error), and MFCC mean-absolute error. The STFT is librosa's: reflect
padding, a periodic Hann window, no window normalisation, no mel and no
log floor. It is not the training frontend, so it runs no hand kernel:
these are plain torch ops (``torch.fft.rfft``, cuBLAS products). MFCCs keep
librosa's defaults (n_fft 2048, hop 512, 128 Slaney-normed mel bands,
power 2, top_db 80, DCT-II ortho).

Every function takes (B, samples) float32 tensors and returns tensors on
their device. ``SimilarityEvaluator`` keeps the reference's per-pair API.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.mel import mel_filterbank


def _frame(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    pad = n_fft // 2
    x = torch.nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    return x.unfold(-1, n_fft, hop)  # (B, T, n_fft), T = 1 + (S + 2 pad - n_fft) // hop


def stft_magnitude(x: torch.Tensor, n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """(B, samples) -> (B, n_bins, T) un-normalized |STFT| (librosa.stft
    semantics, which the reference similarity metrics use — not the
    training frontend's window-max normalization)."""
    win = torch.from_numpy(np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(x.device)
    spec = torch.fft.rfft(_frame(x, n_fft, hop) * win, dim=-1)
    return spec.abs().transpose(-1, -2)


def mae_log_stft(s_ref: torch.Tensor, s_est: torch.Tensor) -> torch.Tensor:
    """(B, F, T) x2 -> (B,). eps = 1e-4 (= -80 dB, reference
    utils/audio.py:117-121)."""
    eps = 1e-4
    l0 = torch.log10(torch.clamp(s_ref, min=eps))
    l1 = torch.log10(torch.clamp(s_est, min=eps))
    return torch.mean(torch.abs(l1 - l0), dim=(-2, -1))


def spectral_convergence(s_ref: torch.Tensor, s_est: torch.Tensor) -> torch.Tensor:
    """(B, F, T) x2 -> (B,) Frobenius-relative error
    (reference: utils/audio.py:137-143). A (near-)silent reference returns
    NaN, as in the JAX package, so aggregations can skip it."""
    num = torch.sqrt(torch.sum(torch.square(s_ref - s_est), dim=(-2, -1)))
    den = torch.sqrt(torch.sum(torch.square(s_ref), dim=(-2, -1)))
    sc = num / torch.clamp(den, min=1e-12)
    return torch.where(den < 1e-3, torch.full_like(sc, float("nan")), sc)


def mfcc(x: torch.Tensor, sr: int = 22050, n_mfcc: int = 40) -> torch.Tensor:
    """(B, samples) -> (B, n_mfcc, T) MFCCs with librosa-default settings
    (the reference calls librosa.feature.mfcc with defaults,
    utils/audio.py:148-150)."""
    n_fft, hop, n_mels = 2048, 512, 128
    power = torch.square(stft_magnitude(x, n_fft, hop))  # (B, F, T)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, norm="slaney")).to(x.device)
    melspec = torch.einsum("mf,bft->bmt", fb, power)
    # power_to_db(ref=1.0, amin=1e-10, top_db=80)
    log_spec = 10.0 * torch.log10(torch.clamp(melspec, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 80.0)
    # DCT-II, norm='ortho' along the mel axis, as a matmul
    k = np.arange(n_mels)
    dct_m = np.cos(np.pi / n_mels * (k[None, :] + 0.5) * k[:n_mfcc, None])
    dct_m = dct_m * np.sqrt(2.0 / n_mels)
    dct_m[0] *= np.sqrt(0.5)
    dct_m = torch.from_numpy(dct_m.astype(np.float32)).to(x.device)
    return torch.einsum("cm,bmt->bct", dct_m, log_spec)


def mae_mfcc(x_ref: torch.Tensor, x_est: torch.Tensor, sr: int = 22050,
             n_mfcc: int = 40) -> torch.Tensor:
    return torch.mean(torch.abs(mfcc(x_ref, sr, n_mfcc) - mfcc(x_est, sr, n_mfcc)), dim=(-2, -1))


@torch.no_grad()
def batched_audio_errors(x_ref: torch.Tensor, x_est: torch.Tensor, n_fft: int = 1024,
                         hop: int = 256, sr: int = 22050) -> Dict[str, torch.Tensor]:
    """All similarity metrics for a batch of waveform pairs: -> dict of (B,)
    tensors (reference per-pair loop: eval.py:254-275)."""
    s_ref = stft_magnitude(x_ref, n_fft, hop)
    s_est = stft_magnitude(x_est, n_fft, hop)
    return {
        "spec_mae": mae_log_stft(s_ref, s_est),
        "spec_sc": spectral_convergence(s_ref, s_est),
        "mfcc13_mae": mae_mfcc(x_ref, x_est, sr, 13),
        "mfcc40_mae": mae_mfcc(x_ref, x_est, sr, 40),
    }


class SimilarityEvaluator:
    """Per-pair wrapper with the reference API (utils/audio.py:95-161); the
    metrics are computed on ``device`` (the card unless the caller asks for
    the CPU) and returned as numpy."""

    def __init__(self, x_wav: Sequence, n_fft=1024, fft_hop=256, sr=22050, n_mfcc=13,
                 device="cuda"):
        assert len(x_wav) == 2
        self.device = resolve_device(device)
        self.x_wav = [np.asarray(x, dtype=np.float32) for x in x_wav]
        self.n_fft, self.fft_hop, self.sr, self.n_mfcc = n_fft, fft_hop, sr, n_mfcc
        self._batch = torch.from_numpy(np.stack(self.x_wav)).to(self.device)
        with torch.no_grad():
            self.stft = stft_magnitude(self._batch, n_fft, fft_hop).cpu().numpy()

    def get_mae_log_stft(self, return_spectrograms=True):
        eps = 1e-4
        logs = [np.log10(np.maximum(s, eps)) for s in self.stft]
        mae = float(np.abs(logs[1] - logs[0]).mean())
        return (mae, logs) if return_spectrograms else mae

    def get_spectral_convergence(self, return_spectrograms=True):
        sc = float(np.linalg.norm(self.stft[0] - self.stft[1], ord="fro")
                   / np.linalg.norm(self.stft[0], ord="fro"))
        return (sc, list(self.stft)) if return_spectrograms else sc

    def get_mae_mfcc(self, return_mfccs=True, n_mfcc: Optional[int] = None):
        with torch.no_grad():
            m = mfcc(self._batch, self.sr, n_mfcc or self.n_mfcc).cpu().numpy()
        mae = float(np.abs(m[0] - m[1]).mean())
        return (mae, list(m)) if return_mfccs else mae
