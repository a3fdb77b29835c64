"""Copy of ``preset_gen_vae_tpu/ops/mel.py``, the JAX package's counterpart,
unchanged apart from this line.

Mel filterbank construction (host-side numpy, used at trace time).

Re-derivation of the standard Slaney-style mel filterbank with
``norm=None``, matching the defaults the reference relies on through
``librosa.feature.melspectrogram(S=..., n_mels=..., norm=None)``
(reference: utils/audio.py:85-87): Slaney mel scale (linear below 1 kHz,
log above), fmin=0, fmax=sr/2, triangular filters, no area normalization.
"""

from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3.0  # Hz per mel in the linear region
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP  # = 15.0
_LOGSTEP = np.log(6.4) / 27.0  # step size in the log region


def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    f = np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)
    return f


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    norm: str | None = None,
) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular filterbank.

    norm=None: un-normalized peak-1 triangles — what the spectrogram
    frontend uses for linear/mel magnitude compatibility (see reference
    comment utils/audio.py:86). norm='slaney': area normalization
    (2 / bandwidth), the librosa default used by its MFCC path."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)  # filter edges
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights = weights * enorm[:, None]
    return weights.astype(np.float32)


