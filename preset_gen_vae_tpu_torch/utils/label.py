"""Copy of ``preset_gen_vae_tpu/utils/label.py``, the JAX package's
counterpart, unchanged apart from this paragraph. No path of the port calls
it.

Heuristic sample labeling: harmonic / percussive / sfx.

Role of the reference ``SimpleSampleLabeler`` (utils/audio.py:166-272):
harmonic-percussive source separation followed by empirical energy-ratio
thresholds. librosa is unavailable, so HPSS is implemented directly as the
standard median-filtering method (Fitzgerald 2010, what librosa.decompose
.hpss implements): harmonic = median filter along time, percussive = median
filter along frequency, soft masks with margin, residual = D - H - P.
Thresholds and attack-energy heuristics mirror the reference's values.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage


def _stft_mag(x: np.ndarray, n_fft: int = 2048, hop: int = 512) -> np.ndarray:
    """librosa-default STFT magnitude (center reflect pad, Hann)."""
    pad = n_fft // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    T = 1 + (len(x) - n_fft) // hop
    idx = (np.arange(T) * hop)[:, None] + np.arange(n_fft)[None, :]
    frames = x[idx] * np.hanning(n_fft + 1)[:-1]
    return np.abs(np.fft.rfft(frames, axis=-1)).T  # (F, T)


def hpss_masks(S: np.ndarray, kernel: int = 31, margin: float = 3.0, power: float = 2.0):
    """Median-filter HPSS soft masks. Returns (H, P) magnitude spectra."""
    harm = scipy.ndimage.median_filter(S, size=(1, kernel), mode="reflect")
    perc = scipy.ndimage.median_filter(S, size=(kernel, 1), mode="reflect")
    eps = 1e-10
    # margin-thresholded binary-ish masks (librosa margin>1 semantics:
    # component must dominate the other by `margin`)
    mask_h = (harm > margin * perc).astype(float)
    mask_p = (perc > margin * harm).astype(float)
    del power, eps
    return S * mask_h, S * mask_p


class SimpleSampleLabeler:
    """(reference API: utils/audio.py:166-272)"""

    def __init__(self, x_wav, Fs: int = 22050, hpss_margin: float = 3.0,
                 perc_duration_ms: float = 250.0):
        assert Fs == 22050
        self.Fs = Fs
        D = _stft_mag(np.asarray(x_wav, dtype=np.float32))
        H, P = hpss_masks(D, margin=hpss_margin)
        R = np.maximum(D - (H + P), 0.0)
        self.specs = {"D": D, "H": H, "P": P, "R": R}
        self.energy = {k: float(v.sum()) for k, v in self.specs.items()}
        d = max(self.energy["D"], 1e-12)
        self.energy_ratio = {
            "D": 1.0,
            "H": self.energy["H"] / d,
            "P": self.energy["P"] / d,
            "R": self.energy["R"] / d,
        }
        limit = int(np.ceil(perc_duration_ms * Fs / 512.0 / 1000.0))
        self.attack_energies = {
            k: float(v[:, :limit].sum()) for k, v in self.specs.items()
        }
        self.is_harmonic = self._is_harmonic()
        self.is_percussive = self._is_percussive()

    def has_label(self, label: str) -> bool:
        if label == "harmonic":
            return self.is_harmonic
        if label == "percussive":
            return self.is_percussive
        if label == "sfx":
            return not self.is_harmonic and not self.is_percussive
        raise ValueError(f"Label '{label}' is not valid.")

    def get_label(self) -> str:
        if self.is_harmonic:
            return "harmonic"
        if self.is_percussive:
            return "percussive"
        return "sfx"

    def _attack_ratio(self, k: str) -> float:
        return self.attack_energies[k] / max(self.energy[k], 1e-12)

    def _is_harmonic(self) -> bool:  # thresholds: reference utils/audio.py:256-261
        if self.energy_ratio["H"] > 0.40:
            return True
        if self.energy_ratio["H"] > 0.35:
            return self._attack_ratio("P") > 0.9
        return False

    def _is_percussive(self) -> bool:  # reference utils/audio.py:263-270
        if self.energy_ratio["P"] > 0.40:
            return self._attack_ratio("P") > 0.9
        if self.energy_ratio["P"] > 0.35 and self.energy_ratio["H"] > 0.15:
            return self._attack_ratio("P") > 0.9 and self._attack_ratio("H") > 0.8
        return False


def label_waveforms(waveforms: np.ndarray, Fs: int = 22050) -> list:
    """Batch helper: (N, samples) -> list of label strings."""
    return [SimpleSampleLabeler(w, Fs).get_label() for w in waveforms]
