"""Copy of ``preset_gen_vae_tpu/logs/metrics.py``, the JAX package's
counterpart, unchanged apart from this line.

Metric primitives (reference: logs/metrics.py:14-187).

Same family of accumulators — SimpleMetric / EpochMetric / BufferedMetric /
LatentMetric / CorrelationMetric — with the Spearman computation vectorized
(one rank transform + one correlation matrix, no per-pair scipy calls).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.stats import spearmanr


class SimpleMetric:
    """Holds a single value (reference: logs/metrics.py:35-51)."""

    def __init__(self, value: float = 0.0):
        self._value = float(value)

    def set(self, value: float):
        self._value = float(value)

    def get(self) -> float:
        return self._value

    def on_new_epoch(self):
        pass

    @property
    def value(self) -> float:
        return self._value


class EpochMetric:
    """Mean of minibatch values over the current epoch
    (reference: logs/metrics.py:54-82)."""

    def __init__(self):
        self._sum = 0.0
        self._count = 0

    def on_new_epoch(self):
        self._sum, self._count = 0.0, 0

    def append(self, value, weight: float = 1.0):
        """``weight`` is the batch's real (unpadded) item count relative to
        a full batch — the final validation batch is cyclically padded to a
        static shape, and its mean must not count as a full batch's worth."""
        self._sum += float(value) * float(weight)
        self._count += weight

    @property
    def has_data(self) -> bool:
        return self._count != 0

    def get(self) -> float:
        if self._count == 0:
            raise ValueError("No values were appended this epoch")
        return self._sum / self._count


class BufferedMetric:
    """Sliding-window mean over the last ``buffer_len`` values
    (reference: logs/metrics.py:14-32)."""

    def __init__(self, buffer_len: int = 10):
        self.buffer_len = buffer_len
        self._values = []

    def on_new_epoch(self):
        pass

    def append(self, value):
        self._values.append(float(value))
        if len(self._values) > self.buffer_len:
            self._values.pop(0)

    def get(self) -> float:
        if not self._values:
            raise ValueError("Empty buffer")
        return float(np.mean(self._values))

    @property
    def mean(self) -> float:
        return self.get()


def spearman_corr_matrix(z: np.ndarray) -> tuple:
    """(N, D) -> (r, p): (D, D) Spearman correlation + p-values
    (reference: logs/metrics.py:169-187)."""
    r, p = spearmanr(z)  # scipy vectorizes over columns
    r = np.atleast_2d(np.asarray(r))
    p = np.atleast_2d(np.asarray(p))
    return r, p


class LatentMetric:
    """Accumulates z0 mu / sampled z over an epoch and computes the Spearman
    correlation "entanglement" scalar: mean |r| off the diagonal
    (reference: logs/metrics.py:86-165)."""

    def __init__(self, dim_z: int, dataset_len: Optional[int] = None):
        self.dim_z = dim_z
        self._mu_chunks = []
        self._z_chunks = []
        self._r: Optional[np.ndarray] = None
        self._p: Optional[np.ndarray] = None

    def on_new_epoch(self):
        self._mu_chunks, self._z_chunks = [], []
        self._r = self._p = None

    def append(self, z_mu: np.ndarray, z_sampled: np.ndarray):
        self._mu_chunks.append(np.asarray(z_mu))
        self._z_chunks.append(np.asarray(z_sampled))
        self._r = self._p = None

    @property
    def has_data(self) -> bool:
        """True once >=2 latent rows were appended this epoch (LatCorr is
        only collected on plot epochs, and never on multi-host jobs)."""
        return sum(c.shape[0] for c in self._mu_chunks) >= 2

    def get_z(self, kind: str) -> np.ndarray:
        chunks = self._mu_chunks if kind == "mu" else self._z_chunks
        if not chunks:
            return np.zeros((0, self.dim_z))
        return np.concatenate(chunks, axis=0)

    def _compute(self):
        if self._r is None:
            z = self.get_z("mu")
            if z.shape[0] < 2:
                raise ValueError("No latent samples accumulated this epoch")
            self._r, self._p = spearman_corr_matrix(z)

    def get_spearman_corr(self) -> np.ndarray:
        self._compute()
        return self._r

    def get_spearman_pvalues(self) -> np.ndarray:
        self._compute()
        return self._p

    def get(self) -> float:
        """Entanglement scalar: mean abs off-diagonal correlation."""
        self._compute()
        r = np.abs(self._r.copy())
        np.fill_diagonal(r, 0.0)
        d = r.shape[0]
        return float(r.sum() / max(d * (d - 1), 1))


class CorrelationMetric:
    """Raw-data correlation store (reference: logs/metrics.py:169-187)."""

    def __init__(self, dim: int, dataset_len: Optional[int] = None):
        self.dim = dim
        self._chunks = []

    def append_batch(self, batch: np.ndarray):
        self._chunks.append(np.asarray(batch))

    def get_spearman_corr_and_p_values(self) -> tuple:
        data = np.concatenate(self._chunks, axis=0)
        return spearman_corr_matrix(data)
