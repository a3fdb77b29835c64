"""Input pipeline: per-epoch shuffled index batches over the corpus
tensors, with padded static-size validation batches.

Counterpart: ``preset_gen_vae_tpu/data/pipeline.py:24-145`` (reference:
data/build.py:43-79, sampler.py:17-59). A batch is a gather of the corpus
tensors where they lie by an index tensor.

Epoch shuffles come from ``numpy.default_rng(seed ^ (epoch + 0x9E3779B9))``
as in the JAX package, so both packages visit the same batches.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


class SplitLoader:
    """Batches of one subset; ``drop_last`` for train only, ``pad_to_full``
    cyclically pads the last partial batch of the other subsets."""

    def __init__(self, tensors: Dict[str, torch.Tensor], item_indexes: np.ndarray,
                 batch_size: int, shuffle: bool, drop_last: bool, seed: int = 0,
                 pad_to_full: bool = False):
        self.tensors = tensors
        self.item_indexes = np.asarray(item_indexes)
        self.batch_size = int(batch_size)
        self.shuffle, self.drop_last, self.seed = shuffle, drop_last, seed
        self.pad_to_full = pad_to_full

    def __len__(self):
        n = len(self.item_indexes)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def n_items(self) -> int:
        return len(self.item_indexes)

    def batch_weight(self, i: int) -> float:
        """Fraction of batch ``i``'s rows that are real, not padding."""
        n_real = min(self.batch_size, self.n_items - i * self.batch_size)
        return max(n_real, 0) / self.batch_size

    def epoch_index_batches(self, epoch: int = 0) -> Iterator[np.ndarray]:
        idx = self.item_indexes
        if self.shuffle:
            idx = np.random.default_rng(self.seed ^ (epoch + 0x9E3779B9)).permutation(idx)
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if self.pad_to_full and len(sel) < self.batch_size:
                sel = np.concatenate([sel, np.resize(idx, self.batch_size - len(sel))])
            yield sel

    def gather(self, sel):
        """(x, v, info) of the items ``sel`` (a numpy array, or an index
        tensor already on the device), gathered where the tensors are."""
        i = torch.as_tensor(sel, dtype=torch.int64, device=self.tensors["x"].device)
        return self.tensors["x"][i], self.tensors["v"][i], self.tensors["info"][i]
