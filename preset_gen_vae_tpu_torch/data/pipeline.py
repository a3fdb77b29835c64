"""Device-resident input pipeline: per-epoch shuffled index batches over the
corpus tensors, with padded static-size validation batches.

Counterpart: ``preset_gen_vae_tpu/data/pipeline.py:24-145`` (reference:
data/build.py:43-79, sampler.py:17-59). A batch is a gather of the
resident corpus by an index tensor; no batch travels from the host.
Epoch shuffles come from ``numpy.default_rng(seed ^ (epoch + 0x9E3779B9))``
as in the JAX package, so both packages visit the same batches.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .sampler import build_subset_item_indexes


class SplitLoader:
    """Batches of one subset; ``drop_last`` for train only, ``pad_to_full``
    cyclically pads the last partial batch of the other subsets.
    ``batch_weights`` overrides ``batch_weight``: a loader carved for one of
    several processes counts the real rows of every process's local batch
    (``parallel/multihost.py``)."""

    def __init__(self, tensors: Dict[str, torch.Tensor], item_indexes: np.ndarray,
                 batch_size: int, shuffle: bool, drop_last: bool, seed: int = 0,
                 pad_to_full: bool = False, batch_weights: Optional[np.ndarray] = None):
        self.tensors = tensors
        self.item_indexes = np.asarray(item_indexes)
        self.batch_size = int(batch_size)
        self.shuffle, self.drop_last, self.seed = shuffle, drop_last, seed
        self.pad_to_full = pad_to_full
        self.batch_weights = None if batch_weights is None else np.asarray(batch_weights, float)

    def __len__(self):
        n = len(self.item_indexes)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def n_items(self) -> int:
        return len(self.item_indexes)

    def batch_weight(self, i: int) -> float:
        """Fraction of batch ``i``'s rows that are real, not padding."""
        if self.batch_weights is not None:
            return float(self.batch_weights[i])
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
        tensor already on the device), gathered on the device."""
        i = torch.as_tensor(sel, dtype=torch.int64, device=self.tensors["x"].device)
        return self.tensors["x"][i], self.tensors["v"][i], self.tensors["info"][i]


def get_split_loaders(dataset, train_config) -> Dict[str, SplitLoader]:
    """'train' / 'validation' / 'test' loaders over the dataset's resident
    corpus (pipeline.py:105-145)."""
    tensors = dataset.corpus_tensors()
    splits = build_subset_item_indexes(
        dataset, k_fold=train_config.current_k_fold, k_folds_count=train_config.k_folds,
        test_holdout_proportion=train_config.test_holdout_proportion,
        random_seed=0)  # reference pins the split seed (sampler.py:36-38)
    return {name: SplitLoader(tensors, idx, train_config.minibatch_size,
                              shuffle=(name == "train"), drop_last=(name == "train"),
                              seed=train_config.seed, pad_to_full=(name != "train"))
            for name, idx in splits.items()}
