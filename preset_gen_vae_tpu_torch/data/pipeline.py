"""Input pipeline: per-epoch shuffled index batches over the corpus
tensors, with padded static-size validation batches.

Counterpart: ``preset_gen_vae_tpu/data/pipeline.py:24-145`` (reference:
data/build.py:43-79, sampler.py:17-59), and the JAX loop's two ways of
feeding a step (``training/loop.py:207-209, 233-237`` there):

- resident (``dataset_cache_device=True``): a batch is a gather of the
  corpus on the device by an index tensor; no batch travels from the host;
- host-fed (``dataset_cache_device=False``): the corpus stays in pinned
  host memory, the fallback for a corpus larger than the device's memory.
  ``device_batches`` gathers each batch on the host into a fresh pinned
  tensor and copies it to the device (``non_blocking``) on the current
  stream; batch i+1 is gathered once step i is enqueued, so that the
  host's gather overlaps step i on the device. A side stream with two
  reused staging buffers, which would let the copy overlap the step too,
  was measured no faster end to end (``scripts/compare_host_feed.py``).

Epoch shuffles come from ``numpy.default_rng(seed ^ (epoch + 0x9E3779B9))``
as in the JAX package, so both packages visit the same batches.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .sampler import build_subset_item_indexes


class SplitLoader:
    """Batches of one subset; ``drop_last`` for train only, ``pad_to_full``
    cyclically pads the last partial batch of the other subsets.
    ``batch_weights`` overrides ``batch_weight``: a loader carved for one of
    several processes counts the real rows of every process's local batch
    (``parallel/multihost.py``). ``tensors`` on the host make the loader
    host-fed (``device_batches``)."""

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
        tensor already on the device), gathered where the tensors are."""
        i = torch.as_tensor(sel, dtype=torch.int64, device=self.tensors["x"].device)
        return self.tensors["x"][i], self.tensors["v"][i], self.tensors["info"][i]

    def device_batches(self, batches, device: torch.device) -> Iterator[Tuple[torch.Tensor, ...]]:
        """(x, v, info) on ``device`` of each index batch of ``batches``, in
        order, each gathered when the caller asks for it. Host tensors and
        a CUDA ``device`` (host-fed): a gather into a fresh pinned tensor,
        copied with ``non_blocking`` on the current stream (the caching
        host allocator keeps the pinned block until the copy is done);
        otherwise ``gather``."""
        host_fed = self.tensors["x"].device.type == "cpu" and device.type == "cuda"
        for sel in batches:
            if not host_fed:
                yield self.gather(sel)
                continue
            sel, out = torch.as_tensor(sel, dtype=torch.int64), []
            for k in ("x", "v", "info"):
                t = self.tensors[k]
                pinned = torch.empty((len(sel), *t.shape[1:]), dtype=t.dtype, pin_memory=True)
                out.append(torch.index_select(t, 0, sel, out=pinned).to(device, non_blocking=True))
            yield tuple(out)


def get_split_loaders(dataset, train_config) -> Dict[str, SplitLoader]:
    """'train' / 'validation' / 'test' loaders over the dataset's corpus
    (pipeline.py:105-145), host-fed where the dataset keeps its corpus on
    the host (``corpus_on_device=False``)."""
    tensors = dataset.corpus_tensors()
    splits = build_subset_item_indexes(
        dataset, k_fold=train_config.current_k_fold, k_folds_count=train_config.k_folds,
        test_holdout_proportion=train_config.test_holdout_proportion,
        random_seed=0)  # reference pins the split seed (sampler.py:36-38)
    return {name: SplitLoader(tensors, idx, train_config.minibatch_size,
                              shuffle=(name == "train"), drop_last=(name == "train"),
                              seed=train_config.seed, pad_to_full=(name != "train"))
            for name, idx in splits.items()}
