"""Copy of ``preset_gen_vae_tpu/data/sampler.py``, the JAX package's counterpart,
unchanged apart from this line.

Deterministic train/validation/test splitting with k-fold support.

Re-derivation of the reference splitter (reference: data/sampler.py:17-59):
seed-0 shuffle of *preset* indexes, test holdout split, k folds over the
remainder; multi-note un-stacked datasets expand preset indexes to item
indexes only after splitting, so no preset ever straddles two subsets.

Returns plain index arrays (the TPU input pipeline shuffles per epoch with
its own PRNG) instead of torch SubsetRandomSamplers.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def split_preset_indexes(
    n_presets: int,
    k_fold: int = 0,
    k_folds_count: int = 5,
    test_holdout_proportion: float = 0.2,
    random_seed: int = 0,
) -> Dict[str, np.ndarray]:
    """-> {'train','validation','test'}: disjoint preset-index arrays."""
    all_idx = np.arange(n_presets)
    rng = np.random.default_rng(seed=random_seed)
    rng.shuffle(all_idx)
    first_test = int(np.floor(n_presets * (1.0 - test_holdout_proportion)))
    non_test, test = np.split(all_idx, [first_test])
    folds = np.array_split(non_test, k_folds_count)
    validation = folds[k_fold]
    train = np.hstack([folds[i] for i in range(k_folds_count) if i != k_fold])
    return {"train": train, "validation": validation, "test": test}


def expand_to_item_indexes(
    preset_indexes: np.ndarray, midi_notes_per_preset: int, stacked: bool
) -> np.ndarray:
    """Preset indexes -> dataset item indexes (reference: sampler.py:47-56).
    Stacked multi-note (or single-note) datasets: identity. Un-stacked
    multi-note: each preset owns ``midi_notes_per_preset`` consecutive items."""
    if midi_notes_per_preset == 1 or stacked:
        return np.asarray(preset_indexes)
    base = np.asarray(preset_indexes)[:, None] * midi_notes_per_preset
    return (base + np.arange(midi_notes_per_preset)[None, :]).reshape(-1)


def build_subset_item_indexes(
    dataset, k_fold=0, k_folds_count=5, test_holdout_proportion=0.2, random_seed=0
) -> Dict[str, np.ndarray]:
    """Reference-facade: dataset-aware split to item indexes
    (reference: data/sampler.py:17-59)."""
    preset_splits = split_preset_indexes(
        dataset.valid_presets_count,
        k_fold,
        k_folds_count,
        test_holdout_proportion,
        random_seed,
    )
    return {
        k: expand_to_item_indexes(
            v,
            dataset.midi_notes_per_preset,
            dataset.multichannel_stacked_spectrograms,
        )
        for k, v in preset_splits.items()
    }
