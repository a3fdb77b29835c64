"""Copy of ``preset_gen_vae_tpu/data/preset.py``, the JAX package's counterpart,
unchanged apart from this line.

Preset domain layer: full(VST) <-> learnable index translation.

Re-derivation of the reference's ``PresetIndexesHelper`` / ``PresetsParams``
(reference: data/preset.py:23-283, 286-391) with one crucial difference for
TPU: every translation is expressed as precomputed numpy index/segment
matrices so encode / decode / losses are *pure vectorized array ops* —
no per-parameter Python loops on the hot path, and everything jit-compiles.

Learnable representation: a preset of N (=155 for Dexed) normalized VST
parameters maps to a learnable vector of length L where
  - params with learnable model ``None`` are dropped,
  - params with model ``'num'`` keep one slot (value in [0, 1]),
  - params with model ``'cat'`` expand to ``cardinality`` one-hot slots.

With the default Dexed config ('all<=32' categorical threshold, operators
all on, constant filter/tune) L = 610 and 144 VST params are learnable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class PresetSpec:
    """Everything a synth dataset must declare about its parameter space.

    ``learnable_model[i]`` is None (not learned), 'num' or 'cat'
    (reference: data/abstractbasedataset.py:234-250, dexeddataset.py:139-167).
    ``cardinalities`` are *learnable-representation* cardinalities
    (-1 = continuous)."""

    n_params: int
    learnable_model: List[Optional[str]]
    cardinalities: np.ndarray
    numerical_vst_params: Sequence[int]
    categorical_vst_params: Sequence[int]
    default_values: Dict[int, float]
    param_names: List[str]
    synth_name: str = "generic"

    @staticmethod
    def identity(nb_params: int) -> "PresetSpec":
        """All-numerical, all-learnable spec (reference: data/preset.py:38-51)."""
        return PresetSpec(
            n_params=nb_params,
            learnable_model=["num"] * nb_params,
            cardinalities=np.full((nb_params,), -1, dtype=np.int64),
            numerical_vst_params=list(range(nb_params)),
            categorical_vst_params=[],
            default_values={},
            param_names=[f"param{i}" for i in range(nb_params)],
            synth_name="generic_synth",
        )


class PresetIndexesHelper:
    """Index translator with vectorized encode/decode and precomputed masks.

    Public surface mirrors the reference class (data/preset.py:23-283):
    ``full_to_learnable``, ``learnable_to_full``, ``learnable_preset_size``,
    ``get_numerical_learnable_indexes()``, ... — plus numpy/segment arrays
    used by the jit-safe losses.
    """

    def __init__(self, spec: PresetSpec):
        self.spec = spec
        self.synth_name = spec.synth_name
        n = spec.n_params

        # --- sequential full->learnable layout (reference: data/preset.py:64-83)
        full_to_learnable: List = []
        learnable_to_full: List[int] = []
        cur = 0
        for vst_idx in range(n):
            model = spec.learnable_model[vst_idx]
            if model is None:
                full_to_learnable.append(None)
            elif model == "num":
                full_to_learnable.append(cur)
                learnable_to_full.append(vst_idx)
                cur += 1
            elif model == "cat":
                card = int(spec.cardinalities[vst_idx])
                assert card >= 1, f"categorical param {vst_idx} needs cardinality >= 1"
                idxs = list(range(cur, cur + card))
                full_to_learnable.append(idxs)
                learnable_to_full.extend([vst_idx] * card)
                cur += card
            else:
                raise ValueError(f"Unknown learnable model '{model}'")
        self._full_to_learnable = full_to_learnable
        self._learnable_to_full = learnable_to_full
        self._learnable_preset_size = cur

        # --- vectorized numerical tables
        num_pairs = [
            (vst, li)
            for vst, li in enumerate(full_to_learnable)
            if isinstance(li, int)
        ]
        self.num_vst_idx = np.array([v for v, _ in num_pairs], dtype=np.int64)
        self.num_learn_idx = np.array([l for _, l in num_pairs], dtype=np.int64)
        self.num_card = spec.cardinalities[self.num_vst_idx] if len(num_pairs) else np.zeros(
            (0,), dtype=np.int64
        )

        # --- vectorized categorical group tables (ragged -> padded matrix)
        cat_groups = [
            (vst, li)
            for vst, li in enumerate(full_to_learnable)
            if isinstance(li, list)
        ]
        self.cat_group_vst_idx = np.array([v for v, _ in cat_groups], dtype=np.int64)
        self.cat_group_card = np.array([len(li) for _, li in cat_groups], dtype=np.int64)
        self.cat_group_start = np.array([li[0] for _, li in cat_groups], dtype=np.int64)
        self.n_cat_groups = len(cat_groups)
        self.max_cat_card = int(self.cat_group_card.max()) if cat_groups else 0
        # padded (G, max_card) matrix of learnable indexes; -1 = padding
        self.cat_group_idx_matrix = np.full(
            (self.n_cat_groups, self.max_cat_card), -1, dtype=np.int64
        )
        for g, (_, li) in enumerate(cat_groups):
            self.cat_group_idx_matrix[g, : len(li)] = li
        self.cat_group_mask = self.cat_group_idx_matrix >= 0  # (G, max_card)

        # learnable slot -> cat group id (or -1 for numerical slots)
        self.learn_idx_cat_group = np.full((cur,), -1, dtype=np.int64)
        for g, (_, li) in enumerate(cat_groups):
            self.learn_idx_cat_group[np.asarray(li)] = g
        # boolean mask over learnable slots: True where slot is numerical
        self.learn_idx_is_num = np.zeros((cur,), dtype=bool)
        if len(self.num_learn_idx):
            self.learn_idx_is_num[self.num_learn_idx] = True

        # --- numerical/categorical *VST* splits crossed with learnable model
        # (reference dicts: data/preset.py:87-115)
        self.cat_idx_learned_as_num = {
            v: full_to_learnable[v]
            for v in spec.categorical_vst_params
            if isinstance(full_to_learnable[v], int)
        }
        self.cat_idx_learned_as_cat = {
            v: full_to_learnable[v]
            for v in spec.categorical_vst_params
            if isinstance(full_to_learnable[v], list)
        }
        self.num_idx_learned_as_num = {
            v: full_to_learnable[v]
            for v in spec.numerical_vst_params
            if isinstance(full_to_learnable[v], int)
        }
        self.num_idx_learned_as_cat = {
            v: full_to_learnable[v]
            for v in spec.numerical_vst_params
            if isinstance(full_to_learnable[v], list)
        }

        # --- useless-params machinery (Dexed zero-volume operators)
        # (reference: data/preset.py:247-283). Precomputed as (6, ...) masks.
        self._build_useless_param_masks()

    # ------------------------------------------------------------------
    # reference-compatible properties
    # ------------------------------------------------------------------
    @property
    def full_preset_size(self) -> int:
        return self.spec.n_params

    @property
    def learnable_preset_size(self) -> int:
        return self._learnable_preset_size

    @property
    def full_to_learnable(self):
        return self._full_to_learnable

    @property
    def learnable_to_full(self):
        return self._learnable_to_full

    @property
    def vst_param_names(self):
        return self.spec.param_names

    @property
    def vst_param_learnable_model(self):
        return self.spec.learnable_model

    @property
    def vst_param_cardinals(self):
        return list(self.spec.cardinalities)

    @property
    def numerical_vst_params(self):
        return self.spec.numerical_vst_params

    @property
    def categorical_vst_params(self):
        return self.spec.categorical_vst_params

    def get_numerical_learnable_indexes(self):
        return list(self.num_learn_idx)

    def get_categorical_learnable_indexes(self):
        return [list(row[row >= 0]) for row in self.cat_group_idx_matrix]

    def get_learnable_param_quantized_steps(self, idx: int):
        """(reference: data/preset.py:231-245)"""
        vst_idx = self._learnable_to_full[idx]
        model = self.spec.learnable_model[vst_idx]
        if model == "cat":
            return np.asarray([0.0, 1.0])
        if model == "num":
            card = int(self.spec.cardinalities[vst_idx])
            if card >= 2:
                return np.linspace(0.0, 1.0, endpoint=True, num=card)
            return None
        raise ValueError(f"Unknown learnable model '{model}' for idx={idx}")

    @property
    def short_description(self) -> str:
        learnable_count = sum(m is not None for m in self.spec.learnable_model)
        return (
            f"[PresetIndexesHelper] {learnable_count} learnable VSTi parameters, "
            f"learnable tensor representation size: {self._learnable_preset_size}"
        )

    # ------------------------------------------------------------------
    # Vectorized encode / decode (replaces PresetsParams loops,
    # reference: data/preset.py:341-391)
    # ------------------------------------------------------------------
    def full_to_learnable_batch(self, full: np.ndarray) -> np.ndarray:
        """(B, n_params) normalized full presets -> (B, L) learnable tensors.
        Numerical slots are copied; categorical slots one-hot encoded from the
        rounded class index (reference: data/preset.py:371-389)."""
        full = np.asarray(full, dtype=np.float32)
        B = full.shape[0]
        out = np.zeros((B, self._learnable_preset_size), dtype=np.float32)
        if len(self.num_learn_idx):
            out[:, self.num_learn_idx] = full[:, self.num_vst_idx]
        if self.n_cat_groups:
            vals = full[:, self.cat_group_vst_idx]  # (B, G)
            classes = np.rint(vals * (self.cat_group_card[None, :] - 1)).astype(np.int64)
            onehot = classes[:, :, None] == np.arange(self.max_cat_card)[None, None, :]
            # scatter padded groups into the learnable layout
            flat_idx = self.cat_group_idx_matrix[self.cat_group_mask]  # (sum cards,)
            out[:, flat_idx] = onehot[:, self.cat_group_mask].astype(np.float32)
        return out

    def learnable_to_full_batch(
        self, learnable: np.ndarray, apply_defaults: bool = True
    ) -> np.ndarray:
        """(B, L) learnable/inferred tensors -> (B, n_params) VST presets.
        Non-learnable slots get their constrained default value if any, else
        -0.1 (reference fill value, data/preset.py:351); categorical groups are
        arg-maxed to ``class / (card-1)`` (data/preset.py:359-363)."""
        learnable = np.asarray(learnable, dtype=np.float32)
        B = learnable.shape[0]
        full = np.full((B, self.spec.n_params), -0.1, dtype=np.float32)
        if apply_defaults:
            for vst_idx, v in self.spec.default_values.items():
                if self.spec.learnable_model[vst_idx] is None:
                    full[:, vst_idx] = v
        if len(self.num_learn_idx):
            full[:, self.num_vst_idx] = learnable[:, self.num_learn_idx]
        if self.n_cat_groups:
            # gather padded groups; pad positions get -inf so argmax ignores them
            gathered = learnable[:, np.maximum(self.cat_group_idx_matrix, 0)]  # (B,G,C)
            gathered = np.where(self.cat_group_mask[None, :, :], gathered, -np.inf)
            classes = np.argmax(gathered, axis=-1).astype(np.float32)  # (B, G)
            denom = np.maximum(self.cat_group_card - 1, 1).astype(np.float32)
            full[:, self.cat_group_vst_idx] = classes / denom[None, :]
        return full

    # ------------------------------------------------------------------
    # Useless-parameter masking (Dexed zero-volume operators)
    # ------------------------------------------------------------------
    def _build_useless_param_masks(self):
        """Precompute per-operator masks over the learnable layout.

        Reference semantics (data/preset.py:259-281): when a Dexed operator's
        output level is ~0, every other parameter of that operator has no
        influence on sound and must be excluded from the synth-params loss.
        Affected per-op VST offsets are EG rates/levels (23-30 + 22i) and
        32-43 + 22i (mode..key velocity) — switch and output level excluded.
        """
        from ..synth import dexed_params as dx

        n_ops = 0
        if self.synth_name.lower() == "dexed":
            n_ops = dx.N_OPERATORS
        self.n_maskable_ops = n_ops
        L, G = self._learnable_preset_size, self.n_cat_groups
        self.op_volume_learn_idx = np.full((max(n_ops, 1),), -1, dtype=np.int64)
        self.useless_num_mask_matrix = np.zeros((max(n_ops, 1), L), dtype=bool)
        self.useless_cat_group_matrix = np.zeros((max(n_ops, 1), max(G, 1)), dtype=bool)
        if n_ops == 0:
            return
        base_offsets = list(dx.OFF_EG_RATES) + list(dx.OFF_EG_LEVELS) + list(
            range(dx.OFF_MODE, dx.OFF_SWITCH)
        )  # +0..+7 and +9..+20 (22 offsets minus volume(+8) and switch(+21))
        vst_to_group = {int(v): g for g, v in enumerate(self.cat_group_vst_idx)}
        for op_i in range(n_ops):
            vol_vst = dx.op_param_index(op_i + 1, dx.OFF_OUTPUT_LEVEL)
            vol_learn = self._full_to_learnable[vol_vst]
            if isinstance(vol_learn, int):
                self.op_volume_learn_idx[op_i] = vol_learn
            elif isinstance(vol_learn, list):
                raise NotImplementedError("Dexed operator volume learned as categorical")
            for off in base_offsets:
                vst_idx = dx.op_param_index(op_i + 1, off)
                li = self._full_to_learnable[vst_idx]
                if isinstance(li, int):
                    self.useless_num_mask_matrix[op_i, li] = True
                elif isinstance(li, list):
                    self.useless_cat_group_matrix[op_i, vst_to_group[vst_idx]] = True

    def useless_masks_batch(self, v_in: np.ndarray, vol_threshold: float = 1e-3):
        """Vectorized equivalent of ``get_useless_learned_params_indexes``
        applied over a whole batch (reference: data/preset.py:247-283 and the
        per-row loop in model/loss.py:120-126).

        :returns: (num_mask, cat_mask): boolean arrays of shape (B, L) and
            (B, G). True = parameter/group is USELESS for that batch row.
        """
        xp = np  # works with numpy or jax.numpy inputs via __array_function__
        v_in = v_in if hasattr(v_in, "shape") else np.asarray(v_in)
        B = v_in.shape[0]
        if self.n_maskable_ops == 0:
            return (
                np.zeros((B, self._learnable_preset_size), dtype=bool),
                np.zeros((B, max(self.n_cat_groups, 1)), dtype=bool),
            )
        vol_idx = self.op_volume_learn_idx  # (6,)
        has_vol = vol_idx >= 0
        vols = v_in[:, xp.maximum(vol_idx, 0)]  # (B, 6)
        op_off = (vols < vol_threshold) & has_vol[None, :]  # (B, 6)
        # float matmul then >0 keeps this identical under numpy and jax.numpy
        num_mask = (
            op_off.astype(np.float32) @ self.useless_num_mask_matrix.astype(np.float32)
        ) > 0.5
        cat_mask = (
            op_off.astype(np.float32) @ self.useless_cat_group_matrix.astype(np.float32)
        ) > 0.5
        return num_mask, cat_mask

    def get_useless_learned_params_indexes(self, preset_GT):
        """Reference-compatible single-row API (data/preset.py:247-283):
        returns (list of useless numerical learnable idx, list of first-slot
        idx of useless categorical groups)."""
        v = np.asarray(preset_GT, dtype=np.float32)[None, :]
        num_mask, cat_mask = self.useless_masks_batch(v)
        num_idx = sorted(set(np.nonzero(num_mask[0])[0]) & set(self.num_learn_idx))
        cat_idx = [int(self.cat_group_start[g]) for g in np.nonzero(cat_mask[0])[0]]
        return [int(i) for i in num_idx], cat_idx
