"""Synth-parameter loss and monitoring criteria, vectorised over the batch.

Counterpart: ``preset_gen_vae_tpu/losses/synth_params.py:31-305``
(reference: model/loss.py:73-315): ``SynthParamsLoss``,
``QuantizedNumericalParamsLoss`` and ``CategoricalParamsAccuracy``, each
with its per-item form and its limited parameter subset for the eval pass.
``FlowParamsLoss`` needs the model's flows and lives in the train step
(``training/train_step.py``), as in the JAX package. The index tables
of ``PresetIndexesHelper`` are numpy; each criterion moves them to the
device of its inputs once and keeps them there: the first step makes
that copy, before any CUDA graph is captured, and a step after it copies
nothing from the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.preset import PresetIndexesHelper


class _Tables:
    """numpy index tables -> tensors, cached per device."""

    def __init__(self, **arrays):
        self._np = arrays
        self._by_dev: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def on(self, device) -> Dict[str, torch.Tensor]:
        if device not in self._by_dev:
            self._by_dev[device] = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                                    for k, v in self._np.items()}
        return self._by_dev[device]


def _masked_argmax(g: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
    return torch.where(pad[None], g, float("-inf")).argmax(-1)


def useless_masks(helper: PresetIndexesHelper, v_in: torch.Tensor, t: Dict,
                  vol_threshold: float = 1e-3):
    """(B, L) and (B, G) masks, True where a parameter or a categorical group
    belongs to a zero-volume Dexed operator (preset.py:322-349)."""
    B = v_in.shape[0]
    if helper.n_maskable_ops == 0:
        return (torch.zeros((B, helper.learnable_preset_size), dtype=torch.bool,
                            device=v_in.device),
                torch.zeros((B, max(helper.n_cat_groups, 1)), dtype=torch.bool,
                            device=v_in.device))
    vols = v_in[:, t["vol_idx"].clamp(min=0)]
    op_off = ((vols < vol_threshold) & (t["vol_idx"] >= 0)[None]).float()
    return op_off @ t["num_mask_m"] > 0.5, op_off @ t["cat_mask_m"] > 0.5


class SynthParamsLoss:
    """Hybrid numerical MSE + categorical CE (or BCE) loss with useless-param
    masking (synth_params.py:36-112; reference: model/loss.py:73-183)."""

    def __init__(self, idx_helper: PresetIndexesHelper, normalize_losses: bool,
                 categorical_loss_factor: float = 0.2,
                 prevent_useless_params_loss: bool = True, cat_bce: bool = True,
                 cat_softmax: bool = False, cat_softmax_t: float = 0.1):
        if cat_bce and cat_softmax:
            raise ValueError("cat_bce and cat_softmax cannot both be True")
        h = idx_helper
        self.h = h
        self.normalize_losses = normalize_losses
        self.cat_loss_factor = categorical_loss_factor
        self.prevent_useless = prevent_useless_params_loss
        self.cat_bce, self.cat_softmax, self.cat_softmax_t = cat_bce, cat_softmax, cat_softmax_t
        self.G = h.n_cat_groups
        self.t = _Tables(
            num_idx=h.num_learn_idx, idx_m=np.maximum(h.cat_group_idx_matrix, 0),
            pad=h.cat_group_mask, card=h.cat_group_card.astype(np.float32),
            vol_idx=h.op_volume_learn_idx,
            num_mask_m=h.useless_num_mask_matrix.astype(np.float32),
            cat_mask_m=h.useless_cat_group_matrix.astype(np.float32))

    def __call__(self, v_out: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
        t = self.t.on(v_in.device)
        B = v_in.shape[0]
        if self.prevent_useless:
            num_useless, cat_useless = useless_masks(self.h, v_in, t)
        else:
            num_useless = torch.zeros_like(v_in, dtype=torch.bool)
            cat_useless = torch.zeros((B, max(self.G, 1)), dtype=torch.bool, device=v_in.device)
        num_loss = v_in.new_zeros(())
        if len(self.h.num_learn_idx):  # (loss.py:127-136)
            idx = t["num_idx"]
            sq = torch.square((v_out[:, idx] - v_in[:, idx]) * (1.0 - num_useless[:, idx].float()))
            num_loss = sq.mean() if self.normalize_losses else sq.sum() / B
        cat_loss = v_in.new_zeros(())
        if self.G > 0:  # (loss.py:137-181)
            q, tgt, pad = v_out[:, t["idx_m"]], v_in[:, t["idx_m"]], t["pad"]
            useful = 1.0 - cat_useless[:, : self.G].float()
            n_useful = torch.clamp(useful.sum(0), min=1.0)  # the items that count
            if not self.cat_bce:
                if self.cat_softmax:
                    q = torch.softmax(torch.where(pad[None], q / self.cat_softmax_t,
                                                  float("-inf")), dim=-1)
                q_sel = torch.sum(q * tgt * pad[None].float(), dim=-1)
                per_group = -torch.sum(torch.log(torch.clamp(q_sel, min=1e-38)) * useful,
                                       dim=0) / n_useful
            else:  # binary cross-entropy, /8 factor (loss.py:173-175)
                qc = torch.clamp(q, 1e-7, 1.0 - 1e-7)
                bce = -(tgt * torch.log(qc) + (1.0 - tgt) * torch.log(1.0 - qc)) * pad[None].float()
                per_group = (torch.sum(bce * useful[:, :, None], dim=(0, 2))
                             / (n_useful * t["card"])) / 8.0
            cat_loss = per_group.sum()
            if self.normalize_losses:
                cat_loss = cat_loss / self.G
        return num_loss + cat_loss * self.cat_loss_factor


class QuantizedNumericalParamsLoss:
    """Quantized numerical-params error, monitoring only
    (synth_params.py:115-217; reference: model/loss.py:187-261). With
    ``limited_vst_params_indexes`` the errors of the other parameters are
    zeroed but still count in the mean (loss.py:226-247)."""

    def __init__(self, idx_helper: PresetIndexesHelper, loss: str = "mse",
                 limited_vst_params_indexes: Optional[Sequence[int]] = None):
        h = idx_helper
        self.loss = loss
        nn_pairs = sorted(h.num_idx_learned_as_num.items())
        vst_to_group = {int(v): g for g, v in enumerate(h.cat_group_vst_idx)}
        nc_vst = sorted(h.num_idx_learned_as_cat)
        nc_groups = np.array([vst_to_group[v] for v in nc_vst], dtype=np.int64)
        lim = (None if limited_vst_params_indexes is None
               else {int(i) for i in limited_vst_params_indexes})
        self.n_nn, self.n_nc = len(nn_pairs), len(nc_groups)
        self.t = _Tables(
            nn_idx=np.array([li for _, li in nn_pairs], dtype=np.int64),
            nn_card=np.array([h.spec.cardinalities[v] for v, _ in nn_pairs], dtype=np.float32),
            nn_include=np.array([lim is None or v in lim for v, _ in nn_pairs], dtype=np.float32),
            nc_idx_m=np.maximum(h.cat_group_idx_matrix[nc_groups], 0),
            nc_pad=h.cat_group_mask[nc_groups],
            nc_card=h.cat_group_card[nc_groups].astype(np.float32),
            nc_include=np.array([lim is None or v in lim for v in nc_vst], dtype=np.float32))

    def _errors(self, v_out: torch.Tensor, v_in: torch.Tensor) -> Optional[torch.Tensor]:
        """(B, P) quantized errors, or None without parameters."""
        t = self.t.on(v_in.device)
        errs = []
        if self.n_nn:
            u_in, u_out, card = v_in[:, t["nn_idx"]], v_out[:, t["nn_idx"]], t["nn_card"][None]
            u_out_q = torch.where(card > 0,
                                  torch.round(u_out * (card - 1.0)) / torch.clamp(card - 1.0, min=1.0),
                                  u_out)
            errs.append((u_out_q - u_in) * t["nn_include"][None])
        if self.n_nc:
            in_cls = _masked_argmax(v_in[:, t["nc_idx_m"]], t["nc_pad"])
            out_cls = _masked_argmax(v_out[:, t["nc_idx_m"]], t["nc_pad"])
            errs.append((out_cls - in_cls).float() / torch.clamp(t["nc_card"][None] - 1.0, min=1.0)
                        * t["nc_include"][None])
        return torch.cat(errs, dim=1) if errs else None

    def _reduce(self, err: torch.Tensor, dim=None) -> torch.Tensor:
        e = torch.square(err) if self.loss == "mse" else err.abs()
        return e.mean() if dim is None else e.mean(dim)

    def __call__(self, v_out: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
        err = self._errors(v_out, v_in)
        return v_in.new_zeros(()) if err is None else self._reduce(err)

    def per_item(self, v_out: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
        """(B,) per-item loss, for the eval pass's table (synth_params.py:185-217)."""
        err = self._errors(v_out, v_in)
        return v_in.new_zeros((v_in.shape[0],)) if err is None else self._reduce(err, 1)


class CategoricalParamsAccuracy:
    """Categorical-params accuracy in percent (synth_params.py:220-305;
    reference: model/loss.py:265-315): ``__call__`` averages per-parameter
    accuracies, ``per_item`` each item's accuracy over the parameters. With
    ``limited_vst_params_indexes`` only those parameters count."""

    def __init__(self, idx_helper: PresetIndexesHelper,
                 limited_vst_params_indexes: Optional[Sequence[int]] = None):
        h = idx_helper
        lim = (None if limited_vst_params_indexes is None
               else {int(i) for i in limited_vst_params_indexes})
        cn_pairs = [(v, li) for v, li in sorted(h.cat_idx_learned_as_num.items())
                    if lim is None or v in lim]
        vst_to_group = {int(v): g for g, v in enumerate(h.cat_group_vst_idx)}
        cc_groups = np.array([vst_to_group[v] for v in sorted(h.cat_idx_learned_as_cat)
                              if lim is None or v in lim], dtype=np.int64)
        self.n_cn, self.n_cc = len(cn_pairs), len(cc_groups)
        self.t = _Tables(
            cn_idx=np.array([li for _, li in cn_pairs], dtype=np.int64),
            cn_card=np.array([h.spec.cardinalities[v] for v, _ in cn_pairs], dtype=np.float32),
            cc_idx_m=np.maximum(h.cat_group_idx_matrix[cc_groups], 0),
            cc_pad=h.cat_group_mask[cc_groups])

    def _hits(self, v_out: torch.Tensor, v_in: torch.Tensor) -> Optional[torch.Tensor]:
        """(B, P) 1.0 where the inferred class is the target's, or None
        without parameters."""
        t = self.t.on(v_in.device)
        hits = []
        if self.n_cn:
            c = t["cn_card"][None] - 1.0
            t_cls = torch.round(v_in[:, t["cn_idx"]] * c)
            o_cls = torch.round(v_out[:, t["cn_idx"]] * c)
            hits.append((t_cls == o_cls).float())
        if self.n_cc:
            t_cls = _masked_argmax(v_in[:, t["cc_idx_m"]], t["cc_pad"])
            o_cls = _masked_argmax(v_out[:, t["cc_idx_m"]], t["cc_pad"])
            hits.append((t_cls == o_cls).float())
        return torch.cat(hits, dim=1) if hits else None

    def __call__(self, v_out: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
        hits = self._hits(v_out, v_in)
        return v_in.new_zeros(()) if hits is None else hits.mean(0).mean() * 100.0

    def per_item(self, v_out: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
        """(B,) per-item accuracy in percent (synth_params.py:276-295). The
        mean is taken as XLA takes the JAX package's, the sum times the
        float32 reciprocal of the count, so both agree to the bit."""
        hits = self._hits(v_out, v_in)
        if hits is None:
            return v_in.new_zeros((v_in.shape[0],))
        return hits.sum(1) * (1.0 / hits.shape[1]) * 100.0
