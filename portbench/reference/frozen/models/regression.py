"""Regression heads z_K -> learnable preset v (an MLP, or an invertible
flow) and the per-parameter output activation.

Counterpart: ``preset_gen_vae_tpu/models/regression.py:21-134``
(reference: model/regression.py:20-189).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..data.preset import PresetIndexesHelper
from .flows import RegressionFlow
from .layers import BatchNorm, dropout, widen


class ActivationTables(nn.Module):
    """The index tables of ``preset_activation`` as non-persistent buffers:
    they move with the head, so no call copies them from the host; the
    categorical slots are taken by their flat positions, not by a boolean
    mask (whose gather waits for the host)."""

    def __init__(self, idx_helper: PresetIndexesHelper):
        super().__init__()
        idx_matrix, mask = idx_helper.cat_group_idx_matrix, idx_helper.cat_group_mask
        tables = {
            "num_idx": idx_helper.num_learn_idx,
            "cat_idx": np.maximum(idx_matrix, 0),  # (G, C) learnable indexes, pads at 0
            "cat_mask": mask,  # (G, C) True where valid
            "cat_flat_idx": idx_matrix[mask],  # learnable index of each valid slot
            "cat_flat_pos": np.flatnonzero(mask),  # its position in the flattened (G, C)
        }
        for name, a in tables.items():
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(a)), persistent=False)


def segment_softmax_scatter(x: torch.Tensor, tables: ActivationTables,
                            temperature: float = 1.0) -> torch.Tensor:
    """In-group softmax over every padded categorical group of a (B, L)
    learnable tensor, written back in place of the logits
    (regression.py:21-40)."""
    if tables.cat_idx.numel() == 0:
        return x
    gathered = x[:, tables.cat_idx]  # (B, G, C)
    gathered = torch.where(tables.cat_mask[None], gathered / temperature, float("-inf"))
    probs = torch.softmax(gathered, dim=-1)
    return x.index_copy(1, tables.cat_flat_idx, probs.flatten(1)[:, tables.cat_flat_pos])


def preset_activation(x: torch.Tensor, tables: ActivationTables, cat_softmax: bool,
                      numerical_max: float = 1.0) -> torch.Tensor:
    """Hardtanh[0, 1] on numerical slots; a softmax per categorical group when
    ``cat_softmax``, else Hardtanh on those too (regression.py:43-59)."""
    if not cat_softmax:
        return torch.clamp(x, 0.0, numerical_max)
    if tables.num_idx.numel():
        idx = tables.num_idx
        x = x.index_copy(1, idx, torch.clamp(x[:, idx], 0.0, numerical_max))
    return segment_softmax_scatter(x, tables)


class MLPRegression(nn.Module):
    """'3l1024'-style MLP (regression.py:62-93): Dense layers ``fc1..fc{n}``
    with ReLU, BatchNorm ``bn{l}`` and dropout on every hidden layer but the
    last, a final Dense ``fc{n+1}`` to the learnable preset size, then the
    preset activation in float32."""

    def __init__(self, architecture: str, dim_z: int, idx_helper: PresetIndexesHelper,
                 dropout_p: float = 0.0, cat_softmax_activation: bool = False):
        super().__init__()
        arch = architecture.split("_")
        if len(arch) != 1:
            raise NotImplementedError("Arch suffix arguments not implemented yet")
        self.n_layers, n_neurons = (int(v) for v in arch[0].split("l"))
        self.idx_helper, self.dropout_p = idx_helper, dropout_p
        self.cat_softmax_activation = cat_softmax_activation
        self.activation_tables = ActivationTables(idx_helper)
        n_in = dim_z
        for l in range(1, self.n_layers + 1):
            setattr(self, f"fc{l}", nn.Linear(n_in, n_neurons))
            if l < self.n_layers:
                setattr(self, f"bn{l}", BatchNorm(n_neurons))
            n_in = n_neurons
        setattr(self, f"fc{self.n_layers + 1}", nn.Linear(n_in, idx_helper.learnable_preset_size))

    def forward(self, z_K, generator: Optional[torch.Generator] = None):
        h = z_K
        for l in range(1, self.n_layers + 1):
            h = getattr(self, f"fc{l}")(h)
            if l < self.n_layers:  # no BN/dropout on the last hidden layer
                h = dropout(getattr(self, f"bn{l}")(h), self.dropout_p, self.training, generator)
            h = torch.relu(h)
        h = getattr(self, f"fc{self.n_layers + 1}")(h)
        return preset_activation(widen(h), self.activation_tables, self.cat_softmax_activation)


class FlowRegression(nn.Module):
    """Invertible flow z_K <-> v; ``fast_forward_flow`` selects which flow
    direction maps z_K -> v (regression.py:96-134)."""

    def __init__(self, architecture: str, dim_z: int, idx_helper: PresetIndexesHelper,
                 dropout_p: float = 0.0, fast_forward_flow: bool = True,
                 cat_softmax_activation: bool = False):
        super().__init__()
        if dim_z != idx_helper.learnable_preset_size:
            raise ValueError("flow regression requires dim_z == learnable preset length "
                             "(reference: model/build.py:70, data/build.py:37-39)")
        self.idx_helper = idx_helper
        self.fast_forward_flow = fast_forward_flow
        self.cat_softmax_activation = cat_softmax_activation
        self.activation_tables = ActivationTables(idx_helper)
        self.flow = RegressionFlow(architecture, dim_z, dropout_p)

    def forward(self, z_K, generator: Optional[torch.Generator] = None):
        step = self.flow.forward if self.fast_forward_flow else self.flow.inverse
        v_out, _ = step(z_K, generator)
        return preset_activation(v_out, self.activation_tables, self.cat_softmax_activation)

    def flow_inverse(self, v, generator=None):
        """v -> z_K direction (regression.py:126-130)."""
        step = self.flow.inverse if self.fast_forward_flow else self.flow.forward
        return step(v, generator)
