"""Normalizing flows: RealNVP affine coupling, inter-layer BatchNorm flows,
ReversePermutation, and their composition into the latent and regression
flows.

Counterpart: ``preset_gen_vae_tpu/models/flows.py:33-195, 287-429``
(reference rules: model/flows.py:42-90, VAE.py:110-127,
regression.py:139-164). Every layer exposes ``forward(x, generator) ->
(y, logdet)`` and ``inverse(y, generator) -> (x, logdet)``, logdet of shape
(B,). MAF (masked autoregressive) layers wait for a later slice.

The conditioner MLPs run in the autocast dtype (bf16 on the card, as the
JAX package's ``dtype`` field); the coupling scale, shift and logdet are
computed in float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .layers import BatchNorm, dropout


def checkerboard_mask(features: int, even_transformed: bool) -> np.ndarray:
    """True = slot TRANSFORMED by the coupling layer (flows.py:33-42)."""
    mask = np.zeros((features,), dtype=bool)
    if even_transformed:
        mask[::2] = True
    else:
        mask[1::2] = True
    return mask


def parse_flow_arch(flow_arch: str):
    """'realnvp_6l300' -> ('realnvp', 6, 300) (flows.py:311-323)."""
    parts = flow_arch.split("_")
    if len(parts) < 2:
        raise AssertionError(
            "flow arch must contain a type and layer spec, e.g. 'realnvp_4l200'")
    if len(parts) > 2:
        raise NotImplementedError("Optional flow arch arguments not supported yet")
    n_layers_s, hidden_s = parts[1].split("l")
    return parts[0].lower(), int(n_layers_s), int(hidden_s)


class ResidualMLP(nn.Module):
    """Dense-in, ``num_blocks`` two-layer residual blocks with optional BN
    before each ReLU and dropout, Dense-out (flows.py:45-81). Submodules
    carry the flax names: initial, bn{b}_{0,1}, fc{b}_{0,1}, final."""

    def __init__(self, in_features: int, out_features: int, hidden_features: int,
                 num_blocks: int = 2, dropout_p: float = 0.0, use_batch_norm: bool = False):
        super().__init__()
        self.num_blocks, self.dropout_p, self.use_bn = num_blocks, dropout_p, use_batch_norm
        self.initial = nn.Linear(in_features, hidden_features)
        for b in range(num_blocks):
            for half in (0, 1):
                if use_batch_norm:
                    setattr(self, f"bn{b}_{half}", BatchNorm(hidden_features))
                setattr(self, f"fc{b}_{half}", nn.Linear(hidden_features, hidden_features))
        self.final = nn.Linear(hidden_features, out_features)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = self.initial(x)
        for b in range(self.num_blocks):
            res = h
            if self.use_bn:
                res = getattr(self, f"bn{b}_0")(res)
            res = getattr(self, f"fc{b}_0")(torch.relu(res))
            if self.use_bn:
                res = getattr(self, f"bn{b}_1")(res)
            res = dropout(torch.relu(res), self.dropout_p, self.training, generator)
            h = h + getattr(self, f"fc{b}_1")(res)
        return self.final(h)


class AffineCouplingLayer(nn.Module):
    """y[tr] = x[tr] * s(x[id]) + t(x[id]); y[id] = x[id], with
    s = sigmoid(raw + 2) + 1e-3 (flows.py:84-137)."""

    def __init__(self, features: int, hidden_features: int, transformed_mask: np.ndarray,
                 num_blocks: int = 2, dropout_p: float = 0.0, bn_within: bool = False):
        super().__init__()
        mask = np.asarray(transformed_mask, dtype=bool)
        self.features = features
        self.register_buffer("idx_tr", torch.from_numpy(np.where(mask)[0]), persistent=False)
        self.register_buffer("idx_id", torch.from_numpy(np.where(~mask)[0]), persistent=False)
        self.conditioner = ResidualMLP(int((~mask).sum()), 2 * int(mask.sum()),
                                       hidden_features, num_blocks, dropout_p, bn_within)

    def _params(self, x_id, generator):
        raw = self.conditioner(x_id, generator).float()
        raw_s, t = raw.chunk(2, dim=-1)
        return torch.sigmoid(raw_s + 2.0) + 1e-3, t

    def _scatter(self, x_id, x_tr):
        out = x_id.new_zeros((x_id.shape[0], self.features))
        return out.index_copy(1, self.idx_id, x_id).index_copy(1, self.idx_tr, x_tr)

    def forward(self, x, generator=None):
        x_id, x_tr = x[:, self.idx_id], x[:, self.idx_tr]
        s, t = self._params(x_id, generator)
        return self._scatter(x_id, x_tr * s + t), torch.log(s).sum(-1)

    def inverse(self, y, generator=None):
        y_id, y_tr = y[:, self.idx_id], y[:, self.idx_tr]
        s, t = self._params(y_id, generator)
        return self._scatter(y_id, (y_tr - t) / s), -torch.log(s).sum(-1)


class BatchNormFlow(nn.Module):
    """Invertible BatchNorm flow layer (flows.py:140-179): train mode
    normalises with the batch statistics and updates the running ones with
    the biased variance (momentum 0.9, flax convention); eval mode and the
    inverse use the running statistics."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.log_gamma = nn.Parameter(torch.zeros(features))
        self.beta = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, generator=None):
        if self.training:
            var, mean = torch.var_mean(x, dim=0, unbiased=False)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        y = torch.exp(self.log_gamma) * (x - mean) * torch.rsqrt(var + self.eps) + self.beta
        logdet = (self.log_gamma - 0.5 * torch.log(var + self.eps)).sum()
        return y, logdet.expand(x.shape[0])

    def inverse(self, y, generator=None):
        mean, var = self.running_mean, self.running_var
        x = (y - self.beta) * torch.exp(-self.log_gamma) * torch.sqrt(var + self.eps) + mean
        logdet = -(self.log_gamma - 0.5 * torch.log(var + self.eps)).sum()
        return x, logdet.expand(y.shape[0])


class ReversePermutation(nn.Module):
    """(flows.py:182-194; reference: VAE.py:113, regression.py:152)"""

    def forward(self, x, generator=None):
        return x.flip(1), x.new_zeros(x.shape[0])

    def inverse(self, y, generator=None):
        return y.flip(1), y.new_zeros(y.shape[0])


class FlowSequence(nn.Module):
    """Composition with summed log|det J| (flows.py:287-308)."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x, generator=None):
        logdet = x.new_zeros(x.shape[0])
        for layer in self.layers:
            x, ld = layer.forward(x, generator)
            logdet = logdet + ld
        return x, logdet

    def inverse(self, y, generator=None):
        logdet = y.new_zeros(y.shape[0])
        for layer in reversed(self.layers):
            y, ld = layer.inverse(y, generator)
            logdet = logdet + ld
        return y, logdet


def _realnvp(features: int, flow_arch: str, bn_between: bool, dropout_p: float):
    flow_type, n_layers, hidden = parse_flow_arch(flow_arch)
    if flow_type not in ("realnvp", "rnvp"):
        raise NotImplementedError(f"flow '{flow_type}' is not ported yet (RealNVP only)")
    layers = []
    for l in range(n_layers):
        not_last_two = l < n_layers - 2
        layers.append(AffineCouplingLayer(
            features, hidden, checkerboard_mask(features, l % 2 == 0), num_blocks=2,
            dropout_p=dropout_p if not_last_two else 0.0, bn_within=True))
        if bn_between and not_last_two:
            layers.append(BatchNormFlow(features))
    return FlowSequence(layers)


class LatentFlow(nn.Module):
    """VAE latent flow z0 -> zK: RealNVP with BN inside the conditioners,
    none between layers, no dropout (flows.py:326-373)."""

    def __init__(self, flow_arch: str, features: int):
        super().__init__()
        self.flow = _realnvp(features, flow_arch, bn_between=False, dropout_p=0.0)

    def forward(self, x, generator=None):
        return self.flow.forward(x, generator)

    def inverse(self, y, generator=None):
        return self.flow.inverse(y, generator)


class RegressionFlow(nn.Module):
    """Synth-parameter regression flow: RealNVP with BN between layers and
    inside the conditioners, and dropout, all off on the last two layers
    (flows.py:376-429)."""

    def __init__(self, flow_arch: str, features: int, dropout_p: float = 0.0):
        super().__init__()
        self.flow = _realnvp(features, flow_arch, bn_between=True, dropout_p=dropout_p)

    def forward(self, x, generator=None):
        return self.flow.forward(x, generator)

    def inverse(self, y, generator=None):
        return self.flow.inverse(y, generator)
