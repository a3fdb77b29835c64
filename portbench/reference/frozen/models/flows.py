"""Normalizing flows: RealNVP affine coupling, MAF (masked autoregressive),
inter-layer BatchNorm flows, ReversePermutation, and their composition into
the latent and regression flows.

Counterpart: ``preset_gen_vae_tpu/models/flows.py:33-429`` (reference
rules: model/flows.py:42-90, VAE.py:110-127, regression.py:139-164). Every
layer exposes ``forward(x, generator) -> (y, logdet)`` and
``inverse(y, generator) -> (x, logdet)``, logdet of shape (B,). A MAF
layer's forward is one MADE pass; its inverse is the D-step sequential
recursion (D MADE passes), always with the MADE net in eval mode.

The conditioner MLPs run in the autocast dtype (bf16 on the card, as the
JAX package's ``dtype`` field); the scale, shift and logdet are computed in
float32 (float64 for float64 inputs).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, dropout, update_running_stats, widen


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
        raw = widen(self.conditioner(x_id, generator))
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
        self.stats_frozen = False  # set by layers.running_stats_frozen
        self.log_gamma = nn.Parameter(torch.zeros(features))
        self.beta = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, generator=None):
        if self.training:
            var, mean = torch.var_mean(x, dim=0, unbiased=False)
            update_running_stats(self, mean, var)
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


def made_masks(features: int, hidden: int, n_hidden_layers: int):
    """MADE degree masks, (in, out) each, strictly autoregressive output with
    respect to the input order; the last one covers the two output blocks
    (shift, raw scale). Copy of flows.py:197-212."""
    degrees_in = np.arange(1, features + 1)
    masks = []
    prev = degrees_in
    for _ in range(n_hidden_layers):
        deg_h = (np.arange(hidden) % max(features - 1, 1)) + 1
        masks.append((deg_h[None, :] >= prev[:, None]).astype(np.float32))
        prev = deg_h
    out_mask = (degrees_in[None, :] > prev[:, None]).astype(np.float32)
    masks.append(np.concatenate([out_mask, out_mask], axis=1))
    return masks


class MaskedDense(nn.Linear):
    """Dense layer whose full kernel is the parameter, multiplied by a fixed
    0/1 mask at use, as flax's MaskedDense does (flows.py:214-224), so the
    kernel carries across unchanged. ``mask`` is (in, out)."""

    def __init__(self, mask: np.ndarray):
        super().__init__(mask.shape[0], mask.shape[1])
        self.register_buffer("mask", torch.from_numpy(np.ascontiguousarray(mask.T)),
                             persistent=False)

    def forward(self, x):
        return F.linear(x, self.weight * self.mask, self.bias)


class MaskedAffineAutoregressive(nn.Module):
    """MAF layer (flows.py:227-284): y_d = x_d * s_d(x_<d) + t_d(x_<d), with
    scale = softplus(raw + c0) + 1e-3, c0 = softplus^-1(1). Submodules carry
    the flax names ``layers`` (MaskedDense) and ``bns`` (BatchNorm)."""

    SOFTPLUS_C0 = 0.5413248546129181  # softplus(c0) == 1

    def __init__(self, features: int, hidden_features: int, n_hidden_layers: int = 2,
                 dropout_p: float = 0.0, use_batch_norm: bool = False):
        super().__init__()
        self.features, self.dropout_p, self.use_bn = features, dropout_p, use_batch_norm
        masks = made_masks(features, hidden_features, n_hidden_layers)
        self.layers = nn.ModuleList([MaskedDense(m) for m in masks])
        if use_batch_norm:
            self.bns = nn.ModuleList([BatchNorm(hidden_features)
                                      for _ in range(n_hidden_layers)])

    def _params(self, x, generator):
        h = x
        for i, layer in enumerate(self.layers[:-1]):
            h = layer(h)
            if self.use_bn:
                h = self.bns[i](h)
            h = dropout(torch.relu(h), self.dropout_p, self.training, generator)
        t, raw_s = widen(self.layers[-1](h)).chunk(2, dim=-1)
        return F.softplus(raw_s + self.SOFTPLUS_C0) + 1e-3, t

    def forward(self, x, generator=None):
        s, t = self._params(x, generator)
        return x * s + t, torch.log(s).sum(-1)

    def inverse(self, y, generator=None):
        """D passes: after pass d the first d outputs are exact. The MADE net
        runs in eval mode (no dropout, running BN statistics), whatever the
        module's mode (flows.py:274-281)."""
        mode = self.training
        self.train(False)
        try:
            x = torch.zeros_like(y)
            for _ in range(self.features):
                s, t = self._params(x, generator)
                x = (y - t) / s
            s, _ = self._params(x, generator)
        finally:
            self.train(mode)
        return x, -torch.log(s).sum(-1)


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


def _build_flow(features: int, flow_arch: str, bn_between: bool, dropout_p: float,
                maf_dropout_p: float):
    """RealNVP with BN inside the conditioners, BN between layers when
    ``bn_between`` and dropout, both off on the last two layers; or MAF as
    (ReversePermutation, MaskedAffineAutoregressive) pairs."""
    flow_type, n_layers, hidden = parse_flow_arch(flow_arch)
    layers = []
    if flow_type == "maf":
        for _ in range(n_layers):
            layers.append(ReversePermutation())
            layers.append(MaskedAffineAutoregressive(features, hidden, dropout_p=maf_dropout_p))
    elif flow_type in ("realnvp", "rnvp"):
        for l in range(n_layers):
            not_last_two = l < n_layers - 2
            layers.append(AffineCouplingLayer(
                features, hidden, checkerboard_mask(features, l % 2 == 0), num_blocks=2,
                dropout_p=dropout_p if not_last_two else 0.0, bn_within=True))
            if bn_between and not_last_two:
                layers.append(BatchNormFlow(features))
    else:
        raise NotImplementedError(f"Unavailable flow '{flow_type}'")
    return FlowSequence(layers)


class LatentFlow(nn.Module):
    """VAE latent flow z0 -> zK (flows.py:326-373): RealNVP with BN inside
    the conditioners, none between layers, no dropout; or MAF."""

    def __init__(self, flow_arch: str, features: int):
        super().__init__()
        self.flow = _build_flow(features, flow_arch, bn_between=False, dropout_p=0.0,
                                maf_dropout_p=0.0)

    def forward(self, x, generator=None):
        return self.flow.forward(x, generator)

    def inverse(self, y, generator=None):
        return self.flow.inverse(y, generator)


class RegressionFlow(nn.Module):
    """Synth-parameter regression flow (flows.py:376-429): RealNVP with BN
    between layers and inside the conditioners, and dropout, all off on the
    last two layers; or MAF with dropout 0.5 (reference: regression.py:158)."""

    def __init__(self, flow_arch: str, features: int, dropout_p: float = 0.0):
        super().__init__()
        self.flow = _build_flow(features, flow_arch, bn_between=True, dropout_p=dropout_p,
                                maf_dropout_p=0.5)

    def forward(self, x, generator=None):
        return self.flow.forward(x, generator)

    def inverse(self, y, generator=None):
        return self.flow.inverse(y, generator)
