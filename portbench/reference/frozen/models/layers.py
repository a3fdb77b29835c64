"""Convolutional layer primitives, BatchNorm with flax semantics, dropout
from an explicit generator, and the flax-like parameter initialisation.

Counterpart: ``preset_gen_vae_tpu/models/layers.py`` (reference:
model/layer.py:10-46). Layout is NCHW. Module attribute names follow the
flax module names (``Conv_0``, ``BatchNorm_0``, ``TorchConvTranspose2d_0``)
so that ``weights.py`` maps a flax variables dict onto a ``state_dict`` by
path alone.

``torch.nn.ConvTranspose2d`` already has the geometry that the JAX
package's ``TorchConvTranspose2d`` (layers.py:36-90) rebuilds by hand:
``H_out = (H_in-1)*stride - 2*pad + dilation*(k-1) + output_padding + 1``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _pair(v):
    return (int(v[0]), int(v[1])) if isinstance(v, (tuple, list)) else (int(v), int(v))


def conv_output_size(size: int, kernel: int, stride: int, pad: int, dilation: int = 1) -> int:
    return (size + 2 * pad - dilation * (kernel - 1) - 1) // stride + 1


def activation(name: str):
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, 0.1)
    if name == "elu":
        return F.elu
    raise NotImplementedError(f"activation '{name}'")


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout whose mask comes from ``generator`` (flax
    ``nn.Dropout`` semantics: keep with probability 1-p, scale by 1/(1-p))."""
    if not training or p <= 0.0:
        return x
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= p
    return x * keep / (1.0 - p)


def widen(x: torch.Tensor) -> torch.Tensor:
    """bf16/f16 (autocast outputs) -> float32; float32 and float64 stay."""
    return x.float() if x.dtype in (torch.float16, torch.bfloat16) else x


def f32_linear(linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A Dense that the JAX package leaves in float32 (no ``dtype``), kept in
    float32 under bf16 autocast (float64 stays)."""
    with torch.autocast(x.device.type, enabled=False):
        return linear(widen(x))


@contextlib.contextmanager
def running_stats_frozen(model: nn.Module):
    """Inside the block the train-mode ``BatchNorm`` and ``BatchNormFlow``
    layers of ``model`` normalise with the batch statistics as before but
    update no running statistic: a forward recomputed for its backward
    (``TrainConfig.remat``) leaves them as the forward's first pass left
    them."""
    layers = [m for m in model.modules() if hasattr(m, "stats_frozen")]
    for m in layers:
        m.stats_frozen = True
    try:
        yield
    finally:
        for m in layers:
            m.stats_frozen = False


def update_running_stats(module: nn.Module, mean: torch.Tensor, var: torch.Tensor) -> None:
    """``running = momentum * running + (1 - momentum) * batch`` for the
    module's ``running_mean`` and ``running_var``, in place and outside
    autograd; nothing while its statistics are frozen."""
    if module.stats_frozen:
        return
    with torch.no_grad():
        module.running_mean.mul_(module.momentum).add_(mean, alpha=1.0 - module.momentum)
        module.running_var.mul_(module.momentum).add_(var, alpha=1.0 - module.momentum)


class BatchNorm(nn.Module):
    """Batch normalisation over every axis but axis 1, with flax
    ``nn.BatchNorm`` semantics: the running variance is updated with the
    BIASED batch variance (torch's own BatchNorm uses the unbiased one, which
    drifts by B/(B-1) per step at the flows' 160-row batches), and flax
    ``momentum=0.9`` is ``running = 0.9 * running + 0.1 * batch``. Computes in
    float32 at least (bf16 inputs are widened, float64 stays)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.stats_frozen = False  # set by running_stats_frozen
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = widen(x)
        if self.training and not self.stats_frozen:
            with torch.no_grad():
                dims = [0] + list(range(2, x.dim()))
                var, mean = torch.var_mean(x, dim=dims, unbiased=False)
            update_running_stats(self, mean, var)
        return F.batch_norm(x, None if self.training else self.running_mean,
                            None if self.training else self.running_var,
                            self.weight, self.bias, training=self.training, eps=self.eps)


class Conv2DBlock(nn.Module):
    """conv + optional BN ('before'/'after' the activation) + activation
    (counterpart: layers.py:92-126)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int], stride=(1, 1),
                 pad=(0, 0), dilation=(1, 1), act: str = "lrelu",
                 batch_norm: Optional[str] = "after"):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, out_ch, _pair(kernel), _pair(stride), _pair(pad),
                                _pair(dilation))
        self.batch_norm = batch_norm
        if batch_norm is not None:
            self.BatchNorm_0 = BatchNorm(out_ch)
        self.act = activation(act)

    def forward(self, x):
        y = self.Conv_0(x)
        if self.batch_norm == "before":
            y = self.BatchNorm_0(y)
        y = self.act(y)
        if self.batch_norm == "after":
            y = self.BatchNorm_0(y)
        return y


class TConv2DBlock(nn.Module):
    """transposed conv + optional BN + activation (counterpart:
    layers.py:129-162)."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=(1, 1), pad=(0, 0),
                 out_pad=(0, 0), dilation=(1, 1), act: str = "lrelu",
                 batch_norm: Optional[str] = "after"):
        super().__init__()
        self.TorchConvTranspose2d_0 = nn.ConvTranspose2d(
            in_ch, out_ch, _pair(kernel), _pair(stride), _pair(pad), _pair(out_pad),
            dilation=_pair(dilation))
        self.batch_norm = batch_norm
        if batch_norm is not None:
            self.BatchNorm_0 = BatchNorm(out_ch)
        self.act = activation(act)

    def forward(self, x):
        y = self.TorchConvTranspose2d_0(x)
        if self.batch_norm == "before":
            y = self.BatchNorm_0(y)
        y = self.act(y)
        if self.batch_norm == "after":
            y = self.BatchNorm_0(y)
        return y


def _truncated_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal(0, std) cut at +-2 std by the inverse CDF of a uniform draw, as
    ``jax.random.truncated_normal`` does (one pass, no rejection loop)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)  # in place: one buffer
    u.mul_(1.0 - 2.0 * lo).add_(lo).mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0) * std)
    return u.float()


@torch.no_grad()
def init_like_flax(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draws every weight from the distribution flax initialises its
    counterpart with: Dense and Conv kernels lecun-normal (truncated normal,
    std sqrt(1/fan_in)/0.8796, cut at 2 std), ``TorchConvTranspose2d``
    kernels uniform(+-sqrt(1/fan_in)) (variance_scaling(1/3, fan_in,
    uniform), layers.py:63-67), biases 0. BatchNorm layers keep scale 1,
    bias 0. Draws in module order from a CPU ``generator``."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            if isinstance(mod, nn.Linear):
                fan_in = w.shape[1]
            elif isinstance(mod, nn.ConvTranspose2d):  # (in, out, kh, kw)
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:  # (out, in, kh, kw)
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            if isinstance(mod, nn.ConvTranspose2d):
                lim = math.sqrt(1.0 / fan_in)
                w.copy_(torch.rand(w.shape, generator=generator) * 2 * lim - lim)
            else:
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w.copy_(_truncated_normal(w.shape, std, generator))
            if mod.bias is not None:
                mod.bias.zero_()
    return model
