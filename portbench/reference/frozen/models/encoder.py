"""Spectrogram encoders: conv stack + feature mixer + FC -> (B, 2, dim_z).

Counterpart: ``preset_gen_vae_tpu/models/encoder.py`` (reference:
model/encoder.py:8-307). The layer tables (``encoder_conv_specs``) are
copied whole from encoder.py:44-108. Input ``x`` is ``(B, C, H, W)``, as at
the JAX package's public function; the port computes in NCHW and flattens
the deepest features in NHWC order, as flax does (encoder.py:204), so the
``mlp_out`` kernel transplants unchanged. Stacked multi-note inputs
(C > 1 channels, speccnn8l1_bn only) run the shared ``single_ch_cnn`` once
per channel, as encoder.py:168-172 does: in train mode each call
normalises with that channel's own batch statistics and updates the shared
running statistics in turn, which folding the channels into the batch
would not. The outputs are concatenated channel-major before the mixers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .layers import BatchNorm, Conv2DBlock, conv_output_size, dropout, f32_linear, widen


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    out_ch: int
    kernel: Tuple[int, int]
    stride: Tuple[int, int]
    pad: Tuple[int, int]
    dilation: Tuple[int, int] = (1, 1)
    bn: Optional[str] = "after"
    act: str = "lrelu"  # 'lrelu' | 'elu'


def _c(out_ch, k, s, p, d=(1, 1), bn="after", act="lrelu"):
    to2 = lambda v: (v, v) if isinstance(v, int) else tuple(v)
    return ConvSpec(out_ch, to2(k), to2(s), to2(p), to2(d), bn, act)


def encoder_conv_specs(architecture: str):
    """Layer tables transcribing the reference stacks
    (model/encoder.py:128-301)."""
    if architecture in ("wavenet_baseline", "wavenet_baseline_lighter"):
        return [
            _c(128, 5, 2, 2), _c(128, 4, 2, 2), _c(128, 4, 2, 2),
            _c(256, 4, 2, 2), _c(256, 4, 2, 2), _c(256, 4, 2, 2),
            _c(512, 4, 2, 2), _c(512, 4, 2, 2), _c(512, 4, (2, 1), 2),
            _c(1024, 1, 1, 0),
        ]
    if architecture == "wavenet_baseline_shallow":
        return [
            _c(8, 5, 2, 2), _c(16, 4, 2, 2), _c(32, 4, 2, 2), _c(64, 4, 2, 2),
            _c(128, 4, 2, 2), _c(256, 4, 2, 2), _c(512, 4, 2, 2),
            _c(1024, 1, 1, 0),
        ]
    if architecture == "flow_synth":
        n = 64
        return [
            _c(n, 7, 2, 3, 1, act="elu"),
            _c(n, 7, 2, 3, 2, act="elu"),
            _c(n, 7, 2, 3, 2, act="elu"),
            _c(n, 7, 2, 3, 2, act="elu"),
            _c(n, 7, 2, 3, 2, act="elu"),
        ]
    if architecture == "speccnn8l1":
        return [
            _c(8, 5, 2, 2), _c(16, 4, 2, 2), _c(32, 4, 2, 2), _c(64, 4, 2, 2),
            _c(128, 4, 2, 2), _c(256, 4, 2, 2), _c(512, 4, 2, 2),
            _c(1024, 1, 1, 0),
        ]
    if architecture == "speccnn8l1_bn":
        # no BN on first and last conv layers (reference: encoder.py:233-259)
        return [
            _c(8, 5, 2, 2, bn=None), _c(16, 4, 2, 2), _c(32, 4, 2, 2),
            _c(64, 4, 2, 2), _c(128, 4, 2, 2), _c(256, 4, 2, 2),
            _c(512, 4, 2, 2), _c(1024, 1, 1, 0, bn=None),
        ]
    if architecture == "speccnn8l1_2":
        return [
            _c(32, 5, 2, 2, bn=None), _c(64, 4, 2, 2), _c(128, 4, 2, 2),
            _c(128, 4, 2, 2), _c(256, 4, 2, 2), _c(256, 4, 2, 2),
            _c(512, 4, 2, 2), _c(1024, 1, 1, 0, bn=None),
        ]
    if architecture == "speccnn8l1_3":
        return [
            _c(8, 5, 2, 2, bn=None), _c(16, 5, 2, 2), _c(32, 5, 2, 2),
            _c(64, 5, 2, 2), _c(128, 5, 2, 2), _c(256, 5, 2, 2),
            _c(512, 5, 2, 2), _c(1024, 1, 1, 0, bn=None),
        ]
    raise NotImplementedError(f"Architecture '{architecture}' not available")


class SpectrogramCNN(nn.Module):
    """Conv stack driven by a spec table, blocks named ``enc1..encN``
    (counterpart: encoder.py:111-132)."""

    def __init__(self, specs, in_ch: int = 1):
        super().__init__()
        self.names = []
        for i, s in enumerate(specs):
            name = f"enc{i + 1}"
            setattr(self, name, Conv2DBlock(in_ch, s.out_ch, s.kernel, s.stride, s.pad,
                                            s.dilation, s.act, s.bn))
            self.names.append(name)
            in_ch = s.out_ch
        self.out_ch = in_ch

    def forward(self, x):
        for name in self.names:
            x = getattr(self, name)(x)
        return x


def _out_hw(specs, hw):
    h, w = hw
    for s in specs:
        h = conv_output_size(h, s.kernel[0], s.stride[0], s.pad[0], s.dilation[0])
        w = conv_output_size(w, s.kernel[1], s.stride[1], s.pad[1], s.dilation[1])
    return h, w


class SpectrogramEncoder(nn.Module):
    """(B, C, H, W) spectrograms -> (B, 2, dim_z) latent mu and log-variance
    (counterpart: encoder.py:135-218; reference: model/encoder.py:23-108)."""

    def __init__(self, architecture: str, dim_z: int, input_hw=(257, 347),
                 spectrogram_channels: int = 1, fc_dropout: float = 0.3,
                 output_bn: bool = False, deepest_features_mix: bool = True,
                 force_bigger_network: bool = False):
        super().__init__()
        if not ("speccnn8l1" in architecture or "wavenet" in architecture):
            raise NotImplementedError(f"Architecture '{architecture}' is not ported yet")
        if spectrogram_channels > 1 and architecture != "speccnn8l1_bn":
            raise ValueError(f"multi-channel input requires 'speccnn8l1_bn' (got "
                             f"'{architecture}'; encoder.py:199-203)")
        self.dim_z, self.fc_dropout, self.channels = dim_z, fc_dropout, spectrogram_channels
        specs = encoder_conv_specs(architecture)
        mixers = []
        if architecture == "speccnn8l1_bn":
            multi_ch = spectrogram_channels > 1
            specs = specs[: len(specs) - (1 if deepest_features_mix else 2)]
            if not deepest_features_mix:  # 4x4 mixing conv then 1x1 (encoder.py:59-70)
                n_4x4 = 1800 if force_bigger_network else (768 if multi_ch else 512)
                mixers.append(("mix7", _c(n_4x4, 4, 2, 2)))
            mixers.append(("mix8", _c(1024 if multi_ch else 2048, 1, 1, 0, bn=None)))  # :46
        self.single_ch_cnn = SpectrogramCNN(specs)
        in_ch = self.single_ch_cnn.out_ch * spectrogram_channels
        self.mixers = []
        for name, s in mixers:
            setattr(self, name, Conv2DBlock(in_ch, s.out_ch, s.kernel, s.stride, s.pad,
                                            s.dilation, s.act, s.bn))
            self.mixers.append(name)
            in_ch = s.out_ch
        h, w = _out_hw(specs + [s for _, s in mixers], input_hw)
        self.mlp_out = nn.Linear(in_ch * h * w, 2 * dim_z)
        self.output_bn = output_bn
        if output_bn:  # flow-input regularizer (encoder.py:209-213)
            self.lat_in_regularization = BatchNorm(2 * dim_z)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        B = x.shape[0]
        if self.channels == 1:
            h = self.single_ch_cnn(x)
        else:  # the shared CNN once per channel (encoder.py:168-172)
            h = torch.cat([self.single_ch_cnn(x[:, c:c + 1]) for c in range(self.channels)],
                          dim=1)
        for name in self.mixers:
            h = getattr(self, name)(h)
        h = h.permute(0, 2, 3, 1).reshape(B, -1)  # flax's NHWC flatten order
        h = dropout(widen(h), self.fc_dropout, self.training, generator)
        h = f32_linear(self.mlp_out, h)
        if self.output_bn:
            h = self.lat_in_regularization(h)
        return h.reshape(B, 2, self.dim_z)
