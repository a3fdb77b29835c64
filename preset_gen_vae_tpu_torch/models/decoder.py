"""Spectrogram decoder: FC from z to a (2048, 3, 4) map, a 1x1 un-mixer,
then a transposed-conv stack ending in a Hardtanh-bounded spectrogram.

Counterpart: ``preset_gen_vae_tpu/models/decoder.py`` (reference:
model/decoder.py:9-274). ``decoder_tconv_specs`` is copied from
decoder.py:49-133; the per-layer output paddings land the speccnn8l1
family exactly on 257x347. The FC output is reshaped in flax's NHWC order
(decoder.py:190) and then moved to NCHW, so the ``mlp`` kernel transplants
unchanged. Output is ``(B, C, H, W)``: ``unmix1`` gives C x 512 (1800
when ``force_bigger_network``) channels and the shared ``single_ch_cnn``
runs once per channel split (decoder.py:195-208), each call with its own
train-mode batch statistics, as the encoder does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.tconv_out import conv_transpose_out, takes_geometry
from .layers import TConv2DBlock, _pair, dropout, f32_linear, widen


@dataclasses.dataclass(frozen=True)
class TConvSpec:
    out_ch: int
    kernel: Tuple[int, int]
    stride: Tuple[int, int]
    pad: Tuple[int, int]
    out_pad: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    bn: Optional[str] = "after"
    act: str = "lrelu"


def _t(out_ch, k, s, p, op=(0, 0), d=(1, 1), bn="after", act="lrelu"):
    to2 = lambda v: (v, v) if isinstance(v, int) else tuple(v)
    return TConvSpec(out_ch, to2(k), to2(s), to2(p), to2(op), to2(d), bn, act)


def decoder_tconv_specs(architecture: str, force_bigger_network: bool = False):
    """Transposed-conv stack tables (reference: model/decoder.py:108-268).
    The final spec row is the plain (no BN / no mid-activation) output conv;
    Hardtanh is applied by the caller."""
    if architecture in ("speccnn8l1", "speccnn8l1_bn"):
        return [
            _t(256, 4, 2, 2, (1, 1)),
            _t(128, 4, 2, 2, (1, 0)),
            _t(64, 4, 2, 2, (1, 1)),
            _t(32, 4, 2, 2, (1, 1)),
            _t(16, 4, 2, 2, (1, 0)),
            _t(8, 4, 2, 2, (1, 0)),
            _t(1, 5, 2, 2, bn=None, act="none"),
        ]
    if architecture == "speccnn8l1_2":
        return [
            _t(512, 1, 1, 0),
            _t(256, 4, 2, 2, (1, 1)),
            _t(256, 4, 2, 2, (1, 0)),
            _t(128, 4, 2, 2, (1, 1)),
            _t(128, 4, 2, 2, (1, 1)),
            _t(64, 4, 2, 2, (1, 0)),
            _t(32, 4, 2, 2, (1, 0)),
            _t(1, 5, 2, 2, bn=None, act="none"),
        ]
    if architecture == "speccnn8l1_3":
        return [
            _t(512, 1, 1, 0),
            _t(256, 5, 2, 2, (0, 1)),
            _t(128, 5, 2, 2, (0, 0)),
            _t(64, 5, 2, 2, (0, 1)),
            _t(32, 5, 2, 2, (0, 1)),
            _t(16, 5, 2, 2, (0, 0)),
            _t(8, 5, 2, 2, (0, 1)),
            _t(1, 5, 2, 2, bn=None, act="none"),
        ]
    if architecture == "wavenet_baseline":
        return [
            _t(512, 1, 1, 0),
            _t(512, 4, (2, 1), 2, (1, 0)),
            _t(256, 4, 2, 2, (1, 1)),
            _t(256, 4, 2, 2, (1, 0)),
            _t(256, 4, 2, 2, (1, 1)),
            _t(128, 4, 2, 2, (1, 0)),
            _t(128, 4, 2, 2, (1, 1)),
            _t(128, 4, 2, 2, (1, 1)),
            _t(128, 5, 2, 2, (0, 0)),
            _t(1, 5, 2, 2, bn=None, act="none"),
        ]
    if architecture == "wavenet_baseline_lighter":
        return [
            _t(512, 1, 1, 0),
            _t(512, 4, (2, 1), 2, (1, 0)),
            _t(256, 4, 2, 2, (1, 1)),
            _t(256, 4, 2, 2, (1, 0)),
            _t(256, 4, 2, 2, (1, 1)),
            _t(128, 4, 2, 2, (1, 0)),
            _t(64, 4, 2, 2, (1, 1)),
            _t(32, 4, 2, 2, (1, 1)),
            _t(16, 5, 2, 2, (0, 0)),
            _t(1, 5, 2, 2, bn=None, act="none"),
        ]
    if architecture == "wavenet_baseline_shallow":
        return [
            _t(512, 1, 1, 0),
            _t(256, 4, 2, 2, (1, 0)),
            _t(128, 4, 2, 2, (1, 1)),
            _t(64, 4, 2, 2, (1, 0)),
            _t(32, 4, 2, 2, (1, 1)),
            _t(16, 4, 2, 2, (1, 1)),
            _t(8, 4, 2, 2, (1, 1)),
            _t(1, 5, 2, 2, bn=None, act="none"),
        ]
    if architecture == "flow_synth":
        n = 64
        return [
            _t(n, 7, 2, 3, 0, (2, 2), act="elu"),
            _t(n, 7, 2, 3, (1, 0), (2, 2), act="elu"),
            _t(n, 7, 2, 3, (0, 1), (2, 2), act="elu"),
            _t(n, 7, 2, 3, (1, 0), (2, 2), act="elu"),
            _t(1, 7, 2, 2, bn=None, act="none"),
        ]
    raise NotImplementedError(f"Architecture '{architecture}' not available")


class DecoderCNN(nn.Module):
    """Transposed-conv stack, blocks named ``dec1..decN``; the last one is a
    bare transposed conv (counterpart: decoder.py:134-162). A bare one with
    the geometry of ``ops/tconv_out.py`` (one output channel, 5x5, stride 2,
    padding 2: every speccnn8l1 decoder's) runs through that op with its own
    weight and bias: the hand-written kernel on the card, the module's own
    function on the CPU."""

    def __init__(self, specs, in_ch: int):
        super().__init__()
        self.names = []
        for i, s in enumerate(specs):
            name = f"dec{i + 1}"
            if s.act == "none":
                block = nn.ConvTranspose2d(in_ch, s.out_ch, s.kernel, s.stride, s.pad,
                                           s.out_pad, dilation=_pair(s.dilation))
            else:
                block = TConv2DBlock(in_ch, s.out_ch, s.kernel, s.stride, s.pad, s.out_pad,
                                     s.dilation, s.act, s.bn)
            setattr(self, name, block)
            self.names.append(name)
            in_ch = s.out_ch

    def forward(self, x):
        for name in self.names:
            block = getattr(self, name)
            if isinstance(block, nn.ConvTranspose2d) and takes_geometry(block):
                x = conv_transpose_out(x, block.weight, block.bias)  # the kernel on the card
            else:
                x = block(x)
        return torch.clamp(widen(x), -1.0, 1.0)  # Hardtanh (decoder.py:160-161)


class SpectrogramDecoder(nn.Module):
    """z -> (B, C, 257, 347) spectrograms (counterpart: decoder.py:165-208)."""

    def __init__(self, architecture: str, dim_z: int, output_size=(257, 347),
                 spectrogram_channels: int = 1, fc_dropout: float = 0.3,
                 force_bigger_network: bool = False):
        super().__init__()
        if "speccnn8l1" not in architecture:
            raise NotImplementedError(
                "Full decoder supports the speccnn8l1 family only (reference: decoder.py:35-37)")
        if tuple(output_size) != (257, 347):
            raise ValueError("speccnn8l1 decoders target 257x347")
        self.fc_dropout, self.channels = fc_dropout, spectrogram_channels
        self.cnn_in = (3, 3) if architecture == "speccnn8l1_3" else (3, 4)
        self.last_4x4_ch = 1800 if force_bigger_network else 512
        self.mlp = nn.Linear(dim_z, 2048 * self.cnn_in[0] * self.cnn_in[1])
        self.unmix1 = TConv2DBlock(2048, spectrogram_channels * self.last_4x4_ch,
                                   (1, 1))  # decoder.py:72-75
        self.single_ch_cnn = DecoderCNN(
            decoder_tconv_specs(architecture, force_bigger_network), self.last_4x4_ch)

    def forward(self, z, generator: Optional[torch.Generator] = None):
        h = dropout(f32_linear(self.mlp, z), self.fc_dropout, self.training, generator)
        h = h.reshape(-1, self.cnn_in[0], self.cnn_in[1], 2048).permute(0, 3, 1, 2)
        h = self.unmix1(h)
        n = self.last_4x4_ch
        outs = [self.single_ch_cnn(h[:, c * n:(c + 1) * n]) for c in range(self.channels)]
        return outs[0] if self.channels == 1 else torch.cat(outs, dim=1)
