"""The controls: the reference computed in the precision below the one the
configuration states, which a later change could be tempted to take.

- ``fp8_products``: for a configuration in bfloat16, every convolution and
  matrix product (forward and backward) takes its operands rounded to
  float8 (e4m3 with a per-tensor scale to its largest magnitude, e5m2 for
  the gradients that flow back), and accumulates in float32: fp8 training
  as tensor cores would run it.
- ``bf16_audio``: for the corpus, whose render and log-mel are float32,
  the rendered waveforms rounded to bfloat16 before the log-mel.

``half_batch`` is one of the faults a training cell can have, planted in
the reference put in the program's place: each step's losses are the
means over the first half of the batch only."""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    if not (torch.is_tensor(t) and t.is_floating_point()):
        return t
    scale = t.detach().abs().amax().clamp(min=1e-30) / top
    return ((t / scale).to(dtype).to(t.dtype)) * scale


class Fp8Products(TorchDispatchMode):
    """Rounds the operands of every convolution and matrix product to
    float8 (see the module docstring)."""

    FORWARD = {aten.convolution.default: (0, 1), aten.mm.default: (0, 1),
               aten.addmm.default: (1, 2), aten.bmm.default: (0, 1)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        args = list(args)
        if func in self.FORWARD:
            for i in self.FORWARD[func]:
                args[i] = _round8(args[i], torch.float8_e4m3fn, E4M3_MAX)
        elif func is aten.convolution_backward.default:
            args[0] = _round8(args[0], torch.float8_e5m2, E5M2_MAX)  # the gradient
            args[1] = _round8(args[1], torch.float8_e4m3fn, E4M3_MAX)
            args[2] = _round8(args[2], torch.float8_e4m3fn, E4M3_MAX)
        return func(*args, **kwargs)


def fp8_products():
    return Fp8Products()


@contextlib.contextmanager
def half_batch():
    """Inside the block each frozen train step sees the first half of its
    batch only (the fault "half of the batch left out, the mean taken over
    the rest")."""
    from .frozen.training import train_step as fstep

    saved = fstep.train_step

    def train_step(model, optimizer, criteria, train_config, x_in, v_in, sample_info, beta,
                   generator=None, **kwargs):
        half = x_in.shape[0] // 2
        return saved(model, optimizer, criteria, train_config, x_in[:half], v_in[:half],
                     sample_info[:half], beta, generator, **kwargs)

    fstep.train_step = train_step
    try:
        yield
    finally:
        fstep.train_step = saved
