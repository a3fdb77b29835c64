"""The weights and the starting state that the benchmark makes from the seed,
and the reference model they fit.

The weights are drawn on the device by one ``torch.Generator`` in one call
over every kernel's entries, then scaled leaf by leaf: Dense and Conv
kernels a normal of std sqrt(1/fan_in) cut at two std (flax's lecun-normal
in spirit), biases 0, BatchNorm scales 1 and shifts 0, running means 0 and
variances 1. They are written as the checkpoint of an epoch of the run (0 unless
given) in the program's checkpoint format (``checkpoints/<epoch>/state.pt``
and ``meta.json`` beside the run's ``config.json``), with a fresh Adam
state, a step generator seeded from the same seed and a fresh plateau
scheduler, so that ``train_config(start_epoch=<epoch> + 1)`` and
``evaluate_model`` start from them, and the reference reads the same file."""

from __future__ import annotations

import json
import math
import pathlib
import shutil

import torch
from torch import nn

from .frozen import config as fcfg
from .frozen.models import build as fbuild
from .frozen.training import schedulers
from .frozen.training.train_step import make_optimizer

STEP_GENERATOR_SALT = 0x5EED  # the step generator's seed: the run's seed xor this


def reference_model(model_c, train_c, helper, device) -> nn.Module:
    """The frozen model, built on ``device`` without the frozen build function's
    host-side initialisation (its weights are overwritten anyway); the
    index tables that its layers make on the host follow it there."""
    saved = fbuild.init_like_flax
    fbuild.init_like_flax = lambda model, generator: model
    try:
        with torch.device(device):
            return fbuild.build_extended_ae_model(model_c, train_c, helper).to(device)
    finally:
        fbuild.init_like_flax = saved


def _fan_in(mod: nn.Module) -> int:
    w = mod.weight
    if isinstance(mod, nn.Linear):
        return w.shape[1]
    if isinstance(mod, nn.ConvTranspose2d):  # (in, out, kh, kw)
        return w.shape[0] * w.shape[2] * w.shape[3]
    return w.shape[1] * w.shape[2] * w.shape[3]


@torch.no_grad()
def seed_weights(model: nn.Module, seed: int) -> None:
    """Every weight of ``model`` from ``seed``, drawn on its device."""
    kernels = [m for m in model.modules() if isinstance(m, (nn.Linear, nn.Conv2d,
                                                            nn.ConvTranspose2d))]
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    flat = torch.randn(sum(m.weight.numel() for m in kernels), generator=gen, device=dev)
    flat.clamp_(-2.0, 2.0)
    i = 0
    for m in kernels:
        n = m.weight.numel()
        m.weight.copy_(flat[i:i + n].view_as(m.weight) * math.sqrt(1.0 / _fan_in(m)))
        i += n
        if m.bias is not None:
            m.bias.zero_()
    for name, t in model.named_parameters():
        if not any(t is m.weight or t is m.bias for m in kernels):
            # BatchNorm scales 1, shifts 0; any other free leaf 0
            t.fill_(1.0 if name.endswith("weight") else 0.0)
    for name, b in model.named_buffers():
        if name.endswith("running_var"):
            b.fill_(1.0)
        elif name.endswith("running_mean"):
            b.zero_()


def step_generator_state(seed: int, device) -> torch.Tensor:
    return torch.Generator(device=device).manual_seed(int(seed) ^ STEP_GENERATOR_SALT).get_state()


def write_start(run_dir: pathlib.Path, model_c, train_c, model: nn.Module, seed: int,
                device, epoch: int = 0) -> None:
    """Writes ``run_dir``'s ``config.json`` (the resolved configs, as the
    loop writes them) and its checkpoint of ``epoch`` from ``model``'s
    weights: a fresh Adam state, the step generator and the scheduler."""
    if run_dir.exists():
        shutil.rmtree(run_dir)
    d = run_dir / "checkpoints" / str(epoch)
    d.mkdir(parents=True)
    fcfg.save_config(run_dir / "config.json", model_c, train_c)
    optimizer = make_optimizer(model, train_c)
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(), "step": 0,
                "generator": step_generator_state(seed, device)}, d / "state.pt")
    plateau = schedulers.ReduceLROnPlateau(
        train_c.initial_learning_rate, factor=train_c.scheduler_lr_factor,
        patience=train_c.scheduler_patience, cooldown=train_c.scheduler_cooldown,
        threshold=train_c.scheduler_threshold)
    with open(d / "meta.json", "w") as f:
        json.dump({"epoch": epoch, "scheduler": plateau.state_dict()}, f)


def load_state(run_dir: pathlib.Path, epoch) -> dict:
    """The checkpoint of ``epoch`` (or of a renamed one) in ``run_dir`` on
    the CPU."""
    return torch.load(run_dir / "checkpoints" / str(epoch) / "state.pt", map_location="cpu",
                      weights_only=True)


def load_meta(run_dir: pathlib.Path, epoch) -> dict:
    """The checkpoint's ``meta.json``: its epoch and the plateau scheduler."""
    with open(run_dir / "checkpoints" / str(epoch) / "meta.json") as f:
        return json.load(f)
