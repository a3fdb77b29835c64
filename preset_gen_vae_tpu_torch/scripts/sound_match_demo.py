"""Sound matching by gradient descent through the synthesizer: start from a
detuned and muted corruption of a structured preset and recover the
target's spectrum by Adam on the continuous preset parameters, the
gradient taken through the FM render (on the card, F1 forward and F1b
backward, the unrolled audio pass in torch ops; a ``render_fn`` that
pins ``'exact'`` takes F2 and F2b as well). Counterpart of
``scripts/sound_match_demo.py``, with its constants.

    python -m preset_gen_vae_tpu_torch.scripts.sound_match_demo [--device cuda]

Prints one JSON line, the JAX demo's: ``demo``, ``steps``,
``initial_spectral_mse``, ``final_spectral_mse``, ``reduction``,
``wall_s``. The learning-rate schedule is ``optax.cosine_decay_schedule``
written as a ``LambdaLR`` factor; the gradient is masked before each Adam
step and the update after it, as the JAX demo does.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from ..device import resolve_device
from ..synth import fm_torch
from ..synth.database import generate_structured_corpus

SR = 22050
NOTE_ON, TOTAL = 1.0, 1.5
STEPS = 400
SCALES = ((1024, 256), (256, 64))
LR, LR_ALPHA = 2e-2, 0.02
TARGET_SEED, PITCH, VELOCITY = 33, 60, 95


def _mag(w, n_fft: int, hop: int):
    """log1p |rFFT| of the Hann-windowed frames starting at 0, hop, ... below
    N - n_fft (the JAX demo's framing), numpy's symmetric window."""
    n_frames = len(range(0, w.shape[1] - n_fft, hop))
    frames = w.unfold(1, n_fft, hop)[:, :n_frames]
    win = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(w.device)
    return torch.log1p(torch.abs(torch.fft.rfft(frames * win, dim=-1)))


def spec_loss(w, targets):
    """Multi-resolution log-magnitude loss: the coarse scale gives smooth
    gradients when partials are misaligned, the fine scale sharpens the fit."""
    return sum(torch.mean(torch.square(_mag(w, n, h) - t)) for (n, h), t in zip(SCALES, targets))


def lr_factor(k: int) -> float:
    """optax.cosine_decay_schedule(LR, STEPS, alpha=LR_ALPHA) / LR at step k."""
    return (1.0 - LR_ALPHA) * 0.5 * (1.0 + math.cos(math.pi * min(k, STEPS) / STEPS)) + LR_ALPHA


def render(p, render_fn=fm_torch.render_batch):
    return render_fn(p, [PITCH], [VELOCITY], note_on_s=NOTE_ON, total_s=TOTAL, sample_rate=SR,
                     feedback="unrolled", fb_iters=3)


def problem(dev, render_fn=fm_torch.render_batch):
    """-> (the corrupted preset (1, 155), the mask of the optimized columns,
    the target's spectra at each scale), on ``dev``."""
    p_target, _, _ = generate_structured_corpus(1, seed=TARGET_SEED)
    with torch.no_grad():
        wav = render(torch.from_numpy(p_target).to(dev), render_fn)
        targets = [_mag(wav, n, h) for n, h in SCALES]
    # corrupt the timbre: mute/bend output levels and EG level shapes
    p = p_target.copy()
    mask = np.zeros((1, p.shape[1]), dtype=np.float32)
    for op in range(6):
        b = 23 + 22 * op
        p[:, b + 8] *= 0.5  # output level
        p[:, b + 4:b + 8] *= 0.6  # EG levels
        mask[:, b + 4:b + 9] = 1.0  # optimize exactly these
    return torch.from_numpy(p).to(dev), torch.from_numpy(mask).to(dev), targets


def fit(p0, mask, targets, steps: int, render_fn=fm_torch.render_batch):
    """``steps`` Adam steps from ``p0`` -> (preset, the loss before each
    step, the learning rate of each step)."""
    p = p0.clone().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=LR, eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lr_factor)
    losses, lrs = [], []
    for _ in range(steps):
        opt.zero_grad()
        loss = spec_loss(render(p, render_fn), targets)
        loss.backward()
        lrs.append(opt.param_groups[0]["lr"])
        with torch.no_grad():
            p.grad.mul_(mask)
            before = p.detach().clone()
            opt.step()
            p.copy_(torch.where(mask > 0, p, before))
        sched.step()
        losses.append(loss.detach())
    return p.detach(), torch.stack(losses).tolist(), lrs


def main(argv=None, render_fn=fm_torch.render_batch) -> dict:
    """``render_fn`` takes ``render_batch``'s arguments (a caller may pin
    another feedback mode)."""
    ap = argparse.ArgumentParser(description="Fit a preset to a target sound through the synth")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    p, mask, targets = problem(dev, render_fn)
    with torch.no_grad():
        l0 = float(spec_loss(render(p, render_fn), targets))
    t0 = time.time()
    _, losses, _ = fit(p, mask, targets, STEPS, render_fn)
    l1 = losses[-1]
    summary = {
        "demo": "sound_match_through_synth",
        "steps": STEPS,
        "initial_spectral_mse": round(l0, 5),
        "final_spectral_mse": round(l1, 5),
        "reduction": round(l0 / max(l1, 1e-9), 1),
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(summary), flush=True)
    return dict(summary, losses=losses)


if __name__ == "__main__":
    main()
