"""The reference's copy of one training epoch, and the numbers that hold the
program's epoch against it.

The program's state is seen only where ``train_config`` leaves it: the
checkpoints it writes and the last epoch's means in its summary. So the
reference follows a whole epoch, not three steps: from a checkpoint, the
frozen train step in the configuration's precision (``compute_dtype``:
bf16 autocast over float32 weights on the card, as the configuration
states; what autocast leaves in float32 with TF32 off) on the same batches
in the same order, with a step generator in the same state (so the same
dropout masks and VAE noise), the same learning rate and beta, then the
frozen eval step over the validation split. The batches' spectrograms are
the program's served corpus rows (its own state; the reference checks them
apart, ``corpus.py``); the targets and items are the reference's own
(``presets.py``).

Numbers:

- ``train_loss_gap``: the epoch's mean of the step's loss (``TotalLoss``,
  what the optimizer minimises), |program - reference| over |reference|;
  beside it each monitored loss's own gap (``train_gap.<loss>``);
- ``valid_loss_gap``: the worst of the validation losses' gaps after the
  epoch;
- ``param_change_gap``: per parameter leaf, | ||w1 - w0||_program -
  ||w1 - w0||_reference | over the larger of the reference's and the
  median leaf's, the worst leaf (``_median`` and ``_p90`` beside it);
- ``grad_rms_gap``: per leaf, the same of ||sqrt(exp_avg_sq)||, Adam's
  running mean square of the gradient as the optimizer got it, the worst
  leaf.

The leaves' numbers leave out the leaves whose reference
||sqrt(exp_avg_sq)|| is under a thousandth of the median leaf's: a
gradient that is nought to rounding moves its leaf under Adam by round-off
alone. PERF.md says which of these a cell compares, and why."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .frozen.data.pipeline import SplitLoader
from .frozen.training import train_step as fstep
from .frozen.utils.hparams import LinearDynamicParam
from .presets import Corpus, feed
from .seeded import load_meta, load_state, reference_model

LOSSES = ("TotalLoss", "ReconsLoss/Backprop", "LatLoss", "Controls/BackpropLoss")
VALID_LOSSES = ("ReconsLoss/Backprop", "LatLoss", "Controls/BackpropLoss")
TINY_GRAD = 1e-3  # leaves under this share of the median leaf's gradient are left out


@contextlib.contextmanager
def full_float32():
    """TF32 off for matmuls and convolutions inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def epoch_lr_beta(train_c, epoch: int, plateau_lr: float):
    """The learning rate and beta of ``epoch`` in a run resumed at it, as
    the loop's ``EpochSchedule`` gives them: the warm-up's, else the
    plateau scheduler's ``plateau_lr`` from the checkpoint."""
    lr = plateau_lr
    if epoch <= train_c.lr_warmup_epochs:
        lr = LinearDynamicParam(train_c.lr_warmup_start_factor, 1.0,
                                end_epoch=train_c.lr_warmup_epochs,
                                current_epoch=epoch).get(epoch) * train_c.initial_learning_rate
    beta = LinearDynamicParam(train_c.beta_start_value, train_c.beta,
                              end_epoch=train_c.beta_warmup_epochs, current_epoch=epoch).get(epoch)
    return float(lr), float(beta)


@dataclasses.dataclass
class EpochResult:
    train: Dict[str, float]
    valid: Dict[str, float]
    model: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]  # by parameter name, where Adam holds state
    param_names: list  # every parameter's name, in the optimizer's order
    flops_per_step: Optional[float]


def follow_epoch(model_c, train_c, corpus: Corpus, x: torch.Tensor, run_dir, epoch: int,
                 device, mode=None, count_flops: bool = False) -> EpochResult:
    """Epoch ``epoch`` from ``run_dir``'s checkpoint ``epoch - 1``, in the
    configuration's precision, on the items of ``x`` (the served corpus,
    any dtype).
    ``mode``, a context manager factory, wraps every step (the controls of
    ``lowp.py``); ``count_flops`` counts the first step's forward and
    backward with ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    start = load_state(run_dir, epoch - 1)
    model = reference_model(model_c, train_c, corpus.helper, device)
    model.load_state_dict(start["model"])
    optimizer = fstep.make_optimizer(model, train_c)
    fstep.load_optimizer_state(optimizer, start["optimizer"])
    generator = torch.Generator(device=device)
    generator.set_state(start["generator"])
    lr, beta = epoch_lr_beta(train_c, epoch, load_meta(run_dir, epoch - 1)["scheduler"]["lr"])
    fstep.set_learning_rate(optimizer, lr)
    beta_t = torch.tensor(beta, device=device)
    criteria = fstep.Criteria(model_c, train_c, corpus.helper)
    tensors = {"x": x, **feed(corpus, device)}
    batch = train_c.minibatch_size
    train = SplitLoader(tensors, corpus.splits["train"], batch, shuffle=True, drop_last=True,
                        seed=train_c.seed)
    valid = SplitLoader(tensors, corpus.splits["validation"], batch, shuffle=False,
                        drop_last=False, pad_to_full=True)
    rows, flops = [], None
    with full_float32(), (mode() if mode else contextlib.nullcontext()):
        for i, sel in enumerate(train.epoch_index_batches(epoch)):
            xb, vb, ib = train.gather(sel)
            counter = FlopCounterMode(display=False) if count_flops and i == 0 else None
            with counter if counter is not None else contextlib.nullcontext():
                m = fstep.train_step(model, optimizer, criteria, train_c, xb.float(), vb, ib,
                                     beta_t, generator)
            if counter is not None:
                flops = float(counter.get_total_flops())
            rows.append(torch.stack([m[k] for k in LOSSES]))
        train_means = torch.stack(rows).double().mean(0).cpu().numpy()
        vals, weights = [], []
        for i, sel in enumerate(valid.epoch_index_batches(epoch)):
            xb, vb, ib = valid.gather(sel)
            m = fstep.eval_step(model, criteria, train_c, xb.float(), vb, ib)
            vals.append(torch.stack([m[k] for k in VALID_LOSSES]))
            weights.append(valid.batch_weight(i))
        vals = torch.stack(vals).double().cpu().numpy()
        w = np.asarray(weights)[:, None]
        valid_means = (vals * w).sum(0) / w.sum()
    names = [n for n, _ in model.named_parameters()]
    state = optimizer.state_dict()["state"]
    exp_avg_sq = {n: state[i]["exp_avg_sq"].detach().cpu() for i, n in enumerate(names)
                  if i in state}
    return EpochResult(train=dict(zip(LOSSES, map(float, train_means))),
                       valid=dict(zip(VALID_LOSSES, map(float, valid_means))),
                       model={k: v.detach().cpu() for k, v in model.state_dict().items()},
                       exp_avg_sq=exp_avg_sq, param_names=names, flops_per_step=flops)


def _rel(a: float, b: float) -> float:
    """|a - b| / |b|, 0 where both are NaN (the reference's own 0/0 of a
    latent loss on a vanishing variance), inf where one alone is."""
    if np.isnan(a) and np.isnan(b):
        return 0.0
    if not (np.isfinite(a) and np.isfinite(b)):
        return float("inf")
    return abs(a - b) / max(abs(b), 1e-30)


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    """Per leaf of ``keep``: |prog - ref| over the larger of ref and the
    median leaf's ref."""
    keep = [k for k in keep if k in ref and k in prog]
    med = float(np.median([ref[k] for k in keep])) if keep else 0.0
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def epoch_readings(start: Dict, prog_state: Dict, prog_summary: Optional[Dict],
                   ref: EpochResult) -> Dict[str, float]:
    """The numbers of the module docstring, and beside them what explains
    them: each loss's own gap, the median and the 90th percentile of the
    leaves' gaps, and the worst leaf. ``start`` is the state of the
    checkpoint that the epoch began from, ``prog_state`` the program's checkpoint after the
    epoch and ``prog_summary`` the summary of the call that trained it, or
    None where that call trained later epochs too (no loss is read)."""
    names = list(ref.exp_avg_sq)
    prog_opt = prog_state["optimizer"]["state"]
    prog_sq = {n: prog_opt[i]["exp_avg_sq"] for i, n in enumerate(ref.param_names)
               if i in prog_opt}
    g_ref = {n: float(t.sqrt().norm()) for n, t in ref.exp_avg_sq.items()}
    g_prog = {n: float(t.float().sqrt().norm()) for n, t in prog_sq.items()}
    # a leaf that the reference moves and the program leaves without state
    # reads as unmoved: its gradient and change read 0 on the program's side
    g_prog.update({n: 0.0 for n in names if n not in g_prog})
    med = float(np.median(list(g_ref.values())))
    keep = [n for n in names if g_ref[n] >= TINY_GRAD * med]
    w0 = start["model"]
    d_ref = {n: float((ref.model[n] - w0[n]).norm()) for n in keep}
    d_prog = {n: float((prog_state["model"][n].float() - w0[n]).norm()) for n in keep}
    out = {}
    if prog_summary is not None:
        for k in LOSSES:
            out[f"train_gap.{k}"] = _rel(prog_summary[f"{k}/Train"], ref.train[k])
        for k in VALID_LOSSES:
            out[f"valid_gap.{k}"] = _rel(prog_summary[f"{k}/Valid"], ref.valid[k])
        out["train_loss_gap"] = out["train_gap.TotalLoss"]
        out["valid_loss_gap"] = max(out[f"valid_gap.{k}"] for k in VALID_LOSSES)
    for name, prog, refs in (("param_change", d_prog, d_ref), ("grad_rms", g_prog, g_ref)):
        gaps = _leaf_gaps(prog, refs, keep)
        values = np.asarray(list(gaps.values())) if gaps else np.asarray([np.inf])
        out[f"{name}_gap"] = float(values.max())
        out[f"{name}_gap_median"] = float(np.median(values))
        out[f"{name}_gap_p90"] = float(np.quantile(values, 0.9))
        out[f"{name}_worst_leaf"] = max(gaps, key=gaps.get) if gaps else ""
    out["leaves_compared"] = float(len(keep))
    out["leaves_left_out"] = float(len(names) - len(keep))
    return out
