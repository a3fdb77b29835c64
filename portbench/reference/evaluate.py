"""The reference's copy of an evaluation pass over the validation split, and
the numbers that hold the program's pass against it.

The reference runs the frozen model in eval mode in float32 (TF32 off) from
the benchmark's seeded checkpoint over the validation items, the program's
served rows as input (its own state; ``corpus.py`` checks them apart), and
scores its inferred presets with the frozen per-item criteria. For the
audio it takes the program's own latent ``zK`` of a sample of items drawn
from the seed (judged in turn by ``latent_gap``), turns it into presets
with the frozen regression head, renders them and their ground truth on
the host (``corpus.render``) and scores the pairs with the frozen
similarity measures.

Numbers, each the worst over its members:

- ``latent_gap``: max |program - reference| of ``z0`` and of ``zK`` over
  every item, over the reference's largest magnitude;
- ``param_metric_gap``: each per-item parameter metric's mean over the
  items, |program - reference| over |reference|;
- ``audio_error_gap``: on the sampled items, each audio metric, |program -
  reference| over the larger of the reference's and its median over the
  sample."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .corpus import render
from .frozen.data.pipeline import SplitLoader
from .frozen.evaluation.similarity import batched_audio_errors
from .frozen.losses.synth_params import CategoricalParamsAccuracy, QuantizedNumericalParamsLoss
from .frozen.synth import dexed_params as dx
from .presets import Corpus, feed
from .seeded import load_state, reference_model
from .train import full_float32

PARAM_METRICS = ("num_eval_loss", "num_mae", "num_mae_dyn", "acc", "acc_dyn")
AUDIO_METRICS = ("spec_mae", "spec_sc", "mfcc13_mae", "mfcc40_mae")


def _criteria(helper):
    dyn = dx.midi_key_related_param_indexes()
    return {"num_eval_loss": QuantizedNumericalParamsLoss(helper, loss="mse"),
            "num_mae": QuantizedNumericalParamsLoss(helper, loss="mae"),
            "num_mae_dyn": QuantizedNumericalParamsLoss(helper, loss="mae",
                                                        limited_vst_params_indexes=dyn),
            "acc": CategoricalParamsAccuracy(helper),
            "acc_dyn": CategoricalParamsAccuracy(helper, limited_vst_params_indexes=dyn)}


@torch.no_grad()
def inference(model_c, train_c, corpus: Corpus, x: torch.Tensor, run_dir, epoch: int, device,
              mode=None) -> Dict[str, np.ndarray]:
    """z0, zK, v_out and the per-item parameter metrics of the validation
    items, in the split's order, in float32 from checkpoint ``epoch``."""
    train_c = dataclasses.replace(train_c, compute_dtype="float32")
    model = reference_model(model_c, train_c, corpus.helper, device)
    model.load_state_dict(load_state(run_dir, epoch)["model"])
    model.eval()
    loader = SplitLoader({"x": x, **feed(corpus, device)}, corpus.splits["validation"],
                         train_c.minibatch_size, shuffle=False, drop_last=False, pad_to_full=True)
    crit = _criteria(corpus.helper)
    cols = {k: [] for k in ("z0", "zK", "v_out") + PARAM_METRICS}
    bs = loader.batch_size
    with full_float32(), (mode() if mode else torch.no_grad()):
        for i, sel in enumerate(loader.epoch_index_batches(0)):
            n_real = min(bs, loader.n_items - i * bs)
            xb, vb, ib = loader.gather(sel[:n_real])
            outs = model.forward_full(xb.float(), ib)
            cols["z0"].append(outs[0][:, 0, :].float())
            cols["zK"].append(outs[2].float())
            cols["v_out"].append(outs[5].float())
            for k, c in crit.items():
                cols[k].append(c.per_item(outs[5].float(), vb))
    del model
    return {k: torch.cat(c).cpu().numpy() for k, c in cols.items()}


@torch.no_grad()
def audio_errors(model_c, train_c, corpus: Corpus, zK: np.ndarray, rows: np.ndarray, run_dir,
                 epoch: int, device, bf16_audio: bool = False) -> Dict[str, np.ndarray]:
    """Per-item audio metrics of the validation items ``rows`` (positions in
    the split): the presets that the frozen head gives for ``zK`` against
    their ground truth, rendered on the host."""
    train_c = dataclasses.replace(train_c, compute_dtype="float32")
    model = reference_model(model_c, train_c, corpus.helper, device)
    model.load_state_dict(load_state(run_dir, epoch)["model"])
    model.eval()
    with full_float32():
        v_out = model.reg_model(torch.from_numpy(zK[rows]).to(device)).float().cpu().numpy()
    del model
    items = corpus.splits["validation"][rows]
    info = corpus.info[items]
    gt = corpus.presets[info[:, 0]]
    inferred = corpus.helper.learnable_to_full_batch(v_out)
    note_on, note_off = model_c.note_duration
    n = len(rows)
    both = render(np.concatenate([gt, inferred]), np.concatenate([info[:, 1], info[:, 1]]),
                  np.concatenate([info[:, 2], info[:, 2]]), float(note_on),
                  float(note_on + note_off), int(model_c.sampling_rate))
    if bf16_audio:
        both = both.to(torch.bfloat16).float()
    e = batched_audio_errors(both[:n], both[n:], model_c.stft_args[0],
                             model_c.stft_args[1], model_c.sampling_rate)
    return {k: e[k].cpu().numpy() for k in AUDIO_METRICS}


def sample_rows(n_items: int, seed: int, k: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed), 0xE7])
    return np.sort(rng.choice(n_items, size=min(k, n_items), replace=False))


def latent_readings(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    lat = max(float(np.abs(prog[k] - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-30))
              for k in ("z0", "zK"))
    par = max(abs(float(np.nanmean(prog[k])) - float(np.nanmean(ref[k])))
              / max(abs(float(np.nanmean(ref[k]))), 1e-30) for k in PARAM_METRICS)
    return {"latent_gap": lat, "param_metric_gap": par}


def audio_readings(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    worst = 0.0
    for k in AUDIO_METRICS:
        r = ref[k].astype(np.float64)
        scale = np.maximum(np.abs(r), np.median(np.abs(r)))
        worst = max(worst, float(np.max(np.abs(prog[k] - r) / np.maximum(scale, 1e-30))))
    return {"audio_error_gap": worst}
