"""Training entry point: build the dataset and the model, train for
``n_epochs`` epochs at a fixed learning rate, validate after each epoch.

Counterpart: ``preset_gen_vae_tpu/training/loop.py:60-897`` (reference:
train.py:37-342), first slice: the beta warm-up is kept; LR warm-up,
ReduceLROnPlateau, early stop, NaN retry, checkpoints and TensorBoard wait
for a later slice. Validation means weight the padded last batch by its
real rows (loop.py:787-795 there).

    from preset_gen_vae_tpu_torch.training.loop import train_config
    summary = train_config(ModelConfig(), TrainConfig(n_epochs=1))  # on the card
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import config as cfg
from ..data.dexed_dataset import DexedDataset, model_config_to_dataset_kwargs
from ..data.pipeline import get_split_loaders
from ..device import resolve_device
from ..models.build import build_extended_ae_model
from .train_step import SCALARS, Criteria, eval_step, make_optimizer, train_step


def beta_at(train_c: cfg.TrainConfig, epoch: int) -> float:
    """Linear beta warm-up from ``beta_start_value`` to ``beta`` over
    ``beta_warmup_epochs`` (utils/hparams.py:4-31 there)."""
    if epoch >= train_c.beta_warmup_epochs:
        return train_c.beta
    if epoch <= 0:
        return train_c.beta_start_value
    return train_c.beta_start_value + (train_c.beta - train_c.beta_start_value) * (
        epoch / train_c.beta_warmup_epochs)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_config(model_config: Optional[cfg.ModelConfig] = None,
                 train_config: Optional[cfg.TrainConfig] = None,
                 dataset: Optional[DexedDataset] = None, device="cuda",
                 dataset_kwargs: Optional[Dict] = None) -> Dict:
    """Trains one run; returns a summary dict of metrics and timings.
    ``device`` defaults to the card and raises if there is none."""
    dev = resolve_device(device)
    model_c, train_c = cfg.resolve(model_config or cfg.ModelConfig(),
                                   train_config or cfg.TrainConfig())
    if dev.type == "cuda" and train_c.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False  # float32 convolutions in full f32
    bf16 = dev.type == "cuda" and train_c.compute_dtype == "bfloat16"
    if dataset is None:
        kwargs = model_config_to_dataset_kwargs(model_c)
        kwargs.update(device=dev, corpus_dtype=torch.bfloat16 if bf16 else torch.float32,
                      **(dataset_kwargs or {}))
        dataset = DexedDataset(**kwargs)
    model_c, train_c = cfg.resolve_with_dataset(model_c, train_c, dataset)
    size = dataset.get_spectrogram_tensor_size()
    model_c = dataclasses.replace(
        model_c, input_tensor_size=(train_c.minibatch_size, 1, *size[1:]),
        spectrogram_size=size[1:])
    loaders = get_split_loaders(dataset, train_c)
    helper = dataset.preset_indexes_helper

    model = build_extended_ae_model(model_c, train_c, helper, seed=train_c.seed).to(dev)
    optimizer = make_optimizer(model, train_c)
    criteria = Criteria(model_c, train_c, helper)
    generator = torch.Generator(device=dev).manual_seed(train_c.seed)

    step_s, train_rows, valid = [], [], {}
    for epoch in range(train_c.start_epoch, train_c.n_epochs):
        beta = beta_at(train_c, epoch)
        rows = []
        for sel in loaders["train"].epoch_index_batches(epoch):
            x, v, info = loaders["train"].gather(sel)
            t0 = time.perf_counter()
            rows.append(train_step(model, optimizer, criteria, train_c, x, v, info, beta,
                                   generator))
            _sync(dev)
            step_s.append(time.perf_counter() - t0)
        if not rows:
            raise ValueError("train split smaller than one (drop_last) minibatch")
        train_rows = [{k: float(t) for k, t in m.items()} for m in rows]
        val, weights = [], []
        for i, sel in enumerate(loaders["validation"].epoch_index_batches(epoch)):
            x, v, info = loaders["validation"].gather(sel)
            val.append(torch.stack([eval_step(model, criteria, train_c, x, v, info)[k]
                                    for k in SCALARS]))
            weights.append(loaders["validation"].batch_weight(i))
        w = np.asarray(weights)
        means = torch.stack(val).cpu().numpy().T @ w / w.sum()
        valid = dict(zip(SCALARS, means.tolist()))

    # the first step includes cuDNN's algorithm search: steady steps after it
    steady = step_s[1:] or step_s
    summary = {
        "epochs_trained": train_c.n_epochs - train_c.start_epoch,
        "train_steps": len(step_s),
        "device": str(dev),
        "dim_z": model_c.dim_z,
        "input_size": list(model_c.input_tensor_size),
        "n_params": sum(p.numel() for p in model.parameters()),
        "corpus_presets": dataset.valid_presets_count,
        "corpus_seconds": dataset.corpus_seconds,
        "corpus_render_seconds": dataset.render_seconds,
        "first_step_ms": step_s[0] * 1e3,
        "step_ms": float(np.mean(steady)) * 1e3,
        "spectrograms_per_s": train_c.minibatch_size / float(np.mean(steady)),
    }
    for k in SCALARS + ("TotalLoss",):
        summary[f"{k}/Train"] = float(np.mean([r[k] for r in train_rows]))
    for k in SCALARS:
        summary[f"{k}/Valid"] = valid[k]
    return summary
