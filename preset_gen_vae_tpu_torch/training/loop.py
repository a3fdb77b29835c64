"""Training entry point: one run from the configs to its checkpoints.

Counterpart: ``preset_gen_vae_tpu/training/loop.py:60-897`` (reference:
train.py:37-342), with its epoch semantics:

- resume: with ``start_epoch > 0`` the configs are checked against the
  run's frozen ``config.json`` and checkpoint ``start_epoch - 1`` restores
  the model, the optimizer, the step count, the generator and the plateau
  scheduler (loop.py:103-147 there);
- LR warm-up for the first ``lr_warmup_epochs`` epochs, then
  ReduceLROnPlateau on the summed ``scheduler_loss`` validation scalars,
  and early stop once the LR falls under ``early_stop_lr_threshold``
  (loop.py:471-478, 814-822); beta warm-up (loop.py:442-446, 478);
- one host fetch per epoch of the stacked train scalars, checked for
  NaN/inf (``ModelConvergenceError``, loop.py:517-528);
- validation means weighted by each padded batch's real rows, and the
  Spearman entanglement ``LatCorr/Valid`` of the real rows' latents
  (loop.py:739-810);
- TensorBoard scalars and hparams metrics when ``use_tensorboard`` (the
  figures wait for a later slice), checkpoints at each ``save_period``
  (epoch > 0), at the last epoch and on early stop (loop.py:869-875).

The JAX-only dispatch machinery (meshes, multi-host, K-step scans) has no
counterpart here. The step profiler (``profiler_args['enabled']``, which
traces 5 steps in the JAX loop, loop.py:459-487 there) is not ported yet:
asking for it raises ``NotImplementedError``.

    from preset_gen_vae_tpu_torch.training.loop import train_config
    summary = train_config(ModelConfig(), TrainConfig(n_epochs=1))  # on the card
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import config as cfg
from ..data.dexed_dataset import DexedDataset, model_config_to_dataset_kwargs
from ..data.pipeline import get_split_loaders
from ..device import resolve_device
from ..logs.logger import RunLogger, get_run_dir, load_checkpoint
from ..logs.metrics import BufferedMetric, EpochMetric, LatentMetric, SimpleMetric
from ..models.build import build_extended_ae_model
from ..utils.exception import check_nan_values
from ..utils.hparams import LinearDynamicParam
from .schedulers import ReduceLROnPlateau
from .train_step import Criteria, eval_step, make_optimizer, train_step

# the losses whose NaN/inf stops a run (loop.py:524-528 there)
NAN_CHECKED = ("ReconsLoss/Backprop", "LatLoss", "FlowInputReg", "Controls/BackpropLoss")
# hparams metrics of TensorBoard: buffered validation scalars (loop.py:447-454)
TB_METRICS = ("ReconsLoss/MSE/Valid", "LatLoss/Valid", "LatCorr/Valid", "Controls/QLoss/Valid",
              "Controls/Accuracy/Valid")


class EpochSchedule:
    """The learning rate and beta of each epoch (loop.py:437-446, 471-478,
    814-822 there): a linear LR warm-up from ``lr_warmup_start_factor`` x
    the initial LR up to epoch ``lr_warmup_epochs``, then ReduceLROnPlateau
    on the validation losses; early stop under ``early_stop_lr_threshold``."""

    def __init__(self, train_c: cfg.TrainConfig):
        self.train_c = train_c
        self.plateau = ReduceLROnPlateau(
            train_c.initial_learning_rate, factor=train_c.scheduler_lr_factor,
            patience=train_c.scheduler_patience, cooldown=train_c.scheduler_cooldown,
            threshold=train_c.scheduler_threshold)
        self.lr_warmup = LinearDynamicParam(train_c.lr_warmup_start_factor, 1.0,
                                            end_epoch=train_c.lr_warmup_epochs,
                                            current_epoch=train_c.start_epoch)
        self.beta_warmup = LinearDynamicParam(train_c.beta_start_value, train_c.beta,
                                              end_epoch=train_c.beta_warmup_epochs,
                                              current_epoch=train_c.start_epoch)

    def epoch_start(self, epoch: int) -> Tuple[float, float]:
        """(lr, beta) to train ``epoch`` with."""
        tc = self.train_c
        if epoch <= tc.lr_warmup_epochs:
            self.plateau.lr = self.lr_warmup.get(epoch) * tc.initial_learning_rate
        return self.plateau.lr, float(self.beta_warmup.get(epoch))

    def epoch_end(self, epoch: int, valid: Dict[str, float]) -> Tuple[float, bool]:
        """(lr, early_stop) after ``epoch``'s validation; ``valid`` maps each
        ``scheduler_loss`` name to its validation mean."""
        tc = self.train_c
        if epoch > tc.lr_warmup_epochs:
            self.plateau.step(sum(valid[n] for n in tc.scheduler_loss))
        return self.plateau.lr, self.plateau.lr < tc.early_stop_lr_threshold


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def prepare_dataset(model_c: cfg.ModelConfig, train_c: cfg.TrainConfig, dev: torch.device,
                    dataset: Optional[DexedDataset] = None,
                    dataset_kwargs: Optional[Dict] = None):
    """Builds the dataset unless one is given (its corpus pass launches K1
    on the card) and resolves the configs against it
    (loop.py:73-85 there); -> (model_c, train_c, dataset)."""
    if dataset is None:
        bf16 = dev.type == "cuda" and train_c.compute_dtype == "bfloat16"
        kwargs = model_config_to_dataset_kwargs(model_c)
        kwargs.update(device=dev, corpus_dtype=torch.bfloat16 if bf16 else torch.float32,
                      **(dataset_kwargs or {}))
        dataset = DexedDataset(**kwargs)
    model_c, train_c = cfg.resolve_with_dataset(model_c, train_c, dataset)
    size = dataset.get_spectrogram_tensor_size()  # (C, H, W), C = stacked notes
    model_c = dataclasses.replace(
        model_c, input_tensor_size=(train_c.minibatch_size, *size), spectrogram_size=size[1:])
    return model_c, train_c, dataset


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_config(model_config: Optional[cfg.ModelConfig] = None,
                 train_config: Optional[cfg.TrainConfig] = None,
                 dataset: Optional[DexedDataset] = None, device="cuda",
                 dataset_kwargs: Optional[Dict] = None, use_tensorboard: bool = True) -> Dict:
    """Trains one run; returns a summary dict of metrics and timings.
    ``device`` defaults to the card and raises if there is none."""
    dev = resolve_device(device)
    model_c, train_c = cfg.resolve(model_config or cfg.ModelConfig(),
                                   train_config or cfg.TrainConfig())
    if train_c.start_epoch >= train_c.n_epochs:
        raise ValueError(f"start_epoch {train_c.start_epoch} >= n_epochs {train_c.n_epochs}")
    if train_c.profiler_args.get("enabled"):
        raise NotImplementedError("profiler_args['enabled']: the step profiler is not ported to "
                                  "the PyTorch package yet")
    if dev.type == "cuda" and train_c.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False  # float32 convolutions in full f32
    model_c, train_c, dataset = prepare_dataset(model_c, train_c, dev, dataset, dataset_kwargs)
    loaders = get_split_loaders(dataset, train_c)
    helper = dataset.preset_indexes_helper

    start_checkpoint = None
    if train_c.start_epoch > 0:  # resume (loop.py:103-112)
        with open(get_run_dir(model_c) / "config.json") as f:
            cfg.check_configs_on_resume_from_checkpoint(model_c, train_c, json.load(f))
        start_checkpoint = load_checkpoint(model_c, train_c.start_epoch - 1)
    logger = RunLogger(model_c, train_c, restart_from_checkpoint=start_checkpoint is not None,
                       use_tensorboard=use_tensorboard)

    t_build = time.perf_counter()
    model = build_extended_ae_model(model_c, train_c, helper, seed=train_c.seed).to(dev)
    _sync(dev)
    build_s = time.perf_counter() - t_build
    if train_c.verbosity >= 1:
        logger.init_with_model(model)
    optimizer = make_optimizer(model, train_c)
    criteria = Criteria(model_c, train_c, helper)
    generator = torch.Generator(device=dev).manual_seed(train_c.seed)
    schedule = EpochSchedule(train_c)
    step = 0
    if start_checkpoint is not None:  # (loop.py:136-147)
        state = start_checkpoint["state"]
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        step = int(state["step"])
        generator.set_state(state["generator"])
        schedule.plateau.load_state_dict(start_checkpoint["scheduler"])
    start_step = step

    scalars: Dict[str, object] = {f"{k}/{split}": EpochMetric()
                                  for k in criteria.scalars for split in ("Train", "Valid")}
    scalars["TotalLoss/Train"] = EpochMetric()
    scalars["LatCorr/Valid"] = LatentMetric(model_c.dim_z)
    scalars["Sched/LR"] = SimpleMetric(train_c.initial_learning_rate)
    metrics = {f"{k}_": BufferedMetric() for k in TB_METRICS}
    metrics["epochs"] = train_c.start_epoch
    if logger.tensorboard is not None:
        logger.tensorboard.init_hparams_and_metrics(metrics)

    train_loader, valid_loader = loaders["train"], loaders["validation"]
    train_keys = criteria.scalars + ("TotalLoss",)
    nan_cols = [train_keys.index(k) for k in NAN_CHECKED]
    first_step_s, steady_s, steady_steps, start_lr = None, 0.0, 0, None
    early_stop = False
    for epoch in range(train_c.start_epoch, train_c.n_epochs):
        for s in scalars.values():
            s.on_new_epoch()
        lr, beta = schedule.epoch_start(epoch)
        set_learning_rate(optimizer, lr)
        if start_lr is None:
            start_lr = [g["lr"] for g in optimizer.param_groups]

        # ---- train: the epoch's index batches go to the device in one copy
        batches = list(train_loader.epoch_index_batches(epoch))
        if not batches:
            raise ValueError("train split smaller than one (drop_last) minibatch")
        t0 = time.perf_counter()
        idx = torch.from_numpy(np.stack(batches)).to(dev)
        rows = []
        for i in range(len(batches)):
            x, v, info = train_loader.gather(idx[i])
            rows.append(train_step(model, optimizer, criteria, train_c, x, v, info, beta,
                                   generator))
            step += 1
            if first_step_s is None:  # includes cuDNN's algorithm search
                _sync(dev)
                first_step_s, t0 = time.perf_counter() - t0, time.perf_counter()
            logger.on_minibatch_finished(i)
        # the epoch's one host fetch of the train scalars (loop.py:572-582)
        train_rows = torch.stack([torch.stack([m[k] for k in train_keys]) for m in rows])
        train_rows = train_rows.cpu().numpy()
        steady_s += time.perf_counter() - t0
        steady_steps += len(rows) - 1 if epoch == train_c.start_epoch else len(rows)
        check_nan_values(epoch, *train_rows[:, nan_cols].ravel())
        for j, k in enumerate(train_keys):
            for value in train_rows[:, j]:
                scalars[f"{k}/Train"].append(value)

        # ---- validation: padded batches weighted by their real rows
        val_rows, latents = [], []
        for i, sel in enumerate(valid_loader.epoch_index_batches(epoch)):
            x, v, info = valid_loader.gather(sel)
            m = eval_step(model, criteria, train_c, x, v, info)
            val_rows.append(torch.stack([m[k] for k in criteria.scalars]))
            n_real = min(valid_loader.batch_size, valid_loader.n_items - i * valid_loader.batch_size)
            latents.append(torch.stack([m["z0_mu"][:n_real], m["z0"][:n_real]]))
        if not val_rows:
            raise ValueError("empty validation split")
        val_rows = torch.stack(val_rows).cpu().numpy()
        latents = torch.cat(latents, dim=1).cpu().numpy()
        for i, row in enumerate(val_rows):
            for k, value in zip(criteria.scalars, row):
                scalars[f"{k}/Valid"].append(value, weight=valid_loader.batch_weight(i))
        scalars["LatCorr/Valid"].append(latents[0], latents[1])
        for split in ("Train", "Valid"):
            scalars[f"VAELoss/{split}"] = SimpleMetric(
                scalars[f"ReconsLoss/Backprop/{split}"].get() + scalars[f"LatLoss/{split}"].get())

        # ---- plateau scheduler and early stop
        lr, early_stop = schedule.epoch_end(
            epoch, {n: scalars[f"{n}/Valid"].get() for n in train_c.scheduler_loss})
        set_learning_rate(optimizer, lr)
        scalars["Sched/LR"] = SimpleMetric(lr)

        if logger.tensorboard is not None:  # (loop.py:846-867)
            for k, s in scalars.items():
                if getattr(s, "has_data", True):
                    logger.tensorboard.add_scalar(k, s.get(), epoch)
            metrics["epochs"] = epoch + 1
            for k in TB_METRICS:
                metrics[f"{k}_"].append(scalars[k].get())
            logger.tensorboard.update_metrics(metrics)

        if ((epoch > 0 and epoch % train_c.save_period == 0) or epoch == train_c.n_epochs - 1
                or early_stop):
            logger.save_checkpoint(epoch, model, optimizer, step, generator, schedule.plateau)
        logger.on_epoch_finished(epoch)
        if early_stop:
            logger.log("Training stopped early (loss plateau)", level=1)
            break
    logger.on_training_finished()

    step_s = steady_s / steady_steps if steady_steps else first_step_s
    summary = {
        "epochs_trained": epoch + 1,
        "early_stop": early_stop,
        "final_lr": lr,
        "start_step": start_step,
        "start_lr": start_lr,
        "train_steps": step - start_step,
        "run_dir": str(logger.run_dir),
        "device": str(dev),
        "dim_z": model_c.dim_z,
        "input_size": list(model_c.input_tensor_size),
        "n_params": sum(p.numel() for p in model.parameters()),
        "corpus_presets": dataset.valid_presets_count,
        "corpus_seconds": dataset.corpus_seconds,
        "corpus_render_seconds": dataset.render_seconds,
        "model_build_seconds": build_s,
        "first_step_ms": first_step_s * 1e3,
        "step_ms": step_s * 1e3,
        "spectrograms_per_s": train_c.minibatch_size / step_s,
    }
    for k, s in scalars.items():
        if k != "Sched/LR":
            summary[k] = s.get()
    return summary


if __name__ == "__main__":
    # `python -m preset_gen_vae_tpu_torch.training.loop` trains the default
    # configs on the card, as the root train.py does for the JAX package
    print(train_config(cfg.ModelConfig(), cfg.TrainConfig()))
