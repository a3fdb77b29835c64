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
- every ``plot_period`` epochs, when TensorBoard writes and the run is one
  process, ``LatCorr/Train`` of the epoch's train latents, and on such an
  epoch or on early stop the four figures ``Spectrogram``, ``LatentMu``,
  ``LatentEntanglement`` and ``SynthControlsError`` (loop.py:434, 504-515,
  719-772, 824-844); a scalar without data is not written
  (loop.py:846-867);
- TensorBoard scalars and hparams metrics when ``use_tensorboard``,
  checkpoints at each ``save_period`` (epoch > 0), at the last epoch and on
  early stop (loop.py:869-875);
- ``profiler_args['enabled']``: a ``torch.profiler`` window over the first
  5 train steps of the first epoch (fewer if the epoch is shorter), written
  to ``<run_dir>/profile/trace.json``; with ``profiler_full_trace`` the run
  stops after 3 steps, before validation (loop.py:459-487, 693-710).

Several processes (``torchrun --nproc_per_node=N -m
preset_gen_vae_tpu_torch.training.loop``, or ``initialize_distributed``
before the call; loop.py:87-100, 204-239 there): each process trains on
``cuda:LOCAL_RANK``, from rank 0's parameters, on its carve of every split
(``parallel/multihost.py``), with the gradients and the scalars averaged
over the processes and synchronised batch statistics; rank 0 alone writes.
``force_multihost_data`` takes that path in one process. The K-step scans
(``steps_per_dispatch``) and the 2-D tensor-parallel mesh are JAX-only.

    from preset_gen_vae_tpu_torch.training.loop import train_config
    summary = train_config(ModelConfig(), TrainConfig(n_epochs=1))  # on the card
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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
from ..parallel import multihost
from ..utils.exception import check_nan_values
from ..utils.hparams import LinearDynamicParam
from ..utils.profile import get_optional_profiler
from .schedulers import ReduceLROnPlateau
from .train_step import Criteria, eval_step, make_optimizer, train_step

# the losses whose NaN/inf stops a run (loop.py:524-528 there)
NAN_CHECKED = ("ReconsLoss/Backprop", "LatLoss", "FlowInputReg", "Controls/BackpropLoss")
# hparams metrics of TensorBoard: buffered validation scalars (loop.py:447-454)
TB_METRICS = ("ReconsLoss/MSE/Valid", "LatLoss/Valid", "LatCorr/Valid", "Controls/QLoss/Valid",
              "Controls/Accuracy/Valid")
PROFILE_STEPS = 5  # the profiler's window: the first epoch's first train steps (loop.py:482)


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


def check_parallel_fields(train_c: cfg.TrainConfig, world: int) -> None:
    """The port's data parallelism is one process a card: ``data_parallel_devices``
    above 1 must be the world size, and the JAX package's tensor-parallel
    mesh (``model_parallel_devices`` above 1) has no counterpart."""
    if train_c.model_parallel_devices > 1:
        raise ValueError(f"model_parallel_devices={train_c.model_parallel_devices}: the 2-D "
                         "tensor-parallel mesh is JAX-only; the port trains data-parallel, "
                         "one process a card")
    if train_c.data_parallel_devices > 1 and train_c.data_parallel_devices != world:
        raise ValueError(f"data_parallel_devices={train_c.data_parallel_devices} in a world of "
                         f"{world} process(es): the port trains one process a card; launch "
                         f"them with torchrun --nproc_per_node={train_c.data_parallel_devices}")


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
    rank, world = multihost.rank_and_world()
    check_parallel_fields(train_c, world)
    multiproc = world > 1 or train_c.force_multihost_data
    if multiproc and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    if dev.type == "cuda" and train_c.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False  # float32 convolutions in full f32
    # rank 0's corpus pass first: a cold 'disk' pass writes the cache, which
    # the other processes then reload warm, instead of racing on its files
    if rank == 0:
        model_c, train_c, dataset_r = prepare_dataset(model_c, train_c, dev, dataset,
                                                      dataset_kwargs)
    multihost.barrier()
    if rank != 0:
        model_c, train_c, dataset_r = prepare_dataset(model_c, train_c, dev, dataset,
                                                      dataset_kwargs)
    dataset = dataset_r
    loaders = get_split_loaders(dataset, train_c)
    if multiproc:  # each process's carve of every split (loop.py:87-100 there)
        loaders = multihost.shard_loaders_for_host(loaders, rank, world,
                                                   dataset.corpus_cache_policy,
                                                   force=train_c.force_multihost_data)
    helper = dataset.preset_indexes_helper

    start_checkpoint = None
    if train_c.start_epoch > 0:  # resume (loop.py:103-112): every process restores
        with open(get_run_dir(model_c) / "config.json") as f:
            cfg.check_configs_on_resume_from_checkpoint(model_c, train_c, json.load(f))
        start_checkpoint = load_checkpoint(model_c, train_c.start_epoch - 1)
    multihost.barrier()  # read before rank 0's logger rewrites config.json
    logger = RunLogger(model_c, train_c, restart_from_checkpoint=start_checkpoint is not None,
                       use_tensorboard=use_tensorboard, write=rank == 0)

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
    multihost.broadcast_(model.state_dict().values())  # every process from rank 0's weights
    start_step = step

    scalars: Dict[str, object] = {f"{k}/{split}": EpochMetric()
                                  for k in criteria.scalars for split in ("Train", "Valid")}
    scalars["TotalLoss/Train"] = EpochMetric()
    scalars["LatCorr/Train"] = LatentMetric(model_c.dim_z)
    scalars["LatCorr/Valid"] = LatentMetric(model_c.dim_z)
    scalars["Sched/LR"] = SimpleMetric(train_c.initial_learning_rate)
    metrics = {f"{k}_": BufferedMetric() for k in TB_METRICS}
    metrics["epochs"] = train_c.start_epoch
    if logger.tensorboard is not None:
        logger.tensorboard.init_hparams_and_metrics(metrics)
    # the trace is rank 0's; every process follows the same steps
    profiling = bool(train_c.profiler_args.get("enabled"))
    profiler = get_optional_profiler(train_c.profiler_args if logger.write else None,
                                     logger.run_dir / "profile", dev)

    train_loader, valid_loader = loaders["train"], loaders["validation"]
    train_keys = criteria.scalars + ("TotalLoss",)
    nan_cols = [train_keys.index(k) for k in NAN_CHECKED]
    first_step_s, steady_s, steady_steps, start_lr = None, 0.0, 0, None
    early_stop, epoch_walls = False, []
    for epoch in range(train_c.start_epoch, train_c.n_epochs):
        t_epoch = time.perf_counter()
        for s in scalars.values():
            s.on_new_epoch()
        lr, beta = schedule.epoch_start(epoch)
        set_learning_rate(optimizer, lr)
        if start_lr is None:
            start_lr = [g["lr"] for g in optimizer.param_groups]
        # the plot epochs: the train latents' LatCorr/Train, the figures
        # (loop.py:504-515, 719-723 there)
        should_plot = (epoch % train_c.plot_period == 0 and logger.tensorboard is not None
                       and world == 1)

        # ---- train: the epoch's index batches go to the device in one copy
        batches = list(train_loader.epoch_index_batches(epoch))
        if not batches:
            raise ValueError("train split smaller than one (drop_last) minibatch")
        trace_active = profiling and epoch == train_c.start_epoch
        if trace_active:
            profiler.start()
        t0 = time.perf_counter()
        idx = torch.from_numpy(np.stack(batches)).to(dev)
        rows, train_latents = [], []
        for i in range(len(batches)):
            x, v, info = train_loader.gather(idx[i])
            with profiler.record_function("train_step"):
                m = train_step(model, optimizer, criteria, train_c, x, v, info, beta, generator,
                               latents=should_plot)
            rows.append(m)
            if should_plot:
                train_latents.append((m["z0_mu"], m["z0"]))
            step += 1
            if first_step_s is None:  # includes cuDNN's algorithm search
                _sync(dev)
                first_step_s, t0 = time.perf_counter() - t0, time.perf_counter()
            logger.on_minibatch_finished(i)
            if trace_active and i + 1 >= PROFILE_STEPS:
                profiler.stop()
                trace_active = False
                logger.save_profiler_results(profiler)
            if profiling and train_c.profiler_full_trace and i == 2:
                break
        if trace_active:  # an epoch shorter than PROFILE_STEPS
            profiler.stop()
            logger.save_profiler_results(profiler)
        # the epoch's one host fetch of the train scalars (loop.py:572-582),
        # averaged over the processes first, so that all stop on a NaN
        train_rows = torch.stack([torch.stack([m[k] for k in train_keys]) for m in rows])
        multihost.all_reduce_mean_([train_rows])
        train_rows = train_rows.cpu().numpy()
        steady_s += time.perf_counter() - t0
        steady_steps += len(rows) - 1 if epoch == train_c.start_epoch else len(rows)
        check_nan_values(epoch, *train_rows[:, nan_cols].ravel())
        for j, k in enumerate(train_keys):
            for value in train_rows[:, j]:
                scalars[f"{k}/Train"].append(value)
        if train_latents:
            scalars["LatCorr/Train"].append(*(torch.cat(z).float().cpu().numpy()
                                              for z in zip(*train_latents)))
        if profiling and train_c.profiler_full_trace and epoch == train_c.start_epoch:
            break  # before validation (loop.py:708-709 there)

        # ---- validation: padded batches weighted by their real rows; each
        # process's batch means averaged over the processes; the latents of
        # one process only (loop.py:768-770 there)
        val_rows, latents, v_errors, first_batch = [], [], [], None
        for i, sel in enumerate(valid_loader.epoch_index_batches(epoch)):
            x, v, info = valid_loader.gather(sel)
            m = eval_step(model, criteria, train_c, x, v, info)
            val_rows.append(torch.stack([m[k] for k in criteria.scalars]))
            n_real = min(valid_loader.batch_size, valid_loader.n_items - i * valid_loader.batch_size)
            if world == 1:
                latents.append(torch.stack([m["z0_mu"][:n_real], m["z0"][:n_real]]))
            if should_plot:
                v_errors.append((m["v_out"].float() - v)[:n_real])
                if i == 0:
                    first_batch = (x, m["x_out"], info)
        if not val_rows:
            raise ValueError("empty validation split")
        val_rows = torch.stack(val_rows)
        multihost.all_reduce_mean_([val_rows])
        val_rows = val_rows.cpu().numpy()
        for i, row in enumerate(val_rows):
            for k, value in zip(criteria.scalars, row):
                scalars[f"{k}/Valid"].append(value, weight=valid_loader.batch_weight(i))
        if latents:
            latents = torch.cat(latents, dim=1).cpu().numpy()
            scalars["LatCorr/Valid"].append(latents[0], latents[1])
        for split in ("Train", "Valid"):
            scalars[f"VAELoss/{split}"] = SimpleMetric(
                scalars[f"ReconsLoss/Backprop/{split}"].get() + scalars[f"LatLoss/{split}"].get())

        # ---- plateau scheduler and early stop
        lr, early_stop = schedule.epoch_end(
            epoch, {n: scalars[f"{n}/Valid"].get() for n in train_c.scheduler_loss})
        set_learning_rate(optimizer, lr)
        scalars["Sched/LR"] = SimpleMetric(lr)

        if logger.tensorboard is not None:
            if world == 1 and (should_plot or early_stop):  # (loop.py:824-844)
                add_figures(logger.tensorboard, epoch, scalars["LatCorr/Valid"], helper,
                            first_batch, v_errors)
            for k, s in scalars.items():  # (loop.py:846-867)
                if getattr(s, "has_data", True):
                    logger.tensorboard.add_scalar(k, s.get(), epoch)
            metrics["epochs"] = epoch + 1
            for k in TB_METRICS:
                if getattr(scalars[k], "has_data", True):
                    metrics[f"{k}_"].append(scalars[k].get())
            logger.tensorboard.update_metrics(metrics)

        if ((epoch > 0 and epoch % train_c.save_period == 0) or epoch == train_c.n_epochs - 1
                or early_stop):
            logger.save_checkpoint(epoch, model, optimizer, step, generator, schedule.plateau)
        logger.on_epoch_finished(epoch)
        epoch_walls.append(time.perf_counter() - t_epoch)
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
        "world_size": world,
        "dim_z": model_c.dim_z,
        "input_size": list(model_c.input_tensor_size),
        "n_params": sum(p.numel() for p in model.parameters()),
        "corpus_presets": dataset.valid_presets_count,
        "corpus_seconds": dataset.corpus_seconds,
        "corpus_render_seconds": dataset.render_seconds,
        "model_build_seconds": build_s,
        "first_step_ms": first_step_s * 1e3,
        "step_ms": step_s * 1e3,
        # an epoch's wall: train steps, validation, scheduler, checkpoint;
        # the first (cuDNN's algorithm search) apart
        "first_epoch_s": epoch_walls[0] if epoch_walls else None,
        "epoch_s": float(np.mean(epoch_walls[1:] or epoch_walls)) if epoch_walls else None,
        "spectrograms_per_s": train_c.minibatch_size / step_s,
    }
    for k, s in scalars.items():  # the scalars that have data (loop.py:892-896 there)
        if k != "Sched/LR" and getattr(s, "has_data", True):
            summary[k] = s.get()
    return summary


def add_figures(writer, epoch: int, latent_valid: LatentMetric, helper, first_batch,
                v_errors) -> None:
    """The four TensorBoard figures of a plot epoch (loop.py:824-844 there):
    the first validation batch's spectrograms against their
    reconstructions, the validation latents' distributions and Spearman
    matrix, the validation presets' errors; all figures closed after."""
    import matplotlib.pyplot as plt

    from ..utils import figures

    if first_batch is not None:
        x, x_out, info = (t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()
                          for t in first_batch)
        writer.add_figure("Spectrogram", figures.plot_train_spectrograms(x, x_out, info)[0], epoch)
    writer.add_figure("LatentMu", figures.plot_latent_distributions_stats(latent_valid)[0], epoch)
    writer.add_figure("LatentEntanglement", figures.plot_spearman_correlation(latent_valid)[0],
                      epoch)
    if v_errors:
        writer.add_figure("SynthControlsError", figures.plot_synth_preset_error(
            torch.cat(v_errors).cpu().numpy(), helper)[0], epoch)
    plt.close("all")


def main(argv=None, model_c: Optional[cfg.ModelConfig] = None,
         train_c: Optional[cfg.TrainConfig] = None, dataset_kwargs: Optional[Dict] = None) -> Dict:
    """``python -m preset_gen_vae_tpu_torch.training.loop [--no-tensorboard]
    [--device cuda]`` trains the default configs (or the ones given), as
    the root train.py does for the JAX package; under torchrun, one process
    a card. Without ``--no-tensorboard`` the run writes TensorBoard events
    and raises ``ImportError`` where tensorboard is not installed."""
    ap = argparse.ArgumentParser(description="Train one run from the default configs")
    ap.add_argument("--no-tensorboard", dest="tensorboard", action="store_false",
                    help="write no TensorBoard events (where tensorboard is not installed)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    multihost.initialize_distributed("env://", int(os.environ.get("WORLD_SIZE", 1)),
                                     int(os.environ.get("RANK", 0)),
                                     backend="nccl" if dev.type == "cuda" else "gloo")
    summary = train_config(model_c or cfg.ModelConfig(), train_c or cfg.TrainConfig(),
                           device=args.device, dataset_kwargs=dataset_kwargs,
                           use_tensorboard=args.tensorboard)
    print(summary)
    return summary


if __name__ == "__main__":
    main()
