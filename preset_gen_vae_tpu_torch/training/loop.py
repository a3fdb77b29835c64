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
``force_multihost_data`` takes that path in one process.

Tensor parallelism (``model_parallel_devices`` above 1; loop.py:155-190
there): the world becomes a grid of ``n_data x n_model`` processes
(``parallel/sharding_rules.py``), ``n_data = gcd(minibatch_size, world //
n_model)``, and a world the grid cannot hold raises. After rank 0's
weights are broadcast, every 2-D kernel of at least ``tp_min_elements``
entries is cut over the model group (``models/layers.py:ShardedLinear``),
the optimizer is made over the shards, the splits are carved by data rank
and the gradients and scalars averaged over the data group; the summary
reports ``tp_kernels_sharded``. Checkpoints are layout-free
(``logs/logger.py``): a run resumes under any grid or in one process.

The host-fed pipeline (``dataset_cache_device=False``; loop.py:207-209,
233-237 there): the corpus pass computes on the card as always, a chunk
at a time, then the corpus lives in pinned host memory
(``data/dexed_dataset.py``) and each batch is gathered there into pinned
memory and copied to the card (``data/pipeline.py:SplitLoader.device_batches``).

K-step dispatch (``steps_per_dispatch``, loop.py:225-233, 392-424,
588-622, 739-758 there; ``training/dispatch.py``): in one process, K
train steps (K = -1: the epoch's batch count; K capped at it) run as one
replay of a CUDA graph that holds the K whole steps, the counterpart of
the JAX loop's K-step ``lax.scan``; each step left over (the remainder)
is one replay of a second graph that holds one whole step, the JAX
loop's one dispatch a left-over step. The run's first group runs eagerly
as the graph's warm-up, the second captures it, the later ones replay
it; the one-step graph is captured on the group's stream at the first
step left over after that warm-up (in the run's first epoch, unless it
is profiled); a failed capture raises. An epoch that draws no figure replays the validation
step's graph (captured after one eager batch) over its batches, the
counterpart of the whole-validation scan. K = 1 steps one at a time, as
do several processes (tensor parallelism too), the host-fed pipeline (the
JAX loop dispatches K steps only over a resident corpus, loop.py:588 there)
and the profiled epoch. The epoch's one fetch of the
train scalars, the NaN check and the validation weighting are the same on
every path; on the CPU the groups run their steps eagerly through the
same static buffers.

    from preset_gen_vae_tpu_torch.training.loop import train_config
    summary = train_config(ModelConfig(), TrainConfig(n_epochs=1))  # on the card
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import config as cfg
from ..data.dexed_dataset import DexedDataset, model_config_to_dataset_kwargs
from ..data.pipeline import get_split_loaders
from ..device import resolve_device
from ..logs.logger import RunLogger, get_run_dir, load_checkpoint
from ..logs.metrics import BufferedMetric, EpochMetric, LatentMetric, SimpleMetric
from ..models.build import build_extended_ae_model
from ..ops import tconv_out
from ..parallel import multihost, sharding_rules
from ..utils.exception import check_nan_values
from ..utils.hparams import LinearDynamicParam
from ..utils.profile import Spans, get_optional_profiler
from .dispatch import EvalReplays, GraphedCall, TrainGroups, dispatch_k, dispatch_sizes
from .schedulers import ReduceLROnPlateau
from .train_step import (
    Criteria,
    eval_step,
    load_optimizer_state,
    make_optimizer,
    set_learning_rate,
    train_step,
)

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


def prepare_dataset(model_c: cfg.ModelConfig, train_c: cfg.TrainConfig, dev: torch.device,
                    dataset: Optional[DexedDataset] = None,
                    dataset_kwargs: Optional[Dict] = None):
    """Builds the dataset unless one is given (its corpus pass launches K1
    on the card), its corpus on the device or, with
    ``dataset_cache_device=False``, on the host, and resolves the configs
    against it (loop.py:73-85 there); -> (model_c, train_c, dataset). A
    given dataset must keep its corpus where the field says."""
    if dataset is None:
        bf16 = dev.type == "cuda" and train_c.compute_dtype == "bfloat16"
        kwargs = model_config_to_dataset_kwargs(model_c)
        kwargs.update(device=dev, corpus_dtype=torch.bfloat16 if bf16 else torch.float32,
                      corpus_on_device=train_c.dataset_cache_device, **(dataset_kwargs or {}))
        dataset = DexedDataset(**kwargs)
    if dataset.corpus_on_device != train_c.dataset_cache_device:
        raise ValueError(f"dataset_cache_device={train_c.dataset_cache_device} with a dataset "
                         f"built with corpus_on_device={dataset.corpus_on_device}")
    model_c, train_c = cfg.resolve_with_dataset(model_c, train_c, dataset)
    size = dataset.get_spectrogram_tensor_size()  # (C, H, W), C = stacked notes
    model_c = dataclasses.replace(
        model_c, input_tensor_size=(train_c.minibatch_size, *size), spectrogram_size=size[1:])
    return model_c, train_c, dataset


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_parallel_fields(train_c: cfg.TrainConfig, world: int) -> Tuple[int, int]:
    """(n_data, n_model) of the grid the world of ``world`` processes, one a
    card, trains on (``sharding_rules.grid_shape``); raises, naming the
    field, where ``model_parallel_devices``, ``data_parallel_devices`` or
    ``minibatch_size`` ask for a grid the world cannot hold."""
    return sharding_rules.grid_shape(world, train_c.minibatch_size,
                                     train_c.model_parallel_devices,
                                     train_c.data_parallel_devices)


def train_config(model_config: Optional[cfg.ModelConfig] = None,
                 train_config: Optional[cfg.TrainConfig] = None,
                 dataset: Optional[DexedDataset] = None, device="cuda",
                 dataset_kwargs: Optional[Dict] = None, use_tensorboard: bool = True) -> Dict:
    """Trains one run; returns a summary dict of metrics and timings.
    ``device`` defaults to the card and raises if there is none.

    The summary's ``spans`` maps each span of the epoch loop
    (``utils/profile.py:Spans``) to its totals over the ``span_epochs``
    epochs that ``epoch_s`` averages (the call's epochs after its first, or
    its one epoch): ``s`` inclusive and ``self_s`` seconds, ``n`` spans,
    ``device_s`` on the card's clock for a device span, ``steps`` for the
    spans that take train steps, ``host_only: True`` where the card has
    nothing queued. The spans, ``epoch`` the parent of the others:

    - ``epoch``: the epoch's wall, which ``epoch_s`` and the logger read;
    - ``epoch.start``: the scalars' reset, the LR and beta;
    - ``epoch.batches``: the index batches, their stack and copy to the card;
    - ``epoch.warmup``, ``epoch.capture``: the run's first group, eager as
      its graph's warm-up, and the next, which captures the graph;
    - ``epoch.replays`` (device): each later group's graph replay;
    - ``epoch.remainder`` (device): the single steps after the groups (every
      step where nothing is grouped), counter ``steps``; each a replay of
      the one-step graph once the groups' warm-up has run (counter
      ``replayed``), else an eager ``train_step``, the span that a profiler
      window shows;
    - ``epoch.fetch``: the train rows' one fetch to the host, where the host
      waits for the card;
    - ``epoch.train_scalars``: the NaN check and the per-value appends;
    - ``epoch.validation``: ``.batches``, ``.steps`` (device: the graph's
      replays, or eager steps), ``.fetch`` and ``.scalars`` (the weighting
      and the latents);
    - ``epoch.schedule``: the plateau step, and TensorBoard where it writes;
    - ``epoch.checkpoint``: ``logger.save_checkpoint``;
    - ``epoch.log``: ``logger.on_epoch_finished``.

    Host-only: ``epoch.start``, ``epoch.batches``, ``epoch.train_scalars``,
    ``epoch.validation.batches``, ``epoch.validation.scalars``,
    ``epoch.schedule``, ``epoch.checkpoint``, ``epoch.log``.

    The summary's ``memory`` splits what the run holds on the card at the
    call's end (``device_memory``); None off the card."""
    dev = resolve_device(device)
    model_c, train_c = cfg.resolve(model_config or cfg.ModelConfig(),
                                   train_config or cfg.TrainConfig())
    if train_c.start_epoch >= train_c.n_epochs:
        raise ValueError(f"start_epoch {train_c.start_epoch} >= n_epochs {train_c.n_epochs}")
    rank, world = multihost.rank_and_world()
    n_data, n_model = check_parallel_fields(train_c, world)
    multiproc = world > 1 or train_c.force_multihost_data
    if multiproc and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    grid = sharding_rules.make_2d_grid(n_data, n_model) if n_model > 1 else None
    with sharding_rules.grid_scope(grid):
        return _train(model_c, train_c, dataset, dev, dataset_kwargs, use_tensorboard, grid)


def _train(model_c: cfg.ModelConfig, train_c: cfg.TrainConfig, dataset: Optional[DexedDataset],
           dev: torch.device, dataset_kwargs: Optional[Dict], use_tensorboard: bool,
           grid: Optional[sharding_rules.Grid]) -> Dict:
    """``train_config``'s run on ``dev``, inside its grid's scope."""
    rank, world = multihost.rank_and_world()
    data_rank, n_data = multihost.data_rank_and_size()
    multiproc = world > 1 or train_c.force_multihost_data
    host_fed = not train_c.dataset_cache_device
    tconv_out_launches = tconv_out.LAUNCHES["tconv_out"]
    if dev.type == "cuda" and train_c.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False  # float32 convolutions in full f32
    # rank 0's corpus pass first: a cold 'disk' pass writes the cache, which
    # the other processes then reload warm, instead of racing on its files
    # (the dataset builds its corpus lazily: rank 0 loads it before the barrier)
    if rank == 0:
        model_c, train_c, dataset_r = prepare_dataset(model_c, train_c, dev, dataset,
                                                      dataset_kwargs)
        if world > 1:
            dataset_r.load_corpus()
    multihost.barrier()
    if rank != 0:
        model_c, train_c, dataset_r = prepare_dataset(model_c, train_c, dev, dataset,
                                                      dataset_kwargs)
    dataset = dataset_r
    loaders = get_split_loaders(dataset, train_c)
    if multiproc:  # each data rank's carve of every split (loop.py:87-100 there)
        loaders = multihost.shard_loaders_for_host(loaders, data_rank, n_data,
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
    n_params = sum(p.numel() for p in model.parameters())
    criteria = Criteria(model_c, train_c, helper)
    generator = torch.Generator(device=dev).manual_seed(train_c.seed)
    schedule = EpochSchedule(train_c)
    step = 0
    if start_checkpoint is not None:  # (loop.py:136-147); a checkpoint holds full tensors
        state = start_checkpoint["state"]
        model.load_state_dict(state["model"])
        step = int(state["step"])
        generator.set_state(state["generator"])
        schedule.plateau.load_state_dict(start_checkpoint["scheduler"])
    multihost.broadcast_(model.state_dict().values())  # every process from rank 0's weights
    tp_report = None
    if grid is not None:  # each process keeps its shards (loop.py:165-190 there)
        tp_report = sharding_rules.count_sharded(model, grid.n_model, train_c.tp_min_elements)
        sharding_rules.shard_model(model, grid, train_c.tp_min_elements)
        logger.log(f"[tp] mesh (data={grid.n_data}, model={grid.n_model}): {tp_report[0]} "
                   f"kernels sharded ({tp_report[1]}/{tp_report[2]} elements)", level=1)
    optimizer = make_optimizer(model, train_c)
    if start_checkpoint is not None:
        load_optimizer_state(optimizer, sharding_rules.shard_optimizer_state(
            start_checkpoint["state"]["optimizer"], model))
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
    beta_t = torch.zeros((), device=dev)  # the epoch's beta, read by every step on the device

    def one_step(batch, latents: bool):
        return train_step(model, optimizer, criteria, train_c, *batch, beta_t, generator,
                          latents=latents)

    def eval_rows(sel):
        """-> the scalars and the (2, B, dim_z) latents of one validation batch."""
        x, v, info = valid_loader.gather(sel)
        m = eval_step(model, criteria, train_c, x, v, info)
        return torch.stack([m[k] for k in criteria.scalars]), torch.stack([m["z0_mu"], m["z0"]])

    # in one process over a resident corpus, the JAX loop's K-step scans as
    # CUDA graphs (training/dispatch.py): groups of K train steps, the steps
    # left over after them one at a time (``rest``, where the epoch's batch
    # count leaves any), and the validation step of the epochs that draw no
    # figure
    groups = rest = evals = None
    if not multiproc and not host_fed:
        name = f"{model_c.name}/{model_c.run_name}"
        k = dispatch_k(train_c.steps_per_dispatch, len(train_loader))
        if k > 1:
            groups = TrainGroups(k, train_loader.batch_size,
                                 lambda sel: one_step(train_loader.gather(sel), True),
                                 train_keys, dev, f"{k} train steps of {name}", generator)
            if len(train_loader) % k:
                rest = TrainGroups(1, train_loader.batch_size, groups.step, train_keys, dev,
                                   f"one train step of {name}", generator, shares=groups.call)
        evals = EvalReplays(valid_loader.batch_size, eval_rows, dev,
                            f"the validation step of {name}")
    train_graphs = [g for g in (groups, rest) if g is not None]
    first_step_s, steady_s, steady_steps, start_lr = None, 0.0, 0, None
    early_stop, epoch_walls = False, []
    # every epoch's spans (utils/profile.py); the host-only ones run while
    # nothing is queued on the card, from a blocking fetch's return to the
    # next launch
    spans = Spans(dev)
    for epoch in range(train_c.start_epoch, train_c.n_epochs):
        with spans.span("epoch", id=epoch) as epoch_span:
            with spans.span("epoch.start", host_only=True):
                for s in scalars.values():
                    s.on_new_epoch()
                lr, beta = schedule.epoch_start(epoch)
                set_learning_rate(optimizer, lr)
                beta_t.fill_(beta)
                if start_lr is None:
                    start_lr = [float(g["lr"]) for g in optimizer.param_groups]
                # the plot epochs: the train latents' LatCorr/Train, the figures
                # (loop.py:504-515, 719-723 there)
                should_plot = (epoch % train_c.plot_period == 0
                               and logger.tensorboard is not None and world == 1)

            # ---- train: the epoch's index batches go to the device in one copy
            # (host-fed: the batches themselves, one at a time); groups of K
            # steps (the profiled epoch steps one at a time), then the remainder
            # one step each (loop.py:588-622 there), where there are groups a
            # one-step graph's replay
            with spans.span("epoch.batches", host_only=True):
                batches = list(train_loader.epoch_index_batches(epoch))
                if not batches:
                    raise ValueError("train split smaller than one (drop_last) minibatch")
                trace_active = profiling and epoch == train_c.start_epoch
                if trace_active:
                    profiler.start()
                sizes = (dispatch_sizes(len(batches), groups.k)
                         if groups is not None and not trace_active else [1] * len(batches))
                captured_s = sum(g.call.capture_s for g in train_graphs)
                t0 = time.perf_counter()
                if host_fed:
                    feed = train_loader.device_batches(batches, dev)
                else:
                    idx = torch.from_numpy(np.stack(batches)).to(dev)
            rows, train_latents, i = [], [], 0

            def single_step(j: int) -> None:
                nonlocal first_step_s, t0
                with spans.span("train_step"):
                    m = one_step(next(feed) if host_fed else train_loader.gather(idx[j]),
                                 should_plot)
                rows.append(torch.stack([m[k] for k in train_keys])[None])
                if should_plot:
                    train_latents.append(torch.stack([m["z0_mu"], m["z0"]])[:, None])
                if first_step_s is None:  # includes cuDNN's algorithm search
                    _sync(dev)
                    first_step_s, t0 = time.perf_counter() - t0, time.perf_counter()

            def replay(graphs: TrainGroups, j: int, size: int) -> None:
                r, lat = graphs.run(idx[j:j + size])
                rows.append(r.clone())  # before the next replay overwrites them
                if should_plot:
                    train_latents.append(lat.clone())

            remainder = None  # one span over the steps left over after the groups
            with contextlib.ExitStack() as stack:
                for size in sizes:
                    if size > 1 and groups.call.warm:
                        with spans.span("epoch.replays" if groups.call.captured
                                        else "epoch.capture", device=True) as span:
                            replay(groups, i, size)
                            span.count("steps", size)
                    elif size > 1:  # the run's first group: its graph's warm-up
                        with spans.span("epoch.warmup") as span, groups.call.warm_up():
                            for j in range(i, i + size):
                                single_step(j)
                            span.count("steps", size)
                    else:
                        if remainder is None:
                            remainder = stack.enter_context(
                                spans.span("epoch.remainder", device=True))
                        # after the groups' warm-up, which the profiled epoch,
                        # stepping one at a time, never runs
                        if rest is not None and groups.call.warm:
                            replay(rest, i, 1)
                            remainder.count("replayed")
                        else:
                            single_step(i)
                        remainder.count("steps")
                    i += size
                    step += size
                    logger.on_minibatch_finished(i - 1)
                    if trace_active and i >= PROFILE_STEPS:
                        profiler.stop()
                        trace_active = False
                        logger.save_profiler_results(profiler)
                    if profiling and train_c.profiler_full_trace and i == 3:
                        break
                if trace_active:  # an epoch shorter than PROFILE_STEPS
                    profiler.stop()
                    logger.save_profiler_results(profiler)
            # the epoch's one host fetch of the train scalars (loop.py:572-582),
            # averaged over the processes first, so that all stop on a NaN
            with spans.span("epoch.fetch"):
                train_rows = torch.cat(rows)
                multihost.all_reduce_mean_([train_rows])
                train_rows = train_rows.cpu().numpy()
                spans.read_device()
            # the steady time leaves out the first step and the graphs' captures
            captured_s = sum(g.call.capture_s for g in train_graphs) - captured_s
            steady_s += time.perf_counter() - t0 - captured_s
            steady_steps += (len(train_rows) - 1 if epoch == train_c.start_epoch
                             else len(train_rows))
            with spans.span("epoch.train_scalars", host_only=True):
                check_nan_values(epoch, *train_rows[:, nan_cols].ravel())
                for j, k in enumerate(train_keys):
                    for value in train_rows[:, j]:
                        scalars[f"{k}/Train"].append(value)
                if train_latents:  # (2, steps, B, dim_z)
                    lat = torch.cat(train_latents, dim=1).flatten(1, 2).float().cpu().numpy()
                    scalars["LatCorr/Train"].append(lat[0], lat[1])
            if profiling and train_c.profiler_full_trace and epoch == train_c.start_epoch:
                break  # before validation (loop.py:708-709 there)

            # ---- validation: padded batches weighted by their real rows; each
            # process's batch means averaged over the data group; the latents
            # where one data rank holds every row (loop.py:768-770 there). In
            # one process over a resident corpus, an epoch
            # that draws no figure replays the validation step's graph (captured
            # at its second batch) over its batches (the whole-validation scan,
            # loop.py:739-758 there).
            with spans.span("epoch.validation"):
                with spans.span("epoch.validation.batches", host_only=True):
                    vbatches = list(valid_loader.epoch_index_batches(epoch))
                    if not vbatches:
                        raise ValueError("empty validation split")
                    val_rows, latents, v_errors, first_batch = [], [], [], None
                    replayed = evals is not None and not should_plot
                    if replayed:
                        vidx = torch.from_numpy(np.stack(vbatches)).to(dev)
                with spans.span("epoch.validation.steps", device=True):
                    if replayed:
                        for i in range(len(vbatches)):
                            if evals.call.warm:
                                row, lat = (t.clone() for t in evals.run(vidx[i]))
                            else:
                                with evals.call.warm_up():
                                    row, lat = eval_rows(vidx[i])
                            val_rows.append(row)
                            latents.append(lat[:, :valid_real_rows(valid_loader, i)])
                    else:
                        for i, (x, v, info) in enumerate(valid_loader.device_batches(vbatches,
                                                                                     dev)):
                            m = eval_step(model, criteria, train_c, x, v, info)
                            val_rows.append(torch.stack([m[k] for k in criteria.scalars]))
                            n_real = valid_real_rows(valid_loader, i)
                            if n_data == 1:
                                latents.append(torch.stack([m["z0_mu"][:n_real],
                                                            m["z0"][:n_real]]))
                            if should_plot:
                                v_errors.append((m["v_out"].float() - v)[:n_real])
                                if i == 0:
                                    first_batch = (x, m["x_out"], info)
                with spans.span("epoch.validation.fetch"):
                    val_rows = torch.stack(val_rows)
                    multihost.all_reduce_mean_([val_rows])
                    val_rows = val_rows.cpu().numpy()
                    spans.read_device()
                with spans.span("epoch.validation.scalars", host_only=True):
                    for i, row in enumerate(val_rows):
                        for k, value in zip(criteria.scalars, row):
                            scalars[f"{k}/Valid"].append(value,
                                                         weight=valid_loader.batch_weight(i))
                    if latents:
                        latents = torch.cat(latents, dim=1).cpu().numpy()
                        scalars["LatCorr/Valid"].append(latents[0], latents[1])
                    for split in ("Train", "Valid"):
                        scalars[f"VAELoss/{split}"] = SimpleMetric(
                            scalars[f"ReconsLoss/Backprop/{split}"].get()
                            + scalars[f"LatLoss/{split}"].get())

            # ---- plateau scheduler and early stop
            with spans.span("epoch.schedule", host_only=True):
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
                with spans.span("epoch.checkpoint", host_only=True):
                    logger.save_checkpoint(epoch, model, optimizer, step, generator,
                                           schedule.plateau)
            with spans.span("epoch.log", host_only=True):
                logger.on_epoch_finished(epoch, epoch_span.elapsed())
        epoch_walls.append(epoch_span.s)
        if early_stop:
            logger.log("Training stopped early (loss plateau)", level=1)
            break
    logger.on_training_finished()

    step_s = steady_s / steady_steps if steady_steps else first_step_s
    span_epochs = list(range(train_c.start_epoch, train_c.start_epoch + len(epoch_walls)))
    span_epochs = span_epochs[1:] or span_epochs  # the epochs that epoch_s averages
    corpus_x = train_loader.tensors["x"]
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
        "n_params": n_params,
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
        # the loop's spans over the epochs that epoch_s averages (train_config)
        "spans": spans.totals(span_epochs),
        "span_epochs": len(span_epochs),
        # K-step dispatch (training/dispatch.py): K, and the CUDA graphs'
        # captures and replays (none on the CPU or across processes)
        "steps_per_dispatch": groups.k if groups is not None else 1,
        "train_graph_captures": groups.call.captures if groups is not None else 0,
        "train_graph_replays": groups.call.replays if groups is not None else 0,
        "eval_graph_captures": evals.call.captures if evals is not None else 0,
        "eval_graph_replays": evals.call.replays if evals is not None else 0,
        "remainder_graph_captures": rest.call.captures if rest is not None else 0,
        "remainder_graph_replays": rest.call.replays if rest is not None else 0,
        "graph_capture_s": sum(g.call.capture_s for g in (*train_graphs, evals)
                               if g is not None),
        # the decoder's output conv kernel's launches in this call (a replay
        # is none; 0 on the CPU, where the plain version runs)
        "tconv_out_launches": tconv_out.LAUNCHES["tconv_out"] - tconv_out_launches,
        # where the corpus lives (the host-fed pipeline: not on the device)
        "dataset_cache_device": train_c.dataset_cache_device,
        "corpus_bytes": corpus_x.numel() * corpus_x.element_size(),
        "memory": device_memory(dev, model, optimizer, corpus_x,
                                [g.call for g in (*train_graphs, evals) if g is not None]),
    }
    if tp_report is not None:  # (loop.py:890-891 there)
        summary["tp_kernels_sharded"] = tp_report[0]
        summary["tp_sharded_elements"] = tp_report[1]
        summary["tp_grid"] = [grid.n_data, grid.n_model]
    for k, s in scalars.items():  # the scalars that have data (loop.py:892-896 there)
        if k != "Sched/LR" and getattr(s, "has_data", True):
            summary[k] = s.get()
    return summary


def device_memory(dev: torch.device, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                  corpus_x: torch.Tensor, calls: List[GraphedCall]) -> Optional[Dict[str, int]]:
    """What the run holds on the card at the call's end, or None off the
    card: ``resident_bytes``, the tensors allocated in the caching
    allocator's default pool and the whole of the private pools of the
    graphed ``calls`` (a replay writes its activations, workspaces and
    outputs anywhere in its pool, which stays reserved while its graph
    lives); of it, ``corpus_bytes``, the resident corpus's spectrograms (0
    where the corpus is fed from the host), and ``model_state_bytes``, the
    parameters, buffers and optimizer state, what a checkpoint saves (Adam
    makes its state at the first step). The gradients are not model state
    here: each step sets them to None and its backward makes them anew, in
    a graph's pool where the step is replayed. The allocator's own
    bookkeeping: no wait for the card, and its peak statistics are left as
    they are."""
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    pools = {tuple(call.graph.pool()) for call in calls if call.graph is not None}
    resident = sum(seg["total_size"] if tuple(seg["segment_pool_id"]) in pools
                   else seg["allocated_size"]
                   for seg in torch.cuda.memory_snapshot() if seg["device"] == index)
    owned = {id(t): t for t in (*model.parameters(), *model.buffers())}
    owned.update((id(t), t) for state in optimizer.state.values() for t in state.values()
                 if torch.is_tensor(t))
    return {
        "resident_bytes": resident,
        "corpus_bytes": corpus_x.numel() * corpus_x.element_size() if corpus_x.is_cuda else 0,
        "model_state_bytes": sum(t.numel() * t.element_size() for t in owned.values()
                                 if t.device.type == "cuda"),
    }


def valid_real_rows(loader, i: int) -> int:
    """The real (not padding) rows of validation batch ``i``."""
    return min(loader.batch_size, loader.n_items - i * loader.batch_size)


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
