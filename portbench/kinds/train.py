"""Traffic kind ``train``: whole training epochs through the port's public
entry, ``training.loop.train_config``, on a corpus that set-up built.

Set-up, all inside ``setup_s``:

1. the dataset (``loop.prepare_dataset``) and its corpus pass on the card,
   ``n_synthetic_presets`` presets of ``synthetic_style`` from the seed;
2. the seeded start: weights made on the card from the seed
   (``reference/seeded.py``), written as the run's checkpoint of epoch
   P - 2, where P is the configuration's ``save_period`` (200: the loop
   writes a checkpoint after epoch P, and after the last epoch of a call);
3. the sizing call, ``train_config(start_epoch=P - 1, n_epochs=P)``: one
   epoch from the seeded start (its first group runs eagerly, the second is
   captured as a CUDA graph, the rest replay it), ending in checkpoint
   P - 1. Its replayed step (``step_ms``) sizes the window: E epochs of
   ``train_steps`` such steps that last at least ``--seconds`` (E < P, so
   that no checkpoint but the last falls inside the window);
4. the measured call's first epoch: ``train_config(start_epoch=P,
   n_epochs=P + 1 + E)`` restores checkpoint P - 1 (weights, Adam state,
   step generator, scheduler), warms up and captures its own graphs, and
   writes checkpoint P.

The window is the measured call's E later epochs: ``train_items_per_s``
is the items of an epoch over the summary's ``epoch_s``, the mean of those
epochs' walls (train steps, validation, the fetch, the scheduler and, in
the last, the checkpoint). ``setup_s`` is the process's wall up to the
call's end less the window. With ``--trace 1`` a second call like the
measured one, with two epochs after its first, runs under the profiler
once the window has closed: the device's busy time and the breakdown come
from it, the other per-layer metrics from the untraced window.

Correctness, once the window has closed and the peak has been read
(``reference/train.py``, in the configuration's precision): the reference
follows the sizing call's epoch from the seeded start and holds the
program's checkpoint P - 1 and epoch means against it; then it follows
epoch P from the program's checkpoint P - 1 and holds the measured call's
checkpoint P against it (numbers ``resumed.*``); and a sample of the
served corpus rows is checked (``reference/corpus.py``)."""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import sys
import time

import torch

from ..reference import corpus as rcorpus
from ..reference import presets as rp
from ..reference import seeded
from ..reference import train as rtrain
from . import Outcome, PhaseLog, configs, corpus_bound_s, make_checks, trace_fields

TRACE_EPOCHS = 2  # the epochs that a traced run's second call reads from the trace
# the sizing call's replayed step overstates the measured call's (flvae2 on
# an H100: 40.7-53.9 against 37.3-39.7 ms), so the window is sized on 0.7 of it
STEP_MARGIN = 0.7


def measured_epoch(train_c) -> int:
    """P, the measured call's first epoch: the least multiple of the
    configuration's ``save_period`` from 2, so that the loop writes its
    checkpoint."""
    return train_c.save_period * math.ceil(2 / train_c.save_period)


def window_epochs(sizing: dict, seconds: float, save_period: int) -> int:
    """E, the window's epochs: enough replayed steps at ``STEP_MARGIN`` of
    the sizing call's ``step_ms`` to fill ``seconds``, fewer than
    ``save_period`` (the window's epochs P + 1 .. P + E then hold no
    multiple of it)."""
    est = sizing["train_steps"] * sizing["step_ms"] * STEP_MARGIN / 1e3
    return min(max(1, math.ceil(seconds / max(est, 1e-3))), max(1, save_period - 1))


def flush_files(run_dir) -> None:
    """Writes the run directory's files through to the disk, so that the
    window does not start with set-up's checkpoints still to be written
    (their writeback would slow the window's own checkpoint by a varying
    amount)."""
    for path in sorted(p for p in run_dir.rglob("*") if p.is_file()):
        with open(path, "rb") as f:
            os.fsync(f.fileno())


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, runs_root,
        device="cuda", dataset=None) -> Outcome:
    """One run of a train cell; ``dataset``, a dataset already built for
    this cell and seed, is for tests on the CPU."""
    from preset_gen_vae_tpu_torch.training.loop import prepare_dataset, train_config

    from ..trace import Tracer

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    log = PhaseLog(t_start)
    model_c, train_c, fmc, ftc = configs(cell, seed, runs_root)
    data = cell.config["dataset"]
    n_presets, style = int(data["n_synthetic_presets"]), data["synthetic_style"]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- set-up: corpus, seeded start, sizing call
    if dataset is None:
        _, _, dataset = prepare_dataset(model_c, train_c, dev, None,
                                        {**data, "synthetic_seed": int(seed)})
        dataset.load_corpus()
    log("corpus pass")
    facts = rp.make_corpus(fmc, ftc, n_presets, style, seed, with_presets=False)
    fmc_r, ftc_r = rp.resolved_configs(fmc, ftc, facts)
    run_dir = runs_root / model_c.name / model_c.run_name
    first = measured_epoch(train_c)
    start_model = seeded.reference_model(fmc_r, ftc_r, facts.helper, dev)
    seeded.seed_weights(start_model, seed)
    log("seeded weights")
    seeded.write_start(run_dir, fmc_r, ftc_r, start_model, seed, dev, epoch=first - 2)
    del start_model
    log(f"checkpoint {first - 2} written")

    def call(start_epoch: int, n_epochs: int) -> dict:
        return train_config(model_c, dataclasses.replace(train_c, start_epoch=start_epoch,
                                                         n_epochs=n_epochs),
                            dataset=dataset, device=dev, use_tensorboard=False)

    sizing = call(first - 1, first)
    log("sizing call: " + ", ".join(f"{k} {sizing[k]:.4f}" for k in (
        "step_ms", "first_step_ms", "first_epoch_s", "graph_capture_s")))
    flush_files(run_dir)
    log("set-up's checkpoints flushed to disk")
    epochs = window_epochs(sizing, seconds, train_c.save_period)

    # ---- the measured call: its first epoch is set-up, the rest the window
    summary = call(first, first + 1 + epochs)
    if cuda:
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    checkpoints = run_dir / "checkpoints"
    os.replace(checkpoints / str(first), checkpoints / "measured")  # kept from the traced call
    log(f"measured call ({epochs} epochs in the window): " + ", ".join(
        f"{k} {summary[k]:.4f}" for k in ("step_ms", "epoch_s", "first_epoch_s",
                                          "graph_capture_s", "model_build_seconds")))
    window_s = epochs * summary["epoch_s"]
    setup_s = t_end - t_start - window_s
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    steps_per_epoch = summary["train_steps"] // (1 + epochs)
    items_per_epoch = steps_per_epoch * train_c.minibatch_size

    # ---- traced: a second call like it under the profiler, its epochs
    # after the first read from the trace (the timed window stays untraced)
    timeline = None
    if trace:
        with Tracer() as tracer:
            tracer.mark("call")
            traced = call(first, first + 1 + TRACE_EPOCHS)
            torch.cuda.synchronize(dev)
            t_traced = time.perf_counter()
        timeline = tracer.read(t_traced - TRACE_EPOCHS * traced["epoch_s"], t_traced)
        log(f"traced call ({TRACE_EPOCHS} epochs read), epoch_s {traced['epoch_s']:.4f}")

    # ---- correctness, the program's state freed but for its corpus
    corpus_s = dataset.corpus_seconds
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_corpus = rp.make_corpus(fmc, ftc, n_presets, style, seed)
    log("reference presets")
    served = dataset.load_corpus()
    readings = rcorpus.readings(fmc_r, served, dataset.spec_stats, ref_corpus.presets, seed,
                                int(cell.workload["sample_presets"]))
    log("reference corpus rows")
    items = dataset.corpus_tensors()["x"]
    ref = rtrain.follow_epoch(fmc_r, ftc_r, ref_corpus, items, run_dir, first - 1, dev,
                              count_flops=True)
    flops_per_step = ref.flops_per_step
    readings.update(rtrain.epoch_readings(seeded.load_state(run_dir, first - 2),
                                          seeded.load_state(run_dir, first - 1), sizing, ref))
    log(f"reference epoch {first - 1}")
    del ref
    ref = rtrain.follow_epoch(fmc_r, ftc_r, ref_corpus, items, run_dir, first, dev)
    resumed = rtrain.epoch_readings(seeded.load_state(run_dir, first - 1),
                                    seeded.load_state(run_dir, "measured"), None, ref)
    readings.update({f"resumed.{k}": v for k, v in resumed.items()})
    log(f"reference epoch {first}, from the program's checkpoint {first - 1}")
    print(f"portbench: readings {json.dumps(readings)}", file=sys.stderr, flush=True)
    shutil.rmtree(run_dir, ignore_errors=True)  # the checkpoints, read
    checks = make_checks(cell.workload["limits"], readings)
    ctx = {
        "kind": "train", "summary": summary, "epochs": epochs, "window_s": window_s,
        "steps_per_epoch": steps_per_epoch, "flops_per_step": flops_per_step,
        "busy_s": timeline["busy_s"] if timeline else None,
        "trace_window_s": timeline["window_s"] if timeline else None,
        "corpus_s": corpus_s, "corpus_bound_s": corpus_bound_s(fmc_r, n_presets),
        "graph_capture_s": summary["graph_capture_s"],
    }
    return Outcome(
        correct=all(v <= lim for _, v, lim in checks),
        attempted=epochs * items_per_epoch, failed=0,
        end_to_end={"train_items_per_s": items_per_epoch / summary["epoch_s"],
                    "setup_s": setup_s, "peak_device_gib": peak / 2**30},
        ctx=ctx, checks=checks, peak_bytes=peak, **trace_fields(timeline))

