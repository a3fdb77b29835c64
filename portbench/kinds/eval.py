"""Traffic kind ``eval``: whole evaluation passes over the validation split
through the port's public entry, ``evaluation.evaluate.evaluate_model``,
on a corpus that set-up built, from a checkpoint of weights made from the
seed.

Set-up: the dataset and its corpus pass; the seeded start written as the
run's checkpoint 0 (``reference/seeded.py``); the first pass, which warms
up every shape (cuDNN's search, the FM kernels' build and first launch).
The window: passes, each the model's build and checkpoint load, batched
inference, the re-render of the ground truth and of the inferred presets on
the card (``audio_render_backend='jax'``, ``audio_batch_size`` items a
call), the similarity and the artifacts, until ``--seconds`` have passed.
``eval_items_per_s`` is the items of all the window's passes over its whole
wall.

With ``--trace 1``, two more passes run under the profiler once the window
has closed: the device's busy time and the breakdown come from them, the
phase times from the untraced window.

Correctness, once the window has closed: the window's last pass's per-item table
(``eval_validation.items.npz``) and latents against the reference's pass
(``reference/evaluate.py``), and a sample of the served corpus rows
(``reference/corpus.py``)."""

from __future__ import annotations

import gc
import json
import shutil
import sys
import time

import numpy as np
import torch

from ..reference import corpus as rcorpus
from ..reference import evaluate as reval
from ..reference import presets as rp
from ..reference import seeded
from . import Outcome, PhaseLog, configs, corpus_bound_s, make_checks, trace_fields

TRACE_PASSES = 2  # the passes that a traced run reads from the trace


def render_bound_s(model_c, rows: int) -> float:
    """The least time the card could take for F1 and F2 over ``rows``
    renders (``work.py``)."""
    from ..reference.presets import samples_per_note
    from ..work import BLOCK, bound_s, fm_control_work, fm_exact_work

    n = samples_per_note(model_c)
    return bound_s([fm_control_work(rows, n // BLOCK), fm_exact_work(rows, n)])


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, runs_root,
        device="cuda", dataset=None) -> Outcome:
    """One run of an eval cell; ``dataset``, a dataset already built for
    this cell and seed, is for tests on the CPU."""
    from preset_gen_vae_tpu_torch import config as cfg
    from preset_gen_vae_tpu_torch.evaluation.evaluate import evaluate_model, items_path
    from preset_gen_vae_tpu_torch.training.loop import prepare_dataset

    from ..trace import Tracer

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    log = PhaseLog(t_start)
    model_c, train_c, fmc, ftc = configs(cell, seed, runs_root)
    data = cell.config["dataset"]
    n_presets, style = int(data["n_synthetic_presets"]), data["synthetic_style"]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if dataset is None:
        _, _, dataset = prepare_dataset(model_c, train_c, dev, None,
                                        {**data, "synthetic_seed": int(seed)})
        dataset.load_corpus()
    log("corpus pass")
    facts = rp.make_corpus(fmc, ftc, n_presets, style, seed, with_presets=False)
    fmc_r, ftc_r = rp.resolved_configs(fmc, ftc, facts)
    run_dir = runs_root / model_c.name / model_c.run_name
    start_model = seeded.reference_model(fmc_r, ftc_r, facts.helper, dev)
    seeded.seed_weights(start_model, seed)
    seeded.write_start(run_dir, fmc_r, ftc_r, start_model, seed, dev)
    del start_model
    log("seeded start")
    eval_c = cfg.EvalConfig(epoch=0, dataset="validation", override_previous_eval=True,
                            audio_batch_size=int(cell.traffic["audio_batch_size"]))

    def one_pass(phases: dict, latents: dict) -> None:
        evaluate_model(model_c, train_c, eval_c, device=dev, dataset=dataset,
                       phase_seconds=phases, latents=latents)

    one_pass({}, {})
    log("first pass")

    # ---- the window: whole passes until --seconds have passed
    passes, latents = [], {}
    t0 = time.perf_counter()
    while not passes or time.perf_counter() - t0 < seconds:
        phases = {}
        one_pass(phases, latents)
        passes.append(phases)
    if cuda:
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    window_s = t_end - t0
    setup_s = t0 - t_start
    log(f"window ({len(passes)} passes)")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    n_items = len(latents["z0"])
    table = dict(np.load(items_path(run_dir, "validation")))

    # ---- traced: passes like the window's under the profiler, once the
    # window has closed (the timed window stays untraced)
    timeline = None
    if trace:
        with Tracer() as tracer:
            tracer.mark("passes")
            t_traced = time.perf_counter()
            for _ in range(TRACE_PASSES):
                one_pass({}, {})
            torch.cuda.synchronize(dev)
            t_traced_end = time.perf_counter()
        timeline = tracer.read(t_traced, t_traced_end)
        log(f"traced passes ({TRACE_PASSES})")
    # ---- correctness
    corpus_s = dataset.corpus_seconds
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_corpus = rp.make_corpus(fmc, ftc, n_presets, style, seed)
    served = dataset.load_corpus()
    readings = rcorpus.readings(fmc_r, served, dataset.spec_stats, ref_corpus.presets, seed,
                                int(cell.workload["sample_presets"]))
    log("reference corpus rows")
    items = dataset.corpus_tensors()["x"]
    ref = reval.inference(fmc_r, ftc_r, ref_corpus, items, run_dir, 0, dev)
    prog = {"z0": latents["z0"], "zK": latents["zK"],
            **{k: table[k] for k in reval.PARAM_METRICS}}
    readings.update(reval.latent_readings(prog, ref))
    rows = reval.sample_rows(n_items, seed, int(cell.workload["sample_items"]))
    ref_audio = reval.audio_errors(fmc_r, ftc_r, ref_corpus, latents["zK"], rows, run_dir, 0,
                                   dev)
    readings.update(reval.audio_readings({k: table[k][rows] for k in reval.AUDIO_METRICS},
                                         ref_audio))
    log("reference pass")
    print(f"portbench: readings {json.dumps(readings)}", file=sys.stderr, flush=True)
    shutil.rmtree(run_dir, ignore_errors=True)  # the checkpoints, read
    checks = make_checks(cell.workload["limits"], readings)
    mean = {k: float(np.mean([p[k] for p in passes])) for k in passes[0]}
    ctx = {"kind": "eval", "passes": len(passes), "phase_s": mean, "window_s": window_s,
           "items_per_pass": n_items, "busy_s": timeline["busy_s"] if timeline else None,
           "trace_window_s": timeline["window_s"] if timeline else None,
           "render_bound_s": render_bound_s(fmc_r, 2 * n_items),
           "corpus_s": corpus_s, "corpus_bound_s": corpus_bound_s(fmc_r, n_presets)}
    return Outcome(
        correct=all(v <= lim for _, v, lim in checks),
        attempted=len(passes) * n_items, failed=0,
        end_to_end={"eval_items_per_s": len(passes) * n_items / window_s,
                    "setup_s": setup_s, "peak_device_gib": peak / 2**30},
        ctx=ctx, checks=checks, peak_bytes=peak, **trace_fields(timeline))
