"""The controls of a cell, and the planted faults of a train cell, read on
the card at the cell's own size; the benchmark's own runs never run this.

    python -m portbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed: the program's corpus pass (the feed both sides read), the
seeded start, then the reference (a train cell's sizing epoch, in the
configuration's precision; an eval cell's pass, in float32) and, in the
program's place,

- ``control_corpus``: the reference's corpus rows from bfloat16 waveforms;
- ``control``: the reference with fp8 products (``reference/lowp.py``):
  a train cell's epoch, an eval cell's inference; for an eval cell's audio,
  the reference's audio rounded to bfloat16 before the similarity;
- ``half_batch`` (train cells): the reference with each step on the first
  half of its batch.

Each prints one JSON line with the numbers that the kind's runner
compares, read against the reference exactly as a run reads the program. The fault "a step that returns its state unchanged" reads 1 on
``param_change_gap`` by its definition and needs no run."""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys

import torch

from . import registry
from .kinds import configs
from .kinds.train import measured_epoch
from .reference import corpus as rcorpus
from .reference import evaluate as reval
from .reference import lowp
from .reference import presets as rp
from .reference import seeded
from .reference import train as rtrain
from .run import cache_env, runs_root


def as_program(res: rtrain.EpochResult):
    """An epoch of the reference in the form the program leaves one: a
    checkpoint's state and a summary's means."""
    state = {"model": res.model,
             "optimizer": {"state": {i: {"exp_avg_sq": res.exp_avg_sq[n]}
                                     for i, n in enumerate(res.param_names)
                                     if n in res.exp_avg_sq}}}
    summary = {**{f"{k}/Train": v for k, v in res.train.items()},
               **{f"{k}/Valid": v for k, v in res.valid.items()}}
    return state, summary


def eval_control(cell, model_c, train_c, corpus, items, run_dir, seed: int, dev) -> dict:
    """An eval cell's control: fp8 inference against float32, and the
    float32 inference's audio rounded to bfloat16 against itself."""
    ref = reval.inference(model_c, train_c, corpus, items, run_dir, 0, dev)
    ctl = reval.inference(model_c, train_c, corpus, items, run_dir, 0, dev,
                          mode=lowp.fp8_products)
    rows = reval.sample_rows(len(ref["zK"]), seed, int(cell.workload["sample_items"]))
    audio = [reval.audio_errors(model_c, train_c, corpus, ref["zK"], rows, run_dir, 0, dev,
                                bf16_audio=bf16) for bf16 in (False, True)]
    return {"control": {**reval.latent_readings(ctl, ref), **reval.audio_readings(audio[1],
                                                                                   audio[0])}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Controls of a cell, and faults of a train cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--corpus-only", action="store_true", help="the corpus stage's control alone")
    args = ap.parse_args(argv)
    root = pathlib.Path.cwd()
    cache_env(root)
    cell = registry.find_cell(root, args.workload)
    from preset_gen_vae_tpu_torch.training.loop import prepare_dataset

    dev = torch.device(args.device)
    data = cell.config["dataset"]
    n_presets, style = int(data["n_synthetic_presets"]), data["synthetic_style"]
    for seed in args.seeds:
        model_c, train_c, fmc, ftc = configs(cell, seed, runs_root(root, cell.name))
        _, _, dataset = prepare_dataset(model_c, train_c, dev, None,
                                        {**data, "synthetic_seed": int(seed)})
        served = dataset.load_corpus()
        ref_corpus = rp.make_corpus(fmc, ftc, n_presets, style, seed)
        fmc_r, ftc_r = rp.resolved_configs(fmc, ftc, ref_corpus)
        run_dir = runs_root(root, cell.name) / model_c.name / model_c.run_name
        is_eval = cell.traffic["kind"] == "eval"
        epoch = 1 if is_eval else measured_epoch(train_c) - 1  # the epoch a run follows
        start_model = seeded.reference_model(fmc_r, ftc_r, ref_corpus.helper, dev)
        seeded.seed_weights(start_model, seed)
        seeded.write_start(run_dir, fmc_r, ftc_r, start_model, seed, dev, epoch=epoch - 1)
        del start_model
        start = seeded.load_state(run_dir, epoch - 1)
        k = int(cell.workload["sample_presets"])
        line = {"workload": cell.name, "seed": seed,
                "control_corpus": rcorpus.readings(fmc_r, served, dataset.spec_stats,
                                                   ref_corpus.presets, seed, k,
                                                   bf16_audio=True)}
        items = dataset.corpus_tensors()["x"]
        if args.corpus_only:
            pass
        elif is_eval:
            line.update(eval_control(cell, fmc_r, ftc_r, ref_corpus, items, run_dir, seed, dev))
        else:
            ref = rtrain.follow_epoch(fmc_r, ftc_r, ref_corpus, items, run_dir, epoch, dev)
            for name, mode in (("control", lowp.fp8_products), ("half_batch", lowp.half_batch)):
                other = rtrain.follow_epoch(fmc_r, ftc_r, ref_corpus, items, run_dir, epoch, dev,
                                            mode=mode)
                line[name] = rtrain.epoch_readings(start, *as_program(other), ref)
                del other
            del ref
        print(json.dumps(line), flush=True)
        del dataset, served, items
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
