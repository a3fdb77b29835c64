"""The 3-note stacked flagship on the structured2 corpus, trained and then
evaluated in one process: the protocol that produced the JAX package's
``saved/FlVAE2/r4stack3_v2_8192/``. Counterpart of
``scripts/run_stack3_v2_r4.py``.

    python -m preset_gen_vae_tpu_torch.scripts.run_stack3_v2 [n_presets] [epochs] \\
        [--resume] [--device cuda] [--data-root DIR] [--logs-root saved]

The protocol is the JAX script's: ``n_presets`` (8,192) ``structured2``
presets from seed 0, the notes (40, 85), (50, 85) and (60, 85) stacked as
channels, the corpus rendered on the card (F1, F2 and K1, ``'jax'``) and
kept there (``'device'``), ``epochs`` (400) epochs with a checkpoint every
``epochs // 2``, ``verbosity`` 0; then the last checkpoint is evaluated on
the validation split with the default re-render, on the same dataset.

The run is ``FlVAE2/torch_stack3_v2_<n_presets>``. It never takes the JAX
run's name: a new run erases its directory, and the JAX package's
``r4stack3_v2_8192`` is the yardstick this run is held against.
``--resume`` restarts from the run's last checkpoint through the loop's own
resume (``start_epoch``); a run whose last checkpoint ends it (the last
epoch, or an early stop) goes straight to the evaluation. TensorBoard is
off. The options beyond the JAX script's argv name the paths and the
device.

Prints one JSON line per phase (``corpus``, ``train``, ``eval``) and, last,
one line with the JAX script's keys, the card's name and power limit, the
peak device memory and the kernels' launches by phase. ``run_protocol`` is
also the body of the six-note protocol (``run_6note.py``), of the
default-config style comparison (``compare_corpus_styles.py``) and of the
FlowParamsLoss runs (``run_flowloss.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Dict, Optional, Tuple

import torch

from .. import config as cfg
from ..device import resolve_device
from ..evaluation.evaluate import evaluate_model
from ..logs.logger import get_run_dir, list_checkpoint_epochs, load_checkpoint
from ..ops import spectrogram as sp
from ..synth import fm_torch as ft
from ..training.loop import prepare_dataset, train_config

RUN_PREFIX = "torch_stack3_v2_"
MIDI_NOTES = ((40, 85), (50, 85), (60, 85))
STYLE = "structured2"


def run_configs(n_presets: int, epochs: int, logs_root: str = "saved"
                ) -> Tuple[cfg.ModelConfig, cfg.TrainConfig]:
    """The JAX script's configs, under the port's run name."""
    model_c = cfg.ModelConfig(
        run_name=f"{RUN_PREFIX}{n_presets}", midi_notes=MIDI_NOTES, stack_spectrograms=True,
        dataset_corpus_render_backend="jax", dataset_corpus_cache_policy="device",
        logs_root_dir=logs_root)
    train_c = cfg.TrainConfig(n_epochs=epochs, save_period=max(epochs // 2, 1), verbosity=0)
    return model_c, train_c


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def launches() -> Dict[str, int]:
    """The port's kernel launches so far in this process, those made."""
    return {k: n for k, n in {**sp.LAUNCHES, **ft.LAUNCHES}.items() if n}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before.get(k, 0) for k, n in launches().items() if n != before.get(k, 0)}


def _peak_gib(dev: torch.device) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0


def _print(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def protocol_options(ap: argparse.ArgumentParser, positional: bool = True
                     ) -> argparse.ArgumentParser:
    """The protocol's arguments after the caller's own: ``n_presets`` and
    ``epochs`` (unless the caller names them itself), ``--resume`` and the
    paths and device."""
    if positional:
        ap.add_argument("n_presets", nargs="?", type=int, default=8192)
        ap.add_argument("epochs", nargs="?", type=int, default=400)
    ap.add_argument("--resume", action="store_true",
                    help="restart from the run's last checkpoint")
    ap.add_argument("--data-root", default=None,
                    help="corpus cache root (default: $PGV_TPU_DATA_DIR or data_cache/)")
    ap.add_argument("--logs-root", default="saved", help="runs directory")
    ap.add_argument("--device", default="cuda")
    return ap


def corpus_phase(args: argparse.Namespace, model_c: cfg.ModelConfig, train_c: cfg.TrainConfig,
                 style: str = STYLE):
    """The corpus pass of ``args.n_presets`` presets of ``style``, once for
    every training and evaluation on it; prints its JSON line and returns
    (dataset, wall s, launches)."""
    dev = resolve_device(args.device)
    dataset_kwargs = {"n_synthetic_presets": args.n_presets, "synthetic_style": style}
    if args.data_root:
        dataset_kwargs["data_root"] = args.data_root
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before, t0 = launches(), time.time()
    _, _, dataset = prepare_dataset(*cfg.resolve(model_c, train_c), dev, None, dataset_kwargs)
    dataset.load_corpus()  # else the loop's first gather renders it
    corpus_s, by_phase = time.time() - t0, _since(before)
    _print("corpus", wall_s=corpus_s, pass_s=dataset.corpus_seconds,
           render_s=dataset.render_seconds, presets=dataset.valid_presets_count,
           peak_gib=_peak_gib(dev), launches=by_phase)
    return dataset, corpus_s, by_phase


def run_protocol(args: argparse.Namespace, model_c: cfg.ModelConfig, train_c: cfg.TrainConfig,
                 tags: dict, style: str = STYLE, dataset=None, render_audio: bool = True,
                 phase_tags: Optional[dict] = None, record: Optional[dict] = None) -> dict:
    """The quality protocol on ``args`` (``protocol_options``): the corpus
    pass once (unless ``dataset`` holds one already), training (or its
    resume), then the last checkpoint evaluated on the validation split of
    the same dataset, re-rendering unless ``render_audio`` is False. Prints
    a JSON line per phase, ``phase_tags`` first in the training's and the
    evaluation's, and, last, the run's line, ``tags`` after its
    ``midi_notes``; ``record``, if given, receives the training's summary
    and the evaluation's as ``train`` and ``eval``. ``prepare_dataset``,
    ``train_config`` and ``evaluate_model`` are this module's names,
    whichever script calls."""
    dev = resolve_device(args.device)
    phase_tags = phase_tags or {}

    train_needed = True
    if args.resume:  # raises FileNotFoundError where the run has no checkpoint
        last = load_checkpoint(model_c)
        train_r = cfg.resolve(model_c, train_c)[1]  # un-stacked notes divide the epochs
        train_needed = not (last["epoch"] == train_r.n_epochs - 1
                            or last["scheduler"]["lr"] < train_r.early_stop_lr_threshold)
        train_c = dataclasses.replace(train_c, start_epoch=last["epoch"] + 1)

    by_phase, corpus_s = {}, 0.0
    if dataset is None:
        dataset, corpus_s, by_phase["corpus"] = corpus_phase(args, model_c, train_c, style)
    elif dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    summary, train_s = {}, 0.0
    if train_needed:
        before, t0 = launches(), time.time()
        summary = train_config(model_c, train_c, dataset=dataset, device=dev,
                               use_tensorboard=False)
        train_s, by_phase["train"] = time.time() - t0, _since(before)
        _print("train", **phase_tags, wall_s=train_s, **summary)

    ep = list_checkpoint_epochs(model_c)[-1]
    eval_c = cfg.EvalConfig(epoch=ep, dataset="validation", override_previous_eval=True)
    before, t0 = launches(), time.time()
    phases = {}
    # render_audio passed only when off: the other protocols' call stays as it was
    evaluate_model(model_c, train_c, eval_c, device=dev, dataset=dataset, phase_seconds=phases,
                   **({} if render_audio else {"render_audio": False}))
    eval_s, by_phase["eval"] = time.time() - t0, _since(before)
    with open(get_run_dir(model_c) / "eval_validation_summary.json") as f:
        s = json.load(f)
    _print("eval", **phase_tags, epoch=ep, wall_s=eval_s, phase_seconds=phases, **s)
    if record is not None:
        record.update(train=summary, eval=s)

    out = {
        "run": model_c.run_name, "n_presets": args.n_presets, "style": style,
        "midi_notes": len(model_c.midi_notes), **tags,
        "epochs_trained": summary.get("epochs_trained"),
        "train_wall_s": train_s, "eval_wall_s": eval_s, **s,
        "resumed_from_epoch": train_c.start_epoch if args.resume else None,
        "early_stop": summary.get("early_stop"), "epoch_s": summary.get("epoch_s"),
        "step_ms": summary.get("step_ms"), "corpus_s": corpus_s,
        "peak_gib": _peak_gib(dev), "launches": by_phase, "card": card_line(),
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> dict:
    ap = protocol_options(argparse.ArgumentParser(
        description="Train and evaluate the 3-note stacked flagship"))
    args = ap.parse_args(argv)
    model_c, train_c = run_configs(args.n_presets, args.epochs, args.logs_root)
    return run_protocol(args, model_c, train_c, {"stacked": True})


if __name__ == "__main__":
    main()
