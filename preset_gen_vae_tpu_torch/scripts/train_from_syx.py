"""Real-data path, end to end: DX7 ``.syx`` cartridges -> a SQLite preset
database in the reference schema -> ``DexedDataset(db_path=)`` -> training
-> evaluation. Counterpart of ``scripts/train_from_syx.py``: the recipe a
user with real DX7 banks follows (reference flow: synth/dexed.py:65-102,
dexeddataset.py:28-167, train.py:188-329, eval.py:65-243).

    python -m preset_gen_vae_tpu_torch.scripts.train_from_syx BANK1.syx BANK2.syx ... \\
        [--run-name syxrun] [--epochs 400] [--db out.sqlite] [--no-eval] \\
        [--data-root DIR] [--logs-root saved] [--device cuda]

Each ``.syx`` holds 32 packed voices per bank (``synth/sysex.py``). The
flagship trains on the database with the default ``ModelConfig`` (the
``'cpp'`` corpus render, cached on ``'disk'`` under the data root, so the
evaluation reloads the corpus instead of rendering it again), then the last
checkpoint is evaluated on the validation split with the default
``EvalConfig`` (the re-render on the card). One JSON line per phase:
``import``, ``train``, ``eval``. The configs are the defaults, as in the
JAX script; the options beyond its own name the paths and the device.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import time

from ..config import EvalConfig, ModelConfig, TrainConfig
from ..evaluation.evaluate import evaluate_model
from ..logs.logger import get_run_dir, list_checkpoint_epochs
from ..synth.sysex import import_syx_banks
from ..training.loop import train_config


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Train the flagship model on DX7 cartridges")
    ap.add_argument("syx", nargs="+", help=".syx cartridge files")
    ap.add_argument("--db", default=None,
                    help="SQLite output path (default: <first bank>_<run name>.sqlite)")
    ap.add_argument("--run-name", default="syxrun")
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--eval", action="store_true", default=True)
    ap.add_argument("--no-eval", dest="eval", action="store_false")
    ap.add_argument("--data-root", default=None,
                    help="corpus cache root (default: $PGV_TPU_DATA_DIR or data_cache/)")
    ap.add_argument("--logs-root", default="saved", help="runs directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    db_path = pathlib.Path(args.db or pathlib.Path(args.syx[0]).with_suffix("").as_posix()
                           + f"_{args.run_name}.sqlite")
    t0 = time.time()
    presets, _, labels = import_syx_banks(args.syx, out_sqlite=db_path)
    print(json.dumps({"phase": "import", "voices": len(presets), "banks": len(args.syx),
                      "db": str(db_path), "labels": dict(collections.Counter(labels)),
                      "wall_s": time.time() - t0}), flush=True)

    model_c = ModelConfig(run_name=args.run_name, logs_root_dir=args.logs_root)
    train_c = TrainConfig(n_epochs=args.epochs)
    dataset_kwargs = {"db_path": str(db_path)}
    if args.data_root:
        dataset_kwargs["data_root"] = args.data_root
    t0 = time.time()
    # TensorBoard is optional in the port (logs/tbwriter.py raises where it
    # is not installed): the phases' JSON lines are this script's record
    summary = train_config(model_c, train_c, device=args.device, dataset_kwargs=dataset_kwargs,
                           use_tensorboard=False)
    print(json.dumps({"phase": "train", "wall_s": time.time() - t0, **summary}), flush=True)

    if args.eval:
        ep = list_checkpoint_epochs(model_c)[-1]
        eval_c = EvalConfig(epoch=ep, dataset="validation", override_previous_eval=True)
        t0 = time.time()
        evaluate_model(model_c, train_c, eval_c, device=args.device,
                       dataset_kwargs=dataset_kwargs)
        with open(get_run_dir(model_c) / "eval_validation_summary.json") as f:
            s = json.load(f)
        print(json.dumps({"phase": "eval", "epoch": ep, "wall_s": time.time() - t0, **s}),
              flush=True)


if __name__ == "__main__":
    main()
