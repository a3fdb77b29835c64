"""Train a queue of runs one after another. Counterpart of the root
``train_queue.py`` (reference: train_queue.py:24-119).

    python -m preset_gen_vae_tpu_torch.scripts.train_queue [--no-tensorboard] \\
        [--device cuda] [--data-root DIR] [--logs-root saved]

Each entry of ``run_mods`` is a pair of overrides of the default
``ModelConfig`` and ``TrainConfig``; edit the list to enqueue runs. A run
whose losses turn NaN is restarted on another seed (``training/queue.py``).
Each run's summary is printed. The options name the device and the paths,
and turn TensorBoard off: without ``--no-tensorboard`` a run raises
``ImportError`` where tensorboard is not installed.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

from .. import config as cfg
from ..device import resolve_device
from ..training.queue import run_queue

# Edit this list to enqueue runs (reference: train_queue.py:24-44)
run_mods = [
    ({"run_name": "queued_run0"}, {}),
]


def main(argv=None, run_mods=run_mods, dataset_kwargs: Optional[Dict] = None):
    """``dataset_kwargs`` go to every run's dataset, after ``--data-root``."""
    ap = argparse.ArgumentParser(description="Train a queue of runs")
    ap.add_argument("--no-tensorboard", dest="tensorboard", action="store_false",
                    help="write no TensorBoard events")
    ap.add_argument("--data-root", default=None,
                    help="corpus cache root (default: $PGV_TPU_DATA_DIR or data_cache/)")
    ap.add_argument("--logs-root", default="saved", help="runs directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    kwargs = {"data_root": args.data_root} if args.data_root else {}
    kwargs.update(dataset_kwargs or {})
    summaries = run_queue(run_mods, base_model=cfg.ModelConfig(logs_root_dir=args.logs_root),
                          k_folds_fanout=False, device=args.device, dataset_kwargs=kwargs or None,
                          use_tensorboard=args.tensorboard)
    for s in summaries:
        print(s)
    return summaries


if __name__ == "__main__":
    main()
