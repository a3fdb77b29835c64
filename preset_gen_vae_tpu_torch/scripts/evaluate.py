"""Evaluate saved runs. Counterpart of the root ``eval.py`` (reference:
eval.py:278-284).

    python -m preset_gen_vae_tpu_torch.scripts.evaluate [MODEL/RUN ...] \\
        [--n-presets N --style S --synthetic-seed K] [--device cuda] \\
        [--data-root DIR] [--logs-root saved]

The ``EvalConfig`` is the JAX script's: ``models_names=()``, the
validation split; the names given replace ``models_names``. A run that
has an evaluation of the split already is skipped (``evaluate_all_models``).
The frozen ``config.json`` of a run does not carry its synthetic corpus:
``--n-presets``, ``--style`` and ``--synthetic-seed`` give the dataset's
``n_synthetic_presets``, ``synthetic_style`` and ``synthetic_seed`` (as the
JAX package's ``scripts/eval_saved_r5.py`` passes them), each left at the
dataset's default unless given. For each run evaluated it prints the
per-preset means' columns as count, mean, std, min and max (NaNs left
out), in place of the JAX script's ``df.describe()``, and last the
kernels' launches.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict

import numpy as np

from .. import config as cfg
from .._native import REPO_ROOT
from ..device import resolve_device
from ..evaluation.evaluate import evaluate_all_models
from ..ops import spectrogram as sp
from ..synth import fm_torch as ft

STATS = ("count", "mean", "std", "min", "max")


def describe(table: Dict[str, np.ndarray]) -> str:
    """Each column's count, mean, std (n - 1), min and max over its
    non-NaN values: the rows of pandas' ``describe()`` without the
    quartiles."""
    width = max(len(k) for k in table)
    lines = [" " * width + "".join(f"{s:>14}" for s in STATS)]
    for k, col in table.items():
        col = np.asarray(col, dtype=np.float64)
        col = col[~np.isnan(col)]
        n = len(col)
        stats = (n, col.mean(), col.std(ddof=1) if n > 1 else np.nan, col.min(), col.max()) \
            if n else (0, np.nan, np.nan, np.nan, np.nan)
        lines.append(f"{k:<{width}}" + "".join(f"{v:>14.6g}" for v in stats))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Evaluate saved runs")
    ap.add_argument("models_names", nargs="*", metavar="MODEL/RUN",
                    help="runs to evaluate (default: EvalConfig's models_names)")
    ap.add_argument("--n-presets", type=int, default=None,
                    help="the synthetic corpus's n_synthetic_presets")
    ap.add_argument("--style", default=None, help="the synthetic corpus's synthetic_style")
    ap.add_argument("--synthetic-seed", type=int, default=None,
                    help="the synthetic corpus's synthetic_seed")
    ap.add_argument("--data-root", default=None,
                    help="corpus cache root (default: $PGV_TPU_DATA_DIR or data_cache/)")
    ap.add_argument("--logs-root", default="saved", help="runs directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    eval_config = cfg.EvalConfig(models_names=(), dataset="validation")
    if args.models_names:
        eval_config.models_names = tuple(args.models_names)
    dataset_kwargs = {k: v for k, v in (("n_synthetic_presets", args.n_presets),
                                        ("synthetic_style", args.style),
                                        ("synthetic_seed", args.synthetic_seed),
                                        ("data_root", args.data_root)) if v is not None}
    saved_root = pathlib.Path(args.logs_root)
    if not saved_root.is_absolute():  # as get_run_dir resolves logs_root_dir
        saved_root = REPO_ROOT / saved_root
    results = evaluate_all_models(eval_config, saved_root=saved_root, device=args.device,
                                  dataset_kwargs=dataset_kwargs or None)
    for table in results:
        print(describe(table), flush=True)
    print(json.dumps({"launches": {k: n for k, n in {**sp.LAUNCHES, **ft.LAUNCHES}.items()
                                   if n}}), flush=True)
    return results


if __name__ == "__main__":
    main()
