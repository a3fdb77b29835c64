"""The per-item spread of a port run's validation eval, and the same
checkpoint evaluated again on the C++ engine.

    python3 scripts/eval_items_report.py RUN_DIR OUT_DIR [--n-presets 8192]
        [--style structured2] [--device cuda]

Copies the run's ``config.json``, ``eval_validation_summary.json`` and
``eval_validation.items.npz`` into ``OUT_DIR`` and prints, for each audio
and parameter metric, the mean, the mean without the worst 1% of items,
quantiles and the worst items. Then evaluates the run's last checkpoint on
the validation split with ``audio_render_backend='cpp'`` (the run dir's
eval artifacts are overwritten; their copies stay in ``OUT_DIR`` beside
the C++ engine's, ``*.cpp.*``) and prints the same. The corpus options
must be the run's own: ``config.json`` does not carry them.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from preset_gen_vae_tpu_torch import config as cfg  # noqa: E402
from preset_gen_vae_tpu_torch.evaluation.evaluate import evaluate_model_from_dir  # noqa: E402

METRICS = ("spec_mae", "spec_sc", "mfcc13_mae", "mfcc40_mae", "num_mae", "acc")


def describe(tag: str, items) -> None:
    print(f"[{tag}] n {len(items['preset_UID'])}", flush=True)
    for k in METRICS:
        v = np.sort(np.asarray(items[k], np.float64))
        cut = -(-len(v) // 100)  # the worst 1%, rounded up
        q = np.quantile(v, [0.1, 0.25, 0.5, 0.75, 0.9, 0.99])
        print(f"[{tag}] {k}: mean {v.mean():.5f} trimmed-1% mean {v[:-cut].mean():.5f} "
              f"quantiles 10/25/50/75/90/99 {np.round(q, 5).tolist()} max {v[-1]:.5f} "
              f"top-1% mean {v[-cut:].mean():.5f}", flush=True)
    for i in np.argsort(-np.asarray(items["spec_mae"]))[:12]:
        print(f"[{tag}] worst uid {int(items['preset_UID'][i])} spec_mae "
              f"{float(items['spec_mae'][i]):.4f} spec_sc {float(items['spec_sc'][i]):.3f} "
              f"num_mae {float(items['num_mae'][i]):.4f} acc {float(items['acc'][i]):.1f}",
              flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", type=pathlib.Path)
    ap.add_argument("out_dir", type=pathlib.Path)
    ap.add_argument("--n-presets", type=int, default=8192)
    ap.add_argument("--style", default="structured2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run, out = args.run_dir, args.out_dir
    out.mkdir(parents=True, exist_ok=True)
    for f in ("config.json", "eval_validation_summary.json", "eval_validation.items.npz"):
        shutil.copy(run / f, out / f)
    describe("jax render", np.load(out / "eval_validation.items.npz"))
    eval_c = cfg.EvalConfig(dataset="validation", audio_render_backend="cpp",
                            override_previous_eval=True)
    evaluate_model_from_dir(run, eval_c, device=args.device, dataset_kwargs={
        "n_synthetic_presets": args.n_presets, "synthetic_style": args.style})
    shutil.copy(run / "eval_validation_summary.json", out / "eval_validation_summary.cpp.json")
    shutil.copy(run / "eval_validation.items.npz", out / "eval_validation.items.cpp.npz")
    with open(out / "eval_validation_summary.cpp.json") as f:
        print(f"[cpp render] summary {json.dumps(json.load(f))}", flush=True)
    describe("cpp render", np.load(out / "eval_validation.items.cpp.npz"))


if __name__ == "__main__":
    main()
