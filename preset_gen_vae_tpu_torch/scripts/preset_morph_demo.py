"""Latent-space sound morphing on the full-scale flagship checkpoint
(``FlVAE2/r2full400``): slerp an 11-point path between two presets, decode
every point to a playable preset, render it on the C++ engine, export the
presets and the wavs, and report the path's audio smoothness
(consecutive-pair spectral distances against the direct endpoint
distance). Counterpart of ``scripts/preset_morph_demo.py``.

    python -m preset_gen_vae_tpu_torch.scripts.preset_morph_demo [uid_a uid_b] \\
        [--logs-root saved] [--data-root DIR] [--device cuda]

The run's frozen ``config.json`` gives the model and the dataset (for
``r2full400``, the default configs the JAX demo builds); its last
checkpoint is loaded. The corpus is the JAX demo's, 30,720 synthetic
presets. Without UIDs the path joins the 8th and the 14th preset. The
options beyond the JAX demo's UIDs name the paths and the device. Writes
``morph_demo/presets.npy``, ``morph_demo/morph_NN.wav`` and
``morph_demo_summary.json`` into the run dir and prints the summary as one
JSON line: ``direct_spec_mae``, ``step_spec_mae_mean``,
``step_spec_mae_max``, ``smooth``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from .. import config as cfg
from ..device import resolve_device
from ..evaluation.interpolate import interpolate_presets
from ..evaluation.similarity import batched_audio_errors
from ..logs.logger import get_run_dir
from ..training.loop import prepare_dataset
from ..utils.audio_io import write_wav

RUN_NAME = "r2full400"
N_STEPS = 11
N_PRESETS = 30720


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Morph between two presets in the latent space")
    ap.add_argument("uids", nargs="*", type=int, help="the two preset UIDs")
    ap.add_argument("--logs-root", default="saved", help="runs directory")
    ap.add_argument("--data-root", default=None,
                    help="corpus cache root (default: $PGV_TPU_DATA_DIR or data_cache/)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if len(args.uids) not in (0, 2):
        ap.error("give two UIDs or none")

    t0 = time.time()
    dev = resolve_device(args.device)
    run = cfg.ModelConfig(run_name=RUN_NAME, logs_root_dir=args.logs_root)
    model_c, train_c = cfg.load_config(get_run_dir(run) / "config.json")
    model_c = dataclasses.replace(model_c, logs_root_dir=args.logs_root)
    kw = {"n_synthetic_presets": N_PRESETS}
    if args.data_root:
        kw["data_root"] = args.data_root
    model_r, train_r, dataset = prepare_dataset(*cfg.resolve(model_c, train_c), dev,
                                                dataset_kwargs=kw)
    uid_a, uid_b = args.uids or (int(dataset.uids[7]), int(dataset.uids[13]))
    full, wavs = interpolate_presets(model_c, train_c, uid_a, uid_b, n_steps=N_STEPS,
                                     dataset=dataset, device=dev)
    # consecutive-pair spectral distances along the path against the direct
    # endpoint distance: a usable morph moves gradually
    w = torch.from_numpy(wavs).to(dev)
    step_d = batched_audio_errors(w[:-1], w[1:])["spec_mae"].cpu().numpy()
    direct = float(batched_audio_errors(w[:1], w[-1:])["spec_mae"][0])

    run_dir = get_run_dir(model_r)
    out_dir = run_dir / "morph_demo"
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / "presets.npy", full)
    for i, wav in enumerate(wavs):
        write_wav(out_dir / f"morph_{i:02d}.wav", wav, dataset.sample_rate)
    summary = {
        "uid_a": uid_a, "uid_b": uid_b, "n_steps": N_STEPS,
        "direct_spec_mae": direct,
        "step_spec_mae_mean": float(step_d.mean()),
        "step_spec_mae_max": float(step_d.max()),
        "smooth": bool(step_d.max() < direct),
        "wall_s": time.time() - t0,
        "out_dir": str(out_dir),
    }
    with open(run_dir / "morph_demo_summary.json", "w") as f:
        json.dump(summary, f)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
