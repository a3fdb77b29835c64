"""Dump the TensorBoard figure set of a run trained by the port as PNGs.
Counterpart of ``scripts/dump_figures.py``.

    python -m preset_gen_vae_tpu_torch.scripts.dump_figures RUN_DIR \\
        [--data-root DIR] [--device cuda]

Loads the run's frozen ``config.json`` and its latest checkpoint, runs the
first 6 validation batches through the eval step (the real rows; the
padding of the last batch is dropped) and draws the loop's four figure
families (reference: utils/figures.py via train.py:286-313) into
``RUN_DIR/figures/``: ``spectrograms.png``, ``latent_mu.png``,
``latent_entanglement.png``, ``synth_param_error.png``. The corpus is the
JAX script's, 30,720 synthetic presets (``N_PRESETS``). The options beyond
the JAX script's run directory name the corpus cache root and the device.
Needs matplotlib, which is imported when the figures are drawn.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib

import numpy as np

from .. import config as cfg
from ..data.pipeline import get_split_loaders
from ..device import resolve_device
from ..logs.logger import load_checkpoint
from ..logs.metrics import LatentMetric
from ..models.build import build_extended_ae_model
from ..training.loop import prepare_dataset
from ..training.train_step import Criteria, eval_step

N_PRESETS = 30720
N_BATCHES = 6


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description="Draw a run's figures as PNGs")
    ap.add_argument("run_dir", help="the run directory (its config.json and checkpoints)")
    ap.add_argument("--data-root", default=None,
                    help="corpus cache root (default: $PGV_TPU_DATA_DIR or data_cache/)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    import matplotlib.pyplot as plt

    from ..utils import figures

    run = pathlib.Path(args.run_dir).resolve()
    model_c, train_c = cfg.load_config(run / "config.json")
    # the checkpoints of RUN_DIR, wherever the run was trained
    model_c = dataclasses.replace(model_c, logs_root_dir=str(run.parent.parent))
    kw = {"n_synthetic_presets": N_PRESETS}
    if args.data_root:
        kw["data_root"] = args.data_root
    model_c, train_c, dataset = prepare_dataset(*cfg.resolve(model_c, train_c), dev,
                                                dataset_kwargs=kw)
    helper = dataset.preset_indexes_helper
    loader = get_split_loaders(dataset, train_c)["validation"]
    model = build_extended_ae_model(model_c, train_c, helper).to(dev)
    ckpt = load_checkpoint(model_c, -1)
    model.load_state_dict(ckpt["state"]["model"])
    print(f"checkpoint epoch {ckpt['epoch']}")

    criteria = Criteria(model_c, train_c, helper)
    lat, v_errors, first = LatentMetric(model_c.dim_z), [], None
    for i, sel in enumerate(loader.epoch_index_batches(0)):
        if i >= N_BATCHES:
            break
        n_real = min(loader.batch_size, loader.n_items - i * loader.batch_size)
        x, v, info = loader.gather(sel)
        m = eval_step(model, criteria, train_c, x, v, info)
        lat.append(m["z0_mu"][:n_real].cpu().numpy(), m["z0"][:n_real].cpu().numpy())
        v_errors.append((m["v_out"].float() - v)[:n_real].cpu().numpy())
        if first is None:
            first = (x.float().cpu().numpy(), m["x_out"].float().cpu().numpy(),
                     info.cpu().numpy())

    out_dir = run / "figures"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, (fig, _) in (
            ("spectrograms.png", figures.plot_train_spectrograms(*first)),
            ("latent_mu.png", figures.plot_latent_distributions_stats(lat)),
            ("latent_entanglement.png", figures.plot_spearman_correlation(lat)),
            ("synth_param_error.png",
             figures.plot_synth_preset_error(np.concatenate(v_errors), helper))):
        fig.savefig(out_dir / name, dpi=90, bbox_inches="tight")
        plt.close(fig)
        paths.append(out_dir / name)
        print("wrote", out_dir / name)
    return paths


if __name__ == "__main__":
    main()
