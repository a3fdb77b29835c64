"""The flagship's default configuration trained and evaluated on each
synthetic corpus style under the same settings: the protocol that produced
the JAX package's ``saved/FlVAE2/r3cmp_structured_30720/`` and
``r3cmp_structured2_30720/``. Counterpart of
``scripts/compare_corpus_styles.py``.

    python -m preset_gen_vae_tpu_torch.scripts.compare_corpus_styles \\
        [--n-presets 2048] [--epochs 100] [--styles structured structured2] \\
        [--seed 0] [--resume] [--device cuda] [--data-root DIR] [--logs-root saved]

The configs are the JAX script's: ``ModelConfig`` at its defaults (one
note (60, 85), ``speccnn8l1_bn``, RealNVP latent flow and head, the
corpus rendered on the host by the C++ engine and cached on disk,
``'cpp'``/``'disk'``) and ``TrainConfig(n_epochs=epochs,
save_period=max(epochs // 2, 1), verbosity=0)``; each style's presets go to
the dataset as ``synthetic_style``. The saved runs are its full scale:
``--n-presets 30720 --epochs 400``. Each style is trained, then its last
checkpoint evaluated on the validation split with the default re-render,
on the same dataset.

The runs are ``FlVAE2/torch_cmp_<style>_<n_presets>`` (``..._seed<k>``
for another ``--seed``, ``TrainConfig.seed``), never a JAX run's name.
``--resume`` and the printed lines are those of ``run_stack3_v2``, whose
protocol body this script runs: per style a line per phase and, last, one
line with the JAX script's keys (``style``, ``n_presets``,
``epochs_trained``, ``train_wall_s``, ``eval_wall_s`` and the evaluation's
summary), the card's name and power limit, the peak device memory and the
kernels' launches by phase. A corpus of 30,720 presets holds about 16.4 GB
of tiers under the data root (a float32 raw tier and two float16 ones).
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

from .. import config as cfg
from .run_stack3_v2 import protocol_options, run_protocol

RUN_PREFIX = "torch_cmp_"
STYLES = ("structured", "structured2")


def run_configs(style: str, n_presets: int, epochs: int, logs_root: str = "saved",
                seed: int = 0) -> Tuple[cfg.ModelConfig, cfg.TrainConfig]:
    """The JAX script's configs, under the port's run name."""
    run_name = f"{RUN_PREFIX}{style}_{n_presets}" + (f"_seed{seed}" if seed else "")
    model_c = cfg.ModelConfig(run_name=run_name, logs_root_dir=logs_root)
    train_c = cfg.TrainConfig(n_epochs=epochs, save_period=max(epochs // 2, 1), verbosity=0,
                              seed=seed)
    return model_c, train_c


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(
        description="Train and evaluate the flagship on each corpus style")
    ap.add_argument("--n-presets", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--styles", nargs="+", choices=STYLES, default=list(STYLES))
    ap.add_argument("--seed", type=int, default=0, help="TrainConfig.seed")
    args = protocol_options(ap, positional=False).parse_args(argv)
    out = []
    for style in args.styles:
        model_c, train_c = run_configs(style, args.n_presets, args.epochs, args.logs_root,
                                       args.seed)
        out.append(run_protocol(args, model_c, train_c, {}, style=style))
    return out


if __name__ == "__main__":
    main()
