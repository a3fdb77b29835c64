"""The paper's FlowParamsLoss trained to its end in both inverse-BN modes
and evaluated without a re-render: the protocol that produced the JAX
package's ``saved/FlVAE2/r2flowloss_train/`` and ``r2flowloss_eval/``.
Counterpart of ``scripts/run_flowloss_r2.py``.

    python -m preset_gen_vae_tpu_torch.scripts.run_flowloss [--n-presets 2048] \\
        [--epochs 150] [--seed 0] [--resume] [--device cuda] [--data-root DIR] \\
        [--logs-root saved]

The configs are the JAX script's: ``ModelConfig(forward_controls_loss=False)``
(the controls loss pulled back through the regression flow's inverse,
reference: train.py:119-121, model/loss.py:318-346), every other field at
its default (the flagship, ``'cpp'``/``'disk'``), and
``TrainConfig(n_epochs=150, save_period=50, flow_loss_bn_mode=mode)`` for
``mode`` in ``train`` (batch statistics in the inverse, the reference's)
and ``eval`` (the running statistics). One dataset, 2,048 presets of the
default style, serves both modes. Each mode's last checkpoint is evaluated
on the validation split with ``render_audio=False``. ``--n-presets`` and
``--epochs`` cut the protocol for a quick run; the saved runs are at the
defaults. TensorBoard is off (the JAX script left it on).

The runs are ``FlVAE2/torch_flowloss_<mode>`` (``..._seed<k>`` for
another ``--seed``, ``TrainConfig.seed``; the corpus is the same for
every seed), never a JAX run's name.
Prints the corpus pass's JSON line, then per mode a ``train`` and an
``eval`` line with the JAX script's keys (``bn_mode`` first) and the run's
line of ``run_stack3_v2``, whose protocol body this script runs; last,
both modes' training and evaluation summaries go to
``<logs-root>/torch_flowloss_comparison.json`` (``..._seed<k>.json``).
``--resume`` is ``run_stack3_v2``'s, for each mode.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, Tuple

from .. import config as cfg
from .run_stack3_v2 import corpus_phase, protocol_options, run_protocol

RUN_PREFIX = "torch_flowloss_"
BN_MODES = ("train", "eval")
N_PRESETS = 2048
N_EPOCHS = 150
STYLE = "structured"  # the dataset's default, which the JAX script keeps
COMPARISON = "torch_flowloss_comparison.json"


def seed_suffix(seed: int) -> str:
    return f"_seed{seed}" if seed else ""


def run_configs(bn_mode: str, epochs: int = N_EPOCHS, logs_root: str = "saved",
                seed: int = 0) -> Tuple[cfg.ModelConfig, cfg.TrainConfig]:
    """The JAX script's configs, under the port's run name."""
    if bn_mode not in BN_MODES:
        raise ValueError(f"flow_loss_bn_mode {bn_mode!r} is not one of {BN_MODES}")
    model_c = cfg.ModelConfig(run_name=f"{RUN_PREFIX}{bn_mode}{seed_suffix(seed)}",
                              forward_controls_loss=False, logs_root_dir=logs_root)
    train_c = cfg.TrainConfig(n_epochs=epochs, save_period=50, flow_loss_bn_mode=bn_mode,
                              seed=seed)
    return model_c, train_c


def main(argv=None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description="Train and evaluate FlowParamsLoss in both BN modes")
    ap.add_argument("--n-presets", type=int, default=N_PRESETS)
    ap.add_argument("--epochs", type=int, default=N_EPOCHS)
    ap.add_argument("--seed", type=int, default=0, help="TrainConfig.seed")
    args = protocol_options(ap, positional=False).parse_args(argv)
    dataset, results = None, {}
    for bn_mode in BN_MODES:
        model_c, train_c = run_configs(bn_mode, args.epochs, args.logs_root, args.seed)
        if dataset is None:
            dataset = corpus_phase(args, model_c, train_c, STYLE)[0]
        record = {}
        run_protocol(args, model_c, train_c, {"bn_mode": bn_mode}, style=STYLE, dataset=dataset,
                     render_audio=False, phase_tags={"bn_mode": bn_mode}, record=record)
        results[bn_mode] = record
    path = pathlib.Path(args.logs_root) / COMPARISON.replace(".json",
                                                             f"{seed_suffix(args.seed)}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
