"""The reference's full six-note MIDI set in either multi-note mode, trained
and then evaluated in one process: the protocol that produced the JAX
package's ``saved/FlVAE2/r5stack6_v2_8192/`` and ``r5multi6_v2_8192/``.
Counterpart of ``scripts/run_6note_r5.py``.

    python -m preset_gen_vae_tpu_torch.scripts.run_6note {stack,multi} [n_presets] [epochs] \\
        [--seed 0] [--resume] [--device cuda] [--data-root DIR] [--logs-root saved]

The protocol is the JAX script's: ``n_presets`` (8,192) ``structured2``
presets from seed 0 at the notes ``NOTES_6``, the corpus rendered on the
card (F1, F2 and K1, ``'jax'``) and kept there (``'device'``), ``epochs``
(400) epochs with a checkpoint every ``epochs // 2``, ``verbosity`` 0;
then the last checkpoint is evaluated on the validation split with the
default re-render, on the same dataset.

- ``stack``: the six spectrograms are the channels of one item, each
  through the shared per-channel CNN, then the 4x4 and 1x1 mixers.
- ``multi``: one channel an item, six items a preset, MIDI pitch and
  velocity in z0. The configuration resolves the epochs, warm-up,
  patience and cool-down as the JAX package does for un-stacked notes
  (``1 + n // 5``: 400 epochs become 81).

The run is ``FlVAE2/torch_{mode}6_v2_<n_presets>``, never a JAX run's name:
a new run erases its directory, and the JAX package's runs are the
yardsticks. ``--seed`` (``TrainConfig.seed``, 0 as in the JAX script's
runs) measures the protocol's spread over seeds; another seed's run is
``..._seed<k>``. The corpus is the same for every seed. ``--resume`` and
the printed lines are those of ``run_stack3_v2``, whose protocol body
this script runs. The JAX script's
``--no-eval`` is not ported: it kept its evaluation off a 15.75 GB
accelerator, and the 80 GB card holds the corpus, the training's remnants
and the re-render together. Its accelerator lock and compile cache have no
counterpart either.
"""

from __future__ import annotations

import argparse
from typing import Tuple

from .. import config as cfg
from .run_stack3_v2 import protocol_options, run_protocol

RUN_PREFIX = "torch_{mode}6_v2_"
MODES = ("stack", "multi")
# the reference's full note set (its config.py:36, commented out there)
NOTES_6 = ((40, 85), (50, 85), (60, 42), (60, 85), (60, 127), (70, 85))


def run_configs(mode: str, n_presets: int, epochs: int, logs_root: str = "saved",
                seed: int = 0) -> Tuple[cfg.ModelConfig, cfg.TrainConfig]:
    """The JAX script's configs, under the port's run name."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    run_name = f"{RUN_PREFIX.format(mode=mode)}{n_presets}" + (f"_seed{seed}" if seed else "")
    model_c = cfg.ModelConfig(
        run_name=run_name, midi_notes=NOTES_6,
        stack_spectrograms=(mode == "stack"), dataset_corpus_render_backend="jax",
        dataset_corpus_cache_policy="device", logs_root_dir=logs_root)
    train_c = cfg.TrainConfig(n_epochs=epochs, save_period=max(epochs // 2, 1), verbosity=0,
                              seed=seed)
    return model_c, train_c


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Train and evaluate the six-note family")
    ap.add_argument("mode", choices=MODES)
    ap.add_argument("--seed", type=int, default=0, help="TrainConfig.seed")
    args = protocol_options(ap).parse_args(argv)
    model_c, train_c = run_configs(args.mode, args.n_presets, args.epochs, args.logs_root,
                                   args.seed)
    return run_protocol(args, model_c, train_c, {"mode": args.mode})


if __name__ == "__main__":
    main()
