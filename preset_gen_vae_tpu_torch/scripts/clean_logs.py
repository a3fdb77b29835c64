"""Erase a run's saved directory (its checkpoints, config, evaluations and
TensorBoard events). Counterpart of the root ``clean_logs.py`` (reference:
clean_logs.py:20-33).

    python -m preset_gen_vae_tpu_torch.scripts.clean_logs [NAME RUN_NAME] [--logs-root saved]

With fewer than two names it erases the default ``ModelConfig``'s run, as
the JAX script does. ``--logs-root`` names the runs directory, as the
port's other scripts do.
"""

from __future__ import annotations

import argparse
import dataclasses

from .. import config as cfg
from ..logs.logger import erase_run, get_run_dir


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Erase a run's saved directory")
    ap.add_argument("names", nargs="*", help="NAME RUN_NAME (default: the default configs')")
    ap.add_argument("--logs-root", default="saved", help="runs directory")
    args = ap.parse_args(argv)
    model_c = dataclasses.replace(cfg.ModelConfig(), logs_root_dir=args.logs_root)
    if len(args.names) >= 2:
        model_c = dataclasses.replace(model_c, name=args.names[0], run_name=args.names[1])
    print(f"Erasing {get_run_dir(model_c)}")
    erase_run(model_c)


if __name__ == "__main__":
    main()
