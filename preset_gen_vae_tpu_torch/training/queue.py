"""Sequential multi-run training queue.

Counterpart: ``preset_gen_vae_tpu/training/queue.py:29-86`` (reference:
train_queue.py:24-119). Each queue entry is a pair of config-override dicts
applied on top of the base configs; k-fold fan-out duplicates an entry over
all folds; a run that raises ``ModelConvergenceError`` (NaN loss) is
restarted up to ``max_restarts`` times before the queue aborts. Each restart
trains with ``seed + 1000 * restart_number``, as in the JAX package: a run
on the same seed takes the same trajectory, so an unchanged seed would
diverge again.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .. import config as cfg
from ..utils.exception import ModelConvergenceError
from .loop import train_config


def expand_k_folds(run_mods: Sequence[Tuple[Dict, Dict]],
                   k_folds_count: int) -> List[Tuple[Dict, Dict]]:
    """Duplicates each run over all folds, suffixing the run name with
    '_kf{n}' (reference: train_queue.py:53-67)."""
    out = []
    for model_mod, train_mod in run_mods:
        for k in range(k_folds_count):
            mm, tm = dict(model_mod), dict(train_mod)
            mm["run_name"] = f"{mm.get('run_name', 'run')}_kf{k}"
            tm["current_k_fold"] = k
            out.append((mm, tm))
    return out


def run_queue(run_mods: Sequence[Tuple[Dict, Dict]],
              base_model: Optional[cfg.ModelConfig] = None,
              base_train: Optional[cfg.TrainConfig] = None, max_restarts: int = 2,
              k_folds_fanout: bool = False, **train_kwargs) -> List[Dict]:
    """Runs every entry; returns the list of training summaries.
    ``train_kwargs`` go to ``train_config`` (``device``, ``dataset_kwargs``,
    ``use_tensorboard``, ...)."""
    base_model = base_model or cfg.ModelConfig()
    base_train = base_train or cfg.TrainConfig()
    if k_folds_fanout:
        run_mods = expand_k_folds(run_mods, base_train.k_folds)
    summaries = []
    for run_idx, (model_mod, train_mod) in enumerate(run_mods):
        model_c = dataclasses.replace(base_model, **model_mod)
        train_c = dataclasses.replace(base_train, **train_mod)
        restarts = 0
        while True:
            try:
                print(f"[train_queue] starting run {run_idx}: {model_c.name}/{model_c.run_name}")
                summaries.append(train_config(model_c, train_c, **train_kwargs))
                break
            except ModelConvergenceError as e:  # train_queue.py:93-106
                restarts += 1
                if restarts > max_restarts:
                    raise RuntimeError(
                        f"Run {run_idx} diverged {restarts} times — aborting queue ({e})")
                train_c = dataclasses.replace(train_c, seed=train_c.seed + 1000 * restarts)
                print(f"[train_queue] NaN divergence ({e}); restart "
                      f"{restarts}/{max_restarts} with seed={train_c.seed}")
    return summaries
