"""Run logger: run-dir lifecycle, config freeze, checkpoints, timing.

Counterpart: ``preset_gen_vae_tpu/logs/logger.py`` (reference:
logs/logger.py:79-226). A run lives in
``<logs_root_dir>/<name>/<run_name>/`` with the frozen ``config.json``,
``tensorboard/`` events, ``model_summary.txt`` and ``checkpoints/``. A
relative ``logs_root_dir`` resolves against the checkout's root, found from
this package's own path.

A checkpoint keeps the JAX package's layout, ``checkpoints/<epoch>/`` with
``meta.json`` = ``{epoch, scheduler}``. In place of orbax's ``state/`` it
holds one ``state.pt`` written by ``torch.save``: ``{"model": the model's
state_dict (BatchNorm running statistics included), "optimizer": the
optimizer's state_dict, "step": the train-step count, "generator": the
state of the run's torch.Generator}``. Everything in it is a tensor, a
number, a string or a container of those, so ``torch.load(...,
weights_only=True)`` reads it. A checkpoint is layout-free: under tensor
parallelism every process first gathers its model group's shards of the
weights and of Adam's moments (``parallel/sharding_rules.py``), and rank 0
writes the full tensors, so that the run resumes in one process or under
any grid.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import config as cfg
from .._native import REPO_ROOT
from ..parallel.sharding_rules import layout_free_state


def get_run_dir(model_config: cfg.ModelConfig) -> pathlib.Path:
    root = pathlib.Path(model_config.logs_root_dir)
    if not root.is_absolute():
        root = REPO_ROOT / root
    return root / model_config.name / model_config.run_name


def get_checkpoints_dir(model_config: cfg.ModelConfig) -> pathlib.Path:
    return get_run_dir(model_config) / "checkpoints"


def list_checkpoint_epochs(model_config: cfg.ModelConfig):
    d = get_checkpoints_dir(model_config)
    if not d.exists():
        return []
    return sorted(int(p.name) for p in d.iterdir() if p.name.isdigit())


def load_checkpoint(model_config: cfg.ModelConfig, epoch: int = -1) -> Dict:
    """Loads {state, epoch, scheduler} onto the CPU; epoch=-1 -> latest
    (reference: logger.py:30-55 get_model_checkpoint/_last_checkpoint)."""
    epochs = list_checkpoint_epochs(model_config)
    if not epochs:
        raise FileNotFoundError(f"No checkpoints under {get_checkpoints_dir(model_config)}")
    epoch = epochs[-1] if epoch < 0 else epoch
    d = get_checkpoints_dir(model_config) / str(epoch)
    if not d.exists():
        raise FileNotFoundError(f"No checkpoint for epoch {epoch} in {d.parent} (has {epochs})")
    state = torch.load(d / "state.pt", map_location="cpu", weights_only=True)
    with open(d / "meta.json") as f:
        meta = json.load(f)
    return {"state": state, "epoch": meta["epoch"], "scheduler": meta["scheduler"]}


class RunLogger:
    def __init__(
        self,
        model_config: cfg.ModelConfig,
        train_config: cfg.TrainConfig,
        eval_config: Optional[cfg.EvalConfig] = None,
        restart_from_checkpoint: bool = False,
        use_tensorboard: bool = True,
        write: bool = True,
    ):
        """``write=False`` (the processes other than rank 0 of a
        multi-process run) touches no file and prints nothing."""
        self.model_config = model_config
        self.train_config = train_config
        self.write = write
        self.verbosity = train_config.verbosity if write else 0
        self.restart = restart_from_checkpoint
        self.run_dir = get_run_dir(model_config)
        self.tensorboard = None
        self._minibatch_times = []
        self._epoch_durations = []
        if not write:
            return

        if not restart_from_checkpoint and self.run_dir.exists():
            if not model_config.allow_erase_run:
                raise RuntimeError(f"Run dir {self.run_dir} exists and allow_erase_run=False")
            if train_config.init_security_pause > 0:  # logger.py:99-106
                print(f"[RunLogger] Erasing {self.run_dir} in "
                      f"{train_config.init_security_pause:.1f}s...")
                time.sleep(train_config.init_security_pause)
            shutil.rmtree(self.run_dir)
        (self.run_dir / "checkpoints").mkdir(parents=True, exist_ok=True)

        # frozen config sidecar (reference: logger.py:158-162)
        cfg.save_config(self.run_dir / "config.json", model_config, train_config, eval_config)
        if use_tensorboard:  # raises ImportError where tensorboard is missing
            from .tbwriter import TensorboardSummaryWriter

            self.tensorboard = TensorboardSummaryWriter(
                self.run_dir / "tensorboard", model_config, train_config)

    # ------------------------------------------------------------------
    def init_with_model(self, model: torch.nn.Module) -> None:
        """Writes the parameter count and the module tree to
        ``model_summary.txt`` (reference: logger.py:155-172, a torchinfo
        summary)."""
        if not self.write:
            return
        n_params = sum(p.numel() for p in model.parameters())
        msg = f"{model.__class__.__name__}: {n_params:,} parameters"
        with open(self.run_dir / "model_summary.txt", "w") as f:
            f.write(f"{msg}\n\n{model}\n")
        if self.tensorboard is not None:
            self.tensorboard.add_text("ModelSummary", f"```\n{msg}\n\n{model}\n```")
        self.log(msg, level=1)

    def log(self, msg: str, level: int = 1):
        if self.verbosity >= level:
            print(f"[RunLogger] {msg}")

    def on_minibatch_finished(self, minibatch_idx: int):
        self._minibatch_times.append(time.time())
        if self.verbosity >= 3 and len(self._minibatch_times) >= 2:
            dt = np.diff(self._minibatch_times[-10:]).mean()
            print(f"[RunLogger] minibatch {minibatch_idx}: avg {dt*1e3:.1f} ms")

    def on_epoch_finished(self, epoch: int, dur: float):
        """``dur``: the epoch's seconds so far, on the clock of the train
        loop's epoch span (``utils/profile.py``), which the summary's
        ``epoch_s`` reads too."""
        self._epoch_durations.append(dur)
        self._minibatch_times = []
        remaining = self.train_config.n_epochs - epoch - 1
        eta_s = remaining * float(np.mean(self._epoch_durations[-10:]))
        self.log(f"epoch {epoch} done in {dur:.1f}s — ETA {eta_s/60.0:.1f} min", level=2)

    def on_training_finished(self):
        if self.tensorboard is not None:
            self.tensorboard.flush()
            self.tensorboard.close()
        total = sum(self._epoch_durations)
        self.log(f"training finished in {total/60.0:.1f} min", level=1)

    # ------------------------------------------------------------------
    def save_checkpoint(self, epoch: int, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, step: int,
                        generator: torch.Generator, scheduler) -> None:
        """(reference: logger.py:199-202). ``scheduler`` is the host-side
        ReduceLROnPlateau. Every process calls it: a sharded model's full
        tensors are gathered over its model groups before rank 0 writes."""
        model_sd, optimizer_sd = layout_free_state(model, optimizer)
        if not self.write:
            return
        d = self.run_dir / "checkpoints" / str(epoch)
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        torch.save({"model": model_sd, "optimizer": optimizer_sd,
                    "step": int(step), "generator": generator.get_state()}, d / "state.pt")
        with open(d / "meta.json", "w") as f:
            json.dump({"epoch": epoch, "scheduler": scheduler.state_dict()}, f)
        self.log(f"checkpoint saved at epoch {epoch}", level=2)

    def save_profiler_results(self, profiler) -> None:
        """Writes the profiler's window as a Chrome trace to
        ``<run_dir>/profile/trace.json`` and logs the path (reference:
        logger.py:204-205; the JAX package's only logs)."""
        if self.write:
            self.log(f"profiler trace in {profiler.export()}", level=1)


def erase_run(model_config: cfg.ModelConfig):
    """clean_logs.py equivalent: removes a run's saved dir."""
    d = get_run_dir(model_config)
    if d.exists():
        shutil.rmtree(d)
