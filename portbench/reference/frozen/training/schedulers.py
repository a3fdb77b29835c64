"""Copy of ``preset_gen_vae_tpu/training/schedulers.py``, the JAX package's
counterpart, unchanged apart from this line.

Host-side LR scheduling.

The reference drives torch's ``ReduceLROnPlateau`` from summed validation
losses, with a linear warmup override during the first epochs
(reference: train.py:171-179, 195-197, 296-299). On TPU the learning rate
is an optax ``inject_hyperparams`` value that the host mutates between
epochs — nothing here is jitted, so the control flow stays Python.

This is a re-derivation of the plateau rule (mode='min', relative
threshold), not a port of torch internals."""

from __future__ import annotations

from typing import Dict


class ReduceLROnPlateau:
    """Multiplies LR by ``factor`` after ``patience`` epochs without a
    relative improvement of at least ``threshold``; then waits ``cooldown``
    epochs before counting again."""

    def __init__(
        self,
        initial_lr: float,
        factor: float = 0.2,
        patience: int = 6,
        cooldown: int = 6,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
    ):
        self.lr = float(initial_lr)
        self.factor = factor
        self.patience = patience
        self.cooldown = cooldown
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, value: float) -> bool:
        return value < self.best * (1.0 - self.threshold)

    def step(self, value: float) -> float:
        """Feed one epoch's (summed) validation loss; returns the LR to use."""
        if self._is_better(value):
            self.best = float(value)
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    # --- checkpointable state (reference analog: scheduler.state_dict(),
    # train.py:177-179; logs/logger.py:199-202)
    def state_dict(self) -> Dict:
        return {
            "lr": self.lr,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "cooldown_counter": self.cooldown_counter,
        }

    def load_state_dict(self, d: Dict) -> None:
        self.lr = float(d["lr"])
        self.best = float(d["best"])
        self.num_bad_epochs = int(d["num_bad_epochs"])
        self.cooldown_counter = int(d["cooldown_counter"])
