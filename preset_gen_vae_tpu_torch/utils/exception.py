"""Copy of ``preset_gen_vae_tpu/utils/exception.py``, the JAX package's
counterpart, unchanged apart from this line.

NaN-divergence detection (reference: utils/exception.py:13-22).

``check_nan_values`` is host-side: call it on loss scalars already pulled
from device (e.g. once per epoch, or per logged step) — never inside a
jitted train step."""

import math


class ModelConvergenceError(Exception):
    """Raised when a training run diverges (NaN losses). The train queue
    catches this and restarts the run (reference: train_queue.py:89-106)."""


def check_nan_values(epoch, *losses):
    for loss in losses:
        v = float(loss)
        if math.isnan(v) or math.isinf(v):
            raise ModelConvergenceError(
                f"Model training has diverged (NaN/inf loss) at epoch {epoch}"
            )
