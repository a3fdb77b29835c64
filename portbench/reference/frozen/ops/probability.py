"""Closed-form Gaussian log-probabilities.

Counterpart: ``preset_gen_vae_tpu/ops/probability.py`` (reference:
utils/probability.py:13-29).
"""

import numpy as np
import torch

_LOG_2_PI = float(np.log(2.0 * np.pi))


def standard_gaussian_log_probability(samples: torch.Tensor) -> torch.Tensor:
    """log N(samples; 0, I), summed over the feature axis -> (B,)."""
    return -0.5 * (samples.shape[1] * _LOG_2_PI + torch.sum(samples ** 2, dim=1))


def gaussian_log_probability(samples, mu, log_var) -> torch.Tensor:
    """log N(samples; mu, diag(exp(log_var))) -> (B,)."""
    return -0.5 * (samples.shape[1] * _LOG_2_PI
                   + torch.sum(log_var + (samples - mu) ** 2 / torch.exp(log_var), dim=1))
