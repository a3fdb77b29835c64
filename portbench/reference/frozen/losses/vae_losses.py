"""Reconstruction and latent losses.

Counterpart: ``preset_gen_vae_tpu/losses/vae_losses.py`` (reference:
model/loss.py:15-66, model/VAE.py:63-66, 183-193).
"""

from __future__ import annotations

import torch

from ..ops.probability import gaussian_log_probability, standard_gaussian_log_probability


def reconstruction_loss(x_out, x_in, normalize: bool) -> torch.Tensor:
    """MSE (mean) when normalized, else the batch-averaged L2 sum
    (reference wiring: train.py:103-106)."""
    sq = torch.square(x_out - x_in)
    return sq.mean() if normalize else sq.sum() / x_in.shape[0]


def gaussian_dkl(mu, logvar, normalize: bool = True) -> torch.Tensor:
    """Dkl(N(mu, exp(logvar)) || N(0, I)), batch-averaged, optionally over
    the latent dimension too (reference: model/loss.py:46-66)."""
    dkl = 0.5 * torch.sum(torch.exp(logvar) + torch.square(mu) - logvar - 1.0) / mu.shape[0]
    return dkl / mu.shape[1] if normalize else dkl


def flow_vae_latent_loss(z0_mu_logvar, z0, zK, log_abs_det_jac, normalize: bool):
    """-E[log p(zK) - log q(z0) + log|det J|] (reference: VAE.py:183-193)."""
    log_q_z0 = gaussian_log_probability(z0, z0_mu_logvar[:, 0, :], z0_mu_logvar[:, 1, :])
    loss = -torch.mean(standard_gaussian_log_probability(zK) - log_q_z0 + log_abs_det_jac)
    return loss / z0.shape[1] if normalize else loss


def latent_dkl_loss(z0_mu_logvar, normalize: bool) -> torch.Tensor:
    """BasicVAE latent loss (vae_losses.py:54-58; reference: VAE.py:63-66)."""
    return gaussian_dkl(z0_mu_logvar[:, 0, :], z0_mu_logvar[:, 1, :], normalize)
