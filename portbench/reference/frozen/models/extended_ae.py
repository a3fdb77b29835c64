"""Extended auto-encoder: the spectrogram VAE plus the synth-parameter
regression head in one module.

Counterpart: ``preset_gen_vae_tpu/models/extended_ae.py`` (reference:
model/extendedAE.py:13-52).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class ExtendedAE(nn.Module):
    def __init__(self, ae_model: nn.Module, reg_model: nn.Module):
        super().__init__()
        self.ae_model, self.reg_model = ae_model, reg_model

    def forward_full(self, x, sample_info=None, noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """(B, C, H, W) spectrograms -> (z0_mu_logvar, z0, zK,
        log_abs_det_jac, x_out, v_out). ``sample_info`` (B, 3) holds each
        item's (uid, pitch, velocity); only MIDI-in-z0 models read it."""
        z0_mu_logvar, z0, zK, logdet, x_out = self.ae_model(x, sample_info, noise, generator)
        v_out = self.reg_model(zK, generator)
        return z0_mu_logvar, z0, zK, logdet, x_out, v_out

    def latent_flow_inverse(self, zK, generator=None):
        return self.ae_model.flow_inverse(zK, generator)

    def regression_flow_inverse(self, v, generator=None):
        return self.reg_model.flow_inverse(v, generator)
