"""FlowVAE: spectrogram VAE with an invertible latent flow z0 -> zK.

Counterpart: ``preset_gen_vae_tpu/models/vae.py:45-98`` (reference:
model/VAE.py:69-181). ``forward`` returns the reference's 5-tuple
``(z0_mu_logvar, z0, zK, log_abs_det_jac, x_out)``. In train mode z0 is
sampled with the reparameterization trick from ``noise`` when the caller
injects it (the parity tests pass the JAX draw), else from ``generator``.
BasicVAE and the MIDI-in-z0 concatenation of multi-note datasets wait for
a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .flows import LatentFlow


class FlowVAE(nn.Module):
    def __init__(self, encoder: nn.Module, decoder: nn.Module, dim_z: int, flow_arch: str):
        super().__init__()
        self.encoder, self.decoder, self.dim_z = encoder, decoder, dim_z
        self.flow = LatentFlow(flow_arch, dim_z)

    def forward(self, x, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        z0_mu_logvar = self.encoder(x, generator)
        mu0 = z0_mu_logvar[:, 0, :]
        if self.training:
            if noise is None:
                noise = torch.randn(mu0.shape, device=mu0.device, generator=generator)
            z0 = mu0 + torch.exp(z0_mu_logvar[:, 1, :] / 2.0) * noise
        else:
            z0 = mu0
        zK, logdet = self.flow(z0, generator)
        return z0_mu_logvar, z0, zK, logdet, self.decoder(zK, generator)

    def flow_inverse(self, zK, generator=None):
        """zK -> z0 with log|det J^-1| (vae.py:95-98)."""
        return self.flow.inverse(zK, generator)
