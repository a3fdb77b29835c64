"""VAE cores: BasicVAE (Gaussian latent, Dkl loss) and FlowVAE (an invertible
latent flow z0 -> zK).

Counterpart: ``preset_gen_vae_tpu/models/vae.py:21-98`` (reference:
model/VAE.py:19-193). ``forward`` returns the reference's 5-tuple
``(z0_mu_logvar, z0, zK, log_abs_det_jac, x_out)``. In train mode z0 is
sampled with the reparameterization trick from ``noise`` when the caller
injects it (the parity tests pass the JAX draw), else from ``generator``.

With ``concat_midi_to_z0`` (un-stacked multi-note datasets) the encoder
emits dim_z - 2 values and the MIDI pitch and velocity of each item take
latent dimensions 0-1: mean min-max scaled to [-1, 1], log-variance of a
unit std in the [0, 127] MIDI domain; zeros for both without
``sample_info`` (vae.py:66-80).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .flows import LatentFlow


def _reparameterize(mu_logvar, training: bool, noise, generator):
    mu = mu_logvar[:, 0, :]
    if not training:
        return mu
    if noise is None:
        noise = torch.randn(mu.shape, device=mu.device, generator=generator)
    return mu + torch.exp(mu_logvar[:, 1, :] / 2.0) * noise


class BasicVAE(nn.Module):
    """dim_z independent Gaussian latents (vae.py:21-42); zK = z0 and a zero
    logdet, for FlowVAE's interface."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module, dim_z: int):
        super().__init__()
        self.encoder, self.decoder, self.dim_z = encoder, decoder, dim_z

    def forward(self, x, sample_info=None, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        z_mu_logvar = self.encoder(x, generator)
        z = _reparameterize(z_mu_logvar, self.training, noise, generator)
        return z_mu_logvar, z, z, z.new_zeros(z.shape[0]), self.decoder(z, generator)


class FlowVAE(nn.Module):
    def __init__(self, encoder: nn.Module, decoder: nn.Module, dim_z: int, flow_arch: str,
                 concat_midi_to_z0: bool = False):
        super().__init__()
        self.encoder, self.decoder, self.dim_z = encoder, decoder, dim_z
        self.concat_midi_to_z0 = concat_midi_to_z0
        self.flow = LatentFlow(flow_arch, dim_z)

    def encode(self, x, sample_info=None, generator=None):
        enc = self.encoder(x, generator)
        if not self.concat_midi_to_z0:
            return enc
        B = enc.shape[0]  # enc: (B, 2, dim_z - 2)
        if sample_info is None:  # tolerated for summaries (reference: VAE.py:157-158)
            head = enc.new_zeros((B, 2, 2))
        else:
            midi_mu = -1.0 + 2.0 * sample_info[:, 1:3].to(enc.dtype) / 127.0
            midi_logvar = torch.full_like(midi_mu, math.log(4.0 / 127 ** 2))
            head = torch.stack([midi_mu, midi_logvar], dim=1)
        return torch.cat([head, enc], dim=2)

    def forward(self, x, sample_info=None, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        z0_mu_logvar = self.encode(x, sample_info, generator)
        z0 = _reparameterize(z0_mu_logvar, self.training, noise, generator)
        zK, logdet = self.flow(z0, generator)
        return z0_mu_logvar, z0, zK, logdet, self.decoder(zK, generator)

    def flow_inverse(self, zK, generator=None):
        """zK -> z0 with log|det J^-1| (vae.py:95-98)."""
        return self.flow.inverse(zK, generator)
