"""The train step and the eval step.

Counterpart: ``preset_gen_vae_tpu/training/train_step.py:62-83, 118-144,
203-415`` (reference: train.py:100-128, 201-293). One train step is the
forward (VAE + regression), the loss

    total = recons + beta * latent + flow_input_reg + controls

its gradients and one Adam update; the monitoring metrics (QLoss, accuracy,
MSE) are computed under ``no_grad``. The eval step is the eval-mode forward
(z0 = mu, running BN statistics) with the same losses and monitors.

On the card with ``compute_dtype='bfloat16'`` both steps run under bf16
autocast with float32 master weights, as the JAX package computes its
convolutions and conditioner matmuls in bf16 with f32 parameters
(config.py:158, models/build.py:22-25 there); the losses are float32.
``torch.optim.Adam(weight_decay=wd)`` adds ``wd * w`` to the gradient
before the moments: the coupled L2 of ``make_optimizer`` (optax
``add_decayed_weights`` then ``adam``). The FlowParamsLoss path
(``forward_controls_loss=False``) waits for a later slice.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from ..config import ModelConfig, TrainConfig
from ..data.preset import PresetIndexesHelper
from ..losses.synth_params import (
    CategoricalParamsAccuracy,
    QuantizedNumericalParamsLoss,
    SynthParamsLoss,
)
from ..losses.vae_losses import flow_vae_latent_loss, gaussian_dkl, reconstruction_loss

SCALARS = ("ReconsLoss/Backprop", "ReconsLoss/MSE", "Controls/BackpropLoss",
           "Controls/QLoss", "Controls/Accuracy", "LatLoss", "FlowInputReg")


def make_optimizer(model: torch.nn.Module, train_config: TrainConfig) -> torch.optim.Adam:
    if train_config.optimizer != "Adam":
        raise NotImplementedError(f"Optimizer '{train_config.optimizer}'")
    return torch.optim.Adam(model.parameters(), lr=train_config.initial_learning_rate,
                            betas=tuple(train_config.adam_betas),
                            weight_decay=train_config.weight_decay)


class Criteria:
    """The loss terms and monitors of one config (train_step.py:118-144)."""

    def __init__(self, model_config: ModelConfig, train_config: TrainConfig,
                 idx_helper: PresetIndexesHelper):
        if not model_config.forward_controls_loss:
            raise NotImplementedError("FlowParamsLoss is not ported yet")
        if model_config.latent_flow_arch is None:
            raise NotImplementedError("the Dkl latent loss of BasicVAE is not ported yet")
        if train_config.params_cat_bceloss and model_config.params_reg_softmax:
            raise ValueError("params_cat_bceloss excludes params_reg_softmax")
        self.normalize = train_config.normalize_losses
        self.beta_final = train_config.beta
        self.dkl_flow_reg = train_config.latent_flow_input_regularization.lower() == "dkl"
        self.controls = SynthParamsLoss(
            idx_helper, train_config.normalize_losses, cat_bce=train_config.params_cat_bceloss,
            cat_softmax=(not model_config.params_reg_softmax
                         and not train_config.params_cat_bceloss),
            cat_softmax_t=train_config.params_cat_softmax_temperature)
        self.qloss = QuantizedNumericalParamsLoss(idx_helper, loss="mse")
        self.accuracy = CategoricalParamsAccuracy(idx_helper)

    def losses(self, outs, x_in, v_in, train: bool) -> Dict[str, torch.Tensor]:
        z0_mu_logvar, z0, zK, logdet, x_out, v_out = outs
        recons = reconstruction_loss(x_out.float(), x_in.float(), self.normalize)
        lat = flow_vae_latent_loss(z0_mu_logvar, z0, zK, logdet, self.normalize)
        flow_in_reg = recons.new_zeros(())
        if train and self.dkl_flow_reg:  # train.py:235-239
            flow_in_reg = 0.1 * self.beta_final * gaussian_dkl(
                z0_mu_logvar[:, 0, :], z0_mu_logvar[:, 1, :], self.normalize)
        return {"recons": recons, "lat": lat, "flow_in_reg": flow_in_reg,
                "cont": self.controls(v_out.float(), v_in)}

    @torch.no_grad()
    def metrics(self, terms, outs, x_in, v_in) -> Dict[str, torch.Tensor]:
        """Monitoring scalars (train_step.py:346-371)."""
        x_out, v_out = outs[4].float(), outs[5].float()
        return {
            "ReconsLoss/Backprop": terms["recons"].detach(),
            "ReconsLoss/MSE": (terms["recons"].detach() if self.normalize
                               else torch.mean(torch.square(x_out - x_in.float()))),
            "Controls/BackpropLoss": terms["cont"].detach(),
            "Controls/QLoss": self.qloss(v_out, v_in),
            "Controls/Accuracy": self.accuracy(v_out, v_in),
            "LatLoss": terms["lat"].detach(),
            "FlowInputReg": terms["flow_in_reg"].detach(),
        }


def autocast(device: torch.device, train_config: TrainConfig):
    """bf16 autocast on the card when ``compute_dtype='bfloat16'``; the CPU
    runs in float32."""
    if device.type == "cuda" and train_config.compute_dtype == "bfloat16":
        return torch.autocast("cuda", dtype=torch.bfloat16)
    return contextlib.nullcontext()


def train_step(model, optimizer, criteria: Criteria, train_config: TrainConfig,
               x_in, v_in, sample_info, beta: float,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One optimisation step (train_step.py:222-343); returns the metrics as
    0-d tensors on the device (plus ``TotalLoss``), without a host sync."""
    model.train()
    with autocast(x_in.device, train_config):
        outs = model.forward_full(x_in, sample_info, noise=noise, generator=generator)
    terms = criteria.losses(outs, x_in, v_in, train=True)
    total = terms["recons"] + terms["lat"] * beta + terms["flow_in_reg"] + terms["cont"]
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    optimizer.step()
    m = criteria.metrics(terms, outs, x_in, v_in)
    m["TotalLoss"] = total.detach()
    return m


@torch.no_grad()
def eval_step(model, criteria: Criteria, train_config: TrainConfig, x_in, v_in,
              sample_info) -> Dict[str, torch.Tensor]:
    """Validation / inference step (train_step.py:374-415): the metrics as
    0-d tensors, plus the latents ``z0_mu`` and ``z0`` (B, dim_z) in float32
    (train_step.py:364-367 there), equal in eval mode."""
    model.eval()
    with autocast(x_in.device, train_config):
        outs = model.forward_full(x_in, sample_info)
    terms = criteria.losses(outs, x_in, v_in, train=False)
    m = criteria.metrics(terms, outs, x_in, v_in)
    m["z0_mu"], m["z0"] = outs[0][:, 0, :].float(), outs[1].float()
    return m
