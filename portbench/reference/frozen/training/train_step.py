"""The train step and the eval step.

Counterpart: ``preset_gen_vae_tpu/training/train_step.py:62-83, 118-415``
(reference: train.py:100-128, 201-293). One train step is the forward
(VAE + regression), the loss

    total = recons + beta * latent + flow_input_reg + controls

its gradients and one Adam update; the monitoring metrics (QLoss, accuracy,
MSE) are computed under ``no_grad``. The latent term is the flow ELBO of
FlowVAE or the Dkl of BasicVAE. The controls term is ``SynthParamsLoss`` on
the regressed preset, or with ``forward_controls_loss=False`` the
FlowParamsLoss: the target preset pulled back through the regression
flow's inverse, then the latent flow's, and scored under q(z0)
(train_step.py:145-200, 282-311 there). Its inverse passes run in train
mode with ``flow_loss_bn_mode='train'`` (batch statistics, dropout, and a
second in-place update of the running statistics, chained after the
forward's, all under ``no_grad``), or with ``'eval'`` in eval mode on the
running statistics from before the step, as the JAX step reads its
pre-step ``batch_stats`` there. The eval step is the eval-mode forward
(z0 = mu, running BN statistics) with the same losses and monitors, its
pullback in eval mode too.

On the card with ``compute_dtype='bfloat16'`` the forwards and the pullback
run under bf16 autocast with float32 master weights, as the JAX package
computes its convolutions and conditioner matmuls in bf16 with f32
parameters (config.py:158, models/build.py:22-25 there); the losses are
float32. ``torch.optim.Adam(weight_decay=wd)`` adds ``wd * w`` to the
gradient before the moments: the coupled L2 of ``make_optimizer`` (optax
``add_decayed_weights`` then ``adam``).

With ``TrainConfig.remat`` the train step's forward runs under
``torch.utils.checkpoint`` (non-reentrant), as the JAX step wraps it in
``jax.checkpoint`` (train_step.py:257-260 there): its activations are
recomputed in the backward instead of kept. The recompute is the same
math: the forward keeps the output of each random draw (the dropout
masks' uniforms, the VAE noise) and the recompute reuses it instead of
drawing again (a selective checkpoint), and its BatchNorms leave the
running statistics that the forward updated alone, so that remat changes
neither the loss, the gradients, the running statistics nor the
generator's state after the step. Nothing in it reads or sets the
generator's state, so a CUDA graph can hold it. The FlowParamsLoss
pullback stays outside the checkpoint.

On the card Adam is ``capturable`` (its step counts and its learning rate
are device tensors) and autocast keeps no cache of cast weights, so that
one step and a CUDA graph of K steps (``training/dispatch.py``) run the
same arithmetic. ``beta`` may be a device scalar, which the graph reads.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from ..config import ModelConfig, TrainConfig
from ..data.preset import PresetIndexesHelper
from ..losses.synth_params import (
    CategoricalParamsAccuracy,
    QuantizedNumericalParamsLoss,
    SynthParamsLoss,
)
from ..losses.vae_losses import (
    flow_vae_latent_loss,
    gaussian_dkl,
    latent_dkl_loss,
    reconstruction_loss,
)
from ..models.layers import running_stats_frozen, widen
from ..ops.probability import gaussian_log_probability

SCALARS = ("ReconsLoss/Backprop", "ReconsLoss/MSE", "Controls/BackpropLoss",
           "Controls/QLoss", "Controls/Accuracy", "LatLoss", "FlowInputReg")
# FlowParamsLoss configs also log the share of a batch's items whose
# pulled-back log-density sits at the floor
FLOORED = "Controls/FlooredShare"

# FlowParamsLoss guard (train_step.py:145-159 there): the pulled-back values
# are clipped after each flow and each item's log-density is floored, so an
# item that the inverse flows blow up adds a constant with zero gradient
PULLBACK_CLIP = 1e4
FLOW_LOSS_FLOOR = -1e8


def make_optimizer(model: torch.nn.Module, train_config: TrainConfig) -> torch.optim.Adam:
    """Adam with the coupled L2 of ``train_config``; ``capturable`` on the
    card, its learning rate a device tensor that ``set_learning_rate``
    fills in place (a CUDA graph of steps reads it there)."""
    if train_config.optimizer != "Adam":
        raise NotImplementedError(f"Optimizer '{train_config.optimizer}'")
    params = list(model.parameters())
    dev = params[0].device
    capturable = dev.type == "cuda"
    lr = train_config.initial_learning_rate
    return torch.optim.Adam(params, lr=torch.tensor(lr, device=dev) if capturable else lr,
                            betas=tuple(train_config.adam_betas),
                            weight_decay=train_config.weight_decay, capturable=capturable)


# the keys of an Adam group that say how it runs, not what it computes
_ADAM_RUNTIME_KEYS = ("capturable", "foreach", "fused", "differentiable")


def load_optimizer_state(optimizer: torch.optim.Adam, state: Dict) -> None:
    """``optimizer.load_state_dict(state)`` that keeps the optimizer's own
    form, whichever form ``state`` was saved in: a capturable Adam's step
    counts and learning rate stay device tensors (the learning rate the
    same tensor, filled in place), a plain Adam's learning rate a float."""
    kept = [({k: g[k] for k in _ADAM_RUNTIME_KEYS if k in g}, g["lr"])
            for g in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, (runtime, lr) in zip(optimizer.param_groups, kept):
        saved_lr = float(group["lr"])
        group.update(runtime)
        if torch.is_tensor(lr):
            lr.fill_(saved_lr)
            group["lr"] = lr
        else:
            group["lr"] = saved_lr
        for p in group["params"]:  # a plain Adam's step counts are on the host
            st = optimizer.state.get(p)
            if st and group["capturable"]:
                st["step"] = st["step"].to(dtype=torch.float32, device=p.device)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate; a device tensor is filled in place."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def pulled_back_log_density(z0_t, logdet, z0_mu_logvar) -> torch.Tensor:
    """Per-item log q(z0_t) + log|det J^-1| of the pullback, z0_t clipped at
    +-PULLBACK_CLIP and the sum floored at FLOW_LOSS_FLOOR -> (B,)."""
    z0_t = torch.clamp(widen(z0_t), -PULLBACK_CLIP, PULLBACK_CLIP)
    logp = gaussian_log_probability(z0_t, z0_mu_logvar[:, 0, :], z0_mu_logvar[:, 1, :])
    return torch.clamp(logp + logdet, min=FLOW_LOSS_FLOOR)


def flow_params_loss(model, v_in, z0_mu_logvar, generator=None) -> torch.Tensor:
    """FlowParamsLoss per item (train_step.py:162-200 there): v_in through
    the regression flow's inverse, clipped, then the latent flow's inverse,
    in the model's current mode -> (B,) floored log-densities."""
    zK_t, logdet_u = model.regression_flow_inverse(v_in, generator)
    zK_t = torch.clamp(widen(zK_t), -PULLBACK_CLIP, PULLBACK_CLIP)
    z0_t, logdet_t = model.latent_flow_inverse(zK_t, generator)
    return pulled_back_log_density(z0_t, logdet_t + logdet_u, z0_mu_logvar)


def _flow_running_stats(model) -> Dict[str, torch.Tensor]:
    return {k: b for k, b in model.named_buffers()
            if k.startswith(("ae_model.flow.", "reg_model.flow."))
            and k.endswith(("running_mean", "running_var"))}


@contextlib.contextmanager
def _eval_on_stats(model, stats: Dict[str, torch.Tensor]):
    """``model`` in eval mode with the running statistics ``stats`` put in
    place of its own (the tensors are swapped, not written, so what
    autograd saved stays valid); both restored on exit."""
    held = _flow_running_stats(model)
    mode = model.training

    def put(buffers):
        for key, t in buffers.items():
            mod, attr = key.rsplit(".", 1)
            model.get_submodule(mod)._buffers[attr] = t

    model.eval()
    put(stats)
    try:
        yield
    finally:
        put(held)
        model.train(mode)


class Criteria:
    """The loss terms and monitors of one config (train_step.py:118-144)."""

    def __init__(self, model_config: ModelConfig, train_config: TrainConfig,
                 idx_helper: PresetIndexesHelper):
        if train_config.params_cat_bceloss and model_config.params_reg_softmax:
            raise ValueError("params_cat_bceloss excludes params_reg_softmax")
        self.train_config = train_config
        self.normalize = train_config.normalize_losses
        self.beta_final = train_config.beta
        self.latent_flow = model_config.latent_flow_arch is not None
        self.dkl_flow_reg = (self.latent_flow and
                             train_config.latent_flow_input_regularization.lower() == "dkl")
        self.flow_params = not model_config.forward_controls_loss
        if self.flow_params and train_config.flow_loss_bn_mode not in ("train", "eval"):
            raise ValueError(f"flow_loss_bn_mode {train_config.flow_loss_bn_mode!r}")
        self.flow_loss_train_bn = train_config.flow_loss_bn_mode == "train"
        self.scalars = SCALARS + ((FLOORED,) if self.flow_params else ())
        self.controls = None if self.flow_params else SynthParamsLoss(
            idx_helper, train_config.normalize_losses, cat_bce=train_config.params_cat_bceloss,
            cat_softmax=(not model_config.params_reg_softmax
                         and not train_config.params_cat_bceloss),
            cat_softmax_t=train_config.params_cat_softmax_temperature)
        self.qloss = QuantizedNumericalParamsLoss(idx_helper, loss="mse")
        self.accuracy = CategoricalParamsAccuracy(idx_helper)

    def stats_before_step(self, model) -> Optional[Dict[str, torch.Tensor]]:
        """Copies of the flows' running statistics, which the 'eval'-mode
        pullback of a train step reads; None where nothing reads them."""
        if not self.flow_params or self.flow_loss_train_bn:
            return None
        return {k: b.clone() for k, b in _flow_running_stats(model).items()}

    def controls_loss(self, model, outs, v_in, generator=None, stats_before=None):
        """-> (controls loss, per-item pulled-back log-densities or None)."""
        if not self.flow_params:
            return self.controls(widen(outs[5]), v_in), None
        swap = (_eval_on_stats(model, stats_before) if model.training and
                not self.flow_loss_train_bn else contextlib.nullcontext())
        with swap, autocast(v_in.device, self.train_config):
            per_item = flow_params_loss(model, v_in, outs[0], generator)
        return -per_item.mean() / 1000.0, per_item

    def losses(self, outs, x_in, cont, train: bool) -> Dict[str, torch.Tensor]:
        z0_mu_logvar, z0, zK, logdet, x_out, v_out = outs
        recons = reconstruction_loss(widen(x_out), widen(x_in), self.normalize)
        if self.latent_flow:
            lat = flow_vae_latent_loss(z0_mu_logvar, z0, zK, logdet, self.normalize)
        else:
            lat = latent_dkl_loss(z0_mu_logvar, self.normalize)
        flow_in_reg = recons.new_zeros(())
        if train and self.dkl_flow_reg:  # train.py:235-239
            flow_in_reg = 0.1 * self.beta_final * gaussian_dkl(
                z0_mu_logvar[:, 0, :], z0_mu_logvar[:, 1, :], self.normalize)
        return {"recons": recons, "lat": lat, "flow_in_reg": flow_in_reg, "cont": cont}

    @torch.no_grad()
    def metrics(self, terms, outs, x_in, v_in, pulled_back=None) -> Dict[str, torch.Tensor]:
        """Monitoring scalars (train_step.py:346-371)."""
        x_out, v_out = widen(outs[4]), widen(outs[5])
        m = {
            "ReconsLoss/Backprop": terms["recons"].detach(),
            "ReconsLoss/MSE": (terms["recons"].detach() if self.normalize
                               else torch.mean(torch.square(x_out - widen(x_in)))),
            "Controls/BackpropLoss": terms["cont"].detach(),
            "Controls/QLoss": self.qloss(v_out, v_in),
            "Controls/Accuracy": self.accuracy(v_out, v_in),
            "LatLoss": terms["lat"].detach(),
            "FlowInputReg": terms["flow_in_reg"].detach(),
        }
        if pulled_back is not None:
            m[FLOORED] = (pulled_back <= FLOW_LOSS_FLOOR).float().mean()
        return m


def autocast(device: torch.device, train_config: TrainConfig):
    """bf16 autocast on the card when ``compute_dtype='bfloat16'``, with no
    cache of cast weights (a CUDA graph cannot hold one, and the eager step
    runs the same casts); the CPU runs in float32."""
    if device.type == "cuda" and train_config.compute_dtype == "bfloat16":
        return torch.autocast("cuda", dtype=torch.bfloat16, cache_enabled=False)
    return contextlib.nullcontext()


def _keep_draws(ctx, op, *args, **kwargs):
    """The remat checkpoint's policy: keep every random draw's output."""
    return (CheckpointPolicy.MUST_SAVE if torch.Tag.nondeterministic_seeded in op.tags
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _recompute_contexts(model):
    """``context_fn`` of the remat checkpoint: (the forward's context, the
    recompute's). The forward keeps its draws and the recompute reuses
    them; the recompute runs with ``model``'s running statistics frozen."""
    forward, reuse = create_selective_checkpoint_contexts(_keep_draws)

    @contextlib.contextmanager
    def recompute():
        with reuse, running_stats_frozen(model):
            yield

    return forward, recompute()


def forward_for_step(model, train_config: TrainConfig, x_in, sample_info, noise=None,
                     generator: Optional[torch.Generator] = None):
    """``model.forward_full`` for a train step: under a non-reentrant
    checkpoint when ``train_config.remat`` is set (the forward recomputed
    in the backward, the same draws, the running statistics updated
    once)."""
    if not train_config.remat:
        return model.forward_full(x_in, sample_info, noise=noise, generator=generator)
    return torch.utils.checkpoint.checkpoint(
        model.forward_full, x_in, sample_info, noise=noise, generator=generator,
        use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: _recompute_contexts(model))


def train_step(model, optimizer, criteria: Criteria, train_config: TrainConfig,
               x_in, v_in, sample_info, beta,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               latents: bool = False) -> Dict[str, torch.Tensor]:
    """One optimisation step (train_step.py:222-343); returns the metrics as
    0-d tensors on the device (plus ``TotalLoss``), without a host sync, and
    with ``latents`` the rows' ``z0_mu`` and ``z0`` (B, dim_z), detached in
    the forward's dtype. ``beta`` is a float or a 0-d tensor."""
    model.train()
    stats_before = criteria.stats_before_step(model)
    with autocast(x_in.device, train_config):
        outs = forward_for_step(model, train_config, x_in, sample_info, noise, generator)
    cont, pulled_back = criteria.controls_loss(model, outs, v_in, generator, stats_before)
    terms = criteria.losses(outs, x_in, cont, train=True)
    total = terms["recons"] + terms["lat"] * beta + terms["flow_in_reg"] + terms["cont"]
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    optimizer.step()
    m = criteria.metrics(terms, outs, x_in, v_in, pulled_back)
    m["TotalLoss"] = total.detach()
    if latents:
        m["z0_mu"], m["z0"] = outs[0][:, 0, :].detach(), outs[1].detach()
    return m


@torch.no_grad()
def eval_step(model, criteria: Criteria, train_config: TrainConfig, x_in, v_in,
              sample_info) -> Dict[str, torch.Tensor]:
    """Validation / inference step (train_step.py:374-415): the metrics as
    0-d tensors, plus the latents ``z0_mu`` and ``z0`` (B, dim_z) in float32
    (train_step.py:364-367 there), equal in eval mode, and the outputs
    ``x_out`` and ``v_out`` in the forward's dtype."""
    model.eval()
    with autocast(x_in.device, train_config):
        outs = model.forward_full(x_in, sample_info)
    cont, pulled_back = criteria.controls_loss(model, outs, v_in)
    terms = criteria.losses(outs, x_in, cont, train=False)
    m = criteria.metrics(terms, outs, x_in, v_in, pulled_back)
    m["z0_mu"], m["z0"] = outs[0][:, 0, :].float(), outs[1].float()
    m["x_out"], m["v_out"] = outs[4], outs[5]
    return m
