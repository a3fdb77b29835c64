"""The paper's other heads, latent models and losses in the port against the
JAX package: the MLP regression head (``r2mlp400``), BasicVAE with its Dkl
latent loss, MAF flows, and FlowParamsLoss (``r2flowloss_train``,
``forward_controls_loss=False``) in both ``flow_loss_bn_mode``s.

Bars: eval-mode ``forward_full`` at rtol 1e-4 / atol 2e-4 (as
tests/test_torch_port_model.py); one train step at the bars of
tests/test_torch_port_train.py (loss terms 2e-3 relative, gradient cosines,
BN running statistics), dropout 0 and the JAX reparameterization draw;
MAF's invertibility and autoregressive Jacobian in float64. Flows are cut
to 3 layers (2 for MAF) with their widths kept. No MAF inverse runs at
the full 610 features here: its D sequential MADE passes are held at
12 features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preset_gen_vae_tpu.losses.vae_losses import latent_dkl_loss as jax_latent_dkl_loss
from preset_gen_vae_tpu.models import flows as jflows
from preset_gen_vae_tpu.training.train_step import create_train_state, make_eval_step
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch import weights
from preset_gen_vae_tpu_torch.data.dexed_spec import build_dexed_preset_spec
from preset_gen_vae_tpu_torch.data.preset import PresetIndexesHelper
from preset_gen_vae_tpu_torch.evaluation import evaluate as ev
from preset_gen_vae_tpu_torch.losses.vae_losses import latent_dkl_loss
from preset_gen_vae_tpu_torch.models.build import build_extended_ae_model
from preset_gen_vae_tpu_torch.models.flows import (
    LatentFlow,
    MaskedAffineAutoregressive,
    RegressionFlow,
    made_masks,
)
from preset_gen_vae_tpu_torch.models.vae import BasicVAE
from preset_gen_vae_tpu_torch.training import train_step as ts
from preset_gen_vae_tpu_torch.training.loop import train_config
from _torch_port_fixtures import isolated_data_root, two_torch_threads  # noqa: F401 (autouse)
from test_torch_port_model import _perturb, flagship_pair
from test_torch_port_multinote import assert_outputs_match, eval_forward_both
from test_torch_port_train import (
    assert_batch_stats_match,
    assert_gradients_align,
    assert_loss_terms_match,
    step_both,
)

LATENT3 = "realnvp_3l300"
VARIANTS = {
    # r2mlp400: mlp_3l1024 head, dim_z 256
    "mlp_head": dict(params_regression_architecture="mlp_3l1024", dim_z=256,
                     latent_flow_arch=LATENT3),
    # BasicVAE (no latent flow) with a MAF regression head, forward direction
    "basic_vae_maf_head": dict(latent_flow_arch=None,
                               params_regression_architecture="flow_maf_2l300"),
}
FLOW_LOSS = dict(forward_controls_loss=False, latent_flow_arch=LATENT3,
                 params_regression_architecture=f"flow_{LATENT3}")


# ---------------------------------------------------------------- forwards
@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    return request.param, flagship_pair(model_kwargs=VARIANTS[request.param])


def test_variant_eval_forward_matches_jax(variant):
    """The MLP head's layers are fc1..fc4; BasicVAE returns zK = z0 and a
    zero logdet, and its eval step reports the Dkl of vae_losses.py:54-58
    as LatLoss."""
    name, (port, ext, jvars, (pm, pt), _, helper, _, x, v, info) = variant
    outs, touts = eval_forward_both(port, ext, jvars, x, info)
    assert_outputs_match(outs, touts)
    assert touts[5].shape == (x.shape[0], helper.learnable_preset_size)
    if name == "mlp_head":
        assert [f"fc{i}" for i in range(1, 5)] == [n for n, _ in port.reg_model.named_children()
                                                   if n.startswith("fc")]
        assert touts[0].shape[-1] == 256
        return
    assert isinstance(port.ae_model, BasicVAE)
    np.testing.assert_array_equal(touts[1], touts[2])
    assert not touts[3].any()
    want = float(jax_latent_dkl_loss(jnp.asarray(outs[0]), True))
    assert float(latent_dkl_loss(torch.from_numpy(touts[0]), True)) == pytest.approx(want, rel=1e-5)
    m = ts.eval_step(port, ts.Criteria(pm, pt, helper), pt, torch.from_numpy(x),
                     torch.from_numpy(v), torch.from_numpy(info))
    assert float(m["LatLoss"]) == pytest.approx(want, rel=1e-4)


def test_builder_refuses_what_the_jax_package_cannot_run():
    helper = PresetIndexesHelper(build_dexed_preset_spec())
    tc = cfg.TrainConfig(minibatch_size=2)
    mlp = cfg.resolve(cfg.ModelConfig(params_regression_architecture="mlp_3l1024",
                                      forward_controls_loss=False), tc)[0]
    with pytest.raises(ValueError, match="forward_controls_loss"):
        build_extended_ae_model(mlp, tc, helper)
    midi = cfg.resolve(cfg.ModelConfig(latent_flow_arch=None, midi_notes=((40, 85), (60, 85))),
                       tc)[0]
    with pytest.raises(ValueError, match="latent flow"):
        build_extended_ae_model(midi, tc, helper)
    pullback = cfg.resolve(cfg.ModelConfig(latent_flow_arch=None, forward_controls_loss=False,
                                           params_regression_architecture="flow_maf_2l300"),
                           tc)[0]
    with pytest.raises(ValueError, match="latent flow"):
        build_extended_ae_model(pullback, tc, helper)


# ---------------------------------------------------------------- MAF
D_MAF = 12


def _maf_pair(port_flow, jax_flow, seed=0):
    torch.manual_seed(seed)
    _perturb(port_flow)
    with torch.no_grad():  # move every masked kernel and bias off its init
        for p in port_flow.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    variables = weights.flax_variables_from_model(port_flow)
    return port_flow, jax.tree_util.tree_map(jnp.asarray, {
        k: v for k, v in variables.items() if v})


@pytest.mark.parametrize("kind", ["latent", "regression", "bn_within"])
def test_maf_flows_match_jax_both_directions(kind):
    """maf_2l32 on 12 features, eval mode: forward and the sequential inverse
    from the same weights (kernels and biases, and the BN leaves ``bns_N``
    of a MAF layer built with BatchNorm)."""
    if kind == "latent":
        port, jflow = LatentFlow("maf_2l32", D_MAF), jflows.LatentFlow("maf_2l32", D_MAF)
    elif kind == "regression":
        port, jflow = (RegressionFlow("maf_2l32", D_MAF),
                       jflows.RegressionFlow("maf_2l32", D_MAF))
    else:
        port = MaskedAffineAutoregressive(D_MAF, 32, use_batch_norm=True)
        jflow = jflows.MaskedAffineAutoregressive(features=D_MAF, hidden_features=32,
                                                  use_batch_norm=True)
    port, jvars = _maf_pair(port, jflow)
    if kind == "bn_within":
        assert set(jvars["batch_stats"]) == {"bns_0", "bns_1"}
    x = np.random.default_rng(1).standard_normal((5, D_MAF)).astype(np.float32)
    port.eval()
    for direction in ("forward", "inverse"):
        jy, jld = jflow.apply(jvars, jnp.asarray(x), train=False, method=direction)
        with torch.no_grad():
            y, ld = getattr(port, direction)(torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(ld.numpy(), np.asarray(jld), rtol=1e-4, atol=2e-4)



def test_maf_inverse_overflows_where_the_jax_one_does():
    """The MAF regression head's inverse at full width (``maf_6l300``, 610
    features, the same weights): equal to the JAX package's on unit-scale
    inputs, and on inputs 10x larger its 6 x 610 sequential passes leave
    f32's range on the same rows in both packages, so a non-finite z_K -> v
    (the head's direction under FlowParamsLoss) is the reference's too."""
    port, jflow = RegressionFlow("maf_6l300", 610), jflows.RegressionFlow("maf_6l300", 610)
    port, jvars = _maf_pair(port, jflow)
    port.eval()
    rng = np.random.default_rng(1)
    for scale, blown in ((1.0, False), (10.0, True)):
        x = (rng.standard_normal((4, 610)) * scale).astype(np.float32)
        jy, _ = jflow.apply(jvars, jnp.asarray(x), train=False, method="inverse")
        with torch.no_grad():
            y, _ = port.inverse(torch.from_numpy(x))
        jy, y = np.asarray(jy), y.numpy()
        np.testing.assert_array_equal(np.isfinite(y).all(1), np.isfinite(jy).all(1))
        assert (~np.isfinite(y).all(1)).all() if blown else np.isfinite(y).all()
        if not blown:
            np.testing.assert_allclose(y, jy, rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("flow_cls", [LatentFlow, RegressionFlow])
def test_maf_invertible_f64(flow_cls):
    """forward then inverse is the identity, and the log-determinants
    cancel; the inverse runs in eval mode even on a module in train mode."""
    torch.manual_seed(0)
    flow, _ = _maf_pair(flow_cls("maf_2l32", D_MAF), None)
    flow = flow.double().eval()
    x = torch.randn(6, D_MAF, dtype=torch.float64)
    with torch.no_grad():
        y, ld = flow.forward(x)
        flow.train()  # the regression MAF's dropout 0.5 must stay off in the inverse
        x2, ld_inv = flow.inverse(y)
    assert float((y - x).abs().max()) > 1e-2
    torch.testing.assert_close(x2, x, rtol=0, atol=1e-10)
    torch.testing.assert_close(ld + ld_inv, torch.zeros(6, dtype=torch.float64), rtol=0,
                               atol=1e-10)


def test_maf_jacobian_is_autoregressive_f64():
    """One MAF layer's Jacobian is lower-triangular (y_d depends on x_<=d
    only) with the scales on its diagonal, and the flow's logdet, with its
    ReversePermutations, is log|det J|: triangular in the permuted order."""
    torch.manual_seed(0)
    layer, _ = _maf_pair(MaskedAffineAutoregressive(D_MAF, 32), None)
    layer = layer.double().eval()
    x = torch.randn(D_MAF, dtype=torch.float64)
    J = torch.autograd.functional.jacobian(lambda v: layer.forward(v[None])[0][0], x)
    assert float(torch.triu(J, diagonal=1).abs().max()) == 0.0
    s, _ = layer._params(x[None], None)
    torch.testing.assert_close(torch.diagonal(J), s[0], rtol=1e-12, atol=0)
    assert float(torch.tril(J, diagonal=-1).abs().max()) > 1e-3  # not diagonal

    flow, _ = _maf_pair(LatentFlow("maf_2l32", D_MAF), None)
    flow = flow.double().eval()
    J = torch.autograd.functional.jacobian(lambda v: flow.forward(v[None])[0][0], x)
    with torch.no_grad():
        ld = flow.forward(x[None])[1][0]
    torch.testing.assert_close(ld, torch.linalg.slogdet(J)[1], rtol=1e-10, atol=1e-10)


def test_made_masks_are_the_jax_masks():
    for got, want in zip(made_masks(9, 20, 2), jflows._made_masks(9, 20, 2)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- FlowParamsLoss
def tame_couplings(model):
    """Scales each coupling conditioner's output layer by 1e-2. At init the
    latent flow's inverse divides by scales near their 1e-3 floor and
    pulls the target presets back to |z0| ~ 1e5, where every item sits at
    the -1e8 floor (the JAX package's train_step.py:145-159) and the loss has no
    gradient; with scales near sigmoid(2) every item is scored."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if name.endswith("conditioner.final"):
                mod.weight.mul_(1e-2)


@pytest.fixture(scope="module", params=["train", "eval"])
def stepped_flow_loss(request):
    return request.param, step_both(dict(flow_loss_bn_mode=request.param), FLOW_LOSS,
                                    tame_couplings)


def test_flow_params_loss_terms_match_jax(stepped_flow_loss):
    mode, st = stepped_flow_loss
    assert_loss_terms_match(st)
    assert float(st["m"][ts.FLOORED]) == 0.0  # every item scored, none at the floor
    assert np.isfinite(st["j_terms"][2]) and st["j_terms"][2] != 0.0


def test_flow_params_loss_gradients_align_with_jax(stepped_flow_loss):
    assert_gradients_align(stepped_flow_loss[1])


def test_flow_params_loss_batch_stats_match_jax(stepped_flow_loss):
    """'train': the pullback updates the running statistics a second time,
    chained after the forward's; 'eval': it reads the pre-step ones and
    leaves the forward's update alone."""
    assert_batch_stats_match(stepped_flow_loss[1])


@pytest.mark.parametrize("stepped_flow_loss", ["train"], indirect=True)
def test_flow_params_loss_eval_step_matches_jax(stepped_flow_loss):
    """The eval step after the train step: its pullback runs in eval mode,
    whatever the train step's BN mode, and updates nothing."""
    mode, st = stepped_flow_loss
    port, ext = st["port"], st["ext"]
    pm, pt, jm, jt = st["configs"]
    (helper, jhelper), (x, v, info) = st["helpers"], st["data"]
    jvars = jax.tree_util.tree_map(jnp.asarray, weights.flax_variables_from_model(port))
    jmet = jax.device_get(jax.jit(make_eval_step(ext, jm, jt, jhelper))(
        create_train_state(ext, jvars, jt), jnp.asarray(x), jnp.asarray(v), jnp.asarray(info)))
    before = {k: b.clone() for k, b in port.state_dict().items()}
    tm = ts.eval_step(port, ts.Criteria(pm, pt, helper), pt, torch.from_numpy(x),
                      torch.from_numpy(v), torch.from_numpy(info))
    for k in ("ReconsLoss/Backprop", "LatLoss", "Controls/BackpropLoss", "Controls/QLoss",
              "Controls/Accuracy"):
        assert float(tm[k]) == pytest.approx(float(jmet[k]), rel=2e-3, abs=1e-6), k
    assert all(torch.equal(before[k], b) for k, b in port.state_dict().items())


def test_flow_params_loss_guard_floors_blown_up_items():
    """An item pulled back to +-inf (or with a -inf logdet) lands at the
    floor with zero gradient; the others keep theirs."""
    rng = np.random.default_rng(0)
    z0 = torch.from_numpy(rng.standard_normal((4, 6))).requires_grad_()
    mu_logvar = torch.from_numpy(rng.standard_normal((4, 2, 6)) * 0.1).requires_grad_()
    logdet = torch.zeros(4, dtype=torch.float64, requires_grad=True)
    z0_t = torch.stack([z0[0], z0[1] + float("inf"), z0[2] - float("inf"), z0[3]])
    ld = logdet + torch.tensor([0.0, 0.0, 0.0, float("-inf")], dtype=torch.float64)
    per_item = ts.pulled_back_log_density(z0_t, ld, mu_logvar)
    assert per_item[1:].tolist() == [ts.FLOW_LOSS_FLOOR] * 3
    assert float(per_item[0]) > ts.FLOW_LOSS_FLOOR and torch.isfinite(per_item).all()
    (-per_item.mean() / 1000.0).backward()
    for g in (z0.grad, mu_logvar.grad, logdet.grad):
        assert torch.isfinite(g).all() and not g[1:].any() and g[0].abs().sum() > 0


# ---------------------------------------------------------------- end to end
@pytest.mark.parametrize("name", ["flowloss", "mlp", "maf_flowloss"])
def test_variant_trains_and_evaluates_on_cpu(tmp_path, name):
    """One epoch of a variant through ``train_config`` on a small corpus;
    the FlowParamsLoss runs report their floored share (with a MAF head,
    whose z_K -> v direction is its inverse in every forward), and the MLP
    run is evaluated from its run dir (the eval steps of BasicVAE and
    FlowParamsLoss are held against the JAX package above)."""
    model_kw = {"flowloss": dict(forward_controls_loss=False, latent_flow_arch="realnvp_2l300",
                                 params_regression_architecture="flow_realnvp_3l300"),
                "mlp": dict(params_regression_architecture="mlp_3l1024", dim_z=256,
                            latent_flow_arch="realnvp_2l300"),
                "maf_flowloss": dict(forward_controls_loss=False, latent_flow_arch="realnvp_2l300",
                                     params_regression_architecture="flow_maf_2l300")}[name]
    model_c = cfg.ModelConfig(dataset_synth_args=(None, (1, 2)), logs_root_dir=str(tmp_path),
                              run_name=name, **model_kw)
    kw = {"n_synthetic_presets": 12}
    summary = train_config(model_c, cfg.TrainConfig(n_epochs=1, minibatch_size=4, verbosity=0),
                           device="cpu", dataset_kwargs=kw, use_tensorboard=False)
    assert summary["train_steps"] == 1
    vals = {k: v for k, v in summary.items() if isinstance(v, float)}
    assert all(np.isfinite(list(vals.values()))), vals
    assert (f"{ts.FLOORED}/Train" in summary) is name.endswith("flowloss")
    if name.endswith("flowloss"):
        assert 0.0 <= summary[f"{ts.FLOORED}/Train"] <= 1.0
    if name == "mlp":
        means = ev.evaluate_model_from_dir(summary["run_dir"],
                                           cfg.EvalConfig(audio_render_backend="cpp"), device="cpu",
                                           dataset_kwargs=kw)
        assert len(means["preset_UID"]) == 2 and np.isfinite(means["spec_mae"]).all()
