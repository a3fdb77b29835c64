"""The port's train step, eval step, optimizer and train loop against the
JAX package's, from the same weights and inputs.

The JAX side differentiates the same loss as its train step's ``loss_fn``
(train_step.py:262-320: recons + beta * latent + controls, float32, BN in
train mode). Reparameterization noise is not portable between the two
frameworks' generators, so the port is handed the JAX draw, recovered as
(z0 - mu) / sigma, and both dropout rates are 0. Bars: each loss term 2e-3
relative; leaf-wise gradient cosine min > 0.95 and median > 0.99 (the
torch twin's measured level, tests/test_torch_parity.py).

BN running statistics after the step. At float32 the median statistic is
held within 1e-5 of the JAX one (relative, in norm) and every one within
1e-4: measured, the median differs by 8.4e-7 and the worst, in the last
coupling layer of the regression flow, by 1.4e-5. That gap is float32
rounding of the flows' inputs, which the batch-of-4 BatchNorms of the
conditioners amplify (flax computes the batch variance as
E[x^2] - E[x]^2), not a fault of the port: from the same pre-step state and
the JAX step's own flow inputs, the two flows' train-mode updates agree to
8.9e-7 (relative, in norm) at float32, and at float64 on both sides every
element of every flow statistic is held within 1e-5 of that statistic's
largest magnitude (measured: 2.7e-8 at worst). A torch-style unbiased
variance update would move the variances by ~1/(B-1) = 33% of the batch
term, far outside every bar."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from preset_gen_vae_tpu.models.flows import LatentFlow as JaxLatentFlow
from preset_gen_vae_tpu.models.flows import RegressionFlow as JaxRegressionFlow
from preset_gen_vae_tpu.training.train_step import (
    _flow_controls_loss,
    _latent_loss,
    _recons_loss,
    build_criteria,
    create_train_state,
    make_eval_step,
    make_optimizer as jax_make_optimizer,
)
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch import weights
from preset_gen_vae_tpu_torch.training import train_step as ts
from preset_gen_vae_tpu_torch.training.loop import train_config
from _torch_port_fixtures import isolated_data_root  # noqa: F401 (autouse)
from test_torch_port_model import flagship_pair

BETA = 0.2
# Flows cut from the flagship's 6 layers to 3 (width 300 and dim_z 610 kept,
# the first layer keeps the inter-layer BatchNormFlow, dropout site and
# conditioner BNs): the JAX compile of the step scales with flow depth, and
# the full-depth model is held in eval mode in tests/test_torch_port_model.py.
FLOW_ARCH = "realnvp_3l300"


def step_both(train_kwargs, model_kwargs, adjust=None):
    """One train step on both sides from the same weights. The JAX side is
    its ``loss_fn`` (train_step.py:262-320): recons + beta * latent +
    controls, the controls term SynthParamsLoss or the FlowParamsLoss
    pullback of ``_flow_controls_loss`` in the configured BN mode, with the
    batch statistics chained as there."""
    port, ext, jvars, (pm, pt), (jm, jt), helper, jhelper, x, v, info = flagship_pair(
        dict(fc_dropout=0.0, reg_fc_dropout=0.0, **train_kwargs), model_kwargs, adjust)
    crit = build_criteria(jm, jt, jhelper)

    def loss_fn(params):
        variables = {"params": params, "batch_stats": jvars["batch_stats"]}
        outs, mut = ext.apply(variables, jnp.asarray(x), jnp.asarray(info), train=True,
                              method=ext.forward_full,
                              rngs={"sampling": jax.random.PRNGKey(11),
                                    "dropout": jax.random.PRNGKey(12)},
                              mutable=["batch_stats"])
        bs = mut["batch_stats"]
        recons = _recons_loss(outs[4], jnp.asarray(x), jt.normalize_losses)
        lat = _latent_loss(jm, jt, *outs[:4])
        if jm.forward_controls_loss:
            cont = crit["controls"](outs[5], jnp.asarray(v))
        elif jt.flow_loss_bn_mode == "train":
            cont, bs = _flow_controls_loss(ext, {"params": params, "batch_stats": bs},
                                           jnp.asarray(v), outs[0], train_mode=True,
                                           rng_pair=jax.random.split(jax.random.PRNGKey(13)))
        else:
            cont, _ = _flow_controls_loss(ext, variables, jnp.asarray(v), outs[0],
                                          train_mode=False)
        return recons + BETA * lat + cont, (outs, bs, recons, lat, cont)

    (j_total, (j_outs, j_bs, *j_terms)), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jvars["params"])
    mu_logvar, z0 = np.asarray(j_outs[0]), np.asarray(j_outs[1])
    noise = (z0 - mu_logvar[:, 0]) / np.exp(mu_logvar[:, 1] / 2.0)

    flows_before = copy.deepcopy({"ae_model": port.ae_model.flow, "reg_model": port.reg_model.flow})
    optimizer = ts.make_optimizer(port, pt)
    m = ts.train_step(port, optimizer, ts.Criteria(pm, pt, helper), pt, torch.from_numpy(x),
                      torch.from_numpy(v), torch.from_numpy(info), BETA,
                      noise=torch.from_numpy(noise.astype(np.float32)))
    return dict(port=port, ext=ext, jvars=jvars, configs=(pm, pt, jm, jt), helpers=(helper, jhelper),
                data=(x, v, info), j_total=float(j_total), j_terms=[float(t) for t in j_terms],
                j_bs=jax.device_get(j_bs), j_grads=jax.device_get(j_grads), m=m,
                flows_before=flows_before, flow_inputs={"ae_model": z0, "reg_model": np.asarray(j_outs[2])},
                noise=noise.astype(np.float32))


def assert_loss_terms_match(st):
    m, (j_recons, j_lat, j_cont) = st["m"], st["j_terms"]
    assert float(m["ReconsLoss/Backprop"]) == pytest.approx(j_recons, rel=2e-3)
    assert float(m["LatLoss"]) == pytest.approx(j_lat, rel=2e-3)
    assert float(m["Controls/BackpropLoss"]) == pytest.approx(j_cont, rel=2e-3)
    assert float(m["TotalLoss"]) == pytest.approx(st["j_total"], rel=2e-3)


def gradient_cosines(st):
    """Each parameter's gradient cosine with the JAX one, and the number
    of parameters."""
    port, j_grads = st["port"], st["j_grads"]
    cosines, n = [], 0
    for key, coll, path, tf in weights.flax_leaves(port):
        if coll != "params":
            continue
        n += 1
        tg = port.get_parameter(key).grad.numpy().ravel()
        jg = weights.to_torch_layout(weights.lookup(j_grads, path), tf).ravel()
        nt, nj = np.linalg.norm(tg), np.linalg.norm(jg)
        # a bias feeding a train-mode BatchNorm has a mathematically zero
        # gradient: both sides carry only rounding noise there
        if nt / np.sqrt(tg.size) < 1e-6 and nj / np.sqrt(jg.size) < 1e-6:
            continue
        cosines.append(float(tg @ jg / (nt * nj + 1e-30)))
    return cosines, n


def assert_gradients_align(st, min_leaves=100):
    cosines, n = gradient_cosines(st)
    assert n == len(list(st["port"].parameters())) and len(cosines) > min_leaves
    assert min(cosines) > 0.95, sorted(cosines)[:5]
    assert float(np.median(cosines)) > 0.99


def batch_stats_rel_errors(st):
    """Each running statistic's relative distance (in norm) to the JAX one."""
    port, j_bs = st["port"], st["j_bs"]
    sd, rel = port.state_dict(), {}
    for key, coll, path, tf in weights.flax_leaves(port):
        if coll == "batch_stats":
            got, want = sd[key].numpy(), np.asarray(weights.lookup(j_bs, path))
            rel[key] = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    return rel


def assert_batch_stats_match(st, min_stats=60):
    rel = batch_stats_rel_errors(st)
    assert len(rel) > min_stats
    assert float(np.median(list(rel.values()))) < 1e-5
    worst = max(rel, key=rel.get)
    assert rel[worst] < 1e-4, (worst, rel[worst])


def assert_eval_step_matches(stepped):
    """The eval step after the train step, on the port's updated weights:
    each metric within the loss terms' bar."""
    port, ext = stepped["port"], stepped["ext"]
    pm, pt, jm, jt = stepped["configs"]
    (helper, jhelper), (x, v, info) = stepped["helpers"], stepped["data"]
    jvars = jax.tree_util.tree_map(jnp.asarray, weights.flax_variables_from_model(port))
    state = create_train_state(ext, jvars, jt)
    jm_ = jax.device_get(jax.jit(make_eval_step(ext, jm, jt, jhelper))(
        state, jnp.asarray(x), jnp.asarray(v), jnp.asarray(info)))
    tm = ts.eval_step(port, ts.Criteria(pm, pt, helper), pt, torch.from_numpy(x),
                      torch.from_numpy(v), torch.from_numpy(info))
    for k in ("ReconsLoss/Backprop", "ReconsLoss/MSE", "LatLoss", "Controls/BackpropLoss",
              "Controls/QLoss", "Controls/Accuracy"):
        assert float(tm[k]) == pytest.approx(float(jm_[k]), rel=2e-3, abs=1e-6), k
    assert float(tm["FlowInputReg"]) == 0.0


@pytest.fixture(scope="module")
def stepped():
    return step_both({}, dict(latent_flow_arch=FLOW_ARCH,
                              params_regression_architecture=f"flow_{FLOW_ARCH}"))


def test_train_step_loss_terms_match_jax(stepped):
    assert_loss_terms_match(stepped)


def test_train_step_gradients_align_with_jax(stepped):
    assert_gradients_align(stepped)


def test_batch_stats_after_step_match_jax(stepped):
    assert_batch_stats_match(stepped)

    port = stepped["port"]
    # the float64 witness: each flow's train-mode update from the pre-step
    # state on the JAX step's own input, both sides at float64
    jax_flows = {"ae_model": JaxLatentFlow(flow_arch=FLOW_ARCH, features=610,
                                           dtype=jnp.float64),
                 "reg_model": JaxRegressionFlow(flow_arch=FLOW_ARCH, features=610,
                                                dtype=jnp.float64)}
    n = 0
    for name, jflow in jax_flows.items():
        flow = stepped["flows_before"][name].double().train()
        inp = stepped["flow_inputs"][name].astype(np.float64)
        with torch.no_grad():
            flow(torch.from_numpy(inp))
        with jax.enable_x64(True):
            start = {c: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                                               stepped["jvars"][c][name]["flow"])
                     for c in ("params", "batch_stats")}
            _, mut = jflow.apply(start, jnp.asarray(inp), train=True, mutable=["batch_stats"])
            j_stats = jax.device_get(mut["batch_stats"])
        fsd = flow.state_dict()
        for key, coll, path, tf in weights.flax_leaves(port):
            prefix = f"{name}.flow."
            if coll == "batch_stats" and key.startswith(prefix):
                n += 1
                got = fsd[key[len(prefix):]].numpy()
                want = np.asarray(weights.lookup(j_stats, path[2:]))
                err = float(np.abs(got - want).max() / np.abs(want).max())
                assert err < 1e-5, (key, err)
    assert n > 40


def test_eval_step_metrics_match_jax(stepped):
    assert_eval_step_matches(stepped)


def test_adam_is_coupled_l2_like_make_optimizer():
    """torch Adam(weight_decay) and the JAX package's optax chain take the
    same three steps on the same gradients."""
    tc = cfg.TrainConfig(initial_learning_rate=1e-2, weight_decay=0.1)
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(8).astype(np.float32)
    grads = [rng.standard_normal(8).astype(np.float32) for _ in range(3)]
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = ts.make_optimizer(torch.nn.ParameterList([p]), tc)
    tx = jax_make_optimizer(tc)
    jw, st = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
        upd, st = tx.update(jnp.asarray(g), st, jw)
        jw = optax.apply_updates(jw, upd)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)


def test_tiny_train_config_on_cpu(tmp_path):
    """One epoch through the user entry point, TensorBoard on: the run dir
    holds the frozen config, the model summary, the events and the last
    epoch's checkpoint."""
    summary = train_config(
        cfg.ModelConfig(dataset_synth_args=(None, (1, 2)), logs_root_dir=str(tmp_path)),
        cfg.TrainConfig(n_epochs=1, minibatch_size=16), device="cpu",
        dataset_kwargs={"n_synthetic_presets": 64})
    assert summary["device"] == "cpu" and summary["train_steps"] == 2
    assert summary["input_size"] == [16, 1, 257, 347]
    assert summary["memory"] is None  # the card's memory split: off the card, nothing to read
    assert summary["tconv_out_launches"] == 0  # the decoder's output conv runs its plain version
    vals = [v for v in summary.values() if isinstance(v, float)]
    assert len(vals) > 15 and all(np.isfinite(vals))
    run_dir = tmp_path / "FlVAE2" / "00_debug"
    assert (run_dir / "config.json").exists() and (run_dir / "model_summary.txt").exists()
    assert list((run_dir / "tensorboard").glob("events.out.tfevents.*"))
    assert (run_dir / "checkpoints" / "0" / "state.pt").exists()
