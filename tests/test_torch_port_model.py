"""The port's flagship FlVAE2 model against the JAX package's, with the same
weights: the eval-mode ``forward_full`` at float32, the weight transplant
both ways, the decoder geometry, and RealNVP invertibility in float64.

Weights: the port builds the model from a seed, its BatchNorm scales,
biases and running statistics are moved away from (1, 0, 0, 1) so that a
swapped leaf cannot hide, ``weights.flax_variables_from_model`` exports
them as a flax variables dict, and ``weights.load_flax_variables`` loads
that dict into a copy of the model whose every leaf was set to NaN, so
that a leaf the loader misses cannot pass. The JAX model
applies the same dict (flax ``init`` is skipped: it costs ~25 s on the CPU).
Forward bar: rtol 1e-4 / atol 2e-4 (PARITY.md "End-to-end numerical
parity")."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preset_gen_vae_tpu import config as jcfg
from preset_gen_vae_tpu.data.dexed_spec import build_dexed_preset_spec as jax_spec
from preset_gen_vae_tpu.data.preset import PresetIndexesHelper as JaxHelper
from preset_gen_vae_tpu.models import build as jbuild
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch import weights
from preset_gen_vae_tpu_torch.data.dexed_spec import build_dexed_preset_spec
from preset_gen_vae_tpu_torch.data.preset import PresetIndexesHelper
from preset_gen_vae_tpu_torch.models.build import build_extended_ae_model
from preset_gen_vae_tpu_torch.models.flows import BatchNormFlow, LatentFlow, RegressionFlow
from preset_gen_vae_tpu_torch.models.layers import BatchNorm

B, H, W = 4, 257, 347


def _perturb(model, seed=7):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.weight.mul_(torch.from_numpy(rng.uniform(0.8, 1.2, mod.weight.shape)).float())
                mod.bias.add_(torch.from_numpy(rng.normal(0, 0.05, mod.bias.shape)).float())
            if isinstance(mod, BatchNormFlow):
                mod.log_gamma.add_(torch.from_numpy(rng.normal(0, 0.05, mod.log_gamma.shape)).float())
                mod.beta.add_(torch.from_numpy(rng.normal(0, 0.05, mod.beta.shape)).float())
            if isinstance(mod, (BatchNorm, BatchNormFlow)):
                n = mod.running_mean.shape
                mod.running_mean.add_(torch.from_numpy(rng.normal(0, 0.05, n)).float())
                mod.running_var.mul_(torch.from_numpy(rng.uniform(0.7, 1.4, n)).float())
    return model


def flagship_pair(train_kwargs=None, model_kwargs=None, adjust=None):
    """(port model loaded from the flax dict, JAX ExtendedAE, flax variables
    as jax arrays, port configs, JAX configs, helper, x, v, info).
    ``model_kwargs`` override the flagship ``ModelConfig`` on both sides;
    x has the resolved config's channels (stacked notes), info cycles its
    MIDI notes, and dim_z is the learnable length for a flow head.
    ``adjust(model)`` edits the port's weights before they are exported."""
    helper = PresetIndexesHelper(build_dexed_preset_spec())
    L = helper.learnable_preset_size
    kw = dict(minibatch_size=B, compute_dtype="float32", **(train_kwargs or {}))
    pm, pt = cfg.resolve(cfg.ModelConfig(**(model_kwargs or {})), cfg.TrainConfig(**kw))
    C = pm.input_tensor_size[1]
    fix = dict(synth_params_count=L, learnable_params_tensor_length=L,
               dim_z=L if pm.params_regression_architecture.startswith("flow_") else pm.dim_z,
               input_tensor_size=(B, C, H, W))
    pm = dataclasses.replace(pm, **fix)
    jm, jt = jcfg.resolve(jcfg.ModelConfig(**(model_kwargs or {})), jcfg.TrainConfig(**kw))
    jm = dataclasses.replace(jm, **fix)
    source = _perturb(build_extended_ae_model(pm, pt, helper, seed=0))
    if adjust is not None:
        adjust(source)
    variables = weights.flax_variables_from_model(source)
    blank = copy.deepcopy(source)
    with torch.no_grad():
        for t in blank.state_dict().values():
            t.fill_(float("nan") if t.is_floating_point() else -1)
    port = weights.load_flax_variables(blank, variables)
    for (k, a), (k2, b) in zip(source.state_dict().items(), port.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    jhelper = JaxHelper(jax_spec())
    _, _, _, ext = jbuild.build_extended_ae_model(jm, jt, jhelper)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, C, H, W)) * 0.3).astype(np.float32)
    v = helper.full_to_learnable_batch(rng.random((B, helper.full_preset_size)).astype(np.float32))
    notes = pm.midi_notes
    info = np.array([[0, *notes[i % len(notes)]] for i in range(B)], dtype=np.int32)
    return port, ext, jvars, (pm, pt), (jm, jt), helper, jhelper, x, v, info


@pytest.fixture(scope="module")
def pair():
    return flagship_pair()


def test_flax_tree_matches_jax_init_structure(pair):
    """The exported dict has exactly the leaves and shapes of the JAX
    package's own model (checked with jax.eval_shape: no compile)."""
    port, ext, jvars, _, (jm, _), *_ = pair
    shapes = jax.eval_shape(lambda: jbuild.init_extended_ae(ext, 0, jm.input_tensor_size))
    want = jax.tree_util.tree_map(lambda s: s.shape, dict(shapes))
    got = jax.tree_util.tree_map(lambda a: a.shape, jvars)
    assert got == want


def test_flagship_eval_forward_matches_jax(pair):
    port, ext, jvars, *_, x, v, info = pair
    outs = jax.jit(lambda variables, x, info: ext.apply(
        variables, x, info, train=False, method=ext.forward_full))(
        jvars, jnp.asarray(x), jnp.asarray(info))
    port.eval()
    with torch.no_grad():
        touts = port.forward_full(torch.from_numpy(x), torch.from_numpy(info))
    names = ("z0_mu_logvar", "z0", "zK", "logdet", "x_out", "v_out")
    assert touts[4].shape == (B, 1, H, W) and touts[5].shape == (B, 610)
    for name, a, b in zip(names, outs, touts):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=2e-4,
                                   err_msg=f"forward output '{name}'")


@pytest.mark.parametrize("flow_cls", [LatentFlow, RegressionFlow])
def test_realnvp_invertible_f64(flow_cls):
    torch.manual_seed(0)
    flow = flow_cls("realnvp_6l300", 610)
    _perturb(flow)
    flow = flow.double().eval()
    x = torch.randn(8, 610, dtype=torch.float64)
    with torch.no_grad():
        y, ld = flow.forward(x)
        x2, ld_inv = flow.inverse(y)
    assert float((y - x).abs().max()) > 1e-3  # not the identity
    torch.testing.assert_close(x2, x, rtol=0, atol=1e-10)
    torch.testing.assert_close(ld + ld_inv, torch.zeros(8, dtype=torch.float64), rtol=0,
                               atol=1e-10)


def test_decoder_geometry_lands_on_257x347():
    from preset_gen_vae_tpu_torch.models.decoder import decoder_tconv_specs
    from preset_gen_vae_tpu_torch.models.layers import tconv_output_size

    h, w = 3, 4
    for s in decoder_tconv_specs("speccnn8l1_bn"):
        h = tconv_output_size(h, s.kernel[0], s.stride[0], s.pad[0], s.out_pad[0], s.dilation[0])
        w = tconv_output_size(w, s.kernel[1], s.stride[1], s.pad[1], s.out_pad[1], s.dilation[1])
    assert (h, w) == (H, W)


def test_batchnorm_layers_update_like_flax():
    """One train-mode call of the port's BatchNorm and BatchNormFlow against
    flax nn.BatchNorm (momentum 0.9) and the JAX BatchNormFlow: outputs and
    updated running statistics (biased variance) within 1e-5."""
    import flax.linen as fnn

    from preset_gen_vae_tpu.models.flows import BatchNormFlow as JaxBNFlow

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 8, 5, 7)) * 2.0 + 0.5).astype(np.float32)  # NCHW
    stats = {"mean": rng.normal(0, 0.1, 8).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 8).astype(np.float32)}
    scale, bias = rng.uniform(0.8, 1.2, 8).astype(np.float32), rng.normal(0, 0.1, 8).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    jy, jmut = jbn.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats},
                         jnp.asarray(x.transpose(0, 2, 3, 1)), mutable=["batch_stats"])
    bn = BatchNorm(8)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(stats["mean"]),
                        "running_var": torch.from_numpy(stats["var"])})
    y = bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    for k, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(jmut["batch_stats"][k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)

    z = rng.standard_normal((6, 8)).astype(np.float32)
    params = {"log_gamma": rng.normal(0, 0.1, 8).astype(np.float32),
              "beta": rng.normal(0, 0.1, 8).astype(np.float32)}
    (jz, jld), jmut = JaxBNFlow(features=8).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(z), train=True,
        mutable=["batch_stats"])
    flow = BatchNormFlow(8)
    flow.load_state_dict({"log_gamma": torch.from_numpy(params["log_gamma"]),
                          "beta": torch.from_numpy(params["beta"]),
                          "running_mean": torch.from_numpy(stats["mean"]),
                          "running_var": torch.from_numpy(stats["var"])})
    tz, tld = flow.train()(torch.from_numpy(z))
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tld.detach().numpy(), np.asarray(jld), rtol=1e-5, atol=1e-5)
    for k, buf in (("mean", flow.running_mean), ("var", flow.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(jmut["batch_stats"][k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
