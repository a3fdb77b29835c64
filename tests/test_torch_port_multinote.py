"""The port's multi-note models and datasets against the JAX package's:
stacked notes as channels (the repo's best run, ``r5stack3_v2_20480``, and
the reference's six notes, ``r5stack6_v2_8192``) and un-stacked notes with
MIDI pitch and velocity in z0 (``r5multi6_v2_12288``).

- Dataset: ``corpus_tensors`` of both packages on the same 8-preset, 3-note
  corpus; v and info exactly, x within K1's plain-version bar (0.05 dB,
  on rendered notes wherever the JAX spectrogram is above -100 dB, where
  f32 rounding near the -120 dB floor stays out; tests/test_torch_port_mel.py)
  mapped through the shared min/max normalisation.
- Model: the eval-mode ``forward_full`` from the same weights at rtol 1e-4 /
  atol 2e-4 (the bar of tests/test_torch_port_model.py), and the exported
  flax tree against the JAX model's own init structure.
- One train step of the stacked model in train mode, at three and at six
  notes, at the bars of tests/test_torch_port_train.py: the shared per-channel CNN normalises
  each channel with its own batch statistics and chains C running-statistic
  updates, which the BN check after the step would catch if the channels
  were folded into the batch.
- The loop and the evaluation end to end on the CPU for both layouts.

Flows are cut to 3 layers (widths, dim_z 610 and 257x347 kept), as in
tests/test_torch_port_train.py, so the JAX compiles stay short.
"""

import json
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preset_gen_vae_tpu.data.dexed_dataset import DexedDataset as JaxDexedDataset
from preset_gen_vae_tpu.models import build as jbuild
from preset_gen_vae_tpu import config as jcfg
from preset_gen_vae_tpu.training.train_step import _latent_loss, create_train_state, make_eval_step
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data.dexed_dataset import (
    DexedDataset,
    model_config_to_dataset_kwargs,
)
from preset_gen_vae_tpu_torch.evaluation import evaluate as ev
from preset_gen_vae_tpu_torch.losses.vae_losses import flow_vae_latent_loss
from preset_gen_vae_tpu_torch.models.encoder import SpectrogramEncoder
from preset_gen_vae_tpu_torch.training import train_step as ts
from preset_gen_vae_tpu_torch.training.loop import train_config
from _torch_port_fixtures import isolated_data_root, two_torch_threads  # noqa: F401 (autouse)
from test_torch_port_model import B, H, W, flagship_pair
from test_torch_port_train import (
    assert_batch_stats_match,
    assert_gradients_align,
    assert_loss_terms_match,
    step_both,
)

NOTES3 = ((40, 85), (50, 85), (60, 85))  # r5stack3_v2_20480
# r5multi6_v2_12288, r5stack6_v2_8192
NOTES6 = ((40, 85), (50, 85), (60, 42), (60, 85), (60, 127), (70, 85))
FLOWS = dict(latent_flow_arch="realnvp_3l300", params_regression_architecture="flow_realnvp_3l300")
E2E_FLOWS = dict(latent_flow_arch="realnvp_2l300",
                 params_regression_architecture="flow_realnvp_2l300")
CONFIGS = {
    "stack3_mix7": dict(midi_notes=NOTES3, stack_spectrograms=True, **FLOWS),
    "stack3_mix8": dict(midi_notes=NOTES3, stack_spectrograms=True,
                        stack_specs_deepest_features_mix=True, **FLOWS),
    "multi6_midi_z0": dict(midi_notes=NOTES6, **FLOWS),
    # six channels' features concatenated before mix7 (encoder.py:165-188 there)
    "stack6_mix7": dict(midi_notes=NOTES6, stack_spectrograms=True, **FLOWS),
}
OUTPUTS = ("z0_mu_logvar", "z0", "zK", "logdet", "x_out", "v_out")


# ---------------------------------------------------------------- dataset
@pytest.fixture(scope="module")
def datasets():
    root = tempfile.mkdtemp(prefix="jax_corpus_")
    out = {}
    for stacked in (True, False):
        kw = dict(midi_notes=NOTES3, multichannel_stacked_spectrograms=stacked,
                  n_synthetic_presets=8)
        jds = JaxDexedDataset(data_root=root, **kw)
        out[stacked] = (DexedDataset(device="cpu", **kw), jds.corpus_tensors(), jds.spec_stats)
    return out


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
def test_corpus_tensors_match_jax(datasets, stacked):
    port, want, stats = datasets[stacked]
    got = port.corpus_tensors()
    n_items = 8 if stacked else 24
    assert tuple(got["x"].shape) == (n_items, 3 if stacked else 1, 257, 347)
    assert port.get_spectrogram_tensor_size() == (3 if stacked else 1, 257, 347)
    assert port.multichannel_stacked_spectrograms is stacked
    np.testing.assert_array_equal(got["v"].numpy(), want["v"])
    np.testing.assert_array_equal(got["info"].numpy(), want["info"])
    half = (stats["max"] - stats["min"]) / 2.0
    db_want = (want["x"] + 1.0) * half + stats["min"]
    db_got = (got["x"].numpy() + 1.0) * half + stats["min"]
    loud = db_want > -100.0
    assert loud.mean() > 0.02
    assert np.abs(db_got - db_want)[loud].max() < 0.05
    if not stacked:  # a view of the (P, n_notes, H, W) corpus, not a copy
        assert got["x"].data_ptr() == port.load_corpus().data_ptr()
        assert got["info"][:4].tolist() == [[0, 40, 85], [0, 50, 85], [0, 60, 85], [1, 40, 85]]


def test_dataset_kwargs_pass_the_stacking_flag_and_refuse_the_jax_backend():
    """The stacking flag and the render backend and cache policy reach the
    dataset; the dataset refuses what the JAX package refuses (the 'device'
    policy without the on-device 'jax' render, an unknown backend)."""
    mc = cfg.ModelConfig(midi_notes=NOTES3, stack_spectrograms=True,
                         dataset_corpus_render_backend="jax", dataset_corpus_cache_policy="device")
    kw = model_config_to_dataset_kwargs(mc)
    assert kw["multichannel_stacked_spectrograms"] is True
    assert (kw["corpus_render_backend"], kw["corpus_cache_policy"]) == ("jax", "device")
    for backend, policy in (("cpp", "device"), ("vst", "disk")):
        with pytest.raises(ValueError):
            DexedDataset(n_synthetic_presets=4, device="cpu", corpus_render_backend=backend,
                         corpus_cache_policy=policy)


# ---------------------------------------------------------------- models
@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return request.param, flagship_pair(model_kwargs=CONFIGS[request.param])


def test_flax_tree_matches_jax_init_structure(pair):
    _, (port, ext, jvars, _, (jm, _), *_) = pair
    shapes = jax.eval_shape(lambda: jbuild.init_extended_ae(ext, 0, jm.input_tensor_size))
    want = jax.tree_util.tree_map(lambda s: s.shape, dict(shapes))
    assert jax.tree_util.tree_map(lambda a: a.shape, jvars) == want


def eval_forward_both(port, ext, jvars, x, info):
    """The eval-mode forward_full of both packages: (jax outputs, port outputs)."""
    outs = jax.jit(lambda variables, x, info: ext.apply(
        variables, x, info, train=False, method=ext.forward_full))(
        jvars, jnp.asarray(x), jnp.asarray(info))
    port.eval()
    with torch.no_grad():
        touts = port.forward_full(torch.from_numpy(x), torch.from_numpy(info))
    return [np.asarray(a) for a in outs], [t.numpy() for t in touts]


def assert_outputs_match(outs, touts):
    for name, a, b in zip(OUTPUTS, outs, touts):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-4, err_msg=f"forward output '{name}'")


def test_eval_forward_matches_jax(pair):
    name, (port, ext, jvars, (pm, _), _, helper, _, x, v, info) = pair
    outs, touts = eval_forward_both(port, ext, jvars, x, info)
    assert_outputs_match(outs, touts)
    C = {"stack3": 3, "stack6": 6}.get(name[:6], 1)
    assert touts[4].shape == (B, C, 257, 347) and touts[5].shape == (B, 610)
    mixers = {"stack3_mix7": ["mix7", "mix8"], "stack3_mix8": ["mix8"],
              "multi6_midi_z0": ["mix7", "mix8"], "stack6_mix7": ["mix7", "mix8"]}[name]
    enc = port.ae_model.encoder
    assert enc.mixers == mixers
    widths = {"stack3_mix7": (768, 1024), "stack3_mix8": (1024,), "multi6_midi_z0": (1800, 2048),
              "stack6_mix7": (768, 1024)}
    assert tuple(getattr(enc, m).Conv_0.out_channels for m in mixers) == widths[name]
    # mix7 (or mix8 alone) reads the C channels' concatenated features
    first = getattr(enc, mixers[0]).Conv_0
    assert first.in_channels == C * enc.single_ch_cnn.out_ch
    dec = port.ae_model.decoder
    assert dec.unmix1.TorchConvTranspose2d_0.out_channels == C * dec.last_4x4_ch


def test_midi_notes_fill_z0_dims_0_and_1(pair):
    """MIDI in z0 (vae.py:66-80): mu = -1 + 2 (pitch, vel) / 127 and logvar
    log(4 / 127^2) for each item; zeros without sample_info; the encoder
    emits dim_z - 2 values. Stacked models leave z0 to the encoder."""
    name, (port, _, _, (pm, _), _, _, _, x, _, info) = pair
    port.eval()
    with torch.no_grad():
        mu_logvar = port.forward_full(torch.from_numpy(x), torch.from_numpy(info))[0]
        no_info = port.ae_model.encode(torch.from_numpy(x))
    assert pm.concat_midi_to_z is (name == "multi6_midi_z0")
    if not pm.concat_midi_to_z:
        assert port.ae_model.encoder.dim_z == 610
        return
    assert port.ae_model.encoder.dim_z == 608
    want_mu = -1.0 + 2.0 * info[:, 1:3].astype(np.float32) / 127.0
    np.testing.assert_array_equal(mu_logvar[:, 0, :2].numpy(), want_mu)
    np.testing.assert_array_equal(mu_logvar[:, 1, :2].numpy(),
                                  np.full((B, 2), np.log(4.0 / 127 ** 2), np.float32))
    assert not no_info[:, :, :2].any()


def test_encoder_runs_the_shared_cnn_once_per_channel():
    """Each channel normalised with its own batch statistics (not folded
    into the batch), and the shared running statistics updated once per
    channel, in channel order."""
    torch.manual_seed(0)
    enc = SpectrogramEncoder("speccnn8l1_bn", 16, (257, 347), spectrogram_channels=2,
                             fc_dropout=0.0).train()
    x = torch.randn(3, 2, 257, 347)
    x[:, 1] = x[:, 1] * 3.0 + 1.0  # channels with different statistics
    bn = enc.single_ch_cnn.enc2.BatchNorm_0
    h1 = enc.single_ch_cnn.enc1(x[:, :1])
    h2 = enc.single_ch_cnn.enc1(x[:, 1:])
    y1, y2 = enc.single_ch_cnn.enc2.Conv_0(h1), enc.single_ch_cnn.enc2.Conv_0(h2)
    y1, y2 = torch.nn.functional.leaky_relu(y1, 0.1), torch.nn.functional.leaky_relu(y2, 0.1)
    want_mean = torch.zeros_like(bn.running_mean)
    for y in (y1, y2):
        want_mean = 0.9 * want_mean + 0.1 * y.mean(dim=(0, 2, 3))
    with torch.no_grad():
        enc(x)
    torch.testing.assert_close(bn.running_mean, want_mean.detach(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def stepped_stack3():
    # 2-layer flows: this step holds the per-note CNN, and the JAX compile
    # of the step grows with the flows' depth
    return step_both({}, dict(CONFIGS["stack3_mix7"], **E2E_FLOWS))


def test_stacked_train_step_loss_terms_match_jax(stepped_stack3):
    assert_loss_terms_match(stepped_stack3)


def test_stacked_train_step_gradients_align_with_jax(stepped_stack3):
    assert_gradients_align(stepped_stack3)


def test_stacked_batch_stats_after_step_match_jax(stepped_stack3):
    assert_batch_stats_match(stepped_stack3, min_stats=50)  # 60 with 2-layer flows


@pytest.fixture(scope="module")
def stepped_stack6():
    # six notes through the shared CNN, mix7 on their 6 x 512 features;
    # 2-layer flows as above, 257x347 and the mixers' widths kept
    return step_both({}, dict(CONFIGS["stack6_mix7"], **E2E_FLOWS))


def test_stack6_train_step_loss_terms_match_jax(stepped_stack6):
    assert_loss_terms_match(stepped_stack6)


def test_stack6_train_step_gradients_align_with_jax(stepped_stack6):
    assert_gradients_align(stepped_stack6)


def test_stack6_batch_stats_after_step_match_jax(stepped_stack6):
    assert_batch_stats_match(stepped_stack6, min_stats=50)


# ---------------------------------------------------------------- end to end
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
def test_train_and_evaluate_multi_note_on_cpu(tmp_path, stacked):
    """One epoch through ``train_config`` and the evaluation from the run
    dir: stacked runs have (B, 2, H, W) inputs and one row per preset
    rendered at the first note; un-stacked runs one row per (preset, note),
    each item rendered at its own note, MIDI in z0."""
    notes = ((40, 85), (50, 85), (60, 100))
    model_c = cfg.ModelConfig(dataset_synth_args=(None, (1, 2)), logs_root_dir=str(tmp_path),
                              midi_notes=notes, stack_spectrograms=stacked, run_name="mn",
                              **E2E_FLOWS)
    kw, batch = {"n_synthetic_presets": 12}, 4 if stacked else 8
    summary = train_config(model_c, cfg.TrainConfig(n_epochs=1, minibatch_size=batch, verbosity=0),
                           device="cpu", dataset_kwargs=kw, use_tensorboard=False)
    assert summary["input_size"] == [batch, 3 if stacked else 1, 257, 347]
    assert summary["epochs_trained"] == 1  # 1 + 1 // (3 - 1) for the un-stacked notes
    assert summary["train_steps"] == (1 if stacked else 2)  # 7 presets, or 21 items
    vals = [v for v in summary.values() if isinstance(v, float)]
    assert all(np.isfinite(vals))
    latents = {}
    means = ev.evaluate_model_from_dir(summary["run_dir"],
                                       cfg.EvalConfig(audio_render_backend="cpp"), device="cpu",
                                       dataset_kwargs=kw, latents=latents)
    items = np.load(f"{summary['run_dir']}/eval_validation.items.npz")
    with open(f"{summary['run_dir']}/eval_validation_summary.json") as f:
        n_items = json.load(f)["n_items"]
    n_presets = len(np.unique(items["preset_UID"]))
    assert n_items == len(items["preset_UID"]) == (n_presets if stacked else 3 * n_presets)
    assert len(means["preset_UID"]) == n_presets
    pairs = {tuple(p) for p in np.stack([items["midi_pitch"], items["midi_velocity"]], 1)}
    assert pairs == ({notes[0]} if stacked else set(notes))
    assert latents["z0"].shape == (n_items, summary["dim_z"])
    if not stacked:  # z0 dims 0-1 of every item hold its own MIDI note
        want = -1.0 + 2.0 * np.stack([items["midi_pitch"], items["midi_velocity"]], 1) / 127.0
        np.testing.assert_allclose(latents["z0"][:, :2], want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- eval-mode 0/0
def _split_logvar_dim(model, out: dict) -> None:
    """Sets the encoder's output batch norm on one log-variance dimension so
    that it splits ``flagship_pair``'s rows: the two rows lowest before the
    norm get a log-variance far below float32's exp range (about -115),
    where exp(logvar) is 0 and, with z0 = mu in eval mode, ``(z0 - mu)^2 /
    exp(logvar)`` is 0/0; the two highest one inside it (above -76). The
    dimension is the one whose middle gap between rows is widest. ``out``
    receives the NaN rows."""
    rng = np.random.default_rng(3)  # flagship_pair's x: its first draw
    x = torch.from_numpy((rng.standard_normal((B, 1, H, W)) * 0.3).astype(np.float32))
    enc = model.ae_model.encoder
    seen = []
    hook = enc.mlp_out.register_forward_hook(lambda m, i, o: seen.append(o.detach()))
    enc.eval()
    with torch.no_grad():
        enc(x)
    hook.remove()
    half = enc.mlp_out.out_features // 2
    y = np.sort(seen[0][:, half:].numpy(), axis=0)  # the log-variances, before the norm
    d = int(np.argmax(y[B // 2] - y[B // 2 - 1]))
    lo, hi = float(y[B // 2 - 1, d]), float(y[B // 2, d])
    bn = enc.lat_in_regularization
    with torch.no_grad():
        bn.running_mean[half + d] = (lo + hi) / 2
        bn.running_var[half + d] = 1.0 - bn.eps
        bn.weight[half + d] = 40.0 / (hi - lo)
        bn.bias[half + d] = -95.5
    out["nan_rows"] = sorted(np.argsort(seen[0][:, half + d].numpy())[:B // 2].tolist())


def test_eval_latent_loss_is_nan_on_the_same_rows_as_jax():
    """The reference's own 0/0, found on ``torch_multi6_v2_8192``'s
    validation split (``ROADMAP.md`` §3): in eval mode z0 = mu, so a row
    whose log-variance leaves float32's exp range on some dimension has a
    NaN latent loss, in the JAX package's eval step as in the port's. With
    one dimension's output norm set to split the rows (MIDI in z0, the
    multi6 layout), each row's eval step in both packages: NaN on the same
    rows, the finite rows within 1e-5, and every other metric finite."""
    split = {}
    port, ext, jvars, (pm, pt), (jm, jt), helper, jhelper, x, v, info = flagship_pair(
        model_kwargs=dict(CONFIGS["multi6_midi_z0"], **E2E_FLOWS),
        adjust=lambda model: _split_logvar_dim(model, split))
    jstep = jax.jit(make_eval_step(ext, jm, jt, jhelper))
    state = create_train_state(ext, jvars, jt)
    criteria = ts.Criteria(pm, pt, helper)
    ours, theirs = [], []
    for i in range(B):
        row = slice(i, i + 1)
        theirs.append(jax.device_get(jstep(state, jnp.asarray(x[row]), jnp.asarray(v[row]),
                                           jnp.asarray(info[row]))))
        ours.append(ts.eval_step(port, criteria, pt, torch.from_numpy(x[row]),
                                 torch.from_numpy(v[row]), torch.from_numpy(info[row])))
    lat = np.array([float(m["LatLoss"]) for m in ours])
    jlat = np.array([float(m["LatLoss"]) for m in theirs])
    assert np.flatnonzero(np.isnan(lat)).tolist() == split["nan_rows"]
    assert np.flatnonzero(np.isnan(jlat)).tolist() == split["nan_rows"]
    finite = ~np.isnan(jlat)
    np.testing.assert_allclose(lat[finite], jlat[finite], rtol=1e-5, atol=1e-5)
    for k in ("ReconsLoss/Backprop", "Controls/BackpropLoss", "Controls/Accuracy"):
        assert all(np.isfinite(float(m[k])) for m in ours + theirs), k


# rows of torch_multi6_v2_8192's validation split, written on the card by
# preset_gen_vae_tpu_torch/scripts/latent_nan_report.py from the run's last
# checkpoint (bf16 autocast; the checkpoint itself, 304 MB, stays off the repo)
NAN_ROWS = pathlib.Path(__file__).resolve().parent / "data" / "torch_multi6_v2_8192_nan_rows.npz"
F32_EXP_ZERO = -103.972  # float32 exp(x) rounds to 0 below this, subnormals kept or not


def test_multi6_nan_rows_are_nan_in_the_jax_latent_loss():
    """The rows whose validation latent loss the card computed NaN, and the
    finite rows whose exp(logvar) is subnormal there (the card keeps
    subnormals): the JAX package's eval-step latent loss
    (``train_step._latent_loss``) on the card's latent tensors is NaN on
    every NaN row, and on the subnormal rows too, since XLA on the CPU
    flushes subnormals to 0 (as a TPU does); the port's formula on the CPU
    is NaN where its own exp gives 0 (it keeps subnormals unless the C++
    engine, built with -ffast-math, was loaded into the process). Every
    finite value equals the card's within 1e-5. The NaN rows'
    log-variances, recomputed by JAX from the encoder head's input, weights
    and output norm, equal the card's within 1e-5 relative, and each NaN
    row has one below float32's exp range."""
    z = np.load(NAN_ROWS)
    n_bad, n_edge = int(z["n_bad"]), int(z["n_edge"])
    assert str(z["compute_dtype"]) == "bfloat16" and (n_bad, n_edge) == (3, 2)
    jm, jt = jcfg.resolve(jcfg.ModelConfig(midi_notes=NOTES6), jcfg.TrainConfig())
    theirs, ours, torch_zero = [], [], []
    for i in range(len(z["lat"])):
        row = [z[k][i:i + 1] for k in ("mu_logvar", "z0", "zK", "logdet")]
        theirs.append(float(_latent_loss(jm, jt, *map(jnp.asarray, row))))
        ours.append(float(flow_vae_latent_loss(*map(torch.from_numpy, row), normalize=True)))
        torch_zero.append(bool((torch.exp(torch.from_numpy(row[0][:, 1])) == 0).any()))
    theirs, ours, card = np.array(theirs), np.array(ours), z["lat"]
    rows = np.arange(len(card))
    bad, edge = rows < n_bad, (rows >= n_bad) & (rows < n_bad + n_edge)
    assert (np.isnan(card) == bad).all()
    assert (np.isnan(theirs) == (bad | edge)).all()  # JAX is NaN wherever the card is
    assert (np.isnan(ours) == np.array(torch_zero)).all() and np.isnan(ours[bad]).all()
    np.testing.assert_allclose(theirs[~(bad | edge)], card[~(bad | edge)], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours[~np.isnan(ours)], card[~np.isnan(ours)], rtol=1e-5,
                               atol=1e-5)
    # the encoder head (mlp_out, then the output batch norm in eval mode)
    y = jnp.dot(jnp.asarray(z["h"]), jnp.asarray(z["w"]).T,
                precision=jax.lax.Precision.HIGHEST) + z["b"]
    logvar = (y - z["bn_running_mean"]) * jax.lax.rsqrt(z["bn_running_var"] + 1e-5) \
        * z["bn_weight"] + z["bn_bias"]
    at_dims = z["mu_logvar"][:n_bad, 1][:, z["dims"]]
    np.testing.assert_allclose(np.asarray(logvar), at_dims, rtol=1e-5)
    assert (at_dims.min(axis=1) < F32_EXP_ZERO).all()
    assert (z["mu_logvar"][n_bad:, 1].min(axis=1) > F32_EXP_ZERO).all()
