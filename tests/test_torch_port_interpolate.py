"""Latent-space preset interpolation in the port against the JAX package's
``evaluation/interpolate.py``, on the CPU, and the morph demo entry point.

A tiny FlowVAE (``realnvp_2l32`` latent flow, ``mlp_2l64`` head, dim_z 16,
the full-width 257x347 encoder) trains one epoch in the port on 16 presets
(the ``'cpp'`` corpus, cached on disk). The JAX function then runs on the
same weights, carried across with ``weights.flax_variables_from_model``
(its checkpoint read and its flax init, ~25 s here, replaced by that
dict), and on the same corpus: its dataset serves the cache the port
wrote. Bars: ``slerp`` bit-equal (the same numpy code); the decoded
presets within 2e-4 absolute (two frameworks' float32 convolutions, as
tests/test_torch_port_model.py's forward bar); the C++ renders of the
two engine builds within 1e-4.

The module's full-size CPU runs take two torch threads
(``two_torch_threads`` of ``_torch_port_fixtures.py``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preset_gen_vae_tpu import config as jcfg
from preset_gen_vae_tpu.data.dexed_dataset import DexedDataset as JaxDexedDataset
from preset_gen_vae_tpu.evaluation import interpolate as jinterp
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch import weights
from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset
from preset_gen_vae_tpu_torch.evaluation.interpolate import interpolate_presets, slerp
from preset_gen_vae_tpu_torch.logs.logger import load_checkpoint
from preset_gen_vae_tpu_torch.models.build import build_extended_ae_model
from preset_gen_vae_tpu_torch.scripts import preset_morph_demo
from preset_gen_vae_tpu_torch.training.loop import prepare_dataset, train_config
from _torch_port_fixtures import isolated_data_root, two_torch_threads  # noqa: F401 (autouse)

MODEL = dict(name="FlVAE2", run_name="interp", latent_flow_arch="realnvp_2l32",
             params_regression_architecture="mlp_2l64", dim_z=16)
TRAIN = dict(minibatch_size=4, n_epochs=1, compute_dtype="float32", verbosity=0)
CORPUS = {"n_synthetic_presets": 16}


@pytest.mark.parametrize("case", ["random", "colinear", "opposite_norms"])
def test_slerp_is_the_jax_functions(case):
    rng = np.random.default_rng(0)
    a = rng.standard_normal(16).astype(np.float32)
    b = {"random": rng.standard_normal(16).astype(np.float32), "colinear": 3.0 * a,
         "opposite_norms": -0.5 * a + 1e-3}[case]
    t = np.linspace(0.0, 1.0, 7).astype(np.float32)
    got = slerp(a, b, t)
    np.testing.assert_array_equal(got, jinterp.slerp(a, b, t))
    np.testing.assert_allclose(got[[0, -1]], np.stack([a, b]), atol=1e-5)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("interp")
    model_c = cfg.ModelConfig(logs_root_dir=str(root / "saved"), **MODEL)
    train_c = cfg.TrainConfig(**TRAIN)
    kw = dict(CORPUS, data_root=str(root / "data"))
    train_config(model_c, train_c, device="cpu", dataset_kwargs=kw, use_tensorboard=False)
    return dict(root=root, model_c=model_c, train_c=train_c, kw=kw)


@pytest.mark.parametrize("mode", ["slerp", "lerp"])
def test_interpolate_presets_matches_jax(trained, monkeypatch, mode):
    port_ds = DexedDataset(device="cpu", **trained["kw"])
    uid_a, uid_b = int(port_ds.uids[0]), int(port_ds.uids[5])
    full, wavs = interpolate_presets(trained["model_c"], trained["train_c"], uid_a, uid_b,
                                     n_steps=7, mode=mode, dataset=port_ds, device="cpu")
    assert full.shape == (7, 155) and full.dtype == np.float32 and np.isfinite(full).all()
    assert 0.0 <= full.min() and full.max() <= 1.0 and np.abs(full[0] - full[-1]).max() > 1e-3
    assert wavs.shape == (7, port_ds.renderer.samples_per_render) and np.isfinite(wavs).all()

    model_r, train_r, _ = prepare_dataset(*cfg.resolve(trained["model_c"], trained["train_c"]),
                                          torch.device("cpu"), port_ds)
    model = build_extended_ae_model(model_r, train_r, port_ds.preset_indexes_helper)
    model.load_state_dict(load_checkpoint(model_r)["state"]["model"])
    variables = jax.tree_util.tree_map(jnp.asarray, weights.flax_variables_from_model(model))
    monkeypatch.setattr(jinterp, "load_checkpoint", lambda *a, **k: {"state_tree": variables})
    monkeypatch.setattr(jinterp.mbuild, "init_extended_ae", lambda *a, **k: variables)
    monkeypatch.setattr(jinterp, "create_train_state", lambda *a, **k: None)
    jds = JaxDexedDataset(**trained["kw"])  # serves the corpus the port cached
    want_full, want_wavs = jinterp.interpolate_presets(
        jcfg.ModelConfig(logs_root_dir=trained["model_c"].logs_root_dir, **MODEL),
        jcfg.TrainConfig(**TRAIN), uid_a, uid_b, n_steps=7, mode=mode, dataset=jds)
    np.testing.assert_allclose(full, want_full, rtol=0, atol=2e-4)
    np.testing.assert_allclose(wavs, want_wavs, rtol=0, atol=1e-4)


def test_interpolation_needs_a_latent_flow(trained):
    model_c = cfg.ModelConfig(logs_root_dir=trained["model_c"].logs_root_dir,
                              **dict(MODEL, latent_flow_arch=None))
    with pytest.raises(ValueError, match="latent flow"):
        interpolate_presets(model_c, trained["train_c"], 0, 1, device="cpu",
                            dataset_kwargs=trained["kw"])
    with pytest.raises(ValueError, match="interpolation mode"):
        interpolate_presets(trained["model_c"], trained["train_c"], 0, 1, mode="cubic",
                            device="cpu", dataset_kwargs=trained["kw"])


def test_morph_demo_entry_point_on_cpu(trained, capsys, monkeypatch):
    """The morph demo on the trained run, by default between the 8th and
    the 14th preset, else between the two UIDs given: the presets, wavs and
    summary written into the run dir, the printed line equal to the summary
    file, every distance finite. The demo's run, path length and corpus
    size are the module's constants, set here to the tiny run, 5 steps and
    16 presets. (This barely trained model's renders may coincide, so the
    distances are not held to be positive.)"""
    root = trained["root"]
    monkeypatch.setattr(preset_morph_demo, "RUN_NAME", "interp")
    monkeypatch.setattr(preset_morph_demo, "N_STEPS", 5)
    monkeypatch.setattr(preset_morph_demo, "N_PRESETS", CORPUS["n_synthetic_presets"])
    args = ["--logs-root", str(root / "saved"), "--data-root", trained["kw"]["data_root"],
            "--device", "cpu"]
    ds = DexedDataset(device="cpu", **trained["kw"])
    default = preset_morph_demo.main(args)
    assert (default["uid_a"], default["uid_b"]) == (int(ds.uids[7]), int(ds.uids[13]))
    summary = preset_morph_demo.main([str(ds.uids[0]), str(ds.uids[5]), *args])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    run_dir = root / "saved" / "FlVAE2" / "interp"
    assert printed == summary == json.loads((run_dir / "morph_demo_summary.json").read_text())
    assert (summary["uid_a"], summary["uid_b"], summary["n_steps"]) == (ds.uids[0], ds.uids[5], 5)
    dists = [summary[k] for k in ("direct_spec_mae", "step_spec_mae_mean", "step_spec_mae_max")]
    assert np.isfinite(dists).all() and min(dists) >= 0.0
    out = run_dir / "morph_demo"
    assert np.load(out / "presets.npy").shape == (5, 155)
    assert sorted(f.name for f in out.glob("*.wav")) == [f"morph_{i:02d}.wav" for i in range(5)]
