"""The port's evaluation pass against the JAX package's: the audio
similarity metrics, the per-item parameter metrics, the latent Spearman
metric, and the pass end to end on the CPU.

Bars: similarity metrics within 1e-4 relative or 1e-4 absolute per metric,
with the NaNs in the same places (float32 FFTs and products of two
frameworks); per-item parameter metrics and the Spearman r and p within
1e-6 absolute; the per-UID means equal pandas' in the same dtype, to one
float32 rounding (1e-6 relative). The end-to-end run trains the full-width flagship (257x347
log-mels, operators 1-2, learnable size 250) for one epoch on a 64-preset
corpus at batch 16, then evaluates its 11 validation items; pandas is used
here only, as the yardstick of the per-item table.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from preset_gen_vae_tpu.data.dexed_spec import build_dexed_preset_spec as jax_spec
from preset_gen_vae_tpu.data.preset import PresetIndexesHelper as JaxHelper
from preset_gen_vae_tpu.evaluation import similarity as jsim
from preset_gen_vae_tpu.logs.metrics import LatentMetric as JaxLatentMetric
from preset_gen_vae_tpu.losses import synth_params as jsp
from preset_gen_vae_tpu.synth import dexed_params as jdx
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset
from preset_gen_vae_tpu_torch.data.dexed_spec import build_dexed_preset_spec
from preset_gen_vae_tpu_torch.data.preset import PresetIndexesHelper
from preset_gen_vae_tpu_torch.evaluation import evaluate as ev
from preset_gen_vae_tpu_torch.evaluation import similarity as sim
from preset_gen_vae_tpu_torch.logs.metrics import LatentMetric
from preset_gen_vae_tpu_torch.losses import synth_params as sp
from preset_gen_vae_tpu_torch.synth import database as db
from preset_gen_vae_tpu_torch.synth import dexed_params as dx
from preset_gen_vae_tpu_torch.synth.render import DexedRenderer
from preset_gen_vae_tpu_torch.training.loop import train_config
from _torch_port_fixtures import isolated_data_root  # noqa: F401 (autouse)

DATASET_KWARGS = {"n_synthetic_presets": 64}
CPP_EVAL = cfg.EvalConfig(audio_render_backend="cpp")


def _waveforms():
    """(ref, est), 13 rows each: 8 rendered DX7 notes of the structured
    corpus, 4 seeded noise rows and one silent row; ``est`` renders 8 other
    presets and perturbs the noise."""
    presets, _, _ = db.generate_structured_corpus(16, seed=3)
    wav = DexedRenderer().render_batch(presets, [60] * 16, [85] * 16)
    rng = np.random.default_rng(5)
    noise = (rng.standard_normal((4, wav.shape[1])) * 0.1).astype(np.float32)
    silent = np.zeros((1, wav.shape[1]), np.float32)
    ref = np.concatenate([wav[:8], noise, silent])
    est = np.concatenate([wav[8:], noise + 0.05 * rng.standard_normal(noise.shape).astype(
        np.float32), noise[:1]])
    return ref, est


def test_batched_audio_errors_match_jax():
    ref, est = _waveforms()
    got = sim.batched_audio_errors(torch.from_numpy(ref), torch.from_numpy(est))
    want = jsim.batched_audio_errors(jnp.asarray(ref), jnp.asarray(est))
    for k in ("spec_mae", "spec_sc", "mfcc13_mae", "mfcc40_mae"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == (13,)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=k)
    assert np.isnan(got["spec_sc"][12]) and np.isfinite(got["spec_sc"][:12]).all()


def test_stft_magnitude_is_librosa_stft():
    """Reflect padding, periodic Hann window, no normalisation:
    torch.stft(center=True, pad_mode='reflect') within float32 rounding."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4096)).astype(np.float32))
    want = torch.stft(x, 512, 128, window=torch.hann_window(512, periodic=True), center=True,
                      pad_mode="reflect", return_complex=True).abs()
    torch.testing.assert_close(sim.stft_magnitude(x, 512, 128), want, rtol=1e-4, atol=1e-4)


def test_similarity_evaluator_matches_jax():
    ref, est = _waveforms()
    pair = [ref[0], est[0]]
    got = sim.SimilarityEvaluator(pair, device="cpu")
    want = jsim.SimilarityEvaluator(pair)
    for name in ("get_mae_log_stft", "get_spectral_convergence", "get_mae_mfcc"):
        g = getattr(got, name)()
        w = getattr(want, name)()
        assert g[0] == pytest.approx(w[0], rel=1e-4, abs=1e-4), name
        for a, b in zip(g[1], w[1]):  # the spectra or MFCCs behind the metric
            assert a.shape == b.shape and float(np.abs(a - b).mean()) < 1e-4, name


@pytest.mark.parametrize("limited", [False, True], ids=["all", "midi_key_related"])
def test_per_item_param_metrics_match_jax(limited):
    helper, jhelper = PresetIndexesHelper(build_dexed_preset_spec()), JaxHelper(jax_spec())
    rng = np.random.default_rng(7)
    v_in = helper.full_to_learnable_batch(
        rng.random((32, helper.full_preset_size)).astype(np.float32))
    v_out = rng.random(v_in.shape).astype(np.float32)
    lim = dx.midi_key_related_param_indexes() if limited else None
    assert lim is None or lim == jdx.midi_key_related_param_indexes()
    t_in, t_out, j_in, j_out = (torch.from_numpy(v_in), torch.from_numpy(v_out),
                                jnp.asarray(v_in), jnp.asarray(v_out))
    pairs = [(sp.QuantizedNumericalParamsLoss(helper, loss=loss, limited_vst_params_indexes=lim),
              jsp.QuantizedNumericalParamsLoss(jhelper, loss=loss, limited_vst_params_indexes=lim))
             for loss in ("mse", "mae")]
    pairs.append((sp.CategoricalParamsAccuracy(helper, limited_vst_params_indexes=lim),
                   jsp.CategoricalParamsAccuracy(jhelper, limited_vst_params_indexes=lim)))
    for port, jax_crit in pairs:
        got = port.per_item(t_out, t_in).numpy()
        assert got.shape == (32,) and np.ptp(got) > 0
        np.testing.assert_allclose(got, np.asarray(jax_crit.per_item(j_out, j_in)), rtol=0,
                                   atol=1e-6)
        # the reduced form: float32 means taken in another order, 1e-6 relative
        assert float(port(t_out, t_in)) == pytest.approx(float(jax_crit(j_out, j_in)), rel=1e-6)


def test_latent_metric_matches_jax():
    z = np.random.default_rng(11).standard_normal((64, 16))
    z[:, 3] += 0.8 * z[:, 1]  # one correlated pair
    port, jax_m = LatentMetric(16), JaxLatentMetric(16)
    for m in (port, jax_m):
        m.append(z[:40], z[:40])
        m.append(z[40:], z[40:])
    np.testing.assert_allclose(port.get_spearman_corr(), jax_m.get_spearman_corr(), atol=1e-6)
    np.testing.assert_allclose(port.get_spearman_pvalues(), jax_m.get_spearman_pvalues(),
                               atol=1e-6)
    assert port.get() == pytest.approx(jax_m.get(), abs=1e-6)


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """One trained epoch, then the evaluation as a user runs it: from the run
    dir, the dataset rebuilt from its keyword arguments."""
    root = tmp_path_factory.mktemp("saved")
    model_c = cfg.ModelConfig(dataset_synth_args=(None, (1, 2)), logs_root_dir=str(root),
                              run_name="e0")
    train_c = cfg.TrainConfig(n_epochs=1, minibatch_size=16, verbosity=0)
    summary = train_config(model_c, train_c, device="cpu", dataset_kwargs=DATASET_KWARGS,
                           use_tensorboard=False)
    phases = {}
    # the C++ re-render: the plain 'jax' exact loop takes ~40 s a 4 s note on the CPU;
    # tests/test_torch_port_fm_corpus.py drives the 'jax' backend
    out = ev.evaluate_model_from_dir(summary["run_dir"], CPP_EVAL, device="cpu",
                                     dataset_kwargs=DATASET_KWARGS, phase_seconds=phases)
    return dict(root=root, run_dir=summary["run_dir"], out=out, phases=phases)


def test_evaluate_writes_the_jax_artifacts(evaluated):
    run_dir = evaluated["run_dir"]
    items = dict(np.load(f"{run_dir}/eval_validation.items.npz"))
    df = pd.DataFrame(items)
    # the JAX table's columns, in its order (evaluate.py:176-182, 323-325 there)
    assert list(df.columns) == ["preset_UID", "midi_pitch", "midi_velocity", "num_eval_loss",
                                "num_mae", "num_mae_dyn", "acc", "acc_dyn", "spec_mae",
                                "spec_sc", "mfcc13_mae", "mfcc40_mae"]
    assert len(df) == 11 and df["preset_UID"].is_unique  # the validation split, no padding
    ds = DexedDataset(device="cpu", operators=(1, 2), **DATASET_KWARGS)
    assert set(df["preset_UID"]) <= set(ds.uids.tolist())
    with open(f"{run_dir}/eval_validation_summary.json") as f:
        summary = json.load(f)
    # the JAX summary's keys and values for this table (evaluate.py:351-366)
    num_cols = [k for k in df.columns if k not in ("preset_UID", "midi_pitch", "midi_velocity")]
    want = {k: float(np.nanmean(df[k])) for k in num_cols}
    want.update({f"n_nan_{k}": int(df[k].isna().sum()) for k in num_cols if df[k].isna().any()})
    assert set(summary) == set(want) | {"latent_entanglement_z0", "latent_entanglement_zK",
                                        "n_items"}
    for k, v in want.items():
        assert summary[k] == pytest.approx(v, rel=1e-12), k
    assert summary["n_items"] == 11
    assert np.isfinite([summary[k] for k in num_cols]).all()
    for name in ("z0", "zK"):
        for kind in ("r", "p"):
            assert np.load(f"{run_dir}/eval_validation_{name}_spearman_{kind}.npy").shape == \
                (250, 250)
    assert np.isfinite(df[["spec_mae", "mfcc13_mae", "mfcc40_mae"]].to_numpy()).all()
    assert set(evaluated["phases"]) == {"dataset", "model", "inference", "render", "similarity",
                                        "artifacts", "model.init", "model.load",
                                        "artifacts.spearman", "artifacts.write",
                                        "artifacts.means", "tconv_out_launches"}
    assert evaluated["phases"]["tconv_out_launches"] == 0  # the plain version on the CPU


def test_per_uid_means_are_pandas_groupby(evaluated):
    items = dict(np.load(f"{evaluated['run_dir']}/eval_validation.items.npz"))
    items["preset_UID"] = items["preset_UID"] % 4  # several rows per UID
    items["spec_sc"][[0, 3]] = np.nan  # a NaN in one group
    want = pd.DataFrame(items).groupby("preset_UID", as_index=False).mean(numeric_only=True)
    got = ev.per_uid_means(items)
    assert list(got) == list(want.columns)
    for k in want.columns:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k].to_numpy(), rtol=1e-6, err_msg=k)
    out = evaluated["out"]  # the pass's own return value: one row per UID
    assert len(out["preset_UID"]) == 11 and set(out) == set(want.columns)


def test_evaluate_all_models_skips_evaluated_runs(evaluated):
    eval_c = cfg.EvalConfig(models_names=("FlVAE2/e0",), audio_render_backend="cpp")
    assert ev.evaluate_all_models(eval_c, saved_root=evaluated["root"], device="cpu",
                                  dataset_kwargs=DATASET_KWARGS) == []


@pytest.mark.parametrize("split", ["validation", "test"])
def test_gt_audio_cache_is_written_then_read_bit_equal(evaluated, split):
    """The C++ re-render's ground-truth cache (``cache_gt_audio``, the
    default): the first eval of a split renders the ground truth and writes
    one ``gt_<key>.npy`` under the corpus cache directory, a second eval
    reads it without rewriting it, and the per-item tables of the two and
    of an eval without the cache are equal, bit for bit. The file holds the
    items' C++ renders, bit-equal to fresh ones."""
    run_dir = evaluated["run_dir"]
    ds = DexedDataset(device="cpu", operators=(1, 2), **DATASET_KWARGS)
    gt_dir = ds._corpus_cache_dir() / "gt_eval_audio"
    shutil.rmtree(gt_dir, ignore_errors=True)  # the module's first eval wrote 'validation''s

    def run(**kwargs):
        ev.evaluate_model_from_dir(run_dir, cfg.EvalConfig(audio_render_backend="cpp",
                                                           dataset=split, **kwargs),
                                   device="cpu", dataset_kwargs=DATASET_KWARGS)
        return dict(np.load(ev.items_path(run_dir, split)))

    first = run()
    (path,) = gt_dir.glob("gt_*.npy")
    assert not list(gt_dir.glob("*.tmp.npy"))
    written = path.stat().st_mtime_ns
    second = run()
    uncached = run(cache_gt_audio=False)
    assert list(gt_dir.glob("gt_*.npy")) == [path] and path.stat().st_mtime_ns == written
    assert len(first["preset_UID"]) == (11 if split == "validation" else 13)
    for table in (second, uncached):
        assert list(table) == list(first)
        for k in first:
            np.testing.assert_array_equal(table[k], first[k], err_msg=k)
    presets = np.stack([ds.get_full_preset_params(u) for u in first["preset_UID"]])
    np.testing.assert_array_equal(np.load(path), ds.renderer.render_batch(
        presets, first["midi_pitch"], first["midi_velocity"]))
