"""The corpus and eval paths of the port's on-device FM render against the
JAX package, on the CPU: the ``structured2`` and ``uniform`` generators
(bit-equal), the ``'jax'`` corpus pass (short notes) against
``load_spectrogram_corpus_device``, the eval's ``'jax'`` re-render (ground
truth and inferred in one call), the dataset keywords' checks, and one
train + eval through the entry points on both ``'jax'`` backends.

Measured on the CPU against the bars below: corpus max |err| 2.4e-3 on the
presets with feedback below 7, MAE 1.6e-3 over all; stats min/max 2.6e-7
and mean/std 1.2e-4 relative.
"""

import numpy as np
import pytest
import torch

from preset_gen_vae_tpu.data.dexed_dataset import DexedDataset as JaxDexedDataset
from preset_gen_vae_tpu.synth import database as jax_db
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data.dexed_dataset import (
    DexedDataset,
    model_config_to_dataset_kwargs,
)
from preset_gen_vae_tpu_torch.evaluation import evaluate as ev
from preset_gen_vae_tpu_torch.evaluation.similarity import batched_audio_errors
from preset_gen_vae_tpu_torch.synth import database as port_db
from preset_gen_vae_tpu_torch.synth import fm_torch as ft
from preset_gen_vae_tpu_torch.synth.render import DexedRenderer
from preset_gen_vae_tpu_torch.training.loop import train_config
from _torch_port_fixtures import isolated_data_root  # noqa: F401 (autouse)

SHORT = dict(n_synthetic_presets=6, synthetic_seed=3, note_duration=(0.15, 0.05),
             midi_notes=((55, 85), (64, 100)), multichannel_stacked_spectrograms=True,
             corpus_render_backend="jax", synthetic_style="structured2")


@pytest.mark.parametrize("style", ["generate_structured_corpus_v2", "generate_random_corpus"])
@pytest.mark.parametrize("algos", [None, (1, 5, 17, 32)])
def test_generators_are_the_jax_packages(style, algos):
    want = getattr(jax_db, style)(500, seed=11, algos=algos)
    got = getattr(port_db, style)(500, seed=11, algos=algos)
    assert got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]


@pytest.mark.parametrize("style", ["structured", "structured2", "uniform"])
def test_synthetic_style_picks_the_jax_corpus(tmp_path, style):
    kw = dict(n_synthetic_presets=40, synthetic_seed=2, synthetic_style=style,
              algos=(1, 2, 3, 4, 5, 6, 7, 8))
    port = DexedDataset(device="cpu", **kw)
    jds = JaxDexedDataset(data_root=tmp_path, **kw)
    np.testing.assert_array_equal(port.uids, jds.valid_preset_UIDs)
    np.testing.assert_array_equal(port.presets, np.stack(
        [jds.get_full_preset_params(u) for u in jds.valid_preset_UIDs]))


@pytest.mark.parametrize("backend,policy", [("cpp", "disk"), ("jax", "disk"), ("jax", "device"),
                                            ("cpp", "device"), ("jax", "nvme"), ("vst", "disk")])
def test_dataset_checks_are_the_jax_packages(tmp_path, backend, policy):
    """The port raises ValueError exactly where the JAX package does."""
    kw = dict(n_synthetic_presets=4, corpus_render_backend=backend, corpus_cache_policy=policy)

    def raises(make):
        try:
            make()
        except ValueError:
            return True
        return False

    assert raises(lambda: DexedDataset(device="cpu", **kw)) == raises(
        lambda: JaxDexedDataset(data_root=tmp_path, **kw))


def test_saved_runs_ask_for_the_jax_backend():
    mc, _ = cfg.load_config(ev.REPO_ROOT / "saved" / "FlVAE2" / "r5stack3_v2_20480" /
                            "config.json")
    kw = model_config_to_dataset_kwargs(mc)
    assert (kw["corpus_render_backend"], kw["corpus_cache_policy"]) == ("jax", "device")


@pytest.fixture(scope="module")
def fm_corpus():
    port = DexedDataset(device="cpu", corpus_cache_policy="device", **SHORT)
    return port, port.load_corpus()


def test_fm_corpus_matches_jax_device_policy(fm_corpus, tmp_path):
    """Stacked 2-note corpus of short notes against the JAX package's
    device-resident pass (whose chunk of 4 re-renders the tail, as its own
    tests do). One raw f16 ulp is 1.2e-3 here once normalized (0.0625 dB
    over a 105 dB range): presets with feedback below 7 agree within 5e-3,
    4 ulps; the feedback-7 preset's recurrence amplifies the two
    frameworks' last-bit sine differences into its quiet bins, so over all
    presets the bar is an MAE of 5e-3 and the stats agree within 1e-3
    relative (min and max within 1e-4). The pass is timed."""
    port, got = fm_corpus
    jds = JaxDexedDataset(data_root=tmp_path, corpus_cache_policy="device", **SHORT)
    want = jds.load_spectrogram_corpus_device(dtype=np.float32, chunk=4).as_numpy_4d()
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (6, 2, 257, 19)
    err = np.abs(got.numpy() - want)
    fb7 = np.rint(port.presets[:, 5] * 7) == 7
    assert 1 <= fb7.sum() < len(fb7)
    assert float(err[~fb7].max()) < 5e-3
    assert float(err.mean()) < 5e-3
    assert set(port.spec_stats) == {"min", "max", "mean", "std"}
    for k in port.spec_stats:
        rel = 1e-4 if k in ("min", "max") else 1e-3
        assert port.spec_stats[k] == pytest.approx(jds.spec_stats[k], rel=rel), k
    assert 0.0 < port.render_seconds <= port.corpus_seconds
    assert float(got.min()) == -1.0 and float(got.max()) == 1.0


def test_fm_corpus_in_a_two_byte_dtype_is_the_f16_corpus_cast(fm_corpus):
    """In bfloat16 the corpus is finalised in place over the f16 buffer
    (one corpus-sized buffer): the f16-normalized values cast to bf16."""
    _, f32 = fm_corpus
    port = DexedDataset(device="cpu", corpus_dtype=torch.bfloat16, **SHORT)
    got = port.load_corpus()
    assert got.dtype == torch.bfloat16 and got.shape == f32.shape
    assert torch.equal(got, f32.to(torch.bfloat16))
    assert got.untyped_storage().nbytes() == got.numel() * 2


def test_eval_renders_ground_truth_and_inferred_in_one_call(monkeypatch):
    """'jax': one render call for both sets, the same audio metrics as two
    calls (to 1e-6 relative); 'cpp' renders them apart on the host."""
    renderer = DexedRenderer(note_duration=(0.1, 0.05))
    dataset = type("Dataset", (), {"renderer": renderer})()
    p, _, _ = port_db.generate_structured_corpus_v2(6, seed=4)
    gt, inferred = p[:3], p[3:]
    pitch, vel = np.array([60, 48, 72]), np.array([85, 100, 64])
    calls = []
    render = ft.render_batch
    monkeypatch.setattr(ft, "render_batch", lambda *a, **k: calls.append(1) or render(*a, **k))
    got = ev.render_pairs(dataset, cfg.EvalConfig(), gt, inferred, pitch, vel, torch.device("cpu"))
    assert len(calls) == 1 and got[0].shape == (3, 3584)
    apart = [render(torch.from_numpy(x), pitch, vel, note_on_s=0.1, total_s=0.15,
                    feedback="exact") for x in (gt, inferred)]
    e_one = batched_audio_errors(*got, 1024, 256, 22050)
    e_two = batched_audio_errors(*apart, 1024, 256, 22050)
    for k in ev.AUDIO_METRICS:
        np.testing.assert_allclose(e_one[k].numpy(), e_two[k].numpy(), rtol=1e-6, err_msg=k)
    cpp = ev.render_pairs(dataset, cfg.EvalConfig(audio_render_backend="cpp"), gt, inferred,
                          pitch, vel, torch.device("cpu"))
    assert len(calls) == 1
    np.testing.assert_array_equal(cpp[0].numpy(), renderer.render_batch(gt, pitch, vel))


def test_train_and_evaluate_on_the_jax_backends_on_cpu(tmp_path):
    """A saved run's 'jax' / 'device' settings through ``train_config`` and
    the evaluation from the run dir, full-length notes on the CPU with the
    unrolled feedback (the exact loop takes ~40 s a note there): every
    metric finite, the GT-audio flag ignored under 'jax'."""
    model_c = cfg.ModelConfig(dataset_synth_args=(None, (1, 2)), logs_root_dir=str(tmp_path),
                              run_name="fm", dataset_corpus_render_backend="jax",
                              dataset_corpus_cache_policy="device")
    kw = {"n_synthetic_presets": 12, "synthetic_style": "structured2",
          "corpus_render_feedback": "unrolled"}
    summary = train_config(model_c, cfg.TrainConfig(n_epochs=1, minibatch_size=4, verbosity=0),
                           device="cpu", dataset_kwargs=kw, use_tensorboard=False)
    assert summary["input_size"] == [4, 1, 257, 347]
    assert 0.0 < summary["corpus_render_seconds"] <= summary["corpus_seconds"]
    assert all(np.isfinite([v for v in summary.values() if isinstance(v, float)]))
    phases = {}
    means = ev.evaluate_model_from_dir(
        summary["run_dir"], cfg.EvalConfig(audio_render_feedback="unrolled", cache_gt_audio=True),
        device="cpu", dataset_kwargs=kw, phase_seconds=phases)
    assert len(means["preset_UID"]) == 2
    for k in ev.AUDIO_METRICS[:1] + ev.AUDIO_METRICS[2:]:
        assert np.isfinite(means[k]).all(), k
    assert phases["render"] > 0.0
