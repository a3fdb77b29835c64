"""The port's figures, plot epochs and sample labeler against the JAX
package's.

- Each of the six figure functions of ``utils/figures.py`` draws the same
  pixels as the JAX module's on the same seeded inputs (the canvas's RGBA
  buffer after ``draw()``), with each package's own ``LatentMetric`` and
  ``PresetIndexesHelper``.
- A 2-epoch CPU run with TensorBoard (the JAX loop tests' tiny model at
  full-size log-mels, 64 presets) logs ``LatCorr/Train`` and the four
  figures every ``plot_period`` epochs and on no other epoch; its
  ``LatCorr/Train`` is the ``LatentMetric`` of the epoch's train latents.
- ``SimpleSampleLabeler`` and ``hpss_masks`` are bit-equal to the JAX
  module's on a tone, noise and a click.
- ``scripts/dump_figures.py --device cpu`` on the trained run writes the
  four figure families as PNGs.
"""

import numpy as np
import pytest
import torch

from preset_gen_vae_tpu.data.dexed_spec import build_dexed_preset_spec as jax_spec
from preset_gen_vae_tpu.data.preset import PresetIndexesHelper as JaxHelper
from preset_gen_vae_tpu.logs.metrics import LatentMetric as JaxLatentMetric
from preset_gen_vae_tpu.utils import figures as jfigures
from preset_gen_vae_tpu.utils import label as jlabel
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data.dexed_spec import build_dexed_preset_spec
from preset_gen_vae_tpu_torch.data.preset import PresetIndexesHelper
from preset_gen_vae_tpu_torch.logs.metrics import LatentMetric
from preset_gen_vae_tpu_torch.scripts import dump_figures
from preset_gen_vae_tpu_torch.training import loop
from preset_gen_vae_tpu_torch.utils import figures, label
from _torch_port_fixtures import isolated_data_root, tiny_configs, two_torch_threads  # noqa: F401

FIGURES = ("Spectrogram", "LatentMu", "LatentEntanglement", "SynthControlsError")
CORPUS = {"n_synthetic_presets": 64}  # 5 train steps an epoch at batch 8


def _figure_args(name, rng, port: bool):
    helper = PresetIndexesHelper(build_dexed_preset_spec()) if port else JaxHelper(jax_spec())
    metric = (LatentMetric if port else JaxLatentMetric)(20)
    z = rng.standard_normal((50, 20)).astype(np.float32)
    metric.append(z, z + 0.1 * rng.standard_normal((50, 20)).astype(np.float32))
    L, P = helper.learnable_preset_size, helper.full_preset_size
    return {
        "plot_train_spectrograms": lambda: (rng.standard_normal((5, 1, 32, 40)),
                                            rng.standard_normal((5, 1, 32, 40)),
                                            np.array([[i, 60, 85] for i in range(5)])),
        "plot_latent_distributions_stats": lambda: (metric,),
        "plot_spearman_correlation": lambda: (metric,),
        "plot_synth_preset_param": lambda: (rng.random(P), rng.random(P), 7, helper),
        "plot_synth_learnable_preset": lambda: (rng.random(L), helper, 7),
        "plot_synth_preset_error": lambda: (rng.standard_normal((30, L)) * 0.1, helper),
    }[name]()


@pytest.mark.parametrize("name", ["plot_train_spectrograms", "plot_latent_distributions_stats",
                                  "plot_spearman_correlation", "plot_synth_preset_param",
                                  "plot_synth_learnable_preset", "plot_synth_preset_error"])
def test_figures_are_pixel_equal_to_the_jax_module(name):
    import matplotlib.pyplot as plt

    pixels = []
    for port, module in ((True, figures), (False, jfigures)):
        fig, _ = getattr(module, name)(*_figure_args(name, np.random.default_rng(5), port))
        fig.canvas.draw()
        pixels.append(np.asarray(fig.canvas.buffer_rgba()).copy())
        plt.close(fig)
    assert pixels[0].shape == pixels[1].shape and pixels[0].size > 10_000
    np.testing.assert_array_equal(pixels[0], pixels[1])


def _events(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(run_dir) + "/tensorboard", size_guidance={"images": 0, "scalars": 0})
    acc.Reload()
    return acc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """plot_period -> its run, trained once for the module."""
    return {}


def _plotted(runs, period, tmp_path_factory):
    """A 2-epoch run at ``plot_period`` ``period``, its train steps' latents
    recorded as the loop received them."""
    if period in runs:
        return runs[period]
    recorded, step = [], loop.train_step

    def recording_step(*args, **kwargs):
        m = step(*args, **kwargs)
        if kwargs.get("latents"):
            recorded.append((m["z0_mu"].float().numpy().copy(), m["z0"].float().numpy().copy()))
        return m

    tmp = tmp_path_factory.mktemp("plots")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "train_step", recording_step)
        model_c, train_c = tiny_configs(cfg, tmp, "plots", plot_period=period)
        s = loop.train_config(model_c, train_c, dataset_kwargs=CORPUS, device="cpu")
    runs[period] = dict(period=period, summary=s, recorded=recorded, events=_events(s["run_dir"]))
    return runs[period]


@pytest.fixture(params=[1, 2], ids=["plot_period_1", "plot_period_2"])
def plotted(request, runs, tmp_path_factory):
    return _plotted(runs, request.param, tmp_path_factory)


def test_plot_epochs_log_latcorr_train_and_the_four_figures(plotted):
    acc, period = plotted["events"], plotted["period"]
    plot_epochs = [e for e in (0, 1) if e % period == 0]
    assert [e.step for e in acc.Scalars("LatCorr/Train")] == plot_epochs
    assert [e.step for e in acc.Scalars("LatCorr/Valid")] == [0, 1]
    assert set(FIGURES) <= set(acc.Tags()["images"])
    for tag in FIGURES:
        assert [e.step for e in acc.Images(tag)] == plot_epochs, tag
    # the summary's LatCorr/Train is the last epoch's, where it has data
    assert ("LatCorr/Train" in plotted["summary"]) == (1 in plot_epochs)


def test_latcorr_train_is_the_latent_metric_of_the_epoch_rows(plotted):
    """Each logged ``LatCorr/Train`` is the metric of its epoch's 5 steps.
    The steps record their latents on every epoch: a group of K steps (the
    default K=16, capped at the epoch's 5) returns them whatever the
    epoch, as the JAX loop's K-step scan does."""
    acc, recorded = plotted["events"], plotted["recorded"]
    logged = acc.Scalars("LatCorr/Train")
    steps = 5
    assert len(recorded) == 2 * steps and logged
    for event in logged:
        want = LatentMetric(16)
        for z0_mu, z0 in recorded[event.step * steps:(event.step + 1) * steps]:
            want.append(z0_mu, z0)
        assert event.value == pytest.approx(want.get(), rel=1e-6)


def _waveforms():
    rng = np.random.default_rng(1234)
    t = np.arange(22050 * 2) / 22050.0
    click = np.zeros(len(t), dtype=np.float32)
    click[:2205] = rng.standard_normal(2205).astype(np.float32) * np.linspace(1, 0, 2205)
    return {"tone": (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
            "noise": (rng.standard_normal(len(t)) * 0.3).astype(np.float32),
            "click": click}


@pytest.mark.parametrize("kind", ["tone", "noise", "click"])
def test_labeler_is_bit_equal_to_the_jax_module(kind):
    wav = _waveforms()[kind]
    got, want = label.SimpleSampleLabeler(wav), jlabel.SimpleSampleLabeler(wav)
    for k in ("D", "H", "P", "R"):
        np.testing.assert_array_equal(got.specs[k], want.specs[k])
    assert got.energy == want.energy and got.attack_energies == want.attack_energies
    assert got.get_label() == want.get_label()
    for a, b in zip(label.hpss_masks(got.specs["D"], margin=2.0),
                    jlabel.hpss_masks(want.specs["D"], margin=2.0)):
        np.testing.assert_array_equal(a, b)
    assert label.label_waveforms(wav[None]) == jlabel.label_waveforms(wav[None])


def test_dump_figures_writes_the_four_pngs(runs, tmp_path_factory, monkeypatch):
    run = _plotted(runs, 1, tmp_path_factory)
    monkeypatch.setattr(dump_figures, "N_PRESETS", CORPUS["n_synthetic_presets"])
    paths = dump_figures.main([run["summary"]["run_dir"], "--device", "cpu"])
    assert sorted(p.name for p in paths) == ["latent_entanglement.png", "latent_mu.png",
                                             "spectrograms.png", "synth_param_error.png"]
    for p in paths:
        assert p.parent.name == "figures" and p.read_bytes()[:4] == b"\x89PNG"
