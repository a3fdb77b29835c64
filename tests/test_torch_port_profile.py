"""The port's step profiler (``utils/profile.py`` on ``torch.profiler``)
and the epoch loop's profiler window against the JAX package's.

On a 64-preset corpus (40 train items: 5 steps an epoch at batch 8) the
profiled run writes ``<run_dir>/profile/trace.json``, a Chrome trace whose
``train_step`` spans are the first epoch's first 5 steps, or every step of
an epoch shorter than that; training goes on past the window. With
``profiler_full_trace`` the port and the JAX loop (its train step and
initialisation stubbed, so that no XLA compile runs: the steps it takes and
where it stops are the loop's own) both stop after 3 steps of the first
epoch, before validation, and report no validation scalar.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import pytest
import torch

from preset_gen_vae_tpu import config as jcfg
from preset_gen_vae_tpu.data.dexed_dataset import DexedDataset as JaxDataset
from preset_gen_vae_tpu.logs import logger as jlogger
from preset_gen_vae_tpu.models import build as jbuild
from preset_gen_vae_tpu.training import loop as jloop
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset
from preset_gen_vae_tpu_torch.logs import logger
from preset_gen_vae_tpu_torch.training import loop
from preset_gen_vae_tpu_torch.utils.profile import ActualProfiler, NoProfiler, Spans, \
    get_optional_profiler
from _torch_port_fixtures import isolated_data_root, tiny_configs, two_torch_threads  # noqa: F401

N_PRESETS = 64


def test_profiler_wrapper(tmp_path):
    """tests/test_utils.py:81-91 for the port, and a window on the CPU that
    exports the spans opened inside it (``Spans``, the loop's spans) as a
    Chrome trace, and none opened outside it."""
    p = get_optional_profiler({"enabled": False})
    assert isinstance(p, NoProfiler)
    with p as prof:
        assert prof is None
    spans = Spans()
    with p, spans.span("X"):
        pass
    actual = get_optional_profiler({"enabled": True}, tmp_path / "prof")
    assert isinstance(actual, ActualProfiler)
    with spans.span("outside"):
        pass
    with actual:
        with spans.span("span"):
            torch.ones(4).sum()
    path = actual.export()
    assert path == tmp_path / "prof" / "trace.json"
    names = [e.get("name") for e in json.loads(path.read_text())["traceEvents"]]
    assert names.count("span") == 1 and "outside" not in names and "X" not in names


@pytest.fixture(scope="module")
def dataset():
    return DexedDataset(n_synthetic_presets=N_PRESETS, device="cpu")


def _spans(run_dir, name="train_step"):
    trace = json.loads((pathlib.Path(run_dir) / "profile" / "trace.json").read_text())
    return [e for e in trace["traceEvents"] if e.get("name") == name and e.get("ph") == "X"]


@pytest.mark.parametrize("batch, epoch_steps, traced", [(8, 5, 5), (16, 2, 2)])
def test_profiled_run_traces_the_first_train_steps(dataset, tmp_path, batch, epoch_steps, traced):
    model_c, train_c = tiny_configs(cfg, tmp_path, "prof", minibatch_size=batch,
                                    profiler_args={"enabled": True})
    s = loop.train_config(model_c, train_c, dataset=dataset, device="cpu", use_tensorboard=False)
    assert len(_spans(s["run_dir"])) == traced
    assert s["epochs_trained"] == 2 and s["train_steps"] == 2 * epoch_steps
    assert "ReconsLoss/Backprop/Valid" in s


def test_full_trace_stops_where_the_jax_loop_stops(dataset, tmp_path, monkeypatch):
    steps = {"port": [], "jax": []}
    for name, mod in (("port", logger), ("jax", jlogger)):
        monkeypatch.setattr(mod.RunLogger, "on_minibatch_finished",
                            lambda self, i, name=name: steps[name].append(i))

    def stub_train_step(*args, **kwargs):  # the JAX step, without its compile
        def step(state, x, v, info, key, beta):
            row = jnp.mean(v)
            return state, {**{k: row for k in jloop.FLUSH_KEYS},
                           "latents": {"z0_mu": v[:, :16], "z0": v[:, :16]}}
        return step

    init = jbuild.init_extended_ae
    monkeypatch.setattr(jloop, "make_train_step", stub_train_step)
    monkeypatch.setattr(jbuild, "init_extended_ae", lambda ext, seed, shape: jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, a.dtype), jax.eval_shape(lambda: init(ext, seed, shape))))
    kw = dict(profiler_args={"enabled": True}, profiler_full_trace=True)
    model_c, train_c = tiny_configs(cfg, tmp_path, "full", **kw)
    port = loop.train_config(model_c, train_c, dataset=dataset, device="cpu",
                             use_tensorboard=False)
    jmodel_c, jtrain_c = tiny_configs(jcfg, tmp_path / "jax", "full", **kw)
    jax_run = jloop.train_config(jmodel_c, jtrain_c, use_tensorboard=False, dataset=JaxDataset(
        n_synthetic_presets=N_PRESETS, data_root=tmp_path / "jax_data"))

    assert steps["port"] == steps["jax"] == [0, 1, 2]
    assert port["epochs_trained"] == jax_run["epochs_trained"] == 1
    assert port["train_steps"] == 3 and len(_spans(port["run_dir"])) == 3
    assert not [k for k in list(port) + list(jax_run) if k.endswith("/Valid")]
    assert port["final_lr"] == pytest.approx(jax_run["final_lr"])
    assert "ReconsLoss/Backprop/Train" in port
