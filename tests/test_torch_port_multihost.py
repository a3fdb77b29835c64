"""The port's multi-process data path (``parallel/multihost.py`` on
``torch.distributed``) against the JAX package's ``parallel/multihost.py``
and against one process.

- The carve: ``host_item_range``, ``_equalized_shard_sizes``,
  ``_global_batch_weights`` and ``shard_loaders_for_host`` give what the
  JAX functions give for 1-4 processes (the JAX side under monkeypatched
  ``jax.process_count`` / ``process_index``, as
  ``tests/test_multihost_carving.py`` does): the items each process
  serves, in each epoch's order, its batch size and the validation
  weights. An indivisible batch and ``corpus_cache_policy='device'`` raise.
- Two processes (gloo, spawned, a ``FileStore`` under ``tmp_path``) each
  take one train step of the flagship on 4 of 8 seeded rows; their loss,
  every averaged gradient and every BatchNorm running statistic equal one
  process's step on the 8 rows within 1e-5 of the tensor's largest
  entry. Rows 0-2 have three silent operators, so the
  categorical loss's useful items differ between the two processes. The
  step runs in float64: at float32 the flagship's step at random weights
  is ill-conditioned (the gradients of the flows' BatchNorm-laden
  conditioners cancel; ``chip_smoke.py``'s ``multiproc2`` prints the
  float32 differences on the card beside the float64 ones). A tensor that
  is zero in exact arithmetic (a bias feeding a train-mode BatchNorm, the
  running mean of a BatchNorm whose input has zero batch mean: under
  1e-6 of its module's largest entry) is held at its module's scale.
- ``force_multihost_data=True`` in one process trains 2 epochs of the
  tiny model within 2e-3 of the plain run (the bar of
  ``tests/test_parallel_integration.py:84-102``).
- ``data_parallel_devices`` and ``model_parallel_devices`` above 1 raise in
  one process, before any work.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from preset_gen_vae_tpu.data.pipeline import SplitLoader as JaxSplitLoader
from preset_gen_vae_tpu.parallel import multihost as jmh
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data.pipeline import SplitLoader
from preset_gen_vae_tpu_torch.parallel import multihost
from preset_gen_vae_tpu_torch.training import loop
import _torch_port_ranks as ranks
from _torch_port_fixtures import isolated_data_root, tiny_configs, two_torch_threads  # noqa: F401


def _loader_pair(n_items=50, batch=8):
    """The JAX carving test's loaders (tests/test_multihost_carving.py:22-35)
    in both packages: numpy tensors there, torch tensors here."""
    tensors = {"x": np.arange(n_items, dtype=np.float32).reshape(n_items, 1),
               "v": np.arange(n_items, dtype=np.float32).reshape(n_items, 1) * 2,
               "info": np.stack([np.arange(n_items)] * 3, axis=1).astype(np.int32)}
    idx = np.arange(n_items)
    out = []
    for cls, ts in ((SplitLoader, {k: torch.from_numpy(t) for k, t in tensors.items()}),
                    (JaxSplitLoader, tensors)):
        out.append({"train": cls(ts, idx[:40], batch, shuffle=True, drop_last=True, seed=0),
                    "validation": cls(ts, idx[40:], batch, shuffle=False, drop_last=False,
                                      pad_to_full=True)})
    return out


def _jax_world(monkeypatch, rank, world):
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(jax, "process_index", lambda: rank)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_item_ranges_shards_and_weights_equal_jax(monkeypatch, world):
    for n_items in (0, 1, 7, 10, 50, 163):
        for rank in range(world):
            _jax_world(monkeypatch, rank, world)
            assert multihost.host_item_range(n_items, rank, world) == jmh.host_item_range(n_items)
        real, common = multihost._equalized_shard_sizes(n_items, world)
        jreal, jcommon = jmh._equalized_shard_sizes(n_items, world)
        np.testing.assert_array_equal(real, jreal)
        assert common == jcommon
        for local_bs in (1, 2, 5):
            for drop_last in (False, True):
                np.testing.assert_array_equal(
                    multihost._global_batch_weights(real, common, local_bs, drop_last),
                    jmh._global_batch_weights(jreal, jcommon, local_bs, drop_last))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_carving_equals_jax(monkeypatch, world):
    for rank in range(world):
        port, jax_loaders = _loader_pair()
        _jax_world(monkeypatch, rank, world)
        got = multihost.shard_loaders_for_host(port, rank, world, force=True)
        want = jmh.shard_loaders_for_host(jax_loaders, force=True)
        for name in ("train", "validation"):
            g, w = got[name], want[name]
            assert (g.batch_size, g.n_items, len(g)) == (w.batch_size, w.n_items, len(w))
            np.testing.assert_array_equal(g.batch_weights, w.batch_weights)
            # the carved tensors hold exactly the rows the JAX carve holds
            for k in ("x", "v", "info"):
                np.testing.assert_array_equal(g.tensors[k].numpy(), w.tensors[k])
            for epoch in (0, 1):
                for gs, ws in zip(g.epoch_index_batches(epoch), w.epoch_index_batches(epoch)):
                    np.testing.assert_array_equal(g.gather(gs)[2].numpy(), w.tensors["info"][ws])


def test_single_process_passes_through_unless_forced():
    port, _ = _loader_pair()
    assert multihost.shard_loaders_for_host(port, 0, 1) is port
    multihost.initialize_distributed("tcp://127.0.0.1:1", world_size=1, rank=0)
    assert multihost.rank_and_world() == (0, 1)


def test_carving_raises_for_an_indivisible_batch_and_for_device_policy():
    port, _ = _loader_pair()
    with pytest.raises(ValueError, match="not divisible"):
        multihost.shard_loaders_for_host(port, 0, 3)
    with pytest.raises(ValueError, match="'device'"):
        multihost.shard_loaders_for_host(port, 0, 2, corpus_cache_policy="device")


def test_two_processes_step_as_one_on_the_concatenated_batch(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=ranks.rank_step, args=(r, 2, str(tmp_path / "store"),
                                                       str(tmp_path), 8)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        p.kill()
    assert not hung, f"ranks {hung} did not finish in 120 s"
    assert [p.exitcode for p in procs] == [0, 0]

    want = ranks.one_step(*ranks.flagship_batch(8))
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert float((got["loss"] - want["loss"]).abs()) <= 1e-5 * float(want["loss"].abs())
        for kind in ("grads", "stats"):
            assert got[kind].keys() == want[kind].keys()
            module_scale = {}
            for k, t in want[kind].items():
                m = k.rsplit(".", 1)[0]
                module_scale[m] = max(module_scale.get(m, 0.0), float(t.abs().max()))
            for k, t in want[kind].items():
                scale = max(float(t.abs().max()), 1e-6 * module_scale[k.rsplit(".", 1)[0]])
                assert float((got[kind][k] - t).abs().max()) <= 1e-5 * scale, (r, kind, k)
    assert len(want["grads"]) > 200 and len(want["stats"]) > 50


LOSSES = ("ReconsLoss/Backprop/Valid", "LatLoss/Valid", "Controls/BackpropLoss/Valid")


def test_forced_multihost_data_trains_as_the_plain_run(tmp_path):
    runs = {}
    for forced in (False, True):
        model_c, train_c = tiny_configs(cfg, tmp_path, f"forced_{forced}",
                                        force_multihost_data=forced)
        runs[forced] = loop.train_config(model_c, train_c, device="cpu", use_tensorboard=False,
                                         dataset_kwargs={"n_synthetic_presets": 24})
    assert runs[True]["epochs_trained"] == 2 and runs[True]["world_size"] == 1
    for k in LOSSES:
        assert runs[True][k] == pytest.approx(runs[False][k], rel=2e-3), k


@pytest.mark.parametrize("field", ["data_parallel_devices", "model_parallel_devices"])
def test_parallel_fields_raise_in_one_process(tmp_path, monkeypatch, field):
    monkeypatch.setattr(loop, "prepare_dataset", lambda *a, **k: pytest.fail("built a dataset"))
    model_c, train_c = tiny_configs(cfg, tmp_path, "par", **{field: 2})
    with pytest.raises(ValueError, match=field):
        loop.train_config(model_c, train_c, device="cpu", use_tensorboard=False)
    loop.check_parallel_fields(dataclasses.replace(train_c, **{field: 1}), 1)
