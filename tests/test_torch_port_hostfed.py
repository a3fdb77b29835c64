"""The host-fed input pipeline (``TrainConfig.dataset_cache_device=False``;
``data/pipeline.py:SplitLoader.device_batches``,
``data/dexed_dataset.py``'s ``corpus_on_device``), the counterpart of the
JAX loop's host-fed mode (``preset_gen_vae_tpu/training/loop.py:207-209,
233-237``, ``tests/test_loop.py:91-101``).

- Two epochs of the tiny model host-fed and resident, in one process and
  on the multi-process data path (``force_multihost_data``): every
  scalar, every parameter and Adam's state bit-equal; the host-fed run
  steps one at a time (no K-step group), its loaders' tensors are host
  tensors.
- A cold corpus pass with the corpus off the device writes the resident
  pass's tiers and statistics and serves its corpus, bit for bit.
- ``device_batches`` hands out, in order, fresh tensors equal to the
  gathered batches (a batch gathered later does not change one handed
  out before).
- A dataset whose corpus lives elsewhere than the field says raises.
- On the card (``cuda``): the corpus and the carve are pinned, and the
  batches arrive equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset
from preset_gen_vae_tpu_torch.data.pipeline import SplitLoader, get_split_loaders
from preset_gen_vae_tpu_torch.logs.logger import load_checkpoint
from preset_gen_vae_tpu_torch.parallel import multihost
from preset_gen_vae_tpu_torch.training import loop
from _torch_port_fixtures import isolated_data_root, tiny_configs, two_torch_threads  # noqa: F401

CORPUS = {"n_synthetic_presets": 40}  # 3 train steps an epoch


def _run(tmp_path, name, **train_kw):
    model_c, train_c = tiny_configs(cfg, tmp_path, name, **train_kw)
    summary = loop.train_config(model_c, train_c, device="cpu", use_tensorboard=False,
                                dataset_kwargs=CORPUS)
    return summary, load_checkpoint(model_c, 1)["state"]


@pytest.mark.parametrize("forced", [False, True], ids=["one_process", "multihost_data"])
def test_host_fed_trains_bit_equal_to_resident(tmp_path, forced):
    kw = dict(force_multihost_data=forced, steps_per_dispatch=2)
    resident, r_state = _run(tmp_path, "resident", **kw)
    host, h_state = _run(tmp_path, "host_fed", dataset_cache_device=False, **kw)
    assert host["dataset_cache_device"] is False and resident["dataset_cache_device"] is True
    assert host["steps_per_dispatch"] == 1
    assert resident["steps_per_dispatch"] == (1 if forced else 2)
    assert host["corpus_bytes"] == resident["corpus_bytes"] > 0
    scalars = [k for k in resident if k.endswith(("/Train", "/Valid"))]
    assert len(scalars) >= 10
    for k in scalars:
        assert host[k] == resident[k], k
    for k, t in r_state["model"].items():
        assert torch.equal(h_state["model"][k], t), k
    for i, st in r_state["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(h_state["optimizer"]["state"][i][k], st[k]), (i, k)
    assert torch.equal(h_state["generator"], r_state["generator"])


SHORT = dict(n_synthetic_presets=70, synthetic_seed=1, note_duration=(0.15, 0.05),
             midi_notes=((60, 85), (48, 100)), multichannel_stacked_spectrograms=True)


@pytest.mark.parametrize("backend", ["cpp", "jax"])
def test_host_fed_cold_pass_equals_resident(tmp_path, backend):
    """A cold ``'disk'`` pass with the corpus off the device (its raw
    corpus rendered straight into its tier, 64 presets at a time over two
    chunks) writes the resident pass's tiers and statistics bit for bit and
    serves its corpus."""
    kw = dict(SHORT, device="cpu", corpus_render_backend=backend,
              **({"corpus_render_feedback": "unrolled"} if backend == "jax" else {}))
    passes = {}
    for on_device in (True, False):
        ds = DexedDataset(data_root=str(tmp_path / str(on_device)), corpus_on_device=on_device,
                          **kw)
        corpus = ds.load_corpus()
        assert ds.render_seconds > 0  # cold
        passes[on_device] = (ds, corpus)
    (res, want), (host, got) = passes[True], passes[False]
    assert torch.equal(got, want) and host.spec_stats == res.spec_stats
    for name in ("specs_raw.npy", "specs_norm_f16.npy"):
        a, b = (np.load(d._corpus_cache_dir() / name) for d in (host, res))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_host_fed_loaders_hold_host_tensors():
    model_c, train_c = tiny_configs(cfg, "unused", "x", dataset_cache_device=False)
    model_c, train_c, dataset = loop.prepare_dataset(model_c, train_c, torch.device("cpu"),
                                                     dataset_kwargs=CORPUS)
    assert not dataset.corpus_on_device
    loaders = get_split_loaders(dataset, train_c)
    carved = multihost.shard_loaders_for_host(loaders, 1, 2)
    for ld in (*loaders.values(), *carved.values()):
        assert all(t.device.type == "cpu" for t in ld.tensors.values())


def test_device_batches_hand_out_fresh_equal_batches():
    n = 23
    tensors = {"x": torch.arange(n * 6, dtype=torch.float32).reshape(n, 1, 2, 3),
               "v": torch.arange(n * 4, dtype=torch.float32).reshape(n, 4) * 2,
               "info": torch.arange(n * 3, dtype=torch.int32).reshape(n, 3)}
    ld = SplitLoader(tensors, np.arange(n), 5, shuffle=True, drop_last=False, seed=3,
                     pad_to_full=True)
    for epoch in (0, 1):
        batches = list(ld.epoch_index_batches(epoch))
        got = list(ld.device_batches(batches, torch.device("cpu")))
        assert len(got) == len(batches) == 5
        for sel, out in zip(batches, got):
            for a, b in zip(out, ld.gather(sel)):
                assert torch.equal(a, b)
        ptrs = {t.data_ptr() for out in got for t in out}
        corpus = {t.data_ptr() for t in tensors.values()}
        assert len(ptrs) == 15 and not ptrs & corpus
    assert list(ld.device_batches([], torch.device("cpu"))) == []


def test_a_dataset_elsewhere_than_the_field_raises(monkeypatch):
    model_c, train_c = tiny_configs(cfg, "unused", "x", dataset_cache_device=False)
    monkeypatch.setattr(DexedDataset, "load_corpus", lambda self: pytest.fail("loaded"))
    dataset = DexedDataset(device="cpu", **CORPUS)
    with pytest.raises(ValueError, match="dataset_cache_device=False"):
        loop.prepare_dataset(model_c, train_c, torch.device("cpu"), dataset=dataset)


@pytest.mark.cuda
def test_host_fed_batches_on_the_card_are_pinned_and_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    model_c, train_c = tiny_configs(cfg, "unused", "x", dataset_cache_device=False)
    model_c, train_c, dataset = loop.prepare_dataset(model_c, train_c, dev,
                                                     dataset_kwargs=CORPUS)
    loaders = get_split_loaders(dataset, train_c)
    carved = multihost.shard_loaders_for_host(loaders, 0, 2)
    for ld in (loaders["train"], carved["train"]):
        assert all(t.is_pinned() for t in ld.tensors.values())
        batches = list(ld.epoch_index_batches(0))
        got = list(ld.device_batches(batches, dev))
        torch.cuda.synchronize()
        for sel, out in zip(batches, got):
            for a, b in zip(out, ld.gather(sel)):
                assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    resident = dataclasses.replace(train_c, dataset_cache_device=True)
    with pytest.raises(ValueError, match="dataset_cache_device=True"):
        loop.prepare_dataset(model_c, resident, dev, dataset=dataset)
