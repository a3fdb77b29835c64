"""The port's tensor parallelism (``parallel/sharding_rules.py``,
``models/layers.py:ShardedLinear``) against the JAX package's
``parallel/sharding_rules.py`` and against one process.

- The plan: for the flagship and three saved runs' configurations at full
  width (shapes only: random weights), at ``n_model`` 2 and 4 and
  ``tp_min_elements`` 1<<18 and 1<<10, the port shards exactly the flax
  leaves that JAX's ``param_spec`` shards, on the same axis (a torch
  weight's dim 0 is the flax kernel's output axis, "column"), over a JAX
  2-D mesh of the 8 CPU devices of ``tests/conftest.py``, and
  ``count_sharded`` gives JAX's counts. ``r2mlp400``'s head kernel
  ``fc4`` (1024 -> 610) shards by rows at 4.
- One train step of the tiny model (BasicVAE, dim_z 16, ``mlp_2l64``,
  full-size log-mels; ``TP_MIN_ELEMENTS`` = 1<<10, so that every kernel
  but the smallest is sharded and the head's last one by rows at 4) on
  grids (1, 2), (2, 2) and (1, 4) of spawned gloo processes against one
  process on the 4 rows, in float64: the loss, every gradient (a shard's
  gathered), every running statistic within 1e-10 of the tensor's scale
  (its largest entry; its module's where it is zero in exact arithmetic,
  under 1e-6 of its module's largest entry), the generator's state equal.
- The (1, 2) grid's model carrying the JAX package's variables
  (``weights.load_flax_variables`` gives each process its slices) runs
  the eval-mode forward as ``ExtendedAE.apply`` does, at the parity bar of
  ``tests/test_torch_port_model.py`` (rtol 1e-4, atol 2e-4).
- Checkpoints are layout-free: a run of 2 epochs under a (1, 2) grid
  resumes for a third in one process, and a one-process run's checkpoint
  resumes under the grid; each third epoch's validation losses are within
  2e-3 of an uninterrupted one-process run's (the bar of
  ``tests/test_parallel_integration.py:76-79``), and the checkpoints hold
  the full tensors.
- A world that ``model_parallel_devices`` does not divide, or a grid that
  leaves processes idle, raises naming the field.
"""

import collections
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from preset_gen_vae_tpu.parallel import sharding_rules as jsr
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch import weights
from preset_gen_vae_tpu_torch.data.dexed_spec import build_dexed_preset_spec
from preset_gen_vae_tpu_torch.data.preset import PresetIndexesHelper
from preset_gen_vae_tpu_torch.logs.logger import load_checkpoint
from preset_gen_vae_tpu_torch.models.build import build_extended_ae_model
from preset_gen_vae_tpu_torch.models.flows import MaskedDense
from preset_gen_vae_tpu_torch.parallel import sharding_rules
from preset_gen_vae_tpu_torch.training import loop
import _torch_port_ranks as ranks
from _torch_port_fixtures import isolated_data_root, tiny_configs, two_torch_threads  # noqa: F401
from test_torch_port_model import flagship_pair

SAVED = pathlib.Path(__file__).resolve().parent.parent / "saved" / "FlVAE2"
CONFIGS = ("flagship", "r5stack3_v2_20480", "r5multi6_v2_12288", "r2mlp400")


@pytest.fixture(scope="module")
def full_width_models():
    """Each configuration's model at full width, built once (seed 0)."""
    helper = PresetIndexesHelper(build_dexed_preset_spec())
    out = {}
    for name in CONFIGS:
        if name == "flagship":
            model_c, train_c, *_ = ranks.flagship_batch(1)
        else:
            model_c, train_c = cfg.load_config(SAVED / name / "config.json")
        out[name] = build_extended_ae_model(model_c, train_c, helper, seed=0)
    return out


def _jax_specs(params, n_model, min_elements):
    """flax path -> JAX's PartitionSpec of every params leaf."""
    mesh = jsr.make_2d_mesh(len(jax.devices()) // n_model, n_model)
    specs = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        specs[tuple(k.key for k in path)] = jsr.param_spec(leaf, mesh, min_elements)
    return mesh, specs


@pytest.mark.parametrize("min_elements", [1 << 18, 1 << 10])
@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("name", CONFIGS)
def test_plan_equals_jax(full_width_models, name, n_model, min_elements):
    model = full_width_models[name]
    params = weights.flax_variables_from_model(model)["params"]
    mesh, specs = _jax_specs(params, n_model, min_elements)
    plan = sharding_rules.shard_plan(model, n_model, min_elements)
    axis = {sharding_rules.COLUMN: jsr.P(None, jsr.MODEL_AXIS),
            sharding_rules.ROW: jsr.P(jsr.MODEL_AXIS, None)}
    want = {}
    for key, coll, path, _ in weights.flax_leaves(model):
        if coll == "params":
            module = key.rpartition(".")[0]
            want[path] = axis[plan[module]] if key.endswith(".weight") and module in plan \
                else jsr.P()
    assert want == specs
    assert sharding_rules.count_sharded(model, n_model, min_elements) == \
        jsr.count_sharded(params, mesh, min_elements)
    if (name, n_model, min_elements) == ("flagship", 2, 1 << 18):
        assert sharding_rules.count_sharded(model, 2) == (2, 44_974_080, 60_372_037)
    if (name, n_model) == ("r2mlp400", 4):
        assert plan["reg_model.fc4"] == sharding_rules.ROW


GRIDS = [(1, 2), (2, 2), (1, 4)]
BATCH = 4


@pytest.fixture(scope="module")
def forward_pair():
    """The tiny model's port and JAX pair of ``tests/test_torch_port_model.py``
    (the port's weights exported as a flax dict) at batch 4."""
    return flagship_pair(model_kwargs=ranks.TINY)


@pytest.fixture(scope="module")
def grid_steps(tmp_path_factory, forward_pair):
    """grid -> its processes' saved steps (and the (1, 2) grid's forwards
    on the JAX variables)."""
    variables = jax.tree_util.tree_map(np.asarray, forward_pair[2])
    out = {}
    for n_data, n_model in GRIDS:
        d = tmp_path_factory.mktemp(f"grid{n_data}x{n_model}")
        ranks.spawn(ranks.rank_tp, n_data * n_model,
                    (str(d / "store"), str(d), BATCH, n_data, n_model,
                     variables if (n_data, n_model) == (1, 2) else None))
        out[(n_data, n_model)] = d
    return out


def _scales(step):
    """``kind:name`` -> the tensor's largest entry, or its module's where the
    tensor is under 1e-6 of it (zero in exact arithmetic)."""
    out = {"loss": float(step["loss"].abs())}
    for kind in ("grads", "stats"):
        module = collections.defaultdict(float)
        for k, t in step[kind].items():
            module[k.rsplit(".", 1)[0]] = max(module[k.rsplit(".", 1)[0]], float(t.abs().max()))
        for k, t in step[kind].items():
            own, mod = float(t.abs().max()), module[k.rsplit(".", 1)[0]]
            out[f"{kind}:{k}"] = own if own >= 1e-6 * mod else mod
    return out


@pytest.fixture(scope="module")
def one_process_step():
    """The tiny model's step in one process on the 4 rows, in float64."""
    return ranks.one_step(*ranks.flagship_batch(BATCH, **ranks.TINY))


def _assert_step_equal(got, want, where):
    """``got`` (a process's step) equals ``want`` (one process's) within 1e-10
    of each tensor's scale, its generator's state equal."""
    scales = _scales(want)
    assert abs(float(got["loss"] - want["loss"])) <= 1e-10 * scales["loss"]
    for kind in ("grads", "stats"):
        assert got[kind].keys() == want[kind].keys()
        for k, t in want[kind].items():
            assert got[kind][k].shape == t.shape, (where, k)
            err = float((got[kind][k] - t).abs().max())
            assert err <= 1e-10 * scales[f"{kind}:{k}"], (where, kind, k, err)
    assert torch.equal(got["generator"], want["generator"])


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{d}x{m}" for d, m in GRIDS])
def test_tp_step_equals_one_process(grid_steps, one_process_step, grid):
    for r in range(grid[0] * grid[1]):
        _assert_step_equal(torch.load(grid_steps[grid] / f"rank{r}.pt"), one_process_step, r)
    model_c, train_c, helper, *_ = ranks.flagship_batch(BATCH, **ranks.TINY)
    model = build_extended_ae_model(model_c, train_c, helper, seed=0)
    plan = sharding_rules.shard_plan(model, grid[1], ranks.TP_MIN_ELEMENTS)
    assert len(plan) >= 5 and plan["ae_model.encoder.mlp_out"] == sharding_rules.COLUMN
    assert plan["reg_model.fc3"] == (sharding_rules.ROW if grid[1] == 4 else
                                     sharding_rules.COLUMN)


def test_tp_step_shards_masked_dense(tmp_path):
    """The tiny model with a MAF latent flow on a (1, 2) grid: each
    MaskedDense is cut with its mask; the step, the masked kernels'
    gradients among them, equals one process's in float64."""
    ranks.spawn(ranks.rank_tp, 2, (str(tmp_path / "store"), str(tmp_path), BATCH, 1, 2, None,
                                   ranks.TINY_MAF))
    want = ranks.one_step(*ranks.flagship_batch(BATCH, **ranks.TINY_MAF))
    model_c, train_c, helper, *_ = ranks.flagship_batch(BATCH, **ranks.TINY_MAF)
    model = build_extended_ae_model(model_c, train_c, helper, seed=0)
    plan = sharding_rules.shard_plan(model, 2, ranks.TP_MIN_ELEMENTS)
    masked = [name for name in plan if isinstance(model.get_submodule(name), MaskedDense)]
    assert len(masked) == 6 and all(plan[name] == sharding_rules.COLUMN for name in masked)
    for name in masked:  # the masked kernels' gradients: zero where their mask is
        mask = model.get_submodule(name).mask
        assert float(want["grads"][f"{name}.weight"][mask == 0].abs().max()) == 0.0
        assert float(want["grads"][f"{name}.weight"].abs().max()) > 0.0
    for r in range(2):
        _assert_step_equal(torch.load(tmp_path / f"rank{r}.pt"), want, r)


def test_tp_forward_from_jax_weights_matches_jax(grid_steps, forward_pair):
    _, ext, jvars, *_ = forward_pair
    *_, x, _, info = ranks.flagship_batch(BATCH, **ranks.TINY)  # the processes' rows
    outs = jax.jit(lambda variables, x, info: ext.apply(
        variables, x, info, train=False, method=ext.forward_full))(jvars, x, info)
    names = ("z0_mu_logvar", "z0", "zK", "logdet", "x_out", "v_out")
    for r in range(2):
        touts = torch.load(grid_steps[(1, 2)] / f"forward{r}.pt")
        for name, a, b in zip(names, outs, touts):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=2e-4,
                                       err_msg=f"rank {r} forward output '{name}'")


LOSSES = ("ReconsLoss/Backprop/Valid", "LatLoss/Valid", "Controls/BackpropLoss/Valid")
CORPUS = {"n_synthetic_presets": 24}


def _tp_train(root, model_c, train_c, corpus=CORPUS):
    """``train_config`` under a (1, 2) grid of spawned gloo processes; -> its
    summary."""
    out = root / f"summary_{model_c.run_name}_{train_c.start_epoch}.pt"
    ranks.spawn(ranks.rank_train, 2, (str(root / f"store_{model_c.run_name}"), str(out), 2,
                                      model_c, train_c, corpus))
    return torch.load(out)


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """Runs of the tiny model on 24 presets: 3 epochs in one process; 2
    epochs under a (1, 2) grid (on a cold corpus cache), resumed for the
    third in one process; 2
    epochs in one process, resumed for the third under the grid."""
    root = tmp_path_factory.mktemp("layouts")
    runs = {}

    def configs(name, **kw):
        model_c, train_c = tiny_configs(cfg, root, name, tp_min_elements=ranks.TP_MIN_ELEMENTS)
        return model_c, dataclasses.replace(train_c, **kw)

    def one(name, **kw):
        return loop.train_config(*configs(name, **kw), device="cpu", use_tensorboard=False,
                                 dataset_kwargs=CORPUS)

    runs["uninterrupted"] = one("uninterrupted", n_epochs=3)
    # a cold corpus pass: rank 0 writes the cache before rank 1 reads it
    runs["tp"] = _tp_train(root, *configs("tp_then_one", n_epochs=2),
                           dict(CORPUS, data_root=str(root / "cold")))
    runs["tp_checkpoint"] = load_checkpoint(configs("tp_then_one")[0], 1)["state"]
    runs["tp_then_one"] = one("tp_then_one", n_epochs=3, start_epoch=2)
    runs["one"] = one("one_then_tp", n_epochs=2)
    runs["one_checkpoint"] = load_checkpoint(configs("one_then_tp")[0], 1)["state"]
    runs["one_then_tp"] = _tp_train(root, *configs("one_then_tp", n_epochs=3, start_epoch=2))
    runs["one_then_tp_checkpoint"] = load_checkpoint(configs("one_then_tp")[0], 2)["state"]
    return runs


def _full_shapes(state):
    return ({k: t.shape for k, t in state["model"].items()},
            {i: st["exp_avg"].shape for i, st in state["optimizer"]["state"].items()})


def test_tp_checkpoint_resumes_in_one_process(layouts):
    tp = layouts["tp"]
    model_c, train_c, helper, *_ = ranks.flagship_batch(BATCH, **ranks.TINY)
    tiny = build_extended_ae_model(model_c, train_c, helper, seed=0)
    assert tp["tp_grid"] == [1, 2] and tp["world_size"] == 2
    assert tp["tp_kernels_sharded"] == sharding_rules.count_sharded(
        tiny, 2, ranks.TP_MIN_ELEMENTS)[0]
    assert _full_shapes(layouts["tp_checkpoint"]) == _full_shapes(layouts["one_checkpoint"])
    resumed, want = layouts["tp_then_one"], layouts["uninterrupted"]
    assert resumed["start_step"] == layouts["tp_checkpoint"]["step"]
    assert resumed["epochs_trained"] == 3 and resumed["world_size"] == 1
    for k in LOSSES:
        assert resumed[k] == pytest.approx(want[k], rel=2e-3), k


def test_one_process_checkpoint_resumes_under_the_grid(layouts):
    resumed, want = layouts["one_then_tp"], layouts["uninterrupted"]
    assert resumed["start_step"] == layouts["one_checkpoint"]["step"]
    assert resumed["epochs_trained"] == 3 and resumed["tp_grid"] == [1, 2]
    assert _full_shapes(layouts["one_then_tp_checkpoint"]) == \
        _full_shapes(layouts["one_checkpoint"])
    for k in LOSSES:
        assert resumed[k] == pytest.approx(want[k], rel=2e-3), k


def test_tp_train_equals_its_column_twin(tmp_path):
    """``train_config`` under a (1, 2) grid, the tiny model with a MAF latent
    flow (its MaskedDense kernels sharded), against its column twin in one
    process (``chip_smoke.column_twin``: each sharded Linear computed in
    halves, as the grid computes it): every scalar, every parameter and
    Adam's state bit-equal after 2 epochs. ``chip_smoke.py``'s ``tp_train``
    holds the grid on the card to the same twin."""
    corpus = dict(CORPUS, data_root=str(tmp_path / "corpus"))
    model_c, train_c = tiny_configs(cfg, tmp_path, "tp", tp_min_elements=ranks.TP_MIN_ELEMENTS)
    model_c = dataclasses.replace(model_c, latent_flow_arch=ranks.TINY_MAF["latent_flow_arch"])
    twin_c = dataclasses.replace(model_c, run_name="twin")
    tp = _tp_train(tmp_path, model_c, train_c, corpus)
    ranks.spawn(ranks.rank_twin_train, 1, (str(tmp_path / "twin.pt"), twin_c, train_c, corpus))
    twin = torch.load(tmp_path / "twin.pt")
    assert tp["tp_grid"] == [1, 2] and tp["tp_kernels_sharded"] >= 8
    scalars = [k for k in twin if k.endswith(("/Train", "/Valid"))]
    assert len(scalars) >= 10
    for k in scalars:
        assert tp[k] == twin[k], k
    a, b = (load_checkpoint(c, 1)["state"] for c in (model_c, twin_c))
    assert a["model"].keys() == b["model"].keys()
    for k, t in b["model"].items():
        assert torch.equal(a["model"][k], t), k
    for i, st in b["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a["optimizer"]["state"][i][k], st[k]), (i, k)
    assert torch.equal(a["generator"], b["generator"]) and a["step"] == b["step"]


@pytest.mark.parametrize("world, fields, name", [
    (3, {"model_parallel_devices": 2}, "model_parallel_devices"),
    (6, {"model_parallel_devices": 2, "minibatch_size": 8}, "minibatch_size"),
    (4, {"model_parallel_devices": 2, "data_parallel_devices": 3}, "data_parallel_devices"),
])
def test_a_grid_the_world_cannot_hold_raises(world, fields, name):
    train_c = cfg.TrainConfig(**fields)
    with pytest.raises(ValueError, match=name):
        loop.check_parallel_fields(train_c, world)
    assert loop.check_parallel_fields(cfg.TrainConfig(model_parallel_devices=2,
                                                      minibatch_size=160), 4) == (2, 2)
