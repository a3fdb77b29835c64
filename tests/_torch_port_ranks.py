"""Process bodies of the port's multi-process tests. Processes spawned by
``torch.multiprocessing`` import their function by name, so it lives in
this importable module; ``tests/test_torch_port_multihost.py`` and
``tests/test_torch_port_tensor_parallel.py`` run them.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data.dexed_spec import build_dexed_preset_spec
from preset_gen_vae_tpu_torch.data.preset import PresetIndexesHelper
from preset_gen_vae_tpu_torch.models.build import build_extended_ae_model
from preset_gen_vae_tpu_torch import weights
from preset_gen_vae_tpu_torch.parallel import multihost, sharding_rules
from preset_gen_vae_tpu_torch.synth import dexed_params as dx
from preset_gen_vae_tpu_torch.training.train_step import Criteria, make_optimizer, train_step

H, W = 257, 347


# the tiny model of the loop tests (tests/_torch_port_fixtures.py:tiny_configs)
TINY = {"latent_flow_arch": None, "params_regression_architecture": "mlp_2l64", "dim_z": 16}
# the tensor-parallel tests' tp_min_elements: every kernel of the tiny model
# but the smallest is sharded, its head's last one (64 -> 610) by rows at 4
TP_MIN_ELEMENTS = 1 << 10
# the tiny model with a MAF latent flow, whose MaskedDense kernels (16 -> 64,
# 64 -> 64, 64 -> 32) the tensor-parallel tests shard with their masks
TINY_MAF = dict(TINY, latent_flow_arch="maf_2l64")


def flagship_batch(batch: int, seed: int = 3, **model_kw):
    """The flagship's configs (float32; ``model_kw`` over its ModelConfig,
    e.g. ``TINY``) and a seeded batch of ``batch`` rows (x, v, info) in
    numpy. Rows 0-2 have operators 1-3 silent, so the categorical loss's
    useful items differ between the first rows and the others."""
    helper = PresetIndexesHelper(build_dexed_preset_spec())
    L = helper.learnable_preset_size
    model_c, train_c = cfg.resolve(cfg.ModelConfig(**model_kw),
                                   cfg.TrainConfig(minibatch_size=batch, compute_dtype="float32"))
    flow_head = model_c.params_regression_architecture.startswith("flow_")
    model_c = dataclasses.replace(model_c, synth_params_count=L,
                                  learnable_params_tensor_length=L,
                                  dim_z=L if flow_head else model_c.dim_z,
                                  input_tensor_size=(batch, 1, H, W))
    rng = np.random.default_rng(seed)
    full = rng.random((batch, helper.full_preset_size)).astype(np.float32)
    full[:3, dx.operator_volume_indexes()[:3]] = 0.0
    x = (rng.standard_normal((batch, 1, H, W)) * 0.3).astype(np.float32)
    info = np.array([[i, 60, 85] for i in range(batch)], dtype=np.int32)
    return model_c, train_c, helper, x, helper.full_to_learnable_batch(full), info


def one_step(model_c, train_c, helper, x, v, info, dtype=torch.float64, grid=None) -> dict:
    """One train step on the CPU, in ``dtype``, of the model built from
    seed 0 (under a ``grid``, sharded at ``TP_MIN_ELEMENTS``), with dropout
    and the reparameterisation noise drawn from a generator seeded 11;
    -> the total loss (averaged over the data group), every gradient (a
    shard's gathered), every running statistic and the generator's state
    after the step."""
    model = build_extended_ae_model(model_c, train_c, helper, seed=0).to(dtype)
    if grid is not None:
        sharding_rules.shard_model(model, grid, TP_MIN_ELEMENTS)
    generator = torch.Generator().manual_seed(11)
    x, v = torch.from_numpy(x).to(dtype), torch.from_numpy(v).to(dtype)
    m = train_step(model, make_optimizer(model, train_c), Criteria(model_c, train_c, helper),
                   train_c, x, v, torch.from_numpy(info), 0.2, generator)
    loss = m["TotalLoss"].reshape(1).clone()
    multihost.all_reduce_mean_([loss])
    return {"loss": loss,
            "grads": sharding_rules.full_gradients(model),
            "stats": {k: b for k, b in model.named_buffers()
                      if k.endswith(("running_mean", "running_var"))},
            "generator": generator.get_state()}


def rank_step(rank: int, world: int, store: str, out: str, batch: int, remat=(False,)):
    """Process ``rank`` of ``world`` under gloo: ``one_step`` on its
    ``batch // world`` rows of ``flagship_batch(batch)``, saved to
    ``<out>/rank<rank>.pt``; for each True in ``remat`` also the step with
    ``TrainConfig.remat``, saved to ``<out>/rank<rank>_remat.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        model_c, train_c, helper, x, v, info = flagship_batch(batch)
        b = batch // world
        rows = slice(rank * b, (rank + 1) * b)
        for on in remat:
            train_c = dataclasses.replace(train_c, minibatch_size=b, remat=on)
            torch.save(one_step(model_c, train_c, helper, x[rows], v[rows], info[rows]),
                       f"{out}/rank{rank}{'_remat' if on else ''}.pt")
    finally:
        dist.destroy_process_group()


def rank_tp(rank: int, world: int, store: str, out: str, batch: int, n_data: int, n_model: int,
            variables=None, model_kw=TINY):
    """Process ``rank`` of a (``n_data``, ``n_model``) grid under gloo: the
    tiny model's (``model_kw``) ``one_step`` in float64 on its data rank's
    ``batch // n_data`` rows of ``flagship_batch(batch, **model_kw)``, saved to
    ``<out>/rank<rank>.pt``; with flax ``variables`` (numpy), also the
    eval-mode ``forward_full`` of the sharded model carrying them, in
    float32, on all ``batch`` rows, saved to ``<out>/forward<rank>.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        grid = sharding_rules.make_2d_grid(n_data, n_model)
        model_c, train_c, helper, x, v, info = flagship_batch(batch, **model_kw)
        b = batch // n_data
        rows = slice(grid.data_rank * b, (grid.data_rank + 1) * b)
        with sharding_rules.grid_scope(grid):
            step_c = dataclasses.replace(train_c, minibatch_size=b)
            torch.save(one_step(model_c, step_c, helper, x[rows], v[rows], info[rows], grid=grid),
                       f"{out}/rank{rank}.pt")
            if variables is not None:
                model = build_extended_ae_model(model_c, train_c, helper, seed=5)
                sharding_rules.shard_model(model, grid, TP_MIN_ELEMENTS)
                weights.load_flax_variables(model, variables).eval()
                with torch.no_grad():
                    outs = model.forward_full(torch.from_numpy(x), torch.from_numpy(info))
                torch.save(outs, f"{out}/forward{rank}.pt")
    finally:
        dist.destroy_process_group()


def rank_train(rank: int, world: int, store: str, out: str, n_model: int, model_c, train_c,
               dataset_kwargs):
    """Process ``rank`` of ``world`` under gloo: ``train_config`` on the CPU
    with ``model_parallel_devices = n_model``; rank 0 saves the summary to
    ``out``."""
    from preset_gen_vae_tpu_torch.training.loop import train_config

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        summary = train_config(model_c, dataclasses.replace(train_c, model_parallel_devices=n_model),
                               device="cpu", use_tensorboard=False, dataset_kwargs=dataset_kwargs)
        if rank == 0:
            torch.save(summary, out)
    finally:
        dist.destroy_process_group()


def rank_twin_train(rank: int, world: int, out: str, model_c, train_c, dataset_kwargs):
    """One process, one thread, no process group: ``train_config`` on the
    CPU of the column twin of a (1, 2) grid (``chip_smoke.column_twin``:
    each sharded Linear computed in halves, as the grid computes it), its
    steps eager as the grid's (``force_multihost_data``); saves the summary
    to ``out``."""
    import chip_smoke
    from preset_gen_vae_tpu_torch.training.loop import train_config

    torch.set_num_threads(1)
    with chip_smoke.column_twin_builds(train_c.tp_min_elements):
        summary = train_config(model_c, dataclasses.replace(train_c, force_multihost_data=True),
                               device="cpu", use_tensorboard=False, dataset_kwargs=dataset_kwargs)
    torch.save(summary, out)


def spawn(target, world: int, args, timeout: float = 240.0) -> None:
    """Runs ``target(rank, world, *args)`` in ``world`` spawned processes;
    fails unless every one exits 0 within ``timeout`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, *args)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=timeout)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        p.kill()
    assert not hung, f"ranks {hung} did not finish in {timeout} s"
    assert [p.exitcode for p in procs] == [0] * world, [p.exitcode for p in procs]
