"""Process bodies of the port's multi-process tests. Processes spawned by
``torch.multiprocessing`` import their function by name, so it lives in
this importable module; ``tests/test_torch_port_multihost.py`` runs them.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data.dexed_spec import build_dexed_preset_spec
from preset_gen_vae_tpu_torch.data.preset import PresetIndexesHelper
from preset_gen_vae_tpu_torch.models.build import build_extended_ae_model
from preset_gen_vae_tpu_torch.parallel import multihost
from preset_gen_vae_tpu_torch.synth import dexed_params as dx
from preset_gen_vae_tpu_torch.training.train_step import Criteria, make_optimizer, train_step

H, W = 257, 347


def flagship_batch(batch: int, seed: int = 3):
    """The flagship's configs (float32) and a seeded batch of ``batch``
    rows (x, v, info) in numpy. Rows 0-2 have operators 1-3 silent, so the
    categorical loss's useful items differ between the first rows and the
    others."""
    helper = PresetIndexesHelper(build_dexed_preset_spec())
    L = helper.learnable_preset_size
    model_c, train_c = cfg.resolve(cfg.ModelConfig(),
                                   cfg.TrainConfig(minibatch_size=batch, compute_dtype="float32"))
    model_c = dataclasses.replace(model_c, synth_params_count=L,
                                  learnable_params_tensor_length=L, dim_z=L,
                                  input_tensor_size=(batch, 1, H, W))
    rng = np.random.default_rng(seed)
    full = rng.random((batch, helper.full_preset_size)).astype(np.float32)
    full[:3, dx.operator_volume_indexes()[:3]] = 0.0
    x = (rng.standard_normal((batch, 1, H, W)) * 0.3).astype(np.float32)
    info = np.array([[i, 60, 85] for i in range(batch)], dtype=np.int32)
    return model_c, train_c, helper, x, helper.full_to_learnable_batch(full), info


def one_step(model_c, train_c, helper, x, v, info, dtype=torch.float64) -> dict:
    """One train step on the CPU, in ``dtype``, of the flagship built from
    seed 0, with dropout and the reparameterisation noise drawn from a
    generator seeded 11; -> the total loss (averaged over the processes of
    a group), every gradient, every running statistic and the generator's
    state after the step."""
    model = build_extended_ae_model(model_c, train_c, helper, seed=0).to(dtype)
    generator = torch.Generator().manual_seed(11)
    x, v = torch.from_numpy(x).to(dtype), torch.from_numpy(v).to(dtype)
    m = train_step(model, make_optimizer(model, train_c), Criteria(model_c, train_c, helper),
                   train_c, x, v, torch.from_numpy(info), 0.2, generator)
    loss = m["TotalLoss"].reshape(1).clone()
    multihost.all_reduce_mean_([loss])
    return {"loss": loss,
            "grads": {k: p.grad for k, p in model.named_parameters()},
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
