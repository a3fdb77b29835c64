"""Tensor parallelism: the (data, model) grid of processes and the rule that
shards the large dense layers over its ``model`` axis.

Counterpart: ``preset_gen_vae_tpu/parallel/sharding_rules.py:1-70`` and the
2-D part of ``parallel/mesh.py`` there, driven by ``training/loop.py:155-190``
there. The JAX package reshapes its devices into a ``(data, model)`` mesh
and lets GSPMD place the collectives; here the world of N processes, one a
card, becomes a grid of ``n_data x n_model``: process ``rank`` sits at
``divmod(rank, n_model)`` = (data rank, model rank). The processes of one
data rank (a *model group*) see the same rows and hold the shards of one
model; the processes of one model rank (a *data group*) see different rows
and average their gradients and their batch statistics
(``parallel/multihost.py``).

The rule is the JAX package's, size-driven: a 2-D kernel with at least
``min_elements`` entries is sharded over the model axis by its output
features ("column") when they divide ``n_model``, else by its input
features ("row") when those do; everything else is replicated. It is read
in the flax orientation: a flax ``Dense`` kernel is ``(in, out)`` and a
torch ``Linear.weight`` is ``(out, in)``, so a column split cuts the
weight's dim 0 and a row split its dim 1. ``shard_model`` replaces each
such ``nn.Linear`` (``flows.MaskedDense`` too) of a built model by a
``models.layers.ShardedLinear`` that keeps its slice; Adam's moments of a
shard are shards as well, since the optimizer is made over the sharded
parameters.

The grid a process trains on is active inside ``grid_scope``; the
collectives of ``parallel/multihost.py`` then run over its data group, and
without an active grid over the whole world. ``layout_free_state`` gathers
a sharded model's weights and Adam moments back into the full tensors
(a checkpoint is layout-free: it resumes under any grid, or in one
process), and ``shard_optimizer_state`` takes a process's shards of such a
state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

COLUMN, ROW = 0, 1  # the torch weight's dim that a shard cuts


@dataclasses.dataclass(frozen=True)
class Grid:
    """This process's place in the (data, model) grid and its two groups."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object


def grid_shape(world: int, minibatch_size: int, model_parallel_devices: int,
               data_parallel_devices: int = -1) -> Tuple[int, int]:
    """(n_data, n_model) for a world of ``world`` processes, sized as the
    JAX loop sizes its mesh (loop.py:155-183 there): ``n_model =
    model_parallel_devices``, ``n_data = gcd(minibatch_size, world //
    n_model)``. Raises, naming the field, unless the grid holds exactly the
    world's processes."""
    n_model = max(1, int(model_parallel_devices))
    if world % n_model:
        raise ValueError(f"model_parallel_devices={n_model} does not divide the world of "
                         f"{world} process(es): launch a multiple of {n_model} processes "
                         f"(torchrun --nproc_per_node)")
    n_avail = world // n_model
    if data_parallel_devices > 1 and data_parallel_devices != n_avail:
        raise ValueError(f"data_parallel_devices={data_parallel_devices} in a world of {world} "
                         f"process(es) with model_parallel_devices={n_model}: the port trains "
                         f"one process a card; launch them with torchrun "
                         f"--nproc_per_node={data_parallel_devices * n_model}")
    n_data = math.gcd(minibatch_size, n_avail)
    if n_data * n_model != world:
        raise ValueError(f"minibatch_size={minibatch_size} with model_parallel_devices="
                         f"{n_model}: the grid ({n_data} data x {n_model} model) would leave "
                         f"{world - n_data * n_model} of {world} processes idle")
    return n_data, n_model


def make_2d_grid(n_data: int, n_model: int) -> Grid:
    """This process's ``Grid`` in a world of exactly ``n_data * n_model``
    processes, with its data group (the processes of its model rank) and
    its model group (those of its data rank). Every process of the world
    calls it, since each group is made by all of them."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"model_parallel_devices={n_model} needs a process group "
                         "(torchrun, or parallel.multihost.initialize_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_model != world:
        raise ValueError(f"the grid ({n_data} data x {n_model} model) does not hold the world "
                         f"of {world} process(es): model_parallel_devices={n_model}")
    data_rank, model_rank = divmod(rank, n_model)
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if m == model_rank:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == data_rank:
            model_group = g
    return Grid(n_data, n_model, data_rank, model_rank, data_group, model_group)


_ACTIVE: List[Optional[Grid]] = [None]


def active_grid() -> Optional[Grid]:
    """The grid of the innermost ``grid_scope``, or None."""
    return _ACTIVE[-1]


@contextlib.contextmanager
def grid_scope(grid: Optional[Grid]):
    """Makes ``grid`` the active grid inside the block (None: the whole
    world is one data group)."""
    _ACTIVE.append(grid)
    try:
        yield grid
    finally:
        _ACTIVE.pop()


def param_spec(weight: torch.Tensor, n_model: int, min_elements: int = 1 << 18) -> Optional[int]:
    """The JAX rule (sharding_rules.py:37-48 there) for one parameter, read
    in the flax orientation: ``COLUMN`` (shard the torch weight's dim 0,
    the flax kernel's output features), ``ROW`` (dim 1, its input
    features) or None (replicated)."""
    if n_model <= 1 or weight.dim() != 2 or weight.numel() < min_elements:
        return None
    d_out, d_in = weight.shape
    if d_out % n_model == 0:
        return COLUMN
    if d_in % n_model == 0:
        return ROW
    return None


def shard_plan(model: nn.Module, n_model: int, min_elements: int = 1 << 18) -> Dict[str, int]:
    """Module name -> the dim its weight is sharded on, for every
    ``nn.Linear`` the rule shards. Raises for any other 2-D parameter the
    rule would shard: the port has no sharded layer for it."""
    plan = {}
    for name, mod in model.named_modules():
        for attr, p in mod.named_parameters(recurse=False):
            spec = param_spec(p, n_model, min_elements)
            if spec is None:
                continue
            if not (isinstance(mod, nn.Linear) and attr == "weight"):
                raise NotImplementedError(f"{name}.{attr} {tuple(p.shape)} would be sharded "
                                          f"at model_parallel_devices={n_model}, but it is not "
                                          "a Linear weight")
            plan[name] = spec
    return plan


def count_sharded(model: nn.Module, n_model: int,
                  min_elements: int = 1 << 18) -> Tuple[int, int, int]:
    """(sharded parameters, their elements, all parameters' elements) of an
    unsharded model, as the JAX function counts its params tree."""
    n = se = te = 0
    for p in model.parameters():
        te += p.numel()
        if param_spec(p, n_model, min_elements) is not None:
            n, se = n + 1, se + p.numel()
    return n, se, te


def shard_model(model: nn.Module, grid: Grid, min_elements: int = 1 << 18) -> Dict[str, int]:
    """Replaces every ``nn.Linear`` that ``shard_plan`` names by a
    ``ShardedLinear`` holding this process's slice, in place, at the same
    attribute (so the parameters keep their names and their order);
    -> the plan."""
    from ..models.layers import ShardedLinear

    plan = shard_plan(model, grid.n_model, min_elements)
    for name, dim in plan.items():
        parent, _, attr = name.rpartition(".")
        owner = model.get_submodule(parent) if parent else model
        setattr(owner, attr, ShardedLinear(getattr(owner, attr), dim, grid))
    return plan


def sharded_dims(model: nn.Module) -> List[Optional[Tuple[int, "object"]]]:
    """For each parameter of ``model`` in ``model.parameters()`` order (the
    optimizer's), (dim, its ShardedLinear) where it is a shard, else None."""
    from ..models.layers import ShardedLinear

    owner = {}
    for mod in model.modules():
        if isinstance(mod, ShardedLinear):
            owner[id(mod.weight)] = (mod.dim, mod)
            if mod.dim == COLUMN:
                owner[id(mod.bias)] = (COLUMN, mod)
    return [owner.get(id(p)) for p in model.parameters()]


def gather_shards(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The model group's shards of one tensor, concatenated along ``dim``."""
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def layout_free_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> Tuple[Dict, Dict]:
    """(model state_dict, optimizer state_dict) with every shard gathered
    into its full tensor over its model group: what one process training
    the same model would hold. Every process of the world calls it."""
    model_sd, opt_sd = model.state_dict(), optimizer.state_dict()
    dims = sharded_dims(model)
    if not any(dims):
        return model_sd, opt_sd
    names = [k for k, _ in model.named_parameters()]
    model_sd = dict(model_sd)
    state = {}
    for i, st in opt_sd["state"].items():
        st = dict(st)
        if dims[i] is not None:
            dim, mod = dims[i]
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = gather_shards(st[k], dim, mod.grid.model_group, mod.grid.n_model)
        state[i] = st
    for name, entry in zip(names, dims):
        if entry is not None:
            dim, mod = entry
            model_sd[name] = gather_shards(model_sd[name], dim, mod.grid.model_group,
                                           mod.grid.n_model)
    return model_sd, {**opt_sd, "state": state}


def full_gradients(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Parameter name -> its full gradient after ``backward()``, a shard's
    gathered over its model group (every process of the world calls it)."""
    out = {}
    for (name, p), entry in zip(model.named_parameters(), sharded_dims(model)):
        g = p.grad
        if entry is not None and g is not None:
            dim, mod = entry
            g = gather_shards(g, dim, mod.grid.model_group, mod.grid.n_model)
        out[name] = g
    return out


def shard_optimizer_state(state: Dict, model: nn.Module) -> Dict:
    """A layout-free optimizer state_dict with each sharded parameter's
    moments cut to this process's shard of ``model``."""
    dims = sharded_dims(model)
    if not any(dims):
        return state
    out = {}
    for i, st in state["state"].items():
        st = dict(st)
        if dims[i] is not None:
            dim, mod = dims[i]
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = mod.local(st[k], dim).clone()
        out[i] = st
    return {**state, "state": out}
