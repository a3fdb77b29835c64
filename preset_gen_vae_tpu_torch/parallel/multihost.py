"""Data parallelism across processes on ``torch.distributed``.

Counterpart: ``preset_gen_vae_tpu/parallel/multihost.py:31-183``. There
every host runs one SPMD program over a global mesh, feeds its local shard
of the global batch, and GSPMD reduces the gradients and the batch
statistics over the global batch (``parallel/mesh.py:11-15`` there: its
BatchNorm is sync-BN). Here each process owns one card and steps on its
local batch; the collectives below stand in for GSPMD's, so that N
processes compute what one process computes on the N local batches
concatenated:

- ``shard_loaders_for_host`` carves each split into the process's
  contiguous item range, equalised across processes by cyclic padding,
  with the batch divided by the world size and validation weights counted
  over every process's real rows (the JAX function's split, on the card);
- ``batch_moments``: BatchNorm's batch mean and biased variance over every
  process's rows, through a differentiable all-reduce;
- ``global_draw``: a random draw at the global batch shape from the
  generator every process seeds alike, of which each keeps its own rows;
- ``global_count``: a count summed over the processes (the categorical
  loss's useful items);
- ``average_gradients``: one flat all-reduce of the gradients after
  ``backward()``; the all-reduce's backward has already summed the
  cotangents of the shared statistics across the processes, so the mean of
  the processes' gradients is the gradient of the one-process loss.

Under tensor parallelism (``parallel/sharding_rules.py``) every "over the
processes" above means over the active grid's data group: the processes
of one model group see the same rows, draw the same masks and hold the
same statistics, and the loop carves the splits by data rank
(``data_rank_and_size``). Without an active grid the data group is the
whole world.

Without a process group every function here is the single-process code
path, with the same numbers. ``make_global_batch`` has no counterpart:
each process steps on its local batch.

Launch one process a card with ``torchrun --nproc_per_node=N -m
preset_gen_vae_tpu_torch.training.loop``, or call ``initialize_distributed``
in each process before ``train_config``.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .sharding_rules import active_grid


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, backend: str = "nccl") -> None:
    """Joins this process to a group of ``world_size`` processes
    (``init_method`` as ``torch.distributed.init_process_group`` takes it,
    e.g. ``tcp://host:port`` or ``env://``). A no-op for a world of one."""
    if world_size is None or world_size <= 1:
        return
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world_size() -> int:
    return rank_and_world()[1]


def data_rank_and_size() -> Tuple[int, int]:
    """(rank, size) in the data group: the active grid's, else the world's."""
    grid = active_grid()
    return (grid.data_rank, grid.n_data) if grid is not None else rank_and_world()


def data_world_size() -> int:
    return data_rank_and_size()[1]


def _data_group():
    grid = active_grid()
    return grid.data_group if grid is not None else None


def barrier() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def host_item_range(n_items: int, rank: int, world: int) -> Tuple[int, int]:
    """[start, end) of the items process ``rank`` of ``world`` owns: a
    contiguous split whose sizes differ by at most one."""
    per, extra = divmod(n_items, world)
    start = rank * per + min(rank, extra)
    return start, start + per + (1 if rank < extra else 0)


def _equalized_shard_sizes(n_items: int, n_hosts: int) -> Tuple[np.ndarray, int]:
    """(real per-host shard sizes, common padded size). Host shards from
    ``host_item_range`` can differ by 1 item; every host is cyclically
    padded up to the max so all hosts run IDENTICAL epoch batch counts —
    otherwise hosts issue different numbers of collective dispatches per
    epoch and the pod job desyncs at the epoch boundary."""
    per, extra = divmod(n_items, n_hosts)
    real = np.array(
        [per + (1 if q < extra else 0) for q in range(n_hosts)], dtype=np.int64
    )
    return real, int(real.max())


def _global_batch_weights(
    real_sizes: np.ndarray, common: int, local_bs: int, drop_last: bool
) -> np.ndarray:
    """Per-global-batch fraction of REAL rows, counting every host's shard.
    Batch i of the global batch concatenates each host's local batch i;
    padded rows (shard equalization + final-batch cyclic padding) must not
    count toward validation means."""
    if drop_last:
        n_batches = common // local_bs
    else:
        n_batches = (common + local_bs - 1) // local_bs
    w = np.empty(n_batches, dtype=np.float64)
    slots = local_bs * len(real_sizes)
    for i in range(n_batches):
        real = np.clip(real_sizes - i * local_bs, 0, local_bs).sum()
        w[i] = real / slots
    return w


def shard_loaders_for_host(loaders, rank: int, world: int, corpus_cache_policy: str = "disk",
                           force: bool = False):
    """Carves every split loader down to process ``rank``'s contiguous item
    range, cyclically padded to the size every process serves, with the
    batch divided by ``world`` and each validation batch weighted by the
    real rows of every process's local batch. The carve is a row index of
    the corpus tensors on their device. A world of one passes through
    unchanged unless ``force``. Raises for a batch that ``world`` does not
    divide, and for ``corpus_cache_policy='device'``, which the JAX
    package keeps to one host (multihost.py:139-155 there)."""
    if world <= 1 and not force:
        return loaders
    if corpus_cache_policy == "device":
        raise ValueError("corpus_cache_policy='device' cannot be carved across processes; "
                         "use corpus_cache_policy='disk' for multi-process runs")
    from ..data.pipeline import SplitLoader

    out = {}
    for name, ld in loaders.items():
        if ld.batch_size % world != 0:
            raise ValueError(f"minibatch_size {ld.batch_size} not divisible by the world "
                             f"size {world}")
        s, e = host_item_range(ld.n_items, rank, world)
        real_sizes, common = _equalized_shard_sizes(ld.n_items, world)
        local = np.resize(np.asarray(ld.item_indexes[s:e]), common)
        rows = np.unique(local)
        remap = np.full(int(rows.max()) + 1 if len(rows) else 1, -1, dtype=np.int64)
        remap[rows] = np.arange(len(rows))
        tensors = {k: t[torch.as_tensor(rows, device=t.device)] for k, t in ld.tensors.items()}
        if ld.tensors["x"].is_pinned():  # the carve of a pinned host corpus stays pinned
            tensors = {k: t.pin_memory() for k, t in tensors.items()}
        local_bs = ld.batch_size // world
        out[name] = SplitLoader(
            tensors, remap[local], batch_size=local_bs, shuffle=ld.shuffle,
            drop_last=ld.drop_last, seed=ld.seed, pad_to_full=ld.pad_to_full,
            batch_weights=_global_batch_weights(real_sizes, common, local_bs, ld.drop_last))
    return out


def batch_moments(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased variance) of ``x`` over ``dims`` and over the rows of
    every process of the data group: the sum, then the sum of squared
    deviations from the global mean, each all-reduced through
    ``torch.distributed.nn`` so that the gradient flows to every
    process's rows."""
    from torch.distributed.nn import functional as dist_nn

    group = _data_group()
    group = dist.group.WORLD if group is None else group
    n = math.prod(x.shape[d] for d in dims) * data_world_size()
    shape = [1 if d in dims else s for d, s in enumerate(x.shape)]
    mean = dist_nn.all_reduce(x.sum(dims), group=group) / n
    centred = x - mean.reshape(shape)
    var = dist_nn.all_reduce(torch.square(centred).sum(dims), group=group) / n
    return mean, var


def global_draw(draw, shape, **kwargs) -> torch.Tensor:
    """``draw(shape, **kwargs)`` (``torch.rand``, ``torch.randn``) at the
    global batch shape, (data group size) x shape[0] rows, of which this
    process keeps its own; ``draw(shape)`` itself without a data group of
    more than one. The processes of one model group draw the same rows."""
    rank, world = data_rank_and_size()
    if world <= 1:
        return draw(shape, **kwargs)
    b = shape[0]
    return draw((world * b, *shape[1:]), **kwargs)[rank * b:(rank + 1) * b]


def global_count(counts: torch.Tensor) -> torch.Tensor:
    """``counts`` summed over the data group, divided by its size: the mean
    count a process would see, whose ratio to a local sum has the mean
    over the processes that the one-process ratio has. ``counts`` itself
    without a data group of more than one."""
    world = data_world_size()
    if world <= 1:
        return counts
    counts = counts.detach().clone()
    dist.all_reduce(counts, group=_data_group())
    return counts / world


def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> None:
    """Replaces each tensor by its mean over the data group, through one
    flat all-reduce; nothing without a process group (a group of one runs
    the all-reduce, with the same numbers)."""
    tensors = list(tensors)
    if not tensors or not (dist.is_available() and dist.is_initialized()):
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=_data_group())
    flat /= data_world_size()
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def average_gradients(model: torch.nn.Module) -> None:
    """The gradients after ``backward()``, averaged over the data group when
    it holds more than one process (a group of one would only copy them);
    a shard's gradient over the processes holding the same shard."""
    if data_world_size() > 1:
        all_reduce_mean_(p.grad for p in model.parameters() if p.grad is not None)


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Every tensor takes process ``src``'s values; nothing without a group."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    for t in tensors:
        dist.broadcast(t, src)
