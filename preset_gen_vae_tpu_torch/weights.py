"""The JAX package's flax variables dict -> the port's ``state_dict``.

The port's modules carry the flax module names, so a torch module path is
the flax path with the module lists ``layers.N`` and ``bns.N`` (a MAF
layer's BatchNorms) read as ``layers_N`` and ``bns_N``. Each leaf changes
layout by the rules of ``tests/_torch_twin.py:41-86`` (copied here, not
imported):

- Dense kernel (in, out) -> Linear weight (out, in)            ``dense_T``
  (MaskedDense too: its full, unmasked kernel is the parameter)
- Conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw)
                                                                ``conv_OIHW``
- TorchConvTranspose2d kernel (kh, kw, in, out) -> ConvTranspose2d weight
  (in, out, kh, kw)                                             ``tconv_IOHW``
- BatchNorm scale/bias (params) and mean/var (batch_stats) -> weight/bias
  and running_mean/running_var; BatchNormFlow log_gamma/beta likewise.

Inputs are plain numpy arrays (``jax.device_get`` of the variables). A
model under tensor parallelism (``parallel/sharding_rules.py``) takes each
sharded layer's slice of the full leaf (``ShardedLinear.local``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from .models.flows import BatchNormFlow, MaskedDense
from .models.layers import BatchNorm, ShardedLinear
from .parallel.sharding_rules import COLUMN

# torch attribute -> (flax collection, flax leaf, layout transform)
_LEAVES = {
    nn.Linear: {"weight": ("params", "kernel", "dense_T"), "bias": ("params", "bias", None)},
    MaskedDense: {"weight": ("params", "kernel", "dense_T"), "bias": ("params", "bias", None)},
    ShardedLinear: {"weight": ("params", "kernel", "dense_T"), "bias": ("params", "bias", None)},
    nn.Conv2d: {"weight": ("params", "kernel", "conv_OIHW"), "bias": ("params", "bias", None)},
    nn.ConvTranspose2d: {"weight": ("params", "kernel", "tconv_IOHW"),
                         "bias": ("params", "bias", None)},
    BatchNorm: {"weight": ("params", "scale", None), "bias": ("params", "bias", None),
                "running_mean": ("batch_stats", "mean", None),
                "running_var": ("batch_stats", "var", None)},
    BatchNormFlow: {"log_gamma": ("params", "log_gamma", None),
                    "beta": ("params", "beta", None),
                    "running_mean": ("batch_stats", "mean", None),
                    "running_var": ("batch_stats", "var", None)},
}


def to_torch_layout(leaf: np.ndarray, transform) -> np.ndarray:
    a = np.asarray(leaf, dtype=np.float32)
    if transform == "dense_T":
        return a.T
    if transform == "conv_OIHW":
        return np.transpose(a, (3, 2, 0, 1))
    if transform == "tconv_IOHW":
        return np.transpose(a, (2, 3, 0, 1))
    return a


_MODULE_LISTS = ("layers", "bns")


def flax_path(module_name: str) -> Tuple[str, ...]:
    """'ae_model.flow.flow.layers.1.bns.0' ->
    ('ae_model', 'flow', 'flow', 'layers_1', 'bns_0')."""
    out, parts = [], module_name.split(".") if module_name else []
    i = 0
    while i < len(parts):
        if parts[i] in _MODULE_LISTS and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{parts[i]}_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return tuple(out)


def flax_leaves(model: nn.Module) -> Iterator[Tuple[str, str, Tuple[str, ...], str]]:
    """(torch state_dict key, flax collection, flax path, transform) for every
    parameter and running statistic of ``model``."""
    for name, mod in model.named_modules():
        rules = _LEAVES.get(type(mod))
        if rules is None:
            continue
        for attr, (coll, leaf, tf) in rules.items():
            if getattr(mod, attr, None) is None:
                continue
            yield (f"{name}.{attr}" if name else attr), coll, flax_path(name) + (leaf,), tf


def lookup(tree: Dict, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def state_dict_from_flax(model: nn.Module, variables: Dict) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` for ``model`` holding the flax ``variables``; a
    sharded layer's entries are its slices of the full leaves."""
    sd = {}
    for key, coll, path, tf in flax_leaves(model):
        t = torch.from_numpy(np.array(to_torch_layout(lookup(variables[coll], path), tf),
                                      order="C"))
        name, _, attr = key.rpartition(".")
        mod = model.get_submodule(name)
        if isinstance(mod, ShardedLinear) and (attr == "weight" or mod.dim == COLUMN):
            t = mod.local(t, mod.dim).contiguous()
        sd[key] = t
    return sd


def from_torch_layout(t: torch.Tensor, transform) -> np.ndarray:
    a = t.detach().cpu().float().numpy()
    if transform == "dense_T":
        return np.ascontiguousarray(a.T)
    if transform == "conv_OIHW":
        return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))
    if transform == "tconv_IOHW":
        return np.ascontiguousarray(np.transpose(a, (2, 3, 0, 1)))
    return a.copy()


def flax_variables_from_model(model: nn.Module) -> Dict:
    """The inverse map: ``{'params': ..., 'batch_stats': ...}`` nested dicts
    of numpy arrays holding ``model``'s weights in the flax layout; raises
    for a model with sharded layers, whose full weights are on several
    processes (``sharding_rules.layout_free_state`` gathers them)."""
    if any(isinstance(m, ShardedLinear) for m in model.modules()):
        raise ValueError("flax_variables_from_model needs the full model; this one is sharded "
                         "(model_parallel_devices > 1)")
    sd, out = model.state_dict(), {"params": {}, "batch_stats": {}}
    for key, coll, path, tf in flax_leaves(model):
        node = out[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = from_torch_layout(sd[key], tf)
    return out


def load_flax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Loads every leaf; raises if the two trees do not match."""
    model.load_state_dict(state_dict_from_flax(model, variables), strict=True)
    return model
