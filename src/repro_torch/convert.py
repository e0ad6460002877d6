"""Carry state across the two packages as numpy arrays.

`state_from_numpy` takes the 7 leaves of a `DPMRState` (the JAX
package's or this one's, in field order: cold, hot, hot_ids, cold_acc,
hot_acc, step, strat) as numpy arrays, in the reference's global layout,
and builds the port's state on `device`: on rank r of a mesh, its blocks
of the sharded leaves (cold, cold_acc and strat, cut in P equal blocks
along their only axis, as the reference's shardings cut them) and the
replicated ones whole. `state_to_numpy` goes the other way, gathering the
blocks of every rank. The same state then gives the same steps in both
packages, up to f32 rounding.

`params_from_numpy` takes the reference's dense params pytree as nested
dicts of numpy arrays (layers stacked on a leading axis, as
`repro.sharding.init_from_defs` makes them) and builds the port's
`Transformer` on `device`; `params_to_numpy` goes the other way. Matrices
are cast to `cfg.dtype` on the way in, as the reference casts them at
every use, so the round trip is exact when `cfg.dtype` is float32 and
rounds the matrices to `cfg.dtype` otherwise.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dpmr import DPMRState, num_shards
from repro_torch.launch.mesh import mesh_rank
from repro_torch.models import transformer

_DTYPES = (np.float32, np.float32, np.int32, np.float32, np.float32,
           np.int32, np.float32)
_SHARDED = ("cold", "cold_acc", "strat")   # cut in P blocks over the mesh


def state_from_numpy(leaves: Sequence, device, mesh=None) -> DPMRState:
    """This rank's DPMRState from 7 global numpy leaves in field order
    (copied)."""
    if len(leaves) != len(DPMRState._fields):
        raise ValueError(f"expected {len(DPMRState._fields)} leaves "
                         f"{DPMRState._fields}, got {len(leaves)}")
    p, r = num_shards(mesh), mesh_rank(mesh)
    out = []
    for name, leaf, dt in zip(DPMRState._fields, leaves, _DTYPES,
                              strict=True):
        leaf = np.asarray(leaf, dtype=dt)
        if name in _SHARDED:
            if leaf.shape[0] % p:
                raise ValueError(f"{name}: {leaf.shape[0]} rows do not "
                                 f"split over {p} ranks")
            n = leaf.shape[0] // p
            leaf = leaf[r * n:(r + 1) * n]
        out.append(torch.tensor(leaf, device=device))
    return DPMRState(*out)


def state_to_numpy(state: DPMRState, mesh=None) -> tuple[np.ndarray, ...]:
    """The 7 leaves of `state` as host numpy arrays (copies) in the
    reference's global layout, in field order; on a mesh, an all_gather of
    every rank's blocks (every rank must call it)."""
    out = []
    for name, t in zip(DPMRState._fields, state, strict=True):
        if name in _SHARDED and mesh is not None:
            whole = t.new_empty((num_shards(mesh) * t.shape[0],))
            dist.all_gather_into_tensor(whole, t.contiguous())
            t = whole
        # a copy: a CPU tensor's .numpy() would share its memory, and the
        # next step updates the state in place
        out.append(t.detach().to("cpu", copy=True).numpy())
    return tuple(out)


def _pairs(model: transformer.Transformer):
    """(path in the reference's tree, layer index or None, parameter)."""
    for i, layer in enumerate(model.layers):
        for name, param in layer.named_parameters():
            yield ("layers", *name.split(".")), i, param
    for name, param in model.named_parameters(recurse=False):
        yield (name,), None, param


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device) -> transformer.Transformer:
    """The port's model from the reference's params tree (copied)."""
    defs = transformer.transformer_defs(cfg)
    model = transformer.Transformer(cfg, device=device)
    with torch.no_grad():
        for path, i, param in _pairs(model):
            leaf = np.asarray(_get(tree, path), dtype=np.float32)
            if leaf.shape != _get(defs, path):
                raise ValueError(f"{'/'.join(path)}: shape {leaf.shape}, "
                                 f"{cfg.name} needs {_get(defs, path)}")
            param.copy_(torch.tensor(leaf if i is None else leaf[i]))
    return model


def params_to_numpy(model: transformer.Transformer) -> dict:
    """The model's parameters as the reference's tree of f32 numpy arrays,
    layers stacked on a leading axis."""
    tree: dict = {}
    per_layer: dict = {}
    for path, i, param in _pairs(model):
        arr = param.detach().to(torch.float32).cpu().numpy()
        if i is None:
            tree[path[0]] = arr
        else:
            per_layer.setdefault(path, []).append(arr)
    for path, arrs in per_layer.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(arrs)
    return tree
