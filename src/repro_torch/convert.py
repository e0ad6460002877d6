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

`params_from_numpy` takes the reference's params pytree of any family
as nested dicts (and, for xlstm's blocks, a tuple) of numpy arrays
(layers stacked on a leading axis, as `repro.sharding.init_from_defs`
makes them: the decoder's `layers`, zamba2's mamba `layers` beside its
one `shared` block, whisper's `encoder` and `layers`) and builds the
port's model of that family on `device`; `params_to_numpy` goes the
other way. For
serving, matrices are cast to `cfg.dtype` on the way in, as the reference
casts them at every use, so the round trip is exact when `cfg.dtype` is
float32 and rounds the matrices to `cfg.dtype` otherwise; a model for
training (`train=True`) keeps `cfg.param_dtype` and the round trip is
exact.

`train_state_from_numpy` and `train_state_to_numpy` carry the dense
trainer's state, the reference's tree `{"params", "opt", "step"}`: the
params as above, the optimizer's moments in trees of the params' shape
(adam's `m` and `v`, momentum's `mu`) beside adam's `count`, and the
step. `train_state_tree` is that tree over the live tensors (a stacked
leaf as the list of its layers' tensors), and `tree_leaves` walks a tree
in the reference's leaf order (`jax.tree.flatten` sorts dict keys and
keeps a tuple's order), which is how `ckpt.checkpointer` writes a dense
checkpoint.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dpmr import DPMRState, num_shards
from repro_torch.launch.mesh import mesh_rank
from repro_torch.models import registry
from repro_torch.runtime.multiprocess import host_value

_DTYPES = (np.float32, np.float32, np.int32, np.float32, np.float32,
           np.int32, np.float32)
SHARDED = ("cold", "cold_acc", "strat")   # cut in P blocks over the mesh


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
        if name in SHARDED:
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
    return tuple(host_value(t, mesh if name in SHARDED else None)
                 for name, t in zip(DPMRState._fields, state, strict=True))


def _pairs(model):
    """(name in `named_parameters`, path in the reference's tree, layer
    index or None) of every parameter. A layer of a stack (`model.STACKS`:
    the reference stacks its leaves on a leading axis) gives its index; a
    block of xlstm's tuple of blocks gives the path (blocks, i, its kind,
    ...)."""
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] in model.STACKS:
            yield name, (parts[0], *parts[2:]), int(parts[1])
        elif parts[0] == "blocks":
            i = int(parts[1])
            yield name, ("blocks", i, model.blocks[i].kind, *parts[2:]), \
                None
        else:
            yield name, tuple(parts), None


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _fill(model, tree: dict, values: dict, cfg: ModelConfig) -> None:
    """Copy the reference-shaped numpy `tree` into `values` (name ->
    tensor of `model`'s parameter names), checking every shape."""
    defs = model.defs(cfg)
    with torch.no_grad():
        for name, path, i in _pairs(model):
            leaf = np.asarray(_get(tree, path), dtype=np.float32)
            if leaf.shape != _get(defs, path):
                keys = "/".join(map(str, path))
                raise ValueError(f"{keys}: shape {leaf.shape}, "
                                 f"{cfg.name} needs {_get(defs, path)}")
            values[name].copy_(torch.tensor(leaf if i is None else leaf[i]))


def params_from_numpy(tree: dict, cfg: ModelConfig, device,
                      train: bool = False):
    """The port's model of `cfg`'s family from the reference's params
    tree (copied), for serving or, with `train=True`, for training."""
    model = registry.model_class(cfg)(cfg, device=device, train=train)
    _fill(model, tree, dict(model.named_parameters()), cfg)
    return model


def params_tree(model, values: dict | None = None) -> dict:
    """The reference's params tree over live tensors: `values` (name ->
    tensor, default the model's parameters) at their paths, a stacked
    leaf as the list of its layers' tensors in layer order, xlstm's
    blocks as a tuple."""
    values = dict(model.named_parameters()) if values is None else values
    tree: dict = {}
    for name, path, i in _pairs(model):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if i is None:
            node[path[-1]] = values[name]
        else:
            node.setdefault(path[-1], []).append(values[name])
    if "blocks" in tree:
        tree["blocks"] = tuple(tree["blocks"][i]
                               for i in range(len(tree["blocks"])))
    return tree


def _to_numpy(leaf, dtype=None) -> np.ndarray:
    """A tensor, or a list of them stacked, as a host array of its own
    (a copy, also of a CPU tensor), cast to `dtype` if given."""
    if isinstance(leaf, list):
        return np.stack([_to_numpy(t, dtype) for t in leaf])
    return leaf.detach().to("cpu", dtype or leaf.dtype, copy=True).numpy()


def _map(tree, fn):
    """`fn` on every leaf of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(v, fn) for v in tree)
    return fn(tree)


def params_to_numpy(model, values: dict | None = None) -> dict:
    """The model's parameters (or `values`, name -> tensor) as the
    reference's tree of f32 numpy arrays, layers stacked on a leading
    axis."""
    return _map(params_tree(model, values),
                lambda leaf: _to_numpy(leaf, torch.float32))


def train_state_tree(state: dict) -> dict:
    """The trainer's state as the reference's tree over its live tensors
    (`params_tree` for the params and each moment)."""
    model = state["params"]
    opt = {k: params_tree(model, v) if isinstance(v, dict) else v
           for k, v in state["opt"].items()}
    return {"params": params_tree(model), "opt": opt, "step": state["step"]}


def tree_leaves(tree, prefix: tuple = ()):
    """(path, leaf) in `jax.tree.flatten`'s order: dict keys sorted at
    every level, a tuple's items in order (their indices in the path). A
    list is a leaf (a stacked leaf's layers)."""
    items = enumerate(tree) if isinstance(tree, tuple) else \
        ((key, tree[key]) for key in sorted(tree))
    for key, node in items:
        if isinstance(node, (dict, tuple)):
            yield from tree_leaves(node, (*prefix, key))
        else:
            yield (*prefix, key), node


def train_state_to_numpy(state: dict) -> dict:
    """The trainer's state as the reference's tree of numpy arrays."""
    return _map(train_state_tree(state), _to_numpy)


def train_state_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The trainer's state on `device` from the reference's tree of numpy
    arrays (copied): the params in `cfg.param_dtype`, the moments in
    `cfg.opt_dtype`, `count` and `step` 0-d int32."""
    model = params_from_numpy(tree["params"], cfg, device, train=True)
    opt = {}
    for key, node in tree["opt"].items():
        if isinstance(node, dict):
            opt[key] = {name: torch.empty(p.shape,
                                          dtype=getattr(torch, cfg.opt_dtype),
                                          device=p.device)
                        for name, p in model.named_parameters()}
            _fill(model, node, opt[key], cfg)
        else:
            opt[key] = torch.tensor(np.asarray(node), dtype=torch.int32,
                                    device=model.device)
    step = torch.tensor(np.asarray(tree["step"]), dtype=torch.int32,
                        device=model.device)
    return {"params": model, "opt": opt, "step": step}
