"""Carry state across the two packages as numpy arrays.

`state_from_numpy` takes the 7 leaves of a `DPMRState` (the JAX
package's or this one's, in field order: cold, hot, hot_ids, cold_acc,
hot_acc, step, strat) as numpy arrays and builds the port's state on
`device`; `state_to_numpy` goes the other way. The same state then gives
the same steps in both packages, up to f32 rounding.

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

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dpmr import DPMRState
from repro_torch.models import transformer

_DTYPES = (np.float32, np.float32, np.int32, np.float32, np.float32,
           np.int32, np.float32)


def state_from_numpy(leaves: Sequence, device) -> DPMRState:
    """The port's DPMRState from 7 numpy leaves in field order (copied)."""
    if len(leaves) != len(DPMRState._fields):
        raise ValueError(f"expected {len(DPMRState._fields)} leaves "
                         f"{DPMRState._fields}, got {len(leaves)}")
    return DPMRState(*(
        torch.tensor(np.asarray(leaf, dtype=dt), device=device)
        for leaf, dt in zip(leaves, _DTYPES, strict=True)))


def state_to_numpy(state: DPMRState) -> tuple[np.ndarray, ...]:
    """The 7 leaves of `state` as host numpy arrays, in field order."""
    return tuple(t.detach().cpu().numpy() for t in state)


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
