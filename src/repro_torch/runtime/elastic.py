"""Elastic rescaling: move a DPMR state between meshes of different rank
counts; the counterpart of `repro.runtime.elastic` (the sparse face).

The parameter table's PADDED length depends on the rank count (F rounded
up to a multiple of P), so growing or shrinking the mesh re-pads the
table before each rank takes its block; the strategy carry is per-rank
state of the old geometry and resets. `reshard_data_state` is the data
plane's case: a loader cursor's host-local step was recorded against one
shard assignment, and the new host count needs a fresh one.
`reshard_tree` is the dense face's: a train state's whole leaves (a
checkpoint's, saved at any mesh) cut into this rank's blocks of a
state laid out over another mesh.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.configs.base import DPMRConfig
from repro_torch.convert import _pairs, state_from_numpy
from repro_torch.core import dpmr
from repro_torch.data.ownership import reassign_state


@torch.no_grad()
def reshard_tree(tree: dict, like: dict) -> dict:
    """Copy the WHOLE arrays of a dense train state's tree (the
    reference's: `params`, `opt`, `step`, and `err` if `like` has it;
    layers stacked on a leading axis) into this rank's blocks of `like`,
    a train state over a mesh (`trainer.init_state(..., mesh=...)`), IN
    PLACE; returns `like`."""
    model = like["params"]
    layout = model.layout

    def put(blocks: dict, subtree: dict) -> None:
        for name, path, layer in _pairs(model):
            leaf = subtree
            for key in path:
                leaf = leaf[key]
            leaf = np.asarray(leaf if layer is None else leaf[layer])
            blocks[name].copy_(layout.shard(name, torch.as_tensor(leaf)))

    put(dict(model.named_parameters()), tree["params"])
    for key, node in like["opt"].items():
        if isinstance(node, dict):
            put(node, tree["opt"][key])
        else:
            node.copy_(torch.as_tensor(np.asarray(tree["opt"][key])))
    like["step"].copy_(torch.as_tensor(np.asarray(tree["step"])))
    if "err" in like:
        put(like["err"], tree["err"])
    return like


def reshard_dpmr_state(state: Sequence, cfg: DPMRConfig, new_mesh=None,
                       device="cpu") -> dpmr.DPMRState:
    """This rank's `DPMRState` on `new_mesh` (None: one rank) and
    `device`, from the 7 GLOBAL leaves of a state saved at another rank
    count (host arrays in field order, as `Checkpointer.restore_host`
    returns them): `cold` and `cold_acc` re-padded to the new
    `padded_features`, the replicated leaves as they were, and the
    strategy carry zeros of the new geometry.

    The carry (compressed_reduce's quantization error, topk_reduce's
    residual) is an optimization residual of the old ranks, meaningless
    under another rank count; the next steps rebuild it. The hot-set
    geometry (`cfg.max_hot`) must match the saved one."""
    s = dpmr.DPMRState(*[np.asarray(x) for x in state])
    if s.hot.shape[0] != cfg.max_hot:
        raise ValueError(f"the checkpoint's hot set holds {s.hot.shape[0]} "
                         f"slots, cfg.max_hot is {cfg.max_hot}: the hot-set "
                         "geometry must match across an elastic restore")
    p_new = dpmr.num_shards(new_mesh)
    f_new = dpmr.padded_features(cfg, p_new)
    if f_new < cfg.num_features:
        raise ValueError("cannot shrink below the real feature space")

    def repad(x):
        if x.shape[0] < f_new:
            return np.pad(x, (0, f_new - x.shape[0]))
        # shrinking drops only padding rows beyond cfg.num_features
        return x[:f_new]

    strat = np.zeros((p_new * dpmr.strategy_carry_len(cfg, new_mesh),),
                     np.float32)
    return state_from_numpy(
        [repad(s.cold), s.hot, s.hot_ids, repad(s.cold_acc), s.hot_acc,
         s.step, strat], device, new_mesh)


def reshard_data_state(data_state: dict, num_hosts: int,
                       host_index: int | None = None) -> dict:
    """Rewrite a loader `state_dict()` (a checkpoint's `extra["data"]`) for
    a NEW data-plane host count: the input face's counterpart of
    `reshard_dpmr_state`.

    The epoch (and with it the per-epoch shuffle permutations) survives;
    the host-local step resets to the epoch start, and the restoring
    loader recomputes its own chunk assignment, so every chunk is owned
    exactly once under the new geometry. Equivalent to
    `loader.load_state_dict(state, on_host_change="reassign")`."""
    return reassign_state(data_state, num_hosts, host_index)
