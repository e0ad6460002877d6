"""Process meshes over `torch.distributed`: the counterpart of
`repro.launch.mesh`.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the default
process group, one rank a DPMR node (samples and parameters). Its dims
are named as the reference's axes: `pod` first when there is more than
one pod (the slow outer tier: between hosts, over the network), then
`data` and `model` (the fast inner tier: NVLink within a host). Rank r's
linear index over the mesh is r itself, which decomposes as
`outer_index * inner_shards + inner_index` because the outer tier leads.

    from repro_torch.launch.mesh import init_from_env, make_host_mesh
    device = init_from_env("cpu")            # under torchrun: gloo
    mesh = make_host_mesh(data=4, pods=2)    # dims ("pod", "data")

On CUDA tensors the groups are NCCL's; on the CPU, gloo's. The
reference's `make_production_mesh` (TPU v5e pods of 16 x 16 chips) has
no counterpart: a deployment's mesh is `make_host_mesh` over its own
torchrun world.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

OUTER_AXES = ("pod",)   # mesh dims that cross the slow inter-host network


class Groups(NamedTuple):
    """The process groups a rank's strategies exchange over."""

    world: dist.ProcessGroup         # every rank of the mesh
    inner: dist.ProcessGroup         # this rank's pod (the world with one)
    outer: dist.ProcessGroup | None  # the ranks of this inner index in
    #                                  every pod; None with one pod


def init_from_env(device=None) -> torch.device:
    """Join the process group that torchrun describes (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) and return
    this rank's device: NCCL on card `LOCAL_RANK` for a CUDA device (the
    default), gloo for the CPU. Raises when the variables are missing or
    the group cannot start."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                           "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"no torchrun environment ({missing} unset): "
                           "start the program with torchrun")
    dev = resolve_device(device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", rank=rank, world_size=world,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", rank=rank, world_size=world)
    return dev


def make_host_mesh(data: int = 1, model: int = 1, pods: int = 1
                   ) -> DeviceMesh:
    """A mesh of `pods x data x model` ranks over the default process
    group, which must hold exactly that many: of CUDA devices under
    NCCL, of the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call init_from_env "
                           "(or torch.distributed.init_process_group) "
                           "first")
    shape = (pods, data, model) if pods > 1 else (data, model)
    names = ("pod", "data", "model") if pods > 1 else ("data", "model")
    n = pods * data * model
    if n != dist.get_world_size():
        raise ValueError(f"a {dict(zip(names, shape, strict=True))} mesh "
                         f"needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def tier_axes(mesh: DeviceMesh) -> tuple:
    """Factor the mesh's dim names into the (outer, inner) wire tiers; the
    outer dims must lead, so that the linear index over the mesh is
    `outer_index * inner_shards + inner_index`."""
    names = tuple(mesh.mesh_dim_names)
    outer = tuple(a for a in names if a in OUTER_AXES)
    inner = tuple(a for a in names if a not in OUTER_AXES)
    if outer and names[:len(outer)] != outer:
        raise ValueError(f"outer axes {outer} must lead the mesh, got "
                         f"{names}")
    return outer, inner


def tier_shards(mesh: DeviceMesh) -> tuple:
    """(outer_shards, inner_shards) rank counts of the two tiers."""
    outer, inner = tier_axes(mesh)
    po = 1
    for a in outer:
        po *= axis_size(mesh, a)
    pi = 1
    for a in inner:
        pi *= axis_size(mesh, a)
    return po, pi


def batch_axes(mesh: DeviceMesh) -> tuple:
    """Mesh dims the global batch is sharded over (the DP dims present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names)
    return int(mesh.shape[names.index(name)]) if name in names else 1


def mesh_rank(mesh: DeviceMesh | None) -> int:
    """This rank's linear index over `mesh` (0 without one)."""
    if mesh is None:
        return 0
    _check_covers_world(mesh)
    return dist.get_rank()


def process_groups(mesh: DeviceMesh) -> Groups:
    """The world, inner and outer groups of this rank in `mesh`. The mesh
    keeps them: asking again returns the same groups."""
    _check_covers_world(mesh)
    outer, inner = tier_axes(mesh)
    world = dist.group.WORLD
    if not outer:
        return Groups(world, world, None)
    if len(inner) == 1:
        inner_group = mesh.get_group(inner[0])
    else:
        # several inner dims: one group over all of them, which the mesh
        # creates once and keeps
        inner_group = mesh[inner]._flatten("_".join(inner)).get_group()
    return Groups(world, inner_group, mesh.get_group(outer[0]))


def _check_covers_world(mesh: DeviceMesh) -> None:
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"the mesh must hold the default group's ranks in "
                         f"order (as make_host_mesh builds it), got {ranks}")
