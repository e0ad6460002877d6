"""Multi-process execution over `torch.distributed`: the parts of
`repro.runtime.multiprocess` that the sparse loop uses.

Under torchrun each process is one rank of the default process group
(`launch.mesh.init_from_env` joins it; the reference's `initialize`, which
stands up `jax.distributed`, has no counterpart). Data flows as the
ownership plane prescribes: rank r *is* data-plane host r of the world
size W. Its `ShardedLoader` reads only the batches that `ShardAssignment`
gives host r, and `global_batch_placement` hands them to the engine as
rank r's rows of a W·B-row global batch, rows [r·B, (r+1)·B) in host
order (`ShardAssignment.global_rows`). `emulate_all_hosts` is the parity
baseline: one stream of the concatenated global batch, from which each
rank cuts the same rows, so both ways of feeding train on the same
samples under the same mesh and give the same bits.

`host_value` gathers a sharded tensor's blocks from every rank in rank
order (a collective: every rank calls it), `barrier` syncs the ranks, and
`is_primary` names the one rank that writes checkpoints.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["ProcessContext", "barrier", "context",
           "emulate_all_hosts", "global_batch_placement", "host_value",
           "is_primary"]


@dataclasses.dataclass(frozen=True)
class ProcessContext:
    """This process's place in the default process group (one process
    and no group without torchrun)."""

    num_processes: int
    process_id: int

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def is_primary(self) -> bool:
        """Rank 0: the only checkpoint writer."""
        return self.process_id == 0


def context() -> ProcessContext:
    """The default process group's size and this process's rank."""
    if dist.is_available() and dist.is_initialized():
        return ProcessContext(dist.get_world_size(), dist.get_rank())
    return ProcessContext(1, 0)


def is_primary() -> bool:
    """True on the one process that owns externally visible side effects
    (checkpoint writes)."""
    return context().is_primary


def host_value(x, mesh=None) -> np.ndarray:
    """`x` as a host numpy array (a copy). With a `mesh` of P > 1 ranks,
    `x` is this rank's block of a tensor sharded along axis 0, and the
    result is the whole tensor: every rank's block in rank order (a
    collective: every rank of the mesh must call it)."""
    if not torch.is_tensor(x):
        return np.array(x)
    if mesh is not None and int(mesh.size()) > 1:
        whole = x.new_empty((int(mesh.size()) * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(whole, x.contiguous())
        x = whole
    # a copy: a CPU tensor's .numpy() would share its memory, and the next
    # step updates the state in place
    return x.detach().to("cpu", copy=True).numpy()


def barrier() -> None:
    """Cross-process sync point (no-op in one process)."""
    if context().is_distributed:
        dist.barrier()


def global_batch_placement(device, num_processes: int | None = None):
    """Placement callable for a `ShardedLoader` in a run of W processes.

    Each process's loader serves B host-local rows a step; the returned
    callable places them on `device` as this rank's rows of a W·B-row
    global batch (a `data.loader.RankBatch`): rank r's rows sit at offset
    r·B, the concatenation order of `emulate_all_hosts`. It runs no
    collective, so the loader's prefetch thread may call it."""
    # late import: data.loader asks this module for the default host
    from repro_torch.data.loader import RankBatch, to_device

    w = context().num_processes if num_processes is None else num_processes
    device = torch.device(device)

    def place(batch: dict) -> RankBatch:
        rows = len(next(iter(batch.values())))
        return RankBatch({k: to_device(v, device, k) for k, v in batch.items()
                          if k in RankBatch.DTYPES}, global_size=rows * w)

    return place


class _AllHostsSource:
    """The parity baseline: one stream serving EVERY host's batches.

    `batch(s)` concatenates `src.batch(s*H + h)` for h = 0..H-1: the
    global batch that H ranks each reading their own host's stride
    assemble at step s. Chunk-owned file corpora interleave differently
    per host and have no single-stream equivalent."""

    def __init__(self, source, num_hosts: int):
        seam = getattr(source, "owned_shards", None)
        if seam is not None and source.num_batches is not None \
                and seam(0, num_hosts).kind != "stride":
            raise ValueError(
                "all-hosts emulation is defined for stride-owned sources "
                "only; chunk-owned corpora need a real multi-process run")
        self.source = source
        self.num_hosts = int(num_hosts)
        self.batch_size = source.batch_size * self.num_hosts
        self.num_batches = None if source.num_batches is None \
            else source.num_batches // self.num_hosts

    def batch(self, index: int) -> dict:
        parts = [self.source.batch(index * self.num_hosts + h)
                 for h in range(self.num_hosts)]
        return {k: np.concatenate([np.asarray(p[k]) for p in parts])
                for k in parts[0]}


def emulate_all_hosts(source, num_hosts: int):
    """Wrap a stride-owned `DataSource` so one stream serves the
    concatenated per-step global batch of all `num_hosts` hosts
    (`launch/train.py --hosts H --host-id -1`)."""
    return _AllHostsSource(source, num_hosts)
