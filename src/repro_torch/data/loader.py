"""`ShardedLoader`: the prefetching, resumable front of the data plane,
the counterpart of `repro.data.loader`.

One loader owns everything between a `DataSource` and the training step:

  shard ownership   the source's `owned_shards(host, num_hosts)` seam
                    decides what host h of H reads. File-backed sources
                    (`file_sparse`) return chunk-aligned contiguous ranges:
                    host h owns a balanced run of ⌈C/H⌉ or ⌊C/H⌋ chunk
                    files and opens only those (the paper's per-node HDFS
                    blocks), with `steps_per_epoch` the exact owned batch
                    count. Synthetic sources declare the `stride` kind
                    (host h reads global batches h, h+H, ...;
                    `steps_per_epoch` is the even floor `num_batches // H`);
                    `ownership="stride"` forces that interleaving on any
                    source.
  conformance       the batch size must divide by the mesh's rank count P;
                    the loader drops the remainder rows (default) or pads
                    (`remainder="pad"`; sparse `ids` pad with -1, empty
                    slots).
  placement         "sharded" puts this rank's rows of each global batch
                    on the loader's device in the kernels' dtypes (a
                    `RankBatch`, what `DPMREngine` takes), "host" yields
                    numpy, or pass any callable(batch) -> batch
                    (`runtime.multiprocess.global_batch_placement` for a
                    rank that reads only its own host's rows); "device"
                    puts every leaf whole on the loader's device in its
                    own dtype (the dense trainer's batches, as the
                    reference's "device" placement).
  prefetch          a thread loads and places the next batches while the
                    consumer runs the step, into a bounded queue (default
                    depth 2). On the card each batch is staged in pinned
                    memory and copied `non_blocking` on a side stream with
                    an event recorded after it; the consumer's stream waits
                    on the event and `record_stream` keeps the caching
                    allocator from reusing the batch's memory early. A
                    producer's exception is raised in the consumer; there
                    is no fallback to synchronous loading.
  cursor            an explicit (epoch, step) position. Batch content is a
                    pure function of `(epoch, step)` (of `step` alone with
                    shuffling off), so `seek(cursor)` after a restore
                    reproduces the continued stream bit for bit. The cursor
                    advances only when a batch is HANDED to the consumer:
                    the prefetch thread running ahead never moves it, so a
                    checkpoint taken mid-stream is exact.
  shuffling         `shuffle=True` visits each epoch's batches in a fresh
                    order, with the reference's numpy seeding. Stride mode:
                    a global permutation seeded by `(shuffle_seed, epoch)`,
                    striped over hosts. Chunk mode: a permutation of this
                    owner's chunks seeded by `(shuffle_seed, epoch, host)`,
                    batches inside a chunk kept consecutive.

    loader = ShardedLoader(get_source("zipf_sparse", batch_size=512,
                                      num_batches=8), mesh, device="cpu")
    for batch in loader.batches(40): ...   # 40 steps, epochs roll over
    for batch in loader.epoch(): ...       # remainder of the current epoch
    ck = loader.state_dict()               # {"cursor": {"epoch": e, "step": s}}
    loader.load_state_dict(ck)             # exact resume

A loader places on the card unless the caller asks for the CPU
(`device="cpu"`); `placement="host"` touches no device.
"""
from __future__ import annotations

from collections.abc import Callable, Iterator
import dataclasses
import queue
import threading
import time
import warnings

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.dpmr import num_shards
from repro_torch.data.ownership import ShardAssignment, reassign_state
from repro_torch.data.sources import DataSource
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_rank
from repro_torch.runtime import multiprocess


class RankBatch(dict):
    """A batch dict holding THIS rank's rows of a global batch of
    `global_size` rows, on the rank's device in the kernels' dtypes
    (`DTYPES`). `DPMREngine` sizes its step functions by `global_size`
    and does not cut the rows again."""

    DTYPES = {"ids": torch.int32, "vals": torch.float32,
              "labels": torch.int32}

    def __init__(self, data: dict, global_size: int):
        super().__init__(data)
        self.global_size = int(global_size)


def to_device(v, device: torch.device, key: str) -> torch.Tensor:
    """One leaf of a batch on `device`, in `RankBatch.DTYPES[key]`. Host
    data bound for the card is staged in pinned memory and copied
    `non_blocking` on the current stream, so the copy is ordered before
    whatever that stream runs next and the host does not wait."""
    dtype = RankBatch.DTYPES[key]
    if torch.is_tensor(v):
        return v.to(device=device, dtype=dtype)
    t = torch.as_tensor(np.asarray(v)).to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def put_whole(v, device: torch.device) -> torch.Tensor:
    """A host array whole on `device` in its own dtype, staged in pinned
    memory and copied `non_blocking` on the current stream when bound
    for the card (as `to_device`)."""
    t = torch.as_tensor(np.asarray(v))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def put_sharded(batch: dict, device, mesh=None) -> RankBatch:
    """Host→device placement of this rank's rows of a GLOBAL batch dict:
    rows [r·B/P, (r+1)·B/P) on rank r of `mesh` (all of them without
    one), in the kernels' dtypes. A `RankBatch` already holds a rank's
    rows and passes through (moved to `device` if it lies elsewhere).
    Raises when the rows do not split evenly over the P ranks.

    THE definition of sparse-face placement: `api.engine.put_batch`
    delegates here."""
    device = torch.device(device)
    if isinstance(batch, RankBatch):
        if all(torch.is_tensor(v) and v.device.type == device.type
               and device.index in (None, v.device.index)
               for v in batch.values()):
            return batch
        return RankBatch({k: to_device(v, device, k)
                          for k, v in batch.items()}, batch.global_size)
    p, r = num_shards(mesh), mesh_rank(mesh)
    out, rows = {}, None
    for k, v in batch.items():
        if k not in RankBatch.DTYPES:
            continue
        rows = len(v)
        if p > 1:
            if len(v) % p:
                raise ValueError(f"batch {k!r} of {len(v)} rows is not a "
                                 f"multiple of P={p}")
            n = len(v) // p
            v = v[r * n:(r + 1) * n]
        out[k] = to_device(v, device, k)
    return RankBatch(out, global_size=rows or 0)


@dataclasses.dataclass(frozen=True)
class Cursor:
    """Explicit stream position: `epoch` full passes done, `step` batches
    consumed within the current pass (local to this host's shard)."""

    epoch: int = 0
    step: int = 0

    def to_dict(self) -> dict[str, int]:
        return {"epoch": int(self.epoch), "step": int(self.step)}

    @classmethod
    def from_dict(cls, d: dict) -> "Cursor":
        return cls(epoch=int(d["epoch"]), step=int(d["step"]))


class ShardedLoader:
    """Per-host sharded, conforming, prefetching view of a `DataSource`.

    Parameters
    ----------
    source:        any DataSource (see repro_torch.data.sources)
    mesh:          torch DeviceMesh (`launch.mesh.make_host_mesh`); sets the
                   default batch divisor (its rank count P) and which rows
                   "sharded" placement keeps. None = one rank
    device:        where "sharded" and "device" placement put batches;
                   None = the card (raises without one), "cpu" for the host
    placement:     "sharded" | "device" | "host" | callable(batch) -> batch
    host_index / num_hosts:
                   this process's slice of the batch stream; default this
                   rank of the default process group
                   (`runtime.multiprocess.context()`)
    ownership:     "auto" (default) asks the source's `owned_shards(host,
                   num_hosts)` seam; "stride" forces the synthetic
                   interleaving (host h reads batches h, h+H, ...)
    batch_divisor: override the divisibility constraint (default: P under
                   "sharded", else 1)
    remainder:     "drop" (default) or "pad" when batch_size % divisor != 0.
                   Pad rows are EMPTY samples (ids=-1, vals=0, labels=0):
                   they add no feature gradients but do count in the loss,
                   accuracy and PRF denominators
    prefetch:      queue depth of placed batches built ahead by a thread;
                   0 = synchronous
    epoch_size:    batches per epoch for UNBOUNDED sources
    cursor:        starting position (default (0, 0))
    shuffle:       per-epoch shuffling (needs a bounded epoch); resume stays
                   exact: the permutation is a pure function of the epoch
    shuffle_seed:  base seed of the per-epoch permutations

    A prefetching iterator adds the seconds the consumer waited for each
    batch it was handed to the `obs` counter `loader.wait_s`, and counts
    the batch in `loader.batches`.
    """

    def __init__(self, source: DataSource, mesh=None, *,
                 device=None,
                 placement: str | Callable = "sharded",
                 host_index: int | None = None,
                 num_hosts: int | None = None,
                 ownership: str = "auto",
                 batch_divisor: int | None = None,
                 remainder: str = "drop",
                 prefetch: int = 2,
                 epoch_size: int | None = None,
                 cursor: Cursor | None = None,
                 shuffle: bool = False,
                 shuffle_seed: int = 0):
        self.source = source
        # duck-typed sources only promise batch/batch_size/num_batches
        self.source_name = getattr(source, "name", type(source).__name__)
        self.mesh = mesh
        self.placement = placement
        if placement not in ("sharded", "device", "host") \
                and not callable(placement):
            raise ValueError(f"unknown placement {placement!r}")
        self.device = None if placement == "host" else resolve_device(device)
        if self.device is not None and self.device.type == "cuda" \
                and self.device.index is None:
            # the prefetch thread selects this card for itself
            self.device = torch.device("cuda", torch.cuda.current_device())
        if mesh is not None and self.device is not None \
                and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot place "
                             f"batches on {self.device}")
        ctx = multiprocess.context()
        self.num_hosts = int(num_hosts if num_hosts is not None
                             else ctx.num_processes)
        self.host_index = int(host_index if host_index is not None
                              else ctx.process_id)
        if not 0 <= self.host_index < self.num_hosts:
            raise ValueError((self.host_index, self.num_hosts))
        if remainder not in ("drop", "pad"):
            raise ValueError(f"remainder must be 'drop'|'pad': {remainder!r}")
        self.remainder = remainder
        self.prefetch = int(prefetch)
        if batch_divisor is None:
            batch_divisor = num_shards(mesh) if placement == "sharded" else 1
        self.batch_divisor = int(batch_divisor)

        # -- shard ownership: what does host h of H read? -------------------
        if ownership not in ("auto", "stride"):
            raise ValueError(f"ownership must be 'auto'|'stride': "
                             f"{ownership!r}")
        assignment = None
        if ownership == "auto":
            seam = getattr(source, "owned_shards", None)
            if callable(seam):
                assignment = seam(self.host_index, self.num_hosts)
        # stride-kind declarations keep the legacy index arithmetic below;
        # only chunk-kind assignments change the iteration order contract
        self._assignment = assignment if (
            assignment is not None and assignment.kind == "chunk") else None
        self.assignment_kind = "chunk" if self._assignment is not None \
            else "stride"

        if self._assignment is not None:
            if epoch_size is not None:
                raise ValueError(
                    "epoch_size= conflicts with chunk ownership: the epoch "
                    "is this host's owned chunk range; pass "
                    "ownership='stride' to override the source's assignment")
            n = self._assignment.num_batches
            self.steps_per_epoch = self._assignment.steps_per_epoch(
                self.host_index)
            if self.steps_per_epoch < 1:
                raise ValueError(
                    f"host {self.host_index} of {self.num_hosts} owns no "
                    f"chunks: the corpus has only "
                    f"{self._assignment.num_chunks} chunk files; use fewer "
                    "hosts or re-chunk the corpus with a smaller "
                    "batches_per_chunk")
        else:
            n = epoch_size if epoch_size is not None else source.num_batches
            self.steps_per_epoch = None if n is None \
                else int(n) // self.num_hosts
            if self.steps_per_epoch is not None and self.steps_per_epoch < 1:
                raise ValueError(
                    f"source has {n} batches for {self.num_hosts} hosts: "
                    "fewer than one batch per host per epoch")
        self.shuffle = bool(shuffle)
        self.shuffle_seed = int(shuffle_seed)
        if self.shuffle and n is None:
            raise ValueError(
                "shuffle=True needs a bounded epoch to permute: give the "
                "source a num_batches or pass epoch_size=")
        self._epoch_batches = None if n is None else int(n)
        self._perm_cache = (None, None)   # (epoch, permutation)
        self._order_cache = (None, None)  # (epoch, owned batch order)
        self._cursor = cursor if cursor is not None else Cursor()
        self._seek_token = 0   # bumped by seek(); invalidates live iterators

    @property
    def assignment(self) -> ShardAssignment | None:
        """The global chunk `ShardAssignment` in force, or None when this
        loader reads by stride (synthetic sources, ownership='stride')."""
        return self._assignment

    # -- cursor -------------------------------------------------------------

    @property
    def cursor(self) -> Cursor:
        return self._cursor

    def seek(self, cursor: Cursor | dict) -> None:
        """Reposition the stream; the next batch is the one an uninterrupted
        run would have produced at this cursor.

        Any iterator already obtained from batches()/epoch() planned its
        positions from the OLD cursor — resuming one after a seek raises
        RuntimeError rather than silently serving stale positions."""
        if isinstance(cursor, dict):
            cursor = Cursor.from_dict(cursor)
        self._seek_token += 1
        self._cursor = cursor

    def state_dict(self) -> dict:
        d = {"cursor": self._cursor.to_dict(),
             "source": self.source_name,
             "batch_size": int(getattr(self.source, "batch_size", 0)),
             "num_hosts": self.num_hosts,
             "host_index": self.host_index,
             "ownership": self.assignment_kind,
             "shuffle": self.shuffle,
             "shuffle_seed": self.shuffle_seed}
        if self._assignment is not None:
            d["assignment"] = self._assignment.to_dict()
        return d

    def load_state_dict(self, state: dict, *,
                        on_host_change: str = "error") -> None:
        """Restore a `state_dict()` position, validating that the stream it
        was recorded against is the one this loader reads.

        `on_host_change` decides what happens when the state was recorded
        under a DIFFERENT host count (elastic rescale): "error" (default)
        refuses — the host-local step addresses someone else's stream —
        while "reassign" rewrites the state via
        `repro_torch.data.ownership.reassign_state` (the epoch survives, the step
        resets to the epoch start, this loader's own assignment takes
        over; every chunk is owned exactly once under the new geometry)."""
        if on_host_change not in ("error", "reassign"):
            raise ValueError(f"on_host_change must be 'error'|'reassign': "
                             f"{on_host_change!r}")
        saved_hosts = state.get("num_hosts")
        if saved_hosts is not None and int(saved_hosts) != self.num_hosts:
            if on_host_change == "reassign":
                warnings.warn(
                    f"cursor was recorded with num_hosts={saved_hosts}; "
                    f"reassigning shards over {self.num_hosts} hosts — "
                    "resuming at the start of epoch "
                    f"{int(state.get('cursor', {}).get('epoch', 0))} "
                    "(correct-by-reassignment, not bit-exact: the "
                    "interrupted epoch is re-read under the new ownership)",
                    RuntimeWarning, stacklevel=2)
                state = reassign_state(state, self.num_hosts,
                                       self.host_index)
            else:
                raise ValueError(
                    f"cursor was recorded with num_hosts={saved_hosts} but "
                    f"this loader shards over {self.num_hosts} hosts — the "
                    "host-local step would address a different sample "
                    "stream; pass on_host_change='reassign' (or rewrite the "
                    "state with runtime/elastic.py::reshard_data_state) to "
                    "resume at the epoch boundary under the new assignment")
        saved_host = state.get("host_index")
        if saved_host is not None and int(saved_host) != self.host_index:
            warnings.warn(
                f"cursor was recorded by host {saved_host} but this loader "
                f"is host {self.host_index}; the step addresses that "
                "host's shard — resume is only exact on the recording host",
                RuntimeWarning, stacklevel=2)
        saved_kind = state.get("ownership")
        if saved_kind is not None and saved_kind != self.assignment_kind:
            warnings.warn(
                f"cursor was recorded under {saved_kind!r} ownership but "
                f"this loader reads by {self.assignment_kind!r}; the step "
                "index addresses a differently-ordered stream — resume is "
                "not exact", RuntimeWarning, stacklevel=2)
        saved_assign = state.get("assignment")
        if (saved_assign is not None and self._assignment is not None
                and int(saved_assign.get("num_hosts", self.num_hosts))
                == self.num_hosts
                and saved_assign != self._assignment.to_dict()):
            warnings.warn(
                "cursor was recorded against a different chunk assignment "
                f"({saved_assign.get('num_chunks')} chunks x "
                f"{saved_assign.get('batches_per_chunk')} batches) than "
                f"this corpus ({self._assignment.num_chunks} x "
                f"{self._assignment.batches_per_chunk}); the step "
                "addresses different samples — resume is not exact",
                RuntimeWarning, stacklevel=2)
        saved_source = state.get("source")
        if saved_source is not None and saved_source != self.source_name:
            warnings.warn(
                f"restoring a cursor recorded against source "
                f"{saved_source!r} into a {self.source_name!r} loader; "
                "resume is only exact if both serve identical batches",
                RuntimeWarning, stacklevel=2)
        saved_shuffle = state.get("shuffle")
        if saved_shuffle is not None and bool(saved_shuffle) != self.shuffle:
            warnings.warn(
                f"cursor was recorded with shuffle={saved_shuffle} but this "
                f"loader has shuffle={self.shuffle}; the step index "
                "addresses a differently-ordered stream — resume is not "
                "exact", RuntimeWarning, stacklevel=2)
        saved_sseed = state.get("shuffle_seed")
        if (self.shuffle and saved_sseed is not None
                and int(saved_sseed) != self.shuffle_seed):
            warnings.warn(
                f"cursor was recorded with shuffle_seed={saved_sseed} but "
                f"this loader uses shuffle_seed={self.shuffle_seed}; the "
                "epoch permutations differ — resume is not exact",
                RuntimeWarning, stacklevel=2)
        saved_bs = state.get("batch_size")
        here_bs = int(getattr(self.source, "batch_size", 0))
        if saved_bs and here_bs and int(saved_bs) != here_bs:
            warnings.warn(
                f"cursor was recorded against batch_size={saved_bs} but "
                f"this loader's source serves batch_size={here_bs}; the "
                "step index addresses different samples — resume is not "
                "exact", RuntimeWarning, stacklevel=2)
        self.seek(Cursor.from_dict(state["cursor"]))

    # -- iteration ----------------------------------------------------------

    def batches(self, limit: int | None = None) -> Iterator[dict]:
        """Yield up to `limit` placed batches from the cursor onward,
        rolling over epochs on bounded sources (None = unbounded stream).

        One live iterator at a time: starting a new one (like seek) stales
        any earlier iterator's plan — resuming the old one raises
        RuntimeError instead of serving duplicate positions."""
        self._seek_token += 1
        token = self._seek_token
        plan = self._positions(self._cursor, limit)
        if self.prefetch <= 0:
            for pos, after in plan:
                self._check_token(token)
                batch = self._place(self._load(pos))
                self._cursor = after
                yield batch
            return
        yield from self._prefetched(plan, token)

    def epoch(self, from_start: bool = False) -> Iterator[dict]:
        """The remainder of the current epoch (or, with `from_start`, the
        whole current epoch); afterwards the cursor sits at the next epoch's
        start. One call == one full pass of this host's shard — the paper's
        per-iteration corpus sweep."""
        spe = self.steps_per_epoch
        if spe is None:
            raise ValueError(
                f"source {self.source_name!r} is unbounded, so an epoch is "
                "undefined: give the source a bounded num_batches (e.g. "
                "num_batches= in the spec passed to get_source) or pass "
                "epoch_size= when constructing the ShardedLoader")

        def gen():
            # everything binds at ITERATION time, not at epoch() call time:
            # if the cursor moved in between (another take(), a seek), the
            # pass still ends exactly at the next epoch boundary instead of
            # spilling a stale batch count into the following epoch
            if self._cursor.step >= spe:
                # normalize an epoch-boundary/overshot cursor the same way
                # _positions() would, so the limit never goes negative
                self._cursor = Cursor(self._cursor.epoch + 1, 0)
            if from_start and self._cursor.step != 0:
                self._cursor = Cursor(self._cursor.epoch, 0)
            yield from self.batches(spe - self._cursor.step)

        return gen()

    def take(self, n: int) -> list:
        return list(self.batches(n))

    # -- internals ----------------------------------------------------------

    def _check_token(self, token: int) -> None:
        if token != self._seek_token:
            raise RuntimeError(
                "loader was repositioned (seek/load_state_dict) or a newer "
                "iterator was started while this iterator was active; its "
                "remaining plan is stale — create a new iterator with "
                "batches()/epoch()")

    def _positions(self, start: Cursor, limit: int | None
                   ) -> Iterator[tuple]:
        """(position, cursor-after) pairs from `start`, epoch-rolling."""
        spe = self.steps_per_epoch
        cur = start
        produced = 0
        while limit is None or produced < limit:
            if spe is not None and cur.step >= spe:
                cur = Cursor(cur.epoch + 1, 0)
            nxt = Cursor(cur.epoch, cur.step + 1)
            if spe is not None and nxt.step >= spe:
                nxt = Cursor(cur.epoch + 1, 0)
            yield cur, nxt
            cur = nxt
            produced += 1

    def _permutation(self, epoch: int) -> np.ndarray:
        """The epoch's global batch permutation — a pure function of
        (shuffle_seed, epoch), so seeking reconstructs it exactly."""
        cached_epoch, perm = self._perm_cache
        if cached_epoch != epoch:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.shuffle_seed, epoch]))
            perm = rng.permutation(self._epoch_batches)
            self._perm_cache = (epoch, perm)
        return perm

    def _owned_order(self, epoch: int) -> np.ndarray:
        """Chunk-ownership read order for one epoch: this host's owned
        chunks — permuted per epoch when shuffling, seeded by
        (shuffle_seed, epoch, host) so hosts draw independent orders —
        with batches inside each chunk kept consecutive (every owned file
        is read once, sequentially). A pure function of the cursor's
        epoch, so seeking reconstructs it exactly."""
        cached_epoch, order = self._order_cache
        if cached_epoch != epoch:
            a = self._assignment
            chunks = list(a.owned_chunks(self.host_index))
            if self.shuffle:
                rng = np.random.default_rng(np.random.SeedSequence(
                    [self.shuffle_seed, epoch, self.host_index]))
                chunks = [chunks[i] for i in rng.permutation(len(chunks))]
            order = np.asarray([i for c in chunks
                                for i in a.chunk_batches(c)], dtype=np.int64)
            self._order_cache = (epoch, order)
        return order

    def _load(self, pos: Cursor) -> dict[str, np.ndarray]:
        # content is a pure function of the cursor: without shuffling it
        # depends only on `step` (every epoch re-reads the same shard in
        # the same order, the deterministic full-batch regime); with
        # shuffling the epoch's permutation reorders the same batch set
        if self._assignment is not None:
            index = int(self._owned_order(pos.epoch)[pos.step])
        else:
            index = pos.step * self.num_hosts + self.host_index
            if self.shuffle:
                index = int(self._permutation(pos.epoch)[index])
        return self._conform(self.source.batch(index))

    def _conform(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        d = self.batch_divisor
        b = next(iter(batch.values())).shape[0]
        rem = b % d
        if rem == 0:
            return batch
        if self.remainder == "drop":
            keep = b - rem
            if keep == 0:
                raise ValueError(
                    f"batch of {b} samples smaller than the mesh divisibility "
                    f"constraint {d}; use remainder='pad' or a larger batch")
            return {k: v[:keep] for k, v in batch.items()}
        pad = d - rem
        out = {}
        for k, v in batch.items():
            fill_val = -1 if k == "ids" else 0
            fill = np.full((pad,) + v.shape[1:], fill_val, v.dtype)
            out[k] = np.concatenate([np.asarray(v), fill], axis=0)
        return out

    def _place(self, batch: dict[str, np.ndarray]) -> dict:
        if callable(self.placement):
            return self.placement(batch)
        if self.placement == "sharded":
            return put_sharded(batch, self.device, self.mesh)
        if self.placement == "device":
            return {k: put_whole(v, self.device) for k, v in batch.items()}
        return batch

    def _prefetched(self, plan: Iterator[tuple],
                    token: int) -> Iterator[dict]:
        """Background-thread loading + placement, bounded-queue delivery.

        The cursor advances on the CONSUMER side as batches are handed out;
        the producer running ahead never moves it, so checkpoints taken
        between steps are exact resume points. On the card the producer
        copies on a side stream and hands an event over with each batch.
        """
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        cuda = self.device is not None and self.device.type == "cuda"

        def offer(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                side = None
                if cuda:
                    torch.cuda.set_device(self.device)
                    side = torch.cuda.Stream(self.device)
                for pos, after in plan:
                    if stop.is_set():
                        return
                    host = self._load(pos)
                    event = None
                    if cuda:
                        with torch.cuda.stream(side):
                            placed = self._place(host)
                            event = torch.cuda.Event()
                            event.record(side)
                    else:
                        placed = self._place(host)
                    if not offer(("batch", placed, after, event)):
                        return
                offer(("done", None, None, None))
            except BaseException as e:  # surface in the consumer
                offer(("error", e, None, None))

        thread = threading.Thread(target=producer, daemon=True,
                                  name="sharded-loader-prefetch")
        thread.start()
        try:
            while True:
                t = time.perf_counter()
                kind, payload, after, event = q.get()
                if kind == "done":
                    return
                if kind == "error":
                    raise payload
                obs.count("loader.wait_s", time.perf_counter() - t)
                obs.count("loader.batches")
                self._check_token(token)
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for v in payload.values():
                        if torch.is_tensor(v) and v.is_cuda:
                            v.record_stream(stream)
                self._cursor = after
                yield payload
        finally:
            stop.set()
            thread.join(timeout=5.0)
