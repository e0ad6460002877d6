"""Shard ownership: which host reads which slice of a corpus. A copy of
`repro.data.ownership` (pure Python): the port imports nothing of the JAX
package, and its assignments must equal the reference's
(tests/test_torch_data.py checks them).

The paper's data plane starts from samples that already live pre-sharded
in a distributed file system: every node maps only over the sample shards
co-located with it. A `ShardAssignment` makes that ownership first-class —
a global map from host to the contiguous, chunk-aligned range of chunk
files it owns, computed once from the corpus manifest:

    manifest.json ──► ShardAssignment.chunk_aligned(C, H, ...)
      num_chunks=C         host 0   ──► chunks [0,  q0)   q = ⌈C/H⌉ or
      batches_per_chunk    host 1   ──► chunks [q0, q1)       ⌊C/H⌋ each,
      num_batches          ...                                balanced
                           host H-1 ──► chunks [..,  C)

Invariants (asserted in tests/test_ownership.py for the reference):

  - every chunk is owned by exactly ONE host; none are dropped;
  - each host's range is contiguous and chunk-aligned, so host h opens
    only its own <= ⌈C/H⌉ chunk files (not all C — the stride baseline's
    H× read amplification), and whenever C >= H every host owns at
    least one chunk (balanced split, not the starving ⌈C/H⌉-greedy one);
  - with H > C the trailing hosts own nothing (their loaders refuse to
    construct rather than silently serving an empty epoch);
  - the last chunk may be short (num_batches % batches_per_chunk != 0) —
    per-host epoch lengths are exact batch counts, not floors.

Synthetic sources have no files to own; they declare the `stride` kind
(host h reads batches h, h+H, ... — the pre-ownership interleaving) so the
loader can record what geometry a cursor was written against.

`reassign_state` is the elastic-rescale hook (re-exported as
`runtime/elastic.py::reshard_data_state`): a loader `state_dict()` recorded
under one host count is rewritten for another — the epoch survives, the
host-local step resets to the epoch start, and the new loader recomputes
its own assignment, mirroring how the per-device strategy carry is reset
on mesh rescale. Correctness over exactness: under the new assignment
every chunk is again owned exactly once, at the cost of re-reading the
interrupted epoch.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ShardAssignment", "reassign_state"]


@dataclasses.dataclass(frozen=True)
class ShardAssignment:
    """Global host → shard-range map for one corpus geometry.

    kind:              "chunk" (file-backed, chunk-aligned contiguous
                       ranges) or "stride" (synthetic interleaving)
    num_hosts:         hosts the corpus is divided over
    num_batches:       global epoch size in batches
    batches_per_chunk / num_chunks / chunk_ranges:
                       chunk-kind geometry; `chunk_ranges[h] == (lo, hi)`
                       is host h's half-open chunk range
    """

    kind: str
    num_hosts: int
    num_batches: int
    batches_per_chunk: int = 0
    num_chunks: int = 0
    chunk_ranges: tuple = ()

    # -- constructors -------------------------------------------------------

    @classmethod
    def chunk_aligned(cls, num_chunks: int, num_hosts: int, *,
                      batches_per_chunk: int,
                      num_batches: int) -> "ShardAssignment":
        """Balanced contiguous ranges: ⌊C/H⌋ chunks each, the first C % H
        hosts take one extra (so every range holds ⌈C/H⌉ or ⌊C/H⌋ chunks).

        NOT the naive ⌈C/H⌉-greedy split, which starves trailing hosts of
        perfectly divisible work — e.g. C=6, H=4 greedy gives (2,2,2,0)
        where balanced gives (2,2,1,1). A host owns nothing only when
        H > C leaves genuinely no chunk for it."""
        if num_chunks < 1 or num_hosts < 1:
            raise ValueError((num_chunks, num_hosts))
        base, extra = divmod(num_chunks, num_hosts)
        ranges = []
        lo = 0
        for h in range(num_hosts):
            hi = lo + base + (1 if h < extra else 0)
            ranges.append((lo, hi))
            lo = hi
        return cls(kind="chunk", num_hosts=int(num_hosts),
                   num_batches=int(num_batches),
                   batches_per_chunk=int(batches_per_chunk),
                   num_chunks=int(num_chunks), chunk_ranges=tuple(ranges))

    @classmethod
    def strided(cls, num_batches: int, num_hosts: int) -> "ShardAssignment":
        """The synthetic interleaving: host h owns batches h, h+H, ..."""
        return cls(kind="stride", num_hosts=int(num_hosts),
                   num_batches=int(num_batches))

    # -- queries ------------------------------------------------------------

    def _check_host(self, host: int) -> None:
        if not 0 <= host < self.num_hosts:
            raise ValueError(f"host {host} out of range for "
                             f"{self.num_hosts} hosts")

    def owned_chunks(self, host: int) -> range:
        """This host's contiguous chunk range (chunk kind only)."""
        self._check_host(host)
        if self.kind != "chunk":
            raise ValueError(f"{self.kind!r} assignments have no chunks")
        lo, hi = self.chunk_ranges[host]
        return range(lo, hi)

    def chunk_batches(self, chunk: int) -> range:
        """Global batch indices inside one chunk (last may be short)."""
        lo = chunk * self.batches_per_chunk
        return range(lo, min(self.num_batches,
                             lo + self.batches_per_chunk))

    def owned_batches(self, host: int) -> list[int]:
        """Global batch indices this host owns, in on-disk read order."""
        self._check_host(host)
        if self.kind == "stride":
            return list(range(host, self.num_batches, self.num_hosts))
        return [i for c in self.owned_chunks(host)
                for i in self.chunk_batches(c)]

    def steps_per_epoch(self, host: int) -> int:
        """Batches this host consumes per epoch.

        Chunk kind: the exact owned count (uneven across hosts when
        C % H != 0 or the last chunk is short). Stride kind: the even
        floor `num_batches // num_hosts` every host can serve."""
        self._check_host(host)
        if self.kind == "stride":
            return self.num_batches // self.num_hosts
        return len(self.owned_batches(host))

    def chunk_owner(self, chunk: int) -> int:
        """The single host owning `chunk` (chunk kind only)."""
        for h, (lo, hi) in enumerate(self.chunk_ranges):
            if lo <= chunk < hi:
                return h
        raise ValueError(f"chunk {chunk} outside [0, {self.num_chunks})")

    def global_rows(self, host: int, batch_size: int) -> range:
        """Rows host `host`'s per-step batch occupies in the assembled
        GLOBAL batch: `[host*B, (host+1)*B)`.

        A real multi-process run (`runtime/multiprocess.py`) glues the
        per-host batches into one `num_hosts*B`-row global array per step
        via `make_array_from_process_local_data`, with process h's local
        devices holding exactly these rows; the single-process parity
        baseline (`--host-id -1`) concatenates the same streams in the
        same host order. One definition, both execution modes."""
        self._check_host(host)
        if batch_size < 1:
            raise ValueError(f"batch_size must be positive: {batch_size}")
        return range(host * batch_size, (host + 1) * batch_size)

    # -- (de)serialization — JSON-native, rides in checkpoint extras --------

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "num_hosts": self.num_hosts,
             "num_batches": self.num_batches}
        if self.kind == "chunk":
            d.update(batches_per_chunk=self.batches_per_chunk,
                     num_chunks=self.num_chunks,
                     chunk_ranges=[list(r) for r in self.chunk_ranges])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ShardAssignment":
        return cls(kind=d["kind"], num_hosts=int(d["num_hosts"]),
                   num_batches=int(d["num_batches"]),
                   batches_per_chunk=int(d.get("batches_per_chunk", 0)),
                   num_chunks=int(d.get("num_chunks", 0)),
                   chunk_ranges=tuple(tuple(r) for r
                                      in d.get("chunk_ranges", ())))


def reassign_state(state: dict, num_hosts: int,
                   host_index: int | None = None) -> dict:
    """Rewrite a loader `state_dict()` for a NEW host count.

    The host-local step of the saved cursor addresses the OLD assignment's
    stream — under a different host count it would point at someone else's
    samples. Reassignment keeps what is still meaningful (the epoch — and
    with it the shuffle permutations) and resets the step to the epoch
    start; the restoring loader recomputes its own chunk range, so every
    chunk is again owned exactly once and none are dropped.
    """
    cur = dict(state.get("cursor") or {})
    new = dict(state)
    new["cursor"] = {"epoch": int(cur.get("epoch", 0)), "step": 0}
    new["num_hosts"] = int(num_hosts)
    if host_index is not None:
        new["host_index"] = int(host_index)
    else:
        new.pop("host_index", None)
    new.pop("assignment", None)     # stale geometry: loader recomputes
    return new
