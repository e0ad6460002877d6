"""Bytes-received-per-rank models for recorded collectives, split by mesh
tier (inner vs outer): the counterpart of `repro.analysis.wire`.

The convention matches the strategies' declared `WireBytes`: count the
bytes a rank RECEIVES over a wire, attributed per sending peer — a
participant's own chunk never leaves the device and is never counted. For
a collective over axes `A` with `n` participants, the peers sharing this
rank's outer (pod) coordinate number `n_in` (the product of the sizes of
the inner axes in `A`), so `n_in - 1` remote peers are reached over the
inner tier (NVLink inside a host) and `n - n_in` over the outer one (the
network between hosts).

Per primitive (`B` = total per-rank buffer bytes):

  all_to_all      each peer contributes one `B/n` chunk:
                  inner `(n_in-1) * B/n`, outer `(n-n_in) * B/n`.
  all_gather      each peer's whole block (`B` = operand bytes) arrives:
                  inner `(n_in-1) * B`, outer `(n-n_in) * B`.
  reduce_scatter  each peer contributes one result-sized chunk
                  (`B` = result bytes): inner `(n_in-1) * B`, outer
                  `(n-n_in) * B`.
  psum/pmax/pmin  modeled as ring reduce-scatter + all_gather:
                  2 x the reduce_scatter cost of an operand-bytes/n chunk.
                  (Algorithm-dependent; NCCL may run it otherwise, but
                  this is the standard analytic bound benchmarks use.)
  ppermute        one peer's buffer; attributed to the outer tier iff the
                  permutation's axes touch an outer axis (conservative).

How the port's own primitives price (`api.strategies`): `_psum_scatter`
is an all_to_all of the (G, block) segments followed by their sum in rank
order on each rank, so it records as an all_to_all and prices as
`(G - 1)` blocks, which equals the reference's `reduce_scatter` of the
same vector. `_psum`, the sum of the hot-set gradient and of the metrics,
is an all_gather of the partials added in rank order: it records and
prices as an all_gather (`(n - 1)` operands), not as the reference's 2x
ring psum.

Anything else (grouped collectives, unknown primitives) has NO model —
`collective_wire` raises, and the auditor turns that into a hard finding
instead of silently under-counting a strategy's wire claim.
"""
from __future__ import annotations

from collections.abc import Iterable, Mapping

from repro_torch.analysis.trace import Collective
from repro_torch.api.strategies import WireBytes


class UnmodeledCollectiveError(ValueError):
    """A collective the wire model cannot attribute (see wire.py docs)."""


def _group_sizes(c: Collective, axis_sizes: Mapping[str, int],
                 outer_axes: Iterable[str]) -> tuple[int, int]:
    """(n, n_in): participants in the collective's group, and how many of
    them share this rank's outer (pod) coordinate."""
    outer = set(outer_axes)
    n = n_in = 1
    for a in c.axes:
        try:
            s = int(axis_sizes[a])
        except KeyError:
            raise UnmodeledCollectiveError(
                f"{c.describe()}: axis {a!r} not in the analytic mesh "
                f"{dict(axis_sizes)}") from None
        n *= s
        if a not in outer:
            n_in *= s
    return n, n_in


def collective_wire(c: Collective, axis_sizes: Mapping[str, int],
                    outer_axes: Iterable[str]) -> WireBytes:
    """Bytes received per rank for one recorded collective."""
    n, n_in = _group_sizes(c, axis_sizes, outer_axes)
    if n == 1:
        return WireBytes(inner=0, outer=0)
    if c.prim == "all_to_all":
        chunk = c.in_bytes // n
        return WireBytes(inner=(n_in - 1) * chunk,
                         outer=(n - n_in) * chunk)
    if c.prim == "all_gather":
        return WireBytes(inner=(n_in - 1) * c.in_bytes,
                         outer=(n - n_in) * c.in_bytes)
    if c.prim == "reduce_scatter":
        return WireBytes(inner=(n_in - 1) * c.out_bytes,
                         outer=(n - n_in) * c.out_bytes)
    if c.prim in ("psum", "pmax", "pmin"):
        chunk = c.in_bytes // n
        return WireBytes(inner=2 * (n_in - 1) * chunk,
                         outer=2 * (n - n_in) * chunk)
    if c.prim == "ppermute":
        crosses = n != n_in
        return WireBytes(inner=0 if crosses else c.in_bytes,
                         outer=c.in_bytes if crosses else 0)
    raise UnmodeledCollectiveError(
        f"no wire model for recorded collective {c.describe()}")


def wire_total(ops: Iterable[Collective], axis_sizes: Mapping[str, int],
               outer_axes: Iterable[str]) -> WireBytes:
    """Sum of `collective_wire` over `ops` (both tiers)."""
    inner = outer = 0
    for c in ops:
        wb = collective_wire(c, axis_sizes, outer_axes)
        inner += wb.inner
        outer += wb.outer
    return WireBytes(inner=inner, outer=outer)
