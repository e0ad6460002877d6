"""Recording a strategy's collectives: the counterpart of
`repro.analysis.trace`.

The reference traces a strategy's `distribute` / `reduce` to a jaxpr
under an analytic axis environment and reads each collective equation's
axes, operand shapes and dtypes. Torch has no jaxpr: the port RUNS the
strategy and records each collective as it is issued. Every
`torch.distributed` call reaches the dispatcher as a `torch.ops.c10d.*`
op that carries its tensors and its `ProcessGroup`; `Recorder`, a
`TorchDispatchMode`, sees each one, maps the group back to the mesh's
axes and keeps a `Collective` with the reference's primitive names:

  c10d op (the port's call)              prim
  alltoall_base_ (all_to_all_single)     all_to_all
  _allgather_base_                       all_gather
  (all_gather_into_tensor)
  _reduce_scatter_base_                  reduce_scatter
  (reduce_scatter_tensor)
  allreduce_ (all_reduce)                psum / pmax / pmin (its ReduceOp)
  send, recv_                            ppermute (axes: where this rank
                                         and its peer differ on the mesh)
  broadcast_, anything else              its own name (no wire model
                                         knows it: W-MODEL)

A group maps to axes by what it is: `world` is every axis of the mesh,
`inner` (`launch.mesh.process_groups`) the non-outer ones, `outer` the
pod axis, a `DeviceMesh` dim's group that dim; any other group by the
axes along which its ranks vary, when they form a whole sub-grid of the
mesh. A group that does neither is recorded as `"<prim>[grouped]"`, which
no wire model knows, so W-MODEL rejects it (the reference does the same
with `axis_index_groups`).

`analytic_world(axis_sizes)` replaces the reference's
`extend_axis_env_nd`: torch's `fake` process-group backend brings up a
world of any size in one process at rank 0, and the mesh of
`launch.mesh.make_host_mesh` is built on it. It touches no device. The
fake backend moves nothing, so the recorder fills each result as a world
of IDENTICAL ranks would: an all_to_all's rows are each this rank's own
row, an all_gather repeats the input, a sum multiplies it by the group's
size. Ids then stay in range, and two traces of one strategy record the
same collectives.

`trace_strategy` gives the reference's `StrategyTrace` from real tensors
on the CPU at the geometry's block and capacity: the collectives of
`distribute`, of the carry-advancing `reduce` (SGD) and, for a stateful
strategy, of the frozen-carry accumulate path. The port's `reduce` may
update the carry in place on the SGD path, so identity alone proves
nothing about the accumulate path: there `carry_passthrough` is "the
returned carry IS the input tensor, and its `_version` did not move"
(no in-place write touched it).
"""
from __future__ import annotations

import contextlib
from collections.abc import Iterator, Sequence
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import mesh as mesh_lib

# collectives the wire model understands (see wire.py); anything else is
# still RECORDED so the auditor can reject it as unmodeled instead of
# silently under-counting
KNOWN_COLLECTIVES = frozenset({
    "all_to_all", "all_gather", "reduce_scatter", "psum", "pmax", "pmin",
    "ppermute",
})

# the c10d ops the port issues -> (prim, index of the input arg, index of
# the output arg); None: the op works in place on its first arg (a list
# of tensors)
_C10D = {
    "alltoall_base_": ("all_to_all", 1, 0),
    "_allgather_base_": ("all_gather", 1, 0),
    "_reduce_scatter_base_": ("reduce_scatter", 1, 0),
    "allreduce_": ("psum", None, None),
    "broadcast_": ("broadcast", None, None),
    "send": ("ppermute", None, None),
    "recv_": ("ppermute", None, None),
}
_REDUCE_PRIM = {int(dist.ReduceOp.SUM): "psum", int(dist.ReduceOp.MAX):
                "pmax", int(dist.ReduceOp.MIN): "pmin"}


class Collective(NamedTuple):
    """One recorded collective call."""

    prim: str                      # primitive name ("all_to_all", ...)
    axes: tuple[str, ...]          # mesh axes the collective runs over
    shapes: tuple[tuple[int, ...], ...]   # per-operand (per-rank) shapes
    dtypes: tuple[str, ...]        # per-operand dtypes
    out_shapes: tuple[tuple[int, ...], ...]
    out_dtypes: tuple[str, ...]

    @property
    def signature(self) -> tuple:
        """Hashable identity used for signature pinning / set comparison."""
        return (self.prim, self.axes, self.shapes, self.dtypes)

    @property
    def in_bytes(self) -> int:
        """Total bytes of the per-rank operand buffers."""
        return sum(_nbytes(s, d) for s, d in zip(self.shapes, self.dtypes,
                                                 strict=True))

    @property
    def out_bytes(self) -> int:
        return sum(_nbytes(s, d) for s, d in zip(self.out_shapes,
                                                 self.out_dtypes,
                                                 strict=True))

    def describe(self) -> str:
        ops = ", ".join(f"{d}{list(s)}" for s, d in
                        zip(self.shapes, self.dtypes, strict=True))
        return f"{self.prim}[{','.join(self.axes) or '·'}]({ops})"


def _nbytes(shape: tuple[int, ...], dtype: str) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * getattr(torch, dtype).itemsize


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _tensors(x) -> list[torch.Tensor]:
    """The tensors of an op argument: a tensor, or nested lists of them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


class Recorder(TorchDispatchMode):
    """Records every `torch.distributed` collective issued while it is
    active, as `Collective`s over the axes of `mesh`.

    `axes` names the axes to report, in mesh order (default: the mesh's
    dims); a dim of size 1 that `axes` leaves out is dropped from every
    collective's axes, as a mesh without it would have none. `fill=True`
    fills each result as a world of identical ranks would (the `fake`
    backend's results are left unset). `records` holds (scope, Collective)
    pairs, the scope being the label of the innermost `scope()` open
    when the call was issued (None outside any); `ops` the collectives.
    """

    def __init__(self, mesh, axes: Sequence[str] | None = None,
                 fill: bool = False):
        super().__init__()
        names = tuple(mesh.mesh_dim_names)
        sizes = dict(zip(names, (int(s) for s in mesh.shape), strict=True))
        axes = names if axes is None else tuple(axes)
        for a in names:
            if a not in axes and sizes[a] != 1:
                raise ValueError(f"mesh dim {a!r} of size {sizes[a]} is "
                                 f"not among the reported axes {axes}")
        self.mesh, self.fill = mesh, fill
        self.axes = tuple(a for a in names if a in axes)
        self._sizes = sizes
        self._names = names
        groups = mesh_lib.process_groups(mesh)
        outer = tuple(a for a in self.axes if a in mesh_lib.OUTER_AXES)
        known = {groups.world.group_name: self.axes,
                 groups.inner.group_name: tuple(
                     a for a in self.axes if a not in outer)}
        if groups.outer is not None:
            known[groups.outer.group_name] = outer
        for d in names:
            known.setdefault(mesh.get_group(d).group_name,
                             (d,) if d in self.axes else ())
        self._known = known
        self._scope: str | None = None
        self.records: list[tuple[str | None, Collective]] = []

    @property
    def ops(self) -> list[Collective]:
        return [c for _, c in self.records]

    def scoped(self, label: str) -> list[Collective]:
        """The collectives issued inside `scope(label)`."""
        return [c for s, c in self.records if s == label]

    def clear(self) -> None:
        self.records.clear()

    @contextlib.contextmanager
    def scope(self, label: str) -> Iterator[None]:
        """Label every collective issued inside the block."""
        prev, self._scope = self._scope, label
        try:
            yield
        finally:
            self._scope = prev

    # -- mapping a group to axes --------------------------------------------

    def _coord(self, rank: int) -> tuple[int, ...]:
        out = []
        for d in reversed(self._names):
            out.append(rank % self._sizes[d])
            rank //= self._sizes[d]
        return tuple(reversed(out))

    def _group_axes(self, pg) -> tuple[str, ...] | None:
        """The axes of group `pg`, or None when its ranks are no whole
        sub-grid of the mesh."""
        axes = self._known.get(pg.group_name)
        if axes is not None:
            return axes
        ranks = dist.get_process_group_ranks(pg)
        coords = [self._coord(r) for r in ranks]
        vary = [i for i, d in enumerate(self._names)
                if len({c[i] for c in coords}) > 1]
        size = 1
        for i in vary:
            size *= self._sizes[self._names[i]]
        if size != len(set(ranks)) or any(
                self._names[i] not in self.axes for i in vary):
            return None
        axes = tuple(self._names[i] for i in vary)
        self._known[pg.group_name] = axes
        return axes

    def _peer_axes(self, pg, peer: int) -> tuple[str, ...]:
        """The axes along which this rank and group rank `peer` differ."""
        me = self._coord(dist.get_global_rank(pg, pg.rank()))
        other = self._coord(dist.get_global_rank(pg, peer))
        return tuple(d for d, a, b in zip(self._names, me, other,
                                          strict=True) if a != b)

    # -- the dispatch hook --------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            name = func.__name__.split(".")[0]
            self._record(name, args)
        return out

    def _record(self, name: str, args) -> None:
        prim, i_in, i_out = _C10D.get(name, (f"c10d.{name}", None, None))
        pg = next((dist.ProcessGroup.unbox(a) for a in args
                   if isinstance(a, torch.ScriptObject)
                   and a._type().name() == "ProcessGroup"), None)
        if i_in is None:
            ins = outs = _tensors(args[0])
        else:
            ins, outs = _tensors(args[i_in]), _tensors(args[i_out])
        if name == "allreduce_":
            prim = _reduce_prim(args[2])
        if pg is None:
            axes = ()
        elif prim == "ppermute":
            axes = self._peer_axes(pg, int(args[2]))
        else:
            axes = self._group_axes(pg)
            if axes is None:
                axes, prim = (), prim + "[grouped]"
        self.records.append((self._scope, Collective(
            prim=prim, axes=axes,
            shapes=tuple(tuple(t.shape) for t in ins),
            dtypes=tuple(_dtype_name(t) for t in ins),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            out_dtypes=tuple(_dtype_name(t) for t in outs))))
        if self.fill and pg is not None:
            _fill_identical(name, prim, pg, ins, outs)


def _reduce_prim(op) -> str:
    """psum / pmax / pmin of a c10d ReduceOp script object."""
    code = int(op.op())
    return _REDUCE_PRIM.get(code, f"preduce{code}")


@torch.no_grad()
def _fill_identical(name, prim, pg, ins, outs) -> None:
    """Set the results of a collective as a world of identical ranks
    would deliver them to this rank."""
    g, me = pg.size(), pg.rank()
    if name == "alltoall_base_":
        outs[0].reshape(g, -1).copy_(ins[0].reshape(g, -1)[me])
    elif name == "_allgather_base_":
        outs[0].reshape(g, -1).copy_(ins[0].reshape(1, -1))
    elif name == "_reduce_scatter_base_":
        outs[0].copy_(ins[0].reshape(g, -1)[me].reshape(outs[0].shape) * g)
    elif prim == "psum":
        for t in ins:
            t.mul_(g)
    elif name == "recv_":
        for t in outs:
            t.zero_()


# ---------------------------------------------------------------------------
# the analytic world
# ---------------------------------------------------------------------------


class AnalyticWorld(NamedTuple):
    """A live fake world: its mesh, this rank's groups, the axis sizes."""

    mesh: object                   # DeviceMesh over the fake backend
    groups: mesh_lib.Groups
    axis_sizes: dict

    def recorder(self) -> Recorder:
        return Recorder(self.mesh, tuple(self.axis_sizes), fill=True)


@contextlib.contextmanager
def analytic_world(axis_sizes: dict) -> Iterator[AnalyticWorld]:
    """A world of prod(axis_sizes) ranks in this process at rank 0 on
    torch's `fake` backend, with the mesh of `launch.mesh.make_host_mesh`
    (`axis_sizes` names `pod`, `data`, `model`, in that order). The
    default group is destroyed on exit; raises when one already
    exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group already exists: an "
                           "analytic world needs the process to itself")
    order = [a for a in ("pod", "data", "model") if a in axis_sizes]
    if list(axis_sizes) != order or axis_sizes.get("pod", 2) < 2:
        raise ValueError(f"axis sizes must name pod (of 2 or more), data "
                         f"and model, in that order: {axis_sizes}")
    sizes = {a: int(axis_sizes.get(a, 1)) for a in ("pod", "data", "model")}
    world = sizes["pod"] * sizes["data"] * sizes["model"]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = mesh_lib.make_host_mesh(data=sizes["data"],
                                       model=sizes["model"],
                                       pods=sizes["pod"])
        yield AnalyticWorld(mesh, mesh_lib.process_groups(mesh),
                            dict(axis_sizes))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# tracing a strategy
# ---------------------------------------------------------------------------


class StrategyTrace(NamedTuple):
    """Everything the contract rules need to know about one strategy on one
    analytic geometry."""

    distribute: tuple[Collective, ...]    # forward (theta shuffle) path
    reduce: tuple[Collective, ...]        # carry-advancing reduce (SGD path)
    accumulate: tuple[Collective, ...] | None  # frozen-carry path (stateful)
    stateful: bool                        # init_carry returned a tensor
    carry_1d_f32: bool | None             # carry is 1-D float32
    reduce_pair: bool | None              # reduce returned (grad, carry)
    carry_aval_preserved: bool | None     # returned carry shape/dtype ==
    #                                       the input's
    carry_passthrough: bool | None        # accumulate path returns the
    #                                       carry tensor itself, unwritten
    wire_dtypes_accumulate: tuple[str, ...] | None  # dtypes on the wire
    #                                       on the accumulate path
    fwd_overflow: bool = False            # distribute's fwd dict carries a
    #                                       scalar int32 "overflow"


def batch_elems(ctx) -> int:
    """Per-rank flat feature-slot count used for tracing.

    Large enough that hier_a2a's inner capacity min(n, cap*Po) never
    clamps — the wire models are stated for the unclamped regime."""
    return max(256, 2 * ctx.capacity * max(ctx.outer_shards, 1))


def _inputs(ctx, n: int):
    """Deterministic cold block, ids (every 8th a padding -1) and
    gradients of a trace."""
    f = ctx.num_shards * ctx.block_size
    k = torch.arange(n, dtype=torch.int64)
    ids = torch.where(k % 8 == 7, -1, (k * 2654435761) % f).to(torch.int32)
    cold = torch.linspace(-1.0, 1.0, ctx.block_size, dtype=torch.float32)
    grads = torch.linspace(-0.5, 0.5, n, dtype=torch.float32)
    return cold, ids, grads


def _is_overflow(fwd) -> bool:
    ov = fwd.get("overflow") if isinstance(fwd, dict) else None
    return (isinstance(ov, torch.Tensor) and ov.dim() == 0
            and ov.dtype == torch.int32)


def trace_strategy(strategy, ctx, axis_sizes: dict, n: int | None = None,
                   world: AnalyticWorld | None = None) -> StrategyTrace:
    """Record `strategy` on the analytic geometry (`ctx`, `axis_sizes`).

    `ctx` gives the counts (`num_shards`, `block_size`, `capacity`,
    `outer_shards`, `topk_frac`); the rank and the groups come from the
    analytic world of `axis_sizes` (`world`, else one made for this
    call). `n` is the flat per-rank feature-slot count (ids/grads
    length), defaulting to `batch_elems(ctx)`.
    """
    if world is None:
        with analytic_world(axis_sizes) as w:
            return trace_strategy(strategy, ctx, axis_sizes, n, w)
    n = batch_elems(ctx) if n is None else n
    ctx = ctx._replace(rank=0, groups=world.groups)
    cold, ids, grads = _inputs(ctx, n)
    rec = world.recorder()

    with rec:
        _, fwd = strategy.distribute(ctx, cold, ids)
    dist_ops = tuple(rec.ops)
    fwd_overflow = _is_overflow(fwd)

    carry0 = strategy.init_carry(ctx, device="cpu")
    stateful = carry0 is not None

    def reduce_ops(carry=None, accumulating=False):
        rec.clear()
        f = fwd if carry is None else {**fwd, "carry": carry,
                                       "accumulate": accumulating}
        with rec:
            out = strategy.reduce(ctx, cold.clone(), grads.clone(), f)
        return tuple(rec.ops), out

    if not stateful:
        red, out = reduce_ops()
        return StrategyTrace(
            distribute=dist_ops, reduce=red, accumulate=None,
            stateful=False, carry_1d_f32=None,
            reduce_pair=isinstance(out, tuple), carry_aval_preserved=None,
            carry_passthrough=None, wire_dtypes_accumulate=None,
            fwd_overflow=fwd_overflow)

    carry_1d_f32 = carry0.dim() == 1 and carry0.dtype == torch.float32
    red, out = reduce_ops(carry0.clone(), False)
    reduce_pair = isinstance(out, tuple) and len(out) == 2
    preserved = None
    if reduce_pair:
        preserved = (isinstance(out[1], torch.Tensor)
                     and tuple(out[1].shape) == tuple(carry0.shape)
                     and out[1].dtype == carry0.dtype)
    frozen = carry0.clone()
    version = frozen._version
    acc, out = reduce_ops(frozen, True)
    passthrough = (isinstance(out, tuple) and len(out) == 2
                   and out[-1] is frozen and frozen._version == version)
    return StrategyTrace(
        distribute=dist_ops, reduce=red, accumulate=acc, stateful=True,
        carry_1d_f32=carry_1d_f32, reduce_pair=reduce_pair,
        carry_aval_preserved=preserved, carry_passthrough=passthrough,
        wire_dtypes_accumulate=tuple(sorted({d for c in acc
                                             for d in c.dtypes})),
        fwd_overflow=fwd_overflow)


@contextlib.contextmanager
def strategy_scope(recorder: Recorder, strategy,
                   label: str = "strategy") -> Iterator[None]:
    """Label the collectives of `strategy`'s own `distribute` and
    `reduce`, and its `reduce_rows` where it has one (`train_step`'s row
    path), through whatever calls them, e.g. a step built by
    `core.dpmr.make_step_fns`, with `label` in `recorder`: the instance's
    methods are wrapped for the block."""
    methods = [m for m in ("distribute", "reduce", "reduce_rows")
               if getattr(strategy, m, None) is not None]
    saved = {m: vars(strategy)[m] for m in methods if m in vars(strategy)}

    def wrap(fn):
        def scoped(*args, **kwargs):
            with recorder.scope(label):
                return fn(*args, **kwargs)
        return scoped

    for m in methods:
        setattr(strategy, m, wrap(getattr(strategy, m)))
    try:
        yield
    finally:
        for m in methods:
            delattr(strategy, m)
            if m in saved:
                setattr(strategy, m, saved[m])


def signature_multiset(ops: Sequence[Collective]) -> tuple:
    """Order-independent, hashable multiset of collective signatures."""
    return tuple(sorted(c.signature for c in ops))


def collect_collectives(fn, mesh, *args, axes: Sequence[str] | None = None,
                        fill: bool = False, **kwargs):
    """`fn(*args, **kwargs)` under a `Recorder` of `mesh`: returns (its
    result, the collectives it issued). The counterpart of the
    reference's `collect_collectives(trace_jaxpr(fn, ...))`; a jaxpr has
    no counterpart here, the call itself is the trace."""
    rec = Recorder(mesh, axes, fill=fill)
    with rec:
        out = fn(*args, **kwargs)
    return out, rec.ops
