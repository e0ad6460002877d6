"""Multi-pod dry run: one step of every (arch x shape x mesh) cell on an
analytic world, with no device (the counterpart of `repro.launch.dryrun`).

The reference lowers and compiles each cell for 512 placeholder devices
of its production meshes and reads XLA's memory and cost analyses and the
collectives of the optimised HLO. No compile step stands in for that
here. The port RUNS the cell's step, once, at rank 0 of an analytic world
(`analysis.trace.analytic_world`: the `fake` process-group backend, the
reference's single (data 16, model 16) or multi (pod 2, data 16, model
16) geometry built by `launch.mesh.make_host_mesh`), on fake tensors
(`FakeTensorMode`: shapes and dtypes, no storage, no arithmetic). The
state (or the params and the cache) are each rank's blocks by the
logical-axis rules (`sharding`), the step is the port's own: the mesh
trainer's `make_train_step(..., mesh)`, or the family's `mesh_prefill` /
`mesh_decode_step` on a `ServeMesh` (the serving mesh holds `data` and
`model`: with two pods each pod serves its share of the batch on its own
(data, model) block of the mesh, the reference's rules putting no
parameter over `pod`). Per cell it records:

  - memory: `argument_size_in_bytes`, the bytes of the storages the
    step is given: the state (or params, and decode's cache), whose
    bytes must equal `sharding.tree_nbytes` of its defs by the rules
    (else the cell is an error), and the batch as the step takes it
    (the mesh trainer: the global batch at every rank, which it slices
    itself, where the reference's step takes its block; prefill and
    decode: this rank's rows); the outputs' bytes (`alias` where they
    are the arguments' own storage, which the port updates in place);
    and `peak_memory_in_bytes`, the most bytes of live storage at any point
    of the step, counted over the fake tensors' storages. Prefill's
    attention counts the `flash_attention` kernel's footprint (its
    custom op's fake implementation: the output alone), not the S x S
    scores of the kernel's plain version. The peak leaves out what the
    card adds: the caching allocator's rounding (512 B blocks, 2 MiB
    segments), NCCL's buffers and cuBLAS' workspace. `card_share` is the
    peak over the H100's 80 GB;
  - cost: `flops` from `torch.utils.flop_counter.FlopCounterMode` (the
    attention kernel's by its formula, `kernels.flash_attention.flops`:
    the pairs the causal mask lets through), and
    `bytes_accessed`, the sum over every operation of its inputs' and
    outputs' bytes (views excluded): an unfused upper count, where XLA's
    counts fused kernels;
  - the collective schedule, recorded at the `torch.distributed` calls
    (`analysis.trace.Recorder`) and named as the reference's HLO ops
    (`all-gather`, `all-reduce`, `reduce-scatter`, `all-to-all`,
    `collective-permute`), each with `op`, `dtype`, `elems`, `bytes` (of
    the result) and `group_size`, and their `collective_summary`.

`lower_s` is the time to lay out the inputs and build the step,
`compile_s` 0 (nothing compiles), `step_s` the fake step's.

A cell whose step fails (an operation that needs the data, which fake
tensors do not have, or a layout the port refuses) writes `status:
"error"` with the reason, never zeros.

Usage:
  python -m repro_torch.launch.dryrun --cell granite-8b:train_4k:single
  python -m repro_torch.launch.dryrun --all --out results/dryrun
  python -m repro_torch.launch.dryrun --strategies --out ""
The sweep spawns one subprocess per cell; each cell writes
<out>/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time
import weakref

CELLS_MESHES = ("single", "multi")
GEOMETRY = {"single": {"data": 16, "model": 16},
            "multi": {"pod": 2, "data": 16, "model": 16}}
HLO_OP = {"all_gather": "all-gather", "psum": "all-reduce",
          "pmax": "all-reduce", "pmin": "all-reduce",
          "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
          "ppermute": "collective-permute"}
HLO_DTYPE = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
             "float64": "f64", "int32": "s32", "int64": "s64", "int16": "s16",
             "int8": "s8", "uint8": "u8", "bool": "pred"}
NOT_COUNTED = ("the caching allocator's rounding (512 B blocks, 2 MiB "
               "segments), NCCL's buffers, cuBLAS' workspace")
SRC = pathlib.Path(__file__).resolve().parents[2]


def run_strategy_wire(global_batch: int = 1 << 24, k: int = 64,
                      feature_space: int = 1 << 30) -> list:
    """Two-tier wire report for every registered distribution strategy on
    the reference's production geometries (analytic).

    Per (mesh, strategy): bytes/rank/step on the fast tier (inner: NVLink
    inside a host) and across pods (outer: the network between hosts),
    from each strategy's own `bytes_per_device` model at the paper's
    full-batch regime, plus the autotuner's wire-cost ranking (each
    tier's bytes charged at the H100 data sheet's link speed,
    `api.autotune`): the per-mesh winner, what
    `DPMRConfig.distribution="auto"` would pick, is marked `*`.
    """
    from repro_torch.api import autotune
    from repro_torch.api.strategies import StrategyContext
    from repro_torch.configs.base import DPMRConfig
    from repro_torch.core import dpmr

    cfg = DPMRConfig(num_features=feature_space, max_features_per_sample=k)
    rows = []
    # the reference's production geometry: single (16,16); multi (2,16,16)
    for mesh_kind, p, po in (("single", 256, 1), ("multi", 512, 2)):
        cap = dpmr.capacity_for_shards(cfg, global_batch // p, p)
        ctx = StrategyContext(num_shards=p, block_size=-(-feature_space // p),
                              capacity=cap, outer_shards=po,
                              topk_frac=cfg.topk_frac)
        ranked = autotune.score_strategies(ctx)
        winner = ranked[0].name
        for rank, s in enumerate(ranked, start=1):
            rows.append({"mesh": mesh_kind, "strategy": s.name,
                         "shards": p, "pods": po, "capacity": cap,
                         "inner_bytes": int(s.wire.inner),
                         "outer_bytes": int(s.wire.outer),
                         "total_bytes": int(s.wire.total),
                         "cost_us": s.cost_s * 1e6, "rank": rank,
                         "lossy": s.lossy, "chosen": s.name == winner})
    print(f"{'mesh':>7s} {'strategy':>18s} {'inner B/rank':>12s} "
          f"{'outer B/rank':>12s} {'total':>12s} {'cost us':>9s} "
          f"{'rank':>4s}")
    for r in rows:
        mark = " *" if r["chosen"] else ("  " if not r["lossy"] else " ~")
        print(f"{r['mesh']:>7s} {r['strategy']:>18s} "
              f"{r['inner_bytes']:>12.3e} {r['outer_bytes']:>12.3e} "
              f"{r['total_bytes']:>12.3e} {r['cost_us']:>9.1f} "
              f"{r['rank']:>4d}{mark}")
    print("  * = autotuner's pick (distribution=\"auto\"); "
          "~ = lossy (error-feedback carry)")
    return rows


def _probe_config(cfg, n: int):
    """Reduced-DEPTH same-width config with n 'units' + the real unit count.

    A unit is whatever repeats: a layer (dense/moe/vlm), an enc+dec layer
    pair (whisper), a mamba group + shared block (zamba), an mLSTM+sLSTM
    pair (xlstm). Costs are affine in units, so two probes extrapolate
    exactly (the port's layers are a Python loop: nothing hides in a
    loop body the counters cannot see).
    """
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, num_layers=n, encoder_layers=n), \
            cfg.num_layers
    if cfg.family == "hybrid":
        every = max(cfg.attn_every, 1)
        return dataclasses.replace(cfg, num_layers=n * every), \
            cfg.num_layers // every
    if cfg.family == "ssm":
        pair = max(cfg.slstm_every, 1)
        return dataclasses.replace(cfg, num_layers=n * pair), \
            cfg.num_layers // pair
    return dataclasses.replace(cfg, num_layers=n), cfg.num_layers


def _parse_overrides(s: str) -> dict:
    """'attn_mode=cp,microbatches=4' -> dict with typed values."""
    out = {}
    if not s:
        return out
    for kv in s.split(","):
        k, v = kv.split("=")
        if v in ("True", "False"):
            out[k] = v == "True"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


# ---------------------------------------------------------------------------
# counting a step on fake tensors
# ---------------------------------------------------------------------------


def _leaves(x) -> list:
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, torch.nn.Module):
        return list(x.parameters())
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def _cost_mode():
    """A dispatch mode that counts, over the operations run under it, the
    peak of live storage bytes and the bytes each operation reads and
    writes (views excluded)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class CostCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.live = 0
            self.peak = 0
            self.bytes_accessed = 0
            self.ops = 0
            self._seen: dict = {}

        def add(self, t) -> None:
            """Count `t`'s storage as live until it is freed."""
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                return
            nb = st.nbytes()
            self._seen[key] = weakref.finalize(st, self._free, key, nb)
            self.live += nb
            self.peak = max(self.peak, self.live)

        def _free(self, key, nb) -> None:
            self._seen.pop(key, None)
            self.live -= nb

        def storages(self, tensors) -> set:
            return {id(t.untyped_storage()) for t in tensors}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            self.ops += 1
            outs = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
            if not getattr(func, "is_view", False):
                ins = [t for t in _leaves([args, list(kwargs.values())])
                       if isinstance(t, torch.Tensor)]
                self.bytes_accessed += sum(
                    t.numel() * t.element_size() for t in ins + outs)
            for t in outs:
                self.add(t)
            return out

    return CostCount()


def _flop_counter():
    """A `FlopCounterMode` that counts the `flash_attention` kernel's
    custom op by the kernel's formula (registering the op first)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import flash_attention as fa

    fa.fake_op()
    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.repro_torch.flash_attention: fa.flops})


def _collective_rows(ops, axis_sizes) -> list:
    rows = []
    for c in ops:
        n = 1
        for a in c.axes:
            n *= int(axis_sizes.get(a, 1))
        elems = sum(_numel(s) for s in c.out_shapes)
        rows.append({"op": HLO_OP.get(c.prim, c.prim),
                     "dtype": HLO_DTYPE.get(c.out_dtypes[0],
                                            c.out_dtypes[0])
                     if c.out_dtypes else "",
                     "elems": elems, "bytes": c.out_bytes,
                     "group_size": n, "axes": list(c.axes)})
    return rows


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def collective_summary(rows) -> dict:
    """{op: {count, bytes}} of a cell's collective rows."""
    agg: dict = {}
    for c in rows:
        a = agg.setdefault(c["op"], {"count": 0, "bytes": 0})
        a["count"] += 1
        a["bytes"] += c["bytes"]
    return agg


def _serve_defs(spec, cfg):
    """The serving model's parameter LeafDefs: the training model's
    logical axes, each leaf in the dtype the serving model stores it."""
    from repro_torch import sharding as shd

    model = spec.model(cfg, device="meta", train=False)
    pd = shd.param_defs(spec, cfg)
    return {n: pd[n]._replace(dtype=str(p.dtype).removeprefix("torch."))
            for n, p in model.named_parameters()}


def _decode_places(sm, defs) -> None:
    """The places a family's decode step reads from `sm` (prefill sets
    them): its K/V leaves, whisper's cross K/V, the convolutions' taps."""
    if "k" in defs:
        sm.place("kv", defs["k"])
    if "xk" in defs:
        sm.place("xkv", defs["xk"])
    if "conv" in defs:
        sm.kv["conv"] = sm.block(defs["conv"])[3]
    for bd in defs.get("blocks", ()):
        if "mlstm" in bd:
            sm.kv["conv"] = sm.block(bd["mlstm"]["conv"])[2]


def dry_step(spec, shape, axis_sizes: dict, parallel, train_cfg=None, *,
             rules=None, collect: bool = True) -> dict:
    """One step of `shape`'s kind for `spec` (its `cfg`) at rank 0 of the
    analytic world of `axis_sizes`, on fake tensors: the record's
    memory, cost and collectives (see the module note)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import sharding as shd
    from repro_torch.analysis.trace import Recorder, analytic_world
    from repro_torch.configs.base import H100_HBM_BYTES, TrainConfig
    from repro_torch.core.fsdp import ParamLayout
    from repro_torch.models import layers, registry
    from repro_torch.models import parallel as par
    from repro_torch.train import trainer

    cfg = spec.cfg
    tc = train_cfg or TrainConfig()
    t0 = time.time()
    bdefs = registry.batch_defs(spec, shape)

    def fake(d):
        return torch.empty(d.shape, dtype=getattr(torch, d.dtype))

    with analytic_world(axis_sizes) as world:
        mesh = world.mesh
        pods = axis_sizes.get("pod", 1)
        if shape.kind == "train":
            sdefs = trainer.state_defs(spec, cfg, tc, parallel)
            laid_bytes = shd.tree_nbytes(sdefs, axis_sizes, rules)
            layout = ParamLayout(spec, cfg, mesh, rules)
        else:
            smesh = mesh["data", "model"] if pods > 1 else mesh
            layout = ParamLayout(spec, cfg, smesh, rules)
            # a pod's share of the batch (the whole where pods do not
            # divide it, as the rules replicate such a dim)
            rows = shape.global_batch // pods \
                if shape.global_batch % pods == 0 else shape.global_batch
            sm = par.ServeMesh(layout, rows)
            pdefs = _serve_defs(spec, cfg)
            laid_bytes = shd.tree_nbytes(pdefs, axis_sizes, rules)
            if shape.kind == "decode":
                laid_bytes += shd.tree_nbytes(bdefs["cache"], axis_sizes,
                                              rules)
        rec = Recorder(mesh, tuple(axis_sizes))
        # a tensor kept across calls would mix a real (or another run's
        # fake) tensor into this run's fake ones
        layers.sinusoidal_positions.cache_clear()
        with FakeTensorMode():
            if shape.kind == "train":
                model = trainer.sharded_model(
                    spec, cfg, mesh, "cpu", lambda name, s: torch.empty(s),
                    layout=layout)
                state = trainer._with_moments(model, cfg, tc, parallel,
                                              mesh)
                # the mesh trainer takes the global batch at every rank
                # and slices its rows itself
                batch = {k: fake(d) for k, d in bdefs.items()}
                step = trainer.make_train_step(spec, cfg, tc, parallel, mesh)
                args = (state, batch)
                laid, given = state, batch
            else:
                model = trainer.sharded_model(
                    spec, cfg, layout.mesh, "cpu",
                    lambda name, s: torch.empty(s), layout=layout,
                    train=False)
                view = par.ShardedView(model, layout)
                if shape.kind == "prefill":
                    # mesh_prefill takes this rank's rows
                    batch = {k: fake(d._replace(shape=(sm.rows,
                                                       *d.shape[1:])))
                             for k, d in bdefs.items()}
                    args = (view, batch, cfg, sm)
                    laid, given = model, batch
                    step = spec.mesh_prefill
                else:
                    defs = spec.cache_defs(cfg, rows, shape.seq_len)
                    cache = sm.new_cache(defs, "cpu")
                    _decode_places(sm, defs)
                    tokens = torch.zeros((sm.rows, 1), dtype=torch.int32)
                    args = (view, cache, tokens, cfg, sm)
                    laid, given = (model, cache), tokens
                    step = spec.mesh_decode_step
            cost = _cost_mode()
            for t in _leaves(laid):
                cost.add(t)
            if cost.live != laid_bytes:
                raise ValueError(
                    f"the step is given {cost.live} B of state, the "
                    f"layout rules give {laid_bytes} B")
            arg_tensors = _leaves([laid, given])
            for t in arg_tensors:
                cost.add(t)
            arg_bytes = cost.live
            flops = _flop_counter()
            t1 = time.time()
            with flops, cost, rec:
                out = step(*args)
            step_s = time.time() - t1
            outs = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
            arg_st = cost.storages(arg_tensors)
            out_bytes = alias = 0
            for st_id, nb in {id(t.untyped_storage()):
                              t.untyped_storage().nbytes()
                              for t in outs}.items():
                out_bytes += nb
                alias += nb if st_id in arg_st else 0
            total_flops = flops.get_total_flops()
        layers.sinusoidal_positions.cache_clear()
    peak = cost.peak
    rec_rows = _collective_rows(rec.ops, axis_sizes)
    out = {
        "status": "ok", "lower_s": round(t1 - t0, 1), "compile_s": 0.0,
        "step_s": round(step_s, 1), "ops": cost.ops,
        "memory_analysis": _mem_dict({
            "temp_size_in_bytes": peak - arg_bytes,
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": alias,
            "generated_code_size_in_bytes": 0,
            "peak_memory_in_bytes": peak}),
        "card_bytes": H100_HBM_BYTES,
        "card_share": peak / H100_HBM_BYTES,
        "not_counted": NOT_COUNTED,
        "flops": float(total_flops),
        "bytes_accessed": float(cost.bytes_accessed),
        "cost_keys": {"flops": float(total_flops),
                      "bytes accessed": float(cost.bytes_accessed)},
        "collective_summary": collective_summary(rec_rows),
    }
    if collect:
        out["collectives"] = rec_rows
    return out


def _mem_dict(mem) -> dict:
    if mem is None:
        return {}
    out = {}
    for k in ("temp_size_in_bytes", "argument_size_in_bytes",
              "output_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes", "peak_memory_in_bytes"):
        v = mem.get(k)
        if v is not None:
            out[k] = int(v)
    return out


def _rules(ovr: dict):
    """The override dict's layout rules (`replicate_vocab`), popped."""
    from repro_torch import sharding as shd

    if ovr.pop("batch_dm", False):
        raise ValueError("batch_dm has no counterpart: the port's mesh "
                         "trainer shards the batch over pod and data only")
    if ovr.pop("replicate_vocab", False):
        return {**shd.DEFAULT_RULES, "vocab": ()}
    return None


def run_probe(arch: str, shape_name: str, overrides: str = "") -> dict:
    """1-unit and 2-unit cost probes on the single-pod geometry."""
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import registry

    spec0 = registry.get_spec(arch)
    shape = SHAPES[shape_name]
    if shape_name not in spec0.supported_shapes:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": spec0.skip_reason}

    # probe at MICROBATCH size: the real step is `micro` sequential passes,
    # so step cost = micro x extrapolated probe cost
    ovr = _parse_overrides(overrides)
    rules = _rules(ovr)
    micro = ovr.pop("microbatches", None) or (
        _parallel_for(arch, shape_name, "single").microbatches
        if shape.kind == "train" else 1)
    if shape.kind == "train" and shape.global_batch % micro == 0:
        shape = dataclasses.replace(
            shape, global_batch=shape.global_batch // micro)
    out = {"arch": arch, "shape": shape_name, "status": "ok",
           "kind": shape.kind, "microbatches": micro,
           "overrides": overrides}
    for n in (1, 2):
        pcfg, units = _probe_config(spec0.cfg, n)
        spec = dataclasses.replace(spec0, cfg=pcfg)
        parallel = ParallelConfig(microbatches=1, remat="full",
                                  scan_layers=False, **ovr)
        rec = dry_step(spec, shape, GEOMETRY["single"], parallel,
                       rules=rules, collect=False)
        out[f"probe{n}"] = {
            "flops": rec["flops"],
            "bytes_accessed": rec["bytes_accessed"],
            "transcendentals": 0.0,
            "collective_summary": rec["collective_summary"],
        }
        out["units"] = units
    print(json.dumps(out, indent=1))
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             collect_hlo: bool = True, overrides: str = "", cfg=None,
             shape=None) -> dict:
    """One cell at the reference's `mesh_kind` geometry. `cfg` and `shape`
    cut it (another config of `arch`, another `ShapeConfig` of the
    shape's kind)."""
    from repro_torch.configs import SHAPES, TrainConfig
    from repro_torch.models import registry

    spec = registry.get_spec(arch)
    if cfg is not None:
        spec = dataclasses.replace(spec, cfg=cfg)
    shape = shape or SHAPES[shape_name]
    if shape_name not in spec.supported_shapes:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": spec.skip_reason}
    parallel = _parallel_for(arch, shape_name, mesh_kind)
    ovr = _parse_overrides(overrides)
    rules = _rules(ovr)
    if ovr:
        parallel = dataclasses.replace(parallel, **ovr)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           **dry_step(spec, shape, GEOMETRY[mesh_kind], parallel,
                      TrainConfig(), rules=rules, collect=collect_hlo)}
    print(json.dumps({k: v for k, v in rec.items() if k != "collectives"},
                     indent=1))
    return rec


def _parallel_for(arch: str, shape_name: str, mesh_kind: str):
    """Per-cell parallel config: microbatching keeps activations in HBM."""
    from repro_torch.configs.base import ParallelConfig

    micro = {
        ("llama3-405b", "train_4k"): 16,
        ("mixtral-8x22b", "train_4k"): 8,
        ("chameleon-34b", "train_4k"): 4,
        ("granite-34b", "train_4k"): 4,
        ("phi3.5-moe-42b-a6.6b", "train_4k"): 4,
        ("granite-8b", "train_4k"): 2,
        ("yi-6b", "train_4k"): 2,
        ("zamba2-2.7b", "train_4k"): 8,   # no SP inside SSM blocks: rely on
        ("xlstm-125m", "train_4k"): 2,    # grad accumulation for activations
        ("whisper-small", "train_4k"): 2,
    }.get((arch, shape_name), 1)
    accum = "bfloat16" if arch in ("llama3-405b", "mixtral-8x22b") else \
        "float32"
    return ParallelConfig(microbatches=micro, remat="full",
                          accum_dtype=accum)


def all_cells():
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.models import registry

    cells = []
    for arch in ARCH_IDS:
        spec = registry.get_spec(arch)
        for shape in SHAPES:
            for mk in CELLS_MESHES:
                cells.append((arch, shape, mk,
                              shape in spec.supported_shapes))
    return cells


def _run_subprocess(argv, timeout):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")])}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *argv], capture_output=True, text=True,
                          timeout=timeout, env=env)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--cell", help="arch:shape:mesh  (runs in-process)")
    ap.add_argument("--strategies", action="store_true",
                    help="print the two-tier (inner/outer) wire model of "
                         "every registered distribution strategy on the "
                         "production mesh geometries")
    ap.add_argument("--probe", action="store_true",
                    help="run the 1/2-unit cost probes instead")
    ap.add_argument("--pconf", default="",
                    help="ParallelConfig overrides, e.g. attn_mode=cp")
    ap.add_argument("--tag", default="",
                    help="suffix for the probe result filename")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="both", choices=("single", "multi",
                                                       "both"))
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--force", action="store_true",
                    help="recompute cells that already have results")
    ap.add_argument("--no-hlo", action="store_true",
                    help="leave the per-call collective list out of the "
                         "record (the summary stays)")
    args = ap.parse_args(argv)

    if args.strategies:
        rows = run_strategy_wire()
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "strategy_wire.json"),
                      "w") as f:
                json.dump(rows, f, indent=1)
        return

    if args.cell:
        parts = args.cell.split(":")
        arch, shape = parts[0], parts[1]
        if args.probe:
            rec = run_probe(arch, shape, overrides=args.pconf)
            suffix = "probe" + (f"_{args.tag}" if args.tag else "")
        else:
            mk = parts[2]
            rec = run_cell(arch, shape, mk, collect_hlo=not args.no_hlo,
                           overrides=args.pconf)
            suffix = mk + (f"_{args.tag}" if args.tag else "")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            safe = f"{arch}__{shape}__{suffix}".replace("/", "_")
            with open(os.path.join(args.out, safe + ".json"), "w") as f:
                json.dump(rec, f)
        return

    if not args.all:
        ap.error("give --cell, --strategies or --all")
    os.makedirs(args.out, exist_ok=True)
    from repro_torch.models import registry

    if args.probe:
        seen = set()
        for arch, shape, _, supported in all_cells():
            if (arch, shape) in seen:
                continue
            seen.add((arch, shape))
            safe = f"{arch}__{shape}__probe".replace("/", "_")
            path = os.path.join(args.out, safe + ".json")
            if os.path.exists(path) and not args.force:
                print(f"[skip existing] {safe}")
                continue
            if not supported:
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape,
                               "status": "skipped",
                               "reason": registry.get_spec(arch)
                               .skip_reason}, f)
                continue
            print(f"[probe] {safe}", flush=True)
            t0 = time.time()
            proc = _run_subprocess(["--cell", f"{arch}:{shape}", "--probe",
                                    "--out", args.out], args.timeout)
            if proc.returncode != 0:
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape,
                               "status": "error",
                               "stderr": proc.stderr[-4000:]}, f)
                print(f"[FAIL {time.time()-t0:.0f}s] {safe}\n"
                      f"{proc.stderr[-1500:]}")
            else:
                print(f"[ok {time.time()-t0:.0f}s] {safe}")
        return
    meshes = CELLS_MESHES if args.mesh == "both" else (args.mesh,)
    for arch, shape, mk, supported in all_cells():
        if mk not in meshes:
            continue
        safe = f"{arch}__{shape}__{mk}".replace("/", "_")
        path = os.path.join(args.out, safe + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[skip existing] {safe}")
            continue
        if not supported:
            with open(path, "w") as f:
                json.dump({"arch": arch, "shape": shape, "mesh": mk,
                           "status": "skipped",
                           "reason": registry.get_spec(arch).skip_reason},
                          f)
            print(f"[skipped-by-design] {safe}")
            continue
        print(f"[run] {safe}", flush=True)
        t0 = time.time()
        proc = _run_subprocess(["--cell", f"{arch}:{shape}:{mk}", "--out",
                                args.out]
                               + (["--no-hlo"] if args.no_hlo else []),
                               args.timeout)
        if proc.returncode != 0:
            with open(path, "w") as f:
                json.dump({"arch": arch, "shape": shape, "mesh": mk,
                           "status": "error",
                           "stderr": proc.stderr[-4000:]}, f)
            print(f"[FAIL {time.time()-t0:.0f}s] {safe}\n"
                  f"{proc.stderr[-2000:]}")
        else:
            print(f"[ok {time.time()-t0:.0f}s] {safe}")


if __name__ == "__main__":
    main()
