"""The port's dry run (`repro_torch.launch.dryrun`) and the shape cells it
sweeps, against `repro.launch.dryrun`, `repro.configs.SHAPES` and
`repro.models.registry`, on the CPU.

- `SHAPES`, each arch's `supported_shapes` and `skip_reason`, and
  `batch_defs`' shapes, dtypes and logical axes for every supported
  shape of all ten arch ids equal the reference's.
- `_probe_config`, `_parse_overrides`, `_parallel_for` and `all_cells`
  equal the reference's; `run_strategy_wire`'s bytes, capacity, shards,
  pods and lossy columns equal the reference's wire models on the same
  geometries (the reference's own `run_strategy_wire` allocates its
  lossy strategies' 4 GiB carries to rank them, so its columns are
  recomputed here from the same calls without the allocation).
- Cells at a smoke config (one unit deep) on the reference's single
  (16, 16) and multi (2, 16, 16) geometries: a training cell of each
  family and yi-6b's prefill and decode cells run (`status: "ok"`),
  with argument bytes equal to the reference's shard arithmetic over
  the same defs (as `tests/test_torch_sharding.py` computes it; a
  training cell's batch whole, as the port's mesh trainer takes it), a
  collective schedule and a peak at least the arguments; a full-size
  cell and its probes through the command line write their JSON with
  the reference's keys.
"""
import contextlib
import dataclasses
import io
import json
import os
import types

import jax
import numpy as np
import pytest

from repro import sharding as jshd
from repro.configs import ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.models import registry as jregistry
from repro.sharding import Annotated
from repro.train import trainer as jtrainer
from repro_torch import sharding as shd
from repro_torch.configs import SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import registry


def _reference_dryrun():
    """`repro.launch.dryrun`, whose import sets XLA_FLAGS for 512 host
    devices: the variable is put back at once, before anything here
    starts a JAX backend."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jdryrun


jdryrun = _reference_dryrun()


def test_shapes_match_reference():
    assert list(SHAPES) == list(J_SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(J_SHAPES[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_supported_shapes_match_reference(arch):
    got, want = registry.get_spec(arch), jregistry.get_spec(arch)
    assert got.supported_shapes == want.supported_shapes
    assert got.skip_reason == want.skip_reason


def _flat(tree, prefix=()):
    """[(path, (shape, dtype, logical))] of a tree of defs, dict keys
    sorted, lists by index."""
    if isinstance(tree, (Annotated, shd.LeafDef)):
        return [(prefix, (tuple(tree.shape), str(tree.dtype),
                          tuple(tree.logical)))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flat(v, prefix + (i,))]
    return [x for k in sorted(tree) for x in _flat(tree[k], prefix + (k,))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_defs_match_reference(arch):
    spec, jspec = registry.get_spec(arch), jregistry.get_spec(arch)
    for name in spec.supported_shapes:
        got = _flat(registry.batch_defs(spec, SHAPES[name]))
        want = _flat(jregistry.batch_defs(jspec, J_SHAPES[name]))
        assert got == want, (arch, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_probe_config_matches_reference(arch):
    cfg, jcfg = registry.get_spec(arch).cfg, jregistry.get_spec(arch).cfg
    for n in (1, 2):
        got, units = dryrun._probe_config(cfg, n)
        want, j_units = jdryrun._probe_config(jcfg, n)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert units == j_units


@pytest.mark.parametrize("s", ["", "attn_mode=cp,microbatches=4",
                               "seq_shard=False,moe_group=256",
                               "batch_dm=True,replicate_vocab=True"])
def test_parse_overrides_matches_reference(s):
    assert dryrun._parse_overrides(s) == jdryrun._parse_overrides(s)


def test_parallel_for_and_cells_match_reference():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for mk in dryrun.CELLS_MESHES:
                assert dataclasses.asdict(
                    dryrun._parallel_for(arch, shape, mk)) == \
                    dataclasses.asdict(jdryrun._parallel_for(arch, shape, mk))
    assert dryrun.CELLS_MESHES == jdryrun.CELLS_MESHES
    assert sorted(dryrun.all_cells()) == sorted(jdryrun.all_cells())


def test_strategy_wire_matches_reference():
    from repro.api import strategies as jstrategies
    from repro.configs.base import DPMRConfig as JDPMR
    from repro.core import dpmr as jdpmr

    with contextlib.redirect_stdout(io.StringIO()) as out:
        rows = dryrun.run_strategy_wire()
    assert "autotuner's pick" in out.getvalue()
    jcfg = JDPMR(num_features=1 << 30, max_features_per_sample=64)
    by_mesh = {}
    for r in rows:
        by_mesh.setdefault(r["mesh"], []).append(r)
        p, po = r["shards"], r["pods"]
        cap = jdpmr.capacity_for_shards(jcfg, (1 << 24) // p, p)
        ctx = jstrategies.StrategyContext(
            axes=(), num_shards=p, block_size=-(-(1 << 30) // p),
            capacity=cap, outer_shards=po, topk_frac=jcfg.topk_frac)
        s = jstrategies.get_strategy(r["strategy"])
        wb = s.bytes_per_device(ctx)
        # lossy: the reference's init_carry(ctx) is not None, from its
        # shape alone (the carry would be 4 GiB)
        lossy = jax.eval_shape(lambda s=s, ctx=ctx: s.init_carry(ctx)) \
            is not None
        assert (r["inner_bytes"], r["outer_bytes"], r["capacity"],
                r["lossy"]) == (int(wb.inner), int(wb.outer), cap, lossy), r
    assert {m: (rs[0]["shards"], rs[0]["pods"]) for m, rs in
            by_mesh.items()} == {"single": (256, 1), "multi": (512, 2)}
    for rs in by_mesh.values():
        assert sorted(r["strategy"] for r in rs) == sorted(
            jstrategies.list_strategies())
        assert sum(r["chosen"] for r in rs) == 1


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

SMALL = {"train_4k": ShapeConfig("train_4k", 16, 32, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 32, 32, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 64, 32, "decode")}
FAMILIES = ("yi-6b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b", "xlstm-125m",
            "whisper-small")


def _reference_bytes(defs, axis_sizes):
    """The reference's per-device bytes of a tree of Annotated over a
    mesh of `axis_sizes` (tests/test_torch_sharding.py's arithmetic)."""
    mesh = types.SimpleNamespace(axis_names=tuple(axis_sizes),
                                 shape=dict(axis_sizes))
    total = 0
    for a in jax.tree.leaves(defs, is_leaf=lambda x: isinstance(
            x, Annotated)):
        n = 1
        for dim, s in zip(a.shape, tuple(a.spec(mesh)), strict=True):
            n *= dim // jshd.mesh_axis_size(mesh, s)
        total += n * np.dtype(jax.numpy.dtype(a.dtype)).itemsize
    return total


def _reference_args(arch, kind, shape):
    """The reference dry run's arguments of a smoke cell, as defs."""
    jspec = jregistry.get_spec(arch)
    jspec = dataclasses.replace(jspec, cfg=jdryrun._probe_config(
        jregistry.smoke_config(arch), 1)[0])
    jshape = J_SHAPES[shape.name].__class__(**dataclasses.asdict(shape))
    bdefs = jregistry.batch_defs(jspec, jshape)
    if kind == "train":
        return [jtrainer.state_defs(jspec, jspec.cfg, JTrain(),
                                    JParallel()), bdefs]
    return [jspec.defs(jspec.cfg), bdefs]


def _cell(arch, shape_name, mk):
    """A cell at the smoke config cut to one unit (`_probe_config`), one
    microbatch, no recompute."""
    with contextlib.redirect_stdout(io.StringIO()):
        return dryrun.run_cell(
            arch, shape_name, mk, overrides="microbatches=1,remat=none",
            cfg=dryrun._probe_config(registry.smoke_config(arch), 1)[0],
            shape=SMALL[shape_name])


CELLS = [(a, "train_4k") for a in FAMILIES] + [("yi-6b", "prefill_32k"),
                                               ("yi-6b", "decode_32k")]


@pytest.mark.parametrize("mk", dryrun.CELLS_MESHES)
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_smoke_cell(arch, shape_name, mk):
    rec = _cell(arch, shape_name, mk)
    assert rec["status"] == "ok", rec
    mem = rec["memory_analysis"]
    state, batch = _reference_args(arch, SMALL[shape_name].kind,
                                   SMALL[shape_name])
    want = _reference_bytes(state, dryrun.GEOMETRY[mk])
    if SMALL[shape_name].kind == "train":
        # the port's mesh trainer takes the global batch at every rank
        want += _reference_bytes(batch, {})
    else:
        want += _reference_bytes(batch, dryrun.GEOMETRY[mk])
    assert mem["argument_size_in_bytes"] == want
    assert mem["peak_memory_in_bytes"] >= want
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["collectives"] and rec["collective_summary"]
    assert {c["op"] for c in rec["collectives"]} <= set(
        dryrun.HLO_OP.values())
    summary = rec["collective_summary"]
    assert sum(a["count"] for a in summary.values()) == len(
        rec["collectives"])
    if SMALL[shape_name].kind == "train":
        # the reference's updates alias its donated state; the port's
        # update it in place
        assert mem["alias_size_in_bytes"] > 0
        assert "all-gather" in summary and "reduce-scatter" in summary
        if mk == "multi":
            assert any(c["axes"] == ["pod"] for c in rec["collectives"])


def test_unsupported_cell_is_skipped():
    rec = dryrun.run_cell("yi-6b", "long_500k", "single")
    assert rec["status"] == "skipped"
    assert rec["reason"] == jregistry.get_spec("yi-6b").skip_reason


def test_cell_through_the_command_line(tmp_path):
    """A full-size cell (xlstm-125m's decode at 32k on the multi
    geometry): its JSON file holds the reference's record keys."""
    with contextlib.redirect_stdout(io.StringIO()):
        dryrun.main(["--cell", "xlstm-125m:decode_32k:multi", "--out",
                     str(tmp_path)])
    rec = json.loads((tmp_path / "xlstm-125m__decode_32k__multi.json")
                     .read_text())
    assert rec["status"] == "ok"
    assert {"arch", "shape", "mesh", "status", "lower_s", "compile_s",
            "memory_analysis", "flops", "bytes_accessed", "cost_keys",
            "collectives", "collective_summary"} <= set(rec)
    assert set(rec["memory_analysis"]) == {
        "temp_size_in_bytes", "argument_size_in_bytes",
        "output_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes", "peak_memory_in_bytes"}
    for c in rec["collectives"]:
        assert {"op", "dtype", "elems", "bytes", "group_size"} <= set(c)
    spec = registry.get_spec("xlstm-125m")
    defs = registry.batch_defs(spec, SHAPES["decode_32k"])
    params = dryrun._serve_defs(spec, spec.cfg)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        shd.tree_nbytes(params, dryrun.GEOMETRY["multi"]) + \
        shd.tree_nbytes(defs, dryrun.GEOMETRY["multi"])
    assert 0 < rec["card_share"] < 1


def test_probe_through_the_command_line(tmp_path):
    """The 1- and 2-unit probes of a full-size cell (xlstm-125m's decode:
    one unit is an mLSTM and an sLSTM block), as the reference's
    `--probe` writes them."""
    with contextlib.redirect_stdout(io.StringIO()):
        dryrun.main(["--cell", "xlstm-125m:decode_32k", "--probe", "--out",
                     str(tmp_path)])
    rec = json.loads((tmp_path / "xlstm-125m__decode_32k__probe.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["units"] == 6
    p1, p2 = rec["probe1"], rec["probe2"]
    assert set(p1) == {"flops", "bytes_accessed", "transcendentals",
                       "collective_summary"}
    assert 0 < p1["flops"] < p2["flops"]
    assert p1["bytes_accessed"] < p2["bytes_accessed"]
    assert p1["collective_summary"]["all-gather"]["count"] < \
        p2["collective_summary"]["all-gather"]["count"]


def test_attention_counts_the_kernel_footprint():
    """Under fake tensors `ops.flash_attention` is the kernel's custom
    op: it allocates its (B, S, H, D) output alone, where the plain
    version builds the S x S scores, and FlopCounterMode counts the
    kernel's formula (the causal pairs); on real CPU tensors the op is
    the plain version."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    b, s, h, kh, d = 2, 4096, 4, 2, 128
    with FakeTensorMode():
        q = torch.empty((b, s, h, d), dtype=torch.bfloat16)
        k = torch.empty((b, s, kh, d), dtype=torch.bfloat16)
        cost = dryrun._cost_mode()
        for t in (q, k):
            cost.add(t)
        before = cost.live
        flops = dryrun._flop_counter()
        with flops, cost:
            out = ops.flash_attention(q, k, k, causal=True)
        assert out.shape == q.shape and out.dtype == q.dtype
        assert cost.peak - before == q.numel() * q.element_size()
        assert flops.get_total_flops() == fa.flops(
            q.shape, k.shape, k.shape, True) == 4 * d * b * h * s * (s + 1) // 2
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 8, n, 16),
                                                    dtype=np.float32))
               for n in (4, 2, 2))
    assert torch.equal(fa.fake_op()(q, k, v, True),
                       ref.flash_attention_ref(q, k, v, causal=True))


@pytest.mark.parametrize("mk", dryrun.CELLS_MESHES)
def test_prefill_cell_at_full_width(mk):
    """yi-6b's prefill_32k at full width, one layer deep: the step's
    temporaries stay under the S x S f32 scores of the rank's rows and
    heads, which the kernel never builds."""
    spec = registry.get_spec("yi-6b")
    with contextlib.redirect_stdout(io.StringIO()):
        rec = dryrun.run_cell("yi-6b", "prefill_32k", mk,
                              cfg=dryrun._probe_config(spec.cfg, 1)[0])
    assert rec["status"] == "ok"
    geo = dryrun.GEOMETRY[mk]
    shape = SHAPES["prefill_32k"]
    rows = shape.global_batch // geo.get("pod", 1) // geo["data"]
    heads = spec.cfg.num_heads // geo["model"]
    scores = rows * heads * shape.seq_len ** 2 * 4
    assert 0 < rec["memory_analysis"]["temp_size_in_bytes"] < scores
