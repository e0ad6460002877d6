"""The yardstick: the roofline's and the model FLOPs' arithmetic against
hand counts at small shapes, the traffic generators against their seed,
and the imports of every module of the benchmark."""
from __future__ import annotations

import ast
import json

import numpy as np
import pytest
import torch
from conftest import PERFBENCH, ROOT

from pb import gen, roofline
from reference import dense_lm


def test_least_time_takes_the_larger_bound():
    assert roofline.least_time_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_time_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.least_time_s(3.35e12, 67e12 * 2) == pytest.approx(2.0)
    assert roofline.least_time_s(0, 989e12, roofline.BF16_TC_FLOPS) == \
        pytest.approx(1.0)


def test_sparse_step_bytes_by_hand():
    # 2 rows of K = 3: ids [[5, 7, -1], [5, 9, 11]]: 5 real slots, 4
    # distinct ids. ids + vals: 2*3*(4+4) = 48 B, labels 8 B, each
    # distinct row's weight and accumulator read and written: 4 * 16 B
    nbytes, nflops = roofline.sparse_step_work(rows=2, k=3, nnz=5, unique=4)
    assert nbytes == 48 + 8 + 64
    assert nflops == 4 * 5 + 6 * 4


def test_seam_call_bytes_by_hand():
    vals = torch.zeros((4, 8))
    theta = torch.zeros((4, 8))
    labels = torch.zeros((4,), dtype=torch.int32)
    out = (torch.zeros((4, 8)), torch.zeros((4,)), torch.zeros((4,)))
    b, f = roofline.seam_call_work("sigmoid_grad", (vals, theta, labels), out)
    assert b == (128 + 128 + 16) + (128 + 16 + 16)
    assert f == 4 * 32
    ids = torch.zeros((10,), dtype=torch.int32)
    g = torch.zeros((10,))
    b, f = roofline.seam_call_work("segment_sum_sorted", (ids, g),
                                   torch.zeros((10,)))
    assert (b, f) == (40 + 40 + 40, 10)
    srt = (ids, g, torch.zeros((10,), dtype=torch.bool))
    b, _ = roofline.seam_call_work("sorted_run_totals", (ids, g), srt)
    assert b == 80 + 40 + 40 + 10
    req = torch.tensor([[3, 4, -1], [4, 9, 2]], dtype=torch.int32)
    acc = torch.zeros((8,))
    b, _ = roofline.seam_call_work("owner_accumulate",
                                   (req, torch.zeros((2, 3)), acc, 2),
                                   acc, touched=3)
    assert b == 24 + 24 + 8 * 3


def test_row_update_bytes_by_hand_and_at_the_kernel_tables_shape():
    # ids sorted, padding last: runs 2, 5, 7 and 11 (outside [0, 10)): 3
    # rows written, 7 slots read
    ids = torch.tensor([2, 2, 5, 7, 7, 11, -1], dtype=torch.int32)
    theta, acc = torch.zeros(10), torch.zeros(10)
    args = ("adagrad", theta, acc, ids, torch.zeros(7), 0, 0.1, 1e-6)
    b, f = roofline.seam_call_work("row_update", args, (theta, acc),
                                   touched=3)
    assert (b, f) == (12 * 7 + 128 * 3, 6 * 3)
    b, _ = roofline.seam_call_work("row_update", ("sgd",) + args[1:],
                                   (theta, acc), touched=3)
    assert b == 12 * 7 + 64 * 3
    # PERF.md's kernel table: b4096's 159,744 slots and 21,125 rows bound
    # the kernel at 0.00138 ms
    big = torch.zeros(159_744, dtype=torch.int32)
    b, f = roofline.seam_call_work("row_update", ("adagrad", theta, acc,
                                                  big, big, 0, 0.1, 1e-6),
                                   None, touched=21_125)
    assert roofline.least_time_s(b, f) * 1e3 == pytest.approx(0.00138,
                                                              abs=5e-6)


def test_the_count_pass_records_row_update_with_its_written_rows():
    from pb import tracing

    from repro_torch.kernels import ops

    ids = torch.tensor([2, 2, 5, 7, 7, 11, -1], dtype=torch.int32)
    theta, acc = torch.zeros(10), torch.zeros(10)
    spans = [s for s in tracing_spans() if s[1] == "row_update"]
    assert spans == [("repro_torch.kernels.ops", "row_update",
                      "seam.row_update", True)]
    with tracing.Spans(torch, spans, mode="count") as counting:
        ops.row_update("adagrad", theta, acc, ids, torch.ones(7), 0, 0.5,
                       1e-6)
    assert counting.work == [("row_update", 12 * 7 + 128 * 3, 6 * 3)]
    assert int((theta != 0).sum()) == 3


def tracing_spans():
    from pb import cells

    return cells.load_module(PERFBENCH / "runners" / "dpmr_sgd.py",
                             "pb_test_runner").SPANS


def test_touched_rows_counts_distinct_ids_in_the_block():
    from pb import tracing

    req = torch.tensor([[3, 4, -1], [4, 9, 2]], dtype=torch.int32)
    # block [2, 10): 3, 4, 9, 2 -> 4 distinct
    assert tracing.touched_rows(torch, req, torch.zeros((8,)), 2) == 4
    # block [3, 5): 3, 4
    assert tracing.touched_rows(torch, req, torch.zeros((2,)), 3) == 2


def test_dense_model_flops_leave_the_embedding_lookup_out():
    conf = json.loads((PERFBENCH / "configs" / "yi-6b-l4.json").read_text())
    d, f, v, layers = 4096, 11008, 64000, 4
    kv = 4 * 128
    per_layer = d * d + 2 * d * kv + d * d + 3 * d * f
    assert dense_lm.product_params(conf) == layers * per_layer + d * v
    batch, seq = 4, 4096
    want = 6 * (layers * per_layer + d * v) * batch * seq \
        + 3 * 4 * 128 * 32 * layers * batch * seq * (seq + 1) // 2
    got = roofline.dense_model_flops(dense_lm.product_params(conf), layers,
                                     32, 128, batch, seq)
    assert got == want
    # the embedding table is not in it: adding its 6 N tokens would be
    assert got < want + 6 * v * d * batch * seq


def test_zipf_draws_follow_numpy():
    """The device sampler's law against numpy's `zipf` (a = 1.2) on the
    shares of the smallest values."""
    g = torch.Generator().manual_seed(3)
    x = gen.zipf(torch, 1.2, 400_000, g, "cpu").numpy()
    y = np.random.default_rng(3).zipf(1.2, 400_000)
    assert x.min() >= 1
    for v in (1, 2, 3, 10):
        assert abs((x == v).mean() - (y == v).mean()) < 0.004, v


def test_traffic_is_reproducible_from_the_seed():
    fields = [3, 40, 1000, 5000]
    corpus = {"num_features": 1 << 16, "fields": fields, "zipf_alpha": 1.2,
              "signal_per_field": 8, "signal_weight_std": 2.0,
              "positive_ratio": 0.25}
    a = gen.fields_zipf(torch, corpus, 2048, 3, 2 ** 31 + 5, "cpu")
    b = gen.fields_zipf(torch, corpus, 2048, 3, 2 ** 31 + 5, "cpu")
    c = gen.fields_zipf(torch, corpus, 2048, 3, 2 ** 31 + 6, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["ids"], c["ids"])
    ids, vals = a["ids"], a["vals"]
    assert ids.shape == (3, 2048, 4) and ids.dtype == torch.int32
    assert int(ids.min()) >= 0 and int(ids.max()) < 1 << 16
    assert torch.all(vals == 0.5)       # 1/sqrt(4 fields)
    # each field's values are its own: the hash is a bijection, so
    # unhashing gives back ranks inside the field's range
    inv = pow(gen.HASH_MUL, -1, 1 << 16)
    glob = (ids.to(torch.int64) * inv) % (1 << 16)
    lo = torch.tensor([0, 3, 43, 1043])
    assert torch.all(glob >= lo) and torch.all(glob < lo + torch.tensor(
        fields))
    # the field of 3 values takes all three; the first value is the most
    # frequent in the largest field
    assert torch.unique(glob[..., 0]).numel() == 3
    big = glob[..., 3].reshape(-1) - 1043
    assert int(torch.bincount(big).argmax()) == 0
    q = a["labels"].float().mean()
    assert abs(float(q) - 0.25) < 0.02
    t1 = gen.lm_markov(torch, 50, 32, 4, 2, 11, "cpu")
    t2 = gen.lm_markov(torch, 50, 32, 4, 2, 11, "cpu")
    assert torch.equal(t1["tokens"], t2["tokens"])
    assert torch.equal(t1["tokens"][..., 1:], t1["labels"][..., :-1])
    assert int(t1["tokens"].max()) < 50


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


SOURCES = sorted(p for p in PERFBENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(PERFBENCH)) for p in SOURCES])
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.partition(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    # nothing reads the JAX package's benchmark folder
    assert "bench" + "marks/" not in path.read_text()


@pytest.mark.parametrize(
    "path", sorted((PERFBENCH / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.partition(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "contextlib", "math", "numpy", "torch"}, \
        tops


def test_run_refuses_without_a_card_or_a_program(tmp_path):
    import shutil
    import subprocess
    import sys

    cmd = [sys.executable, "perfbench/run.py", "--workload",
           "dpmr-lr-13x2e27.sgd-b65536", "--seed", str(2 ** 31 + 1),
           "--seconds", "1", "--trace", "0"]
    if not torch.cuda.is_available():
        got = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        assert got.returncode != 0 and got.stdout.strip() == ""
    # a directory with only BENCHMARK.json and the benchmark's files
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert got.returncode != 0 and got.stdout.strip() == ""
