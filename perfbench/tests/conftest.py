"""Shared set-up of the benchmark's own tests: the benchmark's folder and
the program's sources on the import path, and small versions of the
cells for the CPU."""
from __future__ import annotations

import pathlib
import sys
import time

import pytest

PERFBENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
for p in (str(PERFBENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2 ** 31 + 977       # above 32 signed bits, as the driver's are


def small(cell):
    """`cell` cut to a size the CPU runs in seconds (widths included:
    this is a test of the harness, not a measurement)."""
    if cell.traffic["runner"] == "dpmr_sgd":
        corpus = cell.config["corpus"]
        cell.config = {**cell.config, "num_features": 1 << 20,
                       "corpus": {**corpus, "fields": [
                           min(c, 4096) for c in corpus["fields"]]}}
        cell.traffic = {**cell.traffic, "pool_batches": 6, "trace_steps": 3,
                        "batch": 512}
    else:
        cell.config = {**cell.config, "hidden_size": 64,
                       "num_attention_heads": 4, "num_key_value_heads": 2,
                       "intermediate_size": 128, "vocab_size": 256,
                       "num_hidden_layers": 2}
        cell.traffic = {**cell.traffic, "batch": 2, "seq": 32,
                        "pool_batches": 4, "trace_steps": 1}
        # the full-size limits hold a 4096-wide model's norms; at width 64
        # the program's bf16 gaps are larger (CPU readings over six
        # seeds: loss 1.2e-5..3.9e-5, grad norms 4.1e-4..1.1e-3, updates
        # 3.1e-4..1.0e-3; the fp8 control 1.4e-4..4.0e-4, 5.4e-3..1.8e-2,
        # 2.2e-3..1.5e-2), so the small model is held to its own
        cell.limits = {"loss_gap": 1.2e-4, "grad_norm_gap": 3e-3,
                       "update_norm_gap": 1.8e-3}
    return cell


@pytest.fixture
def small_ctx():
    """A function: the Ctx of a small version of a cell on the CPU."""
    from pb import cells

    def make(workload, variant="program", trace=False, seconds=0.5):
        cell = small(cells.load(ROOT, workload))
        return cells.Ctx(cell=cell, seed=SEED, seconds=seconds, trace=trace,
                         device="cpu", variant=variant,
                         t0=time.perf_counter())

    return make


@pytest.fixture
def cuda():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch
