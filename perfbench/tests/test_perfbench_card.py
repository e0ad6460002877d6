"""On the card: one short run of a one-card cell through the command the
benchmark is run by, its result line well formed and correct. Skips
where there is no CUDA card (decided in the `cuda` fixture)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_of_the_first_cell(cuda, trace):
    got = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "dpmr-lr-13x2e27.sgd-b65536", "--seed", str(2 ** 31 + 4242),
         "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-4000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["kind"] == cuda.cuda.get_device_name(0)
    if trace:
        assert out["device"]["busy_s"] > 0
        assert "sparse.idle_share" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"setup_s", "sparse_samples_per_s",
                                       "peak_mem_gib"}
