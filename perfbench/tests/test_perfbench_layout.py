"""BENCHMARK.json against the harness's files: every cell resolves to its
configuration, traffic mix, runner and limits, every metric to its
reader; a cell, a configuration, a traffic mix and a metric can be added
by files and entries alone; the names keep to the contract's alphabet."""
from __future__ import annotations

import json
import re
import shutil

import pytest
from conftest import PERFBENCH, ROOT

from pb import cells

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_to_its_files(workload):
    cell = cells.load(ROOT, workload)
    assert cell.chips in (1, 4)
    assert (PERFBENCH / "runners" / f"{cell.traffic['runner']}.py").is_file()
    assert (PERFBENCH / "limits" / f"{workload}.json").is_file()
    assert cell.limits, "a cell's numbers need limits"
    for m in cell.per_layer:
        assert (PERFBENCH / "metrics" / f"{m['name']}.py").is_file()
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer


def test_names_units_and_paths_keep_to_the_contract():
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def test_a_cell_config_traffic_and_metric_added_by_files_alone(tmp_path):
    """On a copy of the folder: new files and new entries, no file that
    was there edited, and the harness finds every one by name."""
    copy = tmp_path / "perfbench"
    shutil.copytree(PERFBENCH, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(copy): p.read_bytes()
              for p in copy.rglob("*") if p.is_file()}
    conf = json.loads((copy / "configs" / "dpmr-lr-13x2e27.json")
                      .read_text())
    conf["num_features"] = 1 << 30
    (copy / "configs" / "dpmr-lr-2e30.json").write_text(json.dumps(conf))
    traffic = json.loads((copy / "traffic" / "sgd-b65536.json").read_text())
    traffic["batch"] = 8192
    (copy / "traffic" / "sgd-b8192.json").write_text(json.dumps(traffic))
    (copy / "limits" / "dpmr-lr-2e30.sgd-b8192.json").write_text(
        json.dumps({"loss_gap": 1e-5}))
    (copy / "metrics" / "sparse.steps_traced.py").write_text(
        "def read(r):\n    return float(r['traced_steps'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({**bench["configs"][0], "name": "dpmr-lr-2e30",
                             "file": "perfbench/configs/dpmr-lr-2e30.json"})
    bench["workloads"].append({"name": "dpmr-lr-2e30.sgd-b8192",
                               "config": "dpmr-lr-2e30",
                               "traffic": "sgd-b8192", "chips": 1,
                               "why": "a larger table"})
    bench["per_layer"].append({"name": "sparse.steps_traced",
                               "unit": "steps", "better": "higher",
                               "source": "program_counter",
                               "layer": "device",
                               "moves": "sparse_samples_per_s"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "sparse_samples_per_s":
            m["workloads"].append("dpmr-lr-2e30.sgd-b8192")
    cell = cells.load(tmp_path, "dpmr-lr-2e30.sgd-b8192", bench=bench,
                      perfbench=copy)
    assert cell.config["num_features"] == 1 << 30
    assert cell.traffic["batch"] == 8192
    assert cell.limits == {"loss_gap": 1e-5}
    assert "sparse.steps_traced" in [m["name"] for m in cell.per_layer]
    assert cells.runner(cell, copy).__name__.startswith("pb_runner")
    assert cells.read_metric("sparse.steps_traced", {"traced_steps": 7},
                             copy) == 7.0
    after = {p.relative_to(copy): p.read_bytes()
             for p in copy.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_metric_readers_find_nothing_and_say_so():
    """A reader with nothing to read returns None, never 0 for a share."""
    empty = {"traced_steps": 2, "busy_s": 0.0, "by_name": {},
             "span_device_s": {}, "seam_least_s": 0.0, "seam_device_s": 0.0,
             "host_ops_per_step": 0.0, "wall_per_step_s": 0.01,
             "window_least_s": 0.0, "window_elapsed_s": 1.0,
             "model_flops_per_step": 0, "window_steps": 3}
    for m in BENCH["per_layer"]:
        assert cells.read_metric(m["name"], empty) is None, m["name"]


def test_dense_idle_share_reads_within_the_traced_pass():
    """The profiler stretches a card-paced step's kernels: a traced busy
    time a step above the untraced window's wall a step (as one card run
    of `yi-6b-l4.train-16x1024` read) still gives a share in [0, 100]."""
    r = {"busy_s": 1.1177464, "traced_window_s": 1.1289401,
         "traced_steps": 2, "wall_per_step_s": 0.5512}
    got = cells.read_metric("dense.idle_share", r)
    assert got == pytest.approx((1 - 1.1177464 / 1.1289401) * 100)
    assert 0 <= got <= 100
