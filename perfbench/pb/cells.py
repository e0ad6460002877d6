"""A cell, found by name, and one run of it.

Everything that belongs to one cell is found by name from
`BENCHMARK.json`'s entries:

  perfbench/configs/<file>        the configuration (its `file` entry)
  perfbench/traffic/<traffic>.json the traffic mix: parameters for one
                                  of `gen.GENERATORS`, and the `runner`
  perfbench/runners/<runner>.py   the code that drives the program
  perfbench/limits/<cell>.json    the limits of the compared numbers
  perfbench/metrics/<metric>.py   each per-layer metric's reader:
                                  `read(readings) -> float | None`

so a later change adds a cell, a configuration, a traffic mix or a
metric by adding files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys

from pb import common

HERE = pathlib.Path(__file__).resolve().parents[1]     # perfbench/


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list        # BENCHMARK.json's entries that apply here
    per_layer: list


@dataclasses.dataclass
class Ctx:
    """What a runner is given: the cell and the run's arguments."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    variant: str = "program"
    t0: float = 0.0


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load(root: pathlib.Path, workload: str, bench: dict | None = None,
         perfbench: pathlib.Path = HERE) -> Cell:
    """The cell `workload` of `root/BENCHMARK.json` (or of `bench`), with
    its files read from `perfbench`."""
    if bench is None:
        bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, workload, names)]
    limits_path = perfbench / "limits" / f"{workload}.json"
    return Cell(name=workload, config_name=w["config"],
                traffic_name=w["traffic"], chips=int(w["chips"]),
                config=_load_json(root / conf["file"]),
                traffic=_load_json(perfbench / "traffic"
                                   / f"{w['traffic']}.json"),
                limits=_load_json(limits_path) if limits_path.exists()
                else {},
                end_to_end=e2e, per_layer=layer)


def load_module(path: pathlib.Path, prefix: str):
    """A module from a file of the benchmark (a metric's name may hold
    dots, so it is loaded by path, not imported by name)."""
    name = prefix + "_" + "".join(ch if ch.isalnum() else "_"
                                  for ch in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(cell: Cell, perfbench: pathlib.Path = HERE):
    return load_module(perfbench / "runners" / f"{cell.traffic['runner']}.py",
                       "pb_runner")


def read_metric(name: str, readings: dict,
                perfbench: pathlib.Path = HERE):
    mod = load_module(perfbench / "metrics" / f"{name}.py", "pb_metric")
    return mod.read(readings)


def assemble(cell: Cell, out: dict, trace: bool, device: dict,
             perfbench: pathlib.Path = HERE) -> dict:
    """The result line's object from a runner's outcome."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = read_metric(m["name"], out["layer"], perfbench)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = {**device, "busy_s": out["busy_s"],
                  "window_s": out["window_s"]}
    else:
        for m in cell.end_to_end:
            if m["name"] not in out["e2e"]:
                raise KeyError(f"the runner gave no {m['name']!r}")
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device}
    if trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    return result


def run(ctx: Ctx, task: str = "run", extra=None):
    """The runner's `task` in this process."""
    mod = runner(ctx.cell)
    fn = getattr(mod, task)
    return fn(ctx) if extra is None else fn(ctx, *extra)


def main_error(msg: str, code: int = 2) -> None:
    common.log(msg)
    sys.exit(code)
