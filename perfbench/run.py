#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (`repro_torch`): one run of one
cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `src/repro_torch`, on a machine
with as many CUDA cards as the cell asks for. The cells, metrics and
bounds are `BENCHMARK.json`'s; each cell's files are found by name
(`pb/cells.py`). The run binds its threads to the CPUs local to the
card, makes its inputs on the card from `--seed`, sets up and warms the
program (timed as `setup_s`), measures for `--seconds`, and checks what
the program computed against the plain reference
(`perfbench/reference/`). With `--trace 1` it measures the
same window and then a profiled pass, and reports the per-layer metrics
instead of the end-to-end ones.

Standard output: an earlier line with the card's name and power limit,
and last one JSON object (`correct`, `attempted`, `failed`, `metrics`,
`device`, with `--trace 1` `breakdown`, and last `checks`: each
compared number with its limit). Standard error ends with the same
checks, one a line. The run exits non-zero, with no result, when CUDA
is missing or has too few cards, when a process holds JAX or the JAX
package, and when the program is not in the checkout.
"""
import time

T0 = time.perf_counter()     # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from pb import cells, common  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare(root: pathlib.Path) -> None:
    """The program on the import path, and the caches inside the
    checkout; exits if the checkout holds no program."""
    src = root / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        cells.main_error(f"no program at {src / 'repro_torch'}: run from "
                         "the root of a checkout of the repository")
    sys.path.insert(0, str(src))
    common.set_cache_dirs(root)


def main(argv=None) -> None:
    args = parse(argv)
    try:
        cell = cells.load(ROOT, args.workload)
    except (OSError, KeyError, ValueError) as e:
        cells.main_error(f"cannot load workload {args.workload!r}: {e}")
    prepare(ROOT)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        cells.main_error(f"{cell.name} needs {cell.chips} CUDA card(s); "
                         f"this machine has {n}", 3)
    print(f"[perfbench] card and power limit: {common.power_limit()}",
          flush=True)
    host = common.pin_host(torch)
    ctx = cells.Ctx(cell=cell, seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), t0=T0)
    out = cells.run(ctx)
    common.log(common.host_line(host, out.get("step_p50_ms")))
    bad = common.forbidden_modules()
    if bad:
        cells.main_error(f"forbidden modules loaded: {bad}", 4)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = cells.assemble(cell, out, ctx.trace, device)
    for name, c in result["checks"].items():
        common.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
