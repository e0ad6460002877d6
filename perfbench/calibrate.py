#!/usr/bin/env python3
"""The readings that a cell's limits are set from (`perfbench/limits/`).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --variants program,control,fault:unchanged [--out FILE]

For each seed, in one process on the card, the program's
first steps under each variant, and the control (the reference put in
the program's place in the precision below the configuration's), each
held against the reference: one JSON line of numbers each. "program" is
the program as the benchmark runs it; "fault:<name>" plants one fault
(see `runners/*.py`). No window is measured. The benchmark's own runs
never run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import run as bench  # noqa: E402
from pb import cells  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program,control")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = cells.load(bench.ROOT, args.workload)
    bench.prepare(bench.ROOT)
    ctx = cells.Ctx(cell=cell, seed=0, seconds=0.0, trace=False, t0=T0)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = cells.run(ctx, "calibrate", (seeds, args.variants.split(",")))
    text = "\n".join(json.dumps(r) for r in rows)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text + "\n")
    print(text, flush=True)


if __name__ == "__main__":
    main()
