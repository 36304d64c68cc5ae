#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process on the GPU:
for each seed, the cell's set-up and one unit of its timed path at the
timed sizes, then the float32 reference's numbers for the program and,
on the first ``--control`` seeds, for the control (the reference one
precision lower, fp8, in the program's place).

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 --control 3

Prints one JSON line a seed, then the largest program reading and the
smallest control reading of each number. The benchmark's runs do not run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.dirname(ROOT)]

from faults import FAULTS  # noqa: E402
from harness import Cell  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None,
                    help="plant a fault in the program: half of each step's microbatches, "
                         "the mean over the rest")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    cell = Cell.load(args.workload)
    if args.fault:
        owner, name, broken = FAULTS[args.fault]()
        setattr(owner, name, broken)
    prog_max, ctrl_min = {}, {}
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        drv = cell.driver().Driver(cell, seed)
        drv.setup()
        if drv.unit != "step":  # training's checked steps run in its set-up
            drv.run_unit(0)
        drv.release()
        prog, ctrl = drv.check(control=n < args.control)
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl}), flush=True)
        for k, v in prog.items():
            prog_max[k] = max(prog_max.get(k, 0.0), v)
        for k, v in ctrl.items():
            ctrl_min[k] = min(ctrl_min.get(k, float("inf")), v)
        del drv
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"program_max": prog_max, "control_min": ctrl_min}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
