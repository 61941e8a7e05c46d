"""Readings that the limits in ``perfbench/limits/<cell>.json`` are set
from: the numbers compared, on sound runs of the program over many seeds
and on runs of the control (the timed path computed in TF32, the step
below the configuration's float32 with TF32 off), in one process.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1 2 3 \
        --control-seeds 4 5 6 [--seconds 0]

Each run is the cell's own run (set-up, window, check) with a window of
``--seconds`` (0: one job); one JSON line a run on standard output:
``{"cell", "seed", "control", "correct", "checks"}``. It needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from perfbench import run


def readings(cell: str, seeds, control_seeds, seconds: float = 0.0,
             out=sys.stdout) -> list:
    bench = run.benchmark()
    device = torch.device("cuda", 0)
    lines = []
    for control, group in ((False, seeds), (True, control_seeds)):
        for seed in group:
            r = run.run_cell(bench, cell, seed, seconds, False, device,
                             time.perf_counter(), tf32=control)["result"]
            line = {"cell": cell, "seed": seed, "control": control,
                    "correct": r["correct"], "checks": r["checks"]}
            lines.append(line)
            print(json.dumps(line), file=out, flush=True)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    readings(args.workload, args.seeds, args.control_seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
