"""The readings that a cell's limits are set from: for each seed, a short
window of the cell at its own load, then every compared number read
twice, for the program and for the control (the reference itself in
bfloat16, in the program's place: the tick, or the plain solver of
`reference/solve.py` on the sample of plans).  One JSON line a seed.

    python3 -m portbench.control --workload <name> --seeds 1 2 3 \
        --seconds <s> [--check-every <n>] [--device cpu]

`--check-every` sets how many ticks apart the tracking cells keep a tick
for the check, so that a short window checks as many ticks as a full
run.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import run


def readings(workload, seed, seconds, device="cuda", overrides=None):
    """(program's readings, control's readings, sample counts)."""
    cell = run.make_cell(workload, seed, device, overrides=overrides)[0]
    cell.setup()
    cell.window(seconds)
    cell.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    prog, checked = cell.readings()
    ctl, _ = cell.readings(control=True)
    return prog, ctl, checked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--check-every", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    over = {} if args.check_every is None else {
        "check_every": args.check_every}
    for seed in args.seeds:
        prog, ctl, checked = readings(args.workload, seed, args.seconds,
                                      args.device, over)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": prog, "control": ctl, **checked}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
