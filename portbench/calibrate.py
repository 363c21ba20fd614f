"""Readings for the check's limits: a cell's program and its control on
many seeds in one process, each a full run of the cell (its own weights,
pool, warm-up, window and check) with a short window.

    python3 portbench/calibrate.py --workload e4e_f32_b8 --seeds 12 --control-seeds 3

Prints one JSON line per run (the numbers compared) and, last, each
number's largest reading over the program's seeds (the limit's lower
reading) and smallest over the control's (its upper reading).
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import run as harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    harness.cache_env(harness.ROOT)
    cell = harness.resolve(harness.ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    readings = {"program": [], "control": []}
    plan = ([("program", args.first_seed + i) for i in range(args.seeds)]
            + [("control", args.first_seed + 500 + i) for i in range(args.control_seeds)])
    for side, seed in plan:
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda:0",
                             control=(side == "control"))
        counted = sum(len(c["idx"]) for c in r.calls if c["counted"])
        readings[side].append(r.check)
        print(json.dumps({"side": side, "seed": seed, "images": counted, **r.check}),
              flush=True)
        del r
        torch.cuda.empty_cache()
    keys = list(readings["program"][0]) if readings["program"] else []
    print(json.dumps({
        "lower": {k: max(x[k] for x in readings["program"]) for k in keys},
        "upper": {k: min(x[k] for x in readings["control"]) for k in keys}
        if readings["control"] else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
