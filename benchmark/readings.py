"""Readings that set a cell's limits: the program's compared numbers over
many seeds, and its control's, in one process (set-up is long, so the
runs share it).

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 \
        [--control w4 --control-seeds 4,5,6] [--seconds 8] [--weight-seed N] [--out FILE]

Each seed runs the cell as the benchmark does (set-up, a short window at
the cell's own load, the check against the plain reference) and prints one
JSON line: the seed, the control (none, or ``w4``: the program with its
W4A16 weights in place of the configuration's W8A16), the compared numbers,
the window's end-to-end metrics and the work it did. ``--weight-seed``
draws the model from another seed than the configuration's, to compare
draws. The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default=None)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--weight-seed", type=int, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        run.log("no CUDA device")
        return 2
    spec = run.resolve(run.load_manifest(), args.workload)
    if args.weight_seed is not None:
        spec["cfg"]["weight_seed"] = args.weight_seed
    jobs = [(int(s), None) for s in args.seeds.split(",") if s]
    jobs += [(int(s), args.control) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    for seed, control in jobs:
        t0 = time.perf_counter()
        res = run.execute(spec, seed, args.seconds, False, control=control, t0=t0)
        line = {"workload": args.workload, "weight_seed": spec["cfg"]["weight_seed"],
                "seed": seed, "control": control, "served": res["served"],
                "check": res["check"], "metrics": res["metrics"], "attempted": res["attempted"],
                "failed": res["failed"], "correct": res["correct"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
