#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s phase 5 (the flagship's serving runs (a)-(d),
the servers (s1)-(s3) and clean/tag-reports) spends its time on one NVIDIA
GPU: builds the kernels, then runs ``chip_smoke.flagship_phase`` with every
log line stamped with the seconds since the start, and each
``chip_smoke.profile_run`` reported with the time of the profiler's exit and
its own total beside the profiled run's wall:

    python3 time_flagship_profile.py [--log FILE]

Run from the repository root. Lines go to standard output and, with
``--log``, to FILE as well (a runner that keeps only the end of the
output loses its start).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch
import torch.profiler

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_flagship_profile: no CUDA device", file=sys.stderr)
        return 2
    from mmmm_tpu_torch.ops import _cuda

    sink = None
    if args.log is not None:
        args.log.parent.mkdir(parents=True, exist_ok=True)
        sink = args.log.open("w")
    t_start = time.perf_counter()
    plain_log = cs.log

    def stamped(msg: str) -> None:
        line = f"[{time.perf_counter() - t_start:8.2f}] {msg}"
        plain_log(line)
        if sink is not None:
            sink.write(line + "\n")
            sink.flush()

    cs.log = stamped
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.build()
    _cuda.library()
    stamped("kernels built")

    profile_exit = torch.profiler.profile.__exit__

    def timed_exit(self, *exc):
        t = time.perf_counter()
        out = profile_exit(self, *exc)
        stamped(f"  profiler exit {time.perf_counter() - t:.3f} s")
        return out

    torch.profiler.profile.__exit__ = timed_exit
    profile_run = cs.profile_run

    def timed_profile_run(run, stages=cs.STAGES):
        t = time.perf_counter()
        res = profile_run(run, stages)
        stamped(f"  profile_run total {time.perf_counter() - t:.3f} s (profiled run's wall "
                f"{res['wall_s']:.3f} s)")
        return res

    cs.profile_run = timed_profile_run
    cs.flagship_phase(torch.Generator(device="cuda").manual_seed(0), True, True)
    stamped("phase 5 done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
