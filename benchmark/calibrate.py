"""Readings for the output check's limits: the program's numbers on many
seeds, the control's and each planted fault's on a few, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        --control-seeds 1 2 3 [--faults render gt_embed --fault-seeds 1 2 3] \
        [--out <file.jsonl>]

For each seed it runs the cell's set-up (a training cell through its
followed steps; the act cell through its warm-up and one act on every
frame, no window), then the plain reference on the same inputs, and prints
one JSON line of the numbers the cell compares. For each control seed the
control (the reference in the precision next below the configuration's,
`reference.agent.control_compute`) stands in the program's place on the
same inputs; for each fault and fault seed the program runs with that
fault planted (`faults.py`). The limits in `workloads/<cell>.json` are set
from these readings (PERF.md gives them); the benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run as R  # noqa: E402
from benchmark.faults import FAULTS, planted  # noqa: E402
from benchmark.reference.agent import control_compute  # noqa: E402


def readings(ctx, side: str) -> dict:
    import importlib
    entry = importlib.import_module(f"benchmark.entries.{ctx.workload['entry']}")
    compute = (control_compute(ctx.cfg.method.policy_dtype)
               if side == "control" else None)
    fault = (planted(side.split(":", 1)[1]) if side.startswith("fault:")
             else contextlib.nullcontext())
    shutil.rmtree(ctx.work, ignore_errors=True)
    os.makedirs(ctx.work)
    try:
        with fault:
            return entry.calibrate(ctx, compute)
    finally:
        shutil.rmtree(ctx.work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[], choices=FAULTS)
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 2
    R.set_environment()
    out = open(args.out, "a") if args.out else None
    runs = ([(s, "program") for s in args.seeds]
            + [(s, "control") for s in args.control_seeds]
            + [(s, f"fault:{f}") for f in args.faults
               for s in args.fault_seeds])
    for seed, side in runs:
        ctx = R.Context(torch, args.workload, seed, 0.0, False,
                        torch.device("cuda", 0))
        t0 = time.perf_counter()
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "side": side, **readings(ctx, side),
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
