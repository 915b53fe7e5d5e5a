"""
Readings for the limits of `correct`: for each seed, the numbers that the
check compares for the program (a short window of the cell, as a run makes
it) and, on the control seeds, for the control (the reference computed one
precision below the configuration's, in the program's place).

    python3 -m perfbench.readings --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 2]

Prints one JSON line per seed.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import time

from . import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="",
                   help="seeds on which the program runs with a planted fault (train: 'half')")
    p.add_argument("--fp32-seeds", default="",
                   help="train: seeds on which the program runs without autocast (the look)")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    run.cache_env()
    import importlib

    import torch

    c = run.cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    faulty = {int(s) for s in args.fault_seeds.split(",") if s}
    mod = importlib.import_module(f"perfbench.drivers.{c['traffic']['driver']}")
    runs = ([(int(s), None) for s in args.seeds.split(",") if s]
            + [(s, "half") for s in sorted(faulty)]
            + [(int(s), "fp32") for s in args.fp32_seeds.split(",") if s])
    for s, fault in runs:
        t = time.perf_counter()
        drv = mod.Driver(c["config"], c["traffic"], s, torch.device("cuda", 0), lambda o: None)
        if fault == "fp32":
            drv.amp = None
        else:
            drv.fault = fault
        drv.setup()
        out = drv.window(args.seconds)
        drv.release()
        row = {"seed": s, "failed": out["failed"], "fault": fault,
               "program": drv.check()}
        if s in ctrl and not fault:
            row["control"] = drv.control()
        if getattr(drv, "worst", None):
            row["worst"] = drv.worst
        row["wall_s"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
