"""
One run of one benchmark cell of the PyTorch + CUDA port `mcaq_yolo_tpu_torch`:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json` `workloads`) names a configuration
(`perfbench/configs/<config>.json`) and a traffic mix
(`perfbench/traffic/<traffic>.json`); the mix names its driver
(`perfbench/drivers/<driver>.py`), which builds the program from the
seed, warms it up (set-up), drives it for `--seconds` (the window), and
returns what it produced for the check against the plain reference
(`perfbench/reference/`) under the limits of `perfbench/limits/<cell>.json`.
`--trace 1` adds a profiled sub-window after the window and prints the
cell's per-layer metrics, each read by `perfbench/metrics/<metric>.py`.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, breakdown (traced runs) and, last, `checks`: each
number compared with its limit, which also end standard error.  Earlier
lines carry what a reader of the run wants beside it (`info`).  Exits
non-zero without a result when the card or the cell's chips are missing,
or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mcaq_yolo_tpu")


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    no library may pull in JAX through the environment."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(workload: str, bench: Optional[Dict] = None) -> Dict:
    """The cell's entry, configuration, traffic mix and limits."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {"entry": entry, "bench": bench,
            "config": load_json(ROOT / conf["file"]),
            "traffic": load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{workload}.json")}


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_metrics(c: Dict) -> list:
    """The per-layer metrics this cell reports: those listing it, and those
    without a list whose end-to-end metric the cell reports."""
    name = c["entry"]["name"]
    e2e = {m["name"] for m in c["bench"]["end_to_end"]
           if "workloads" not in m or name in m["workloads"]}
    return [m for m in c["bench"]["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None,
             c: Optional[Dict] = None, log=None, t_start: Optional[float] = None) -> Dict:
    """Set-up, window, optional traced sub-window, check: the result dict.
    `device` None: CUDA (raises without the chips the cell asks for).
    `t_start`: when set-up began (default: now)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    c = c or cell(workload)
    log = log or (lambda obj: print(json.dumps(obj), flush=True))
    if device is None:
        need = int(c["entry"].get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise SystemExit(f"perfbench: needs {need} CUDA device(s); found "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    tf32 = bool(c["config"].get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    driver_mod = importlib.import_module(f"perfbench.drivers.{c['traffic']['driver']}")
    drv = driver_mod.Driver(c["config"], c["traffic"], seed, device, log)

    drv.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    out = drv.window(seconds)
    metrics = {}
    breakdown = None
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
           if device.type == "cuda" else 0}
    if trace:
        ctx = drv.traced()
        dev["busy_s"] = ctx["trace"].busy_s
        dev["window_s"] = ctx["trace"].window_s
        if device.type == "cuda":
            dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
        for m in per_layer_metrics(c):
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = {"device_ops": [[n, s] for n, s in ctx["trace"].device_ops],
                     "idle_gaps": [[n, s] for n, s in ctx["trace"].idle_gaps]}
    else:
        for m in c["bench"]["end_to_end"]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            v = setup_s if m["name"] == "setup_s" else out["metrics"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    log({"info": "window", **out.get("info", {})})
    drv.release()
    numbers = drv.check()
    checks = {k: {"value": float(numbers[k]), "limit": float(lim)}
              for k, lim in c["limits"].items() if not k.startswith("_")}
    correct = bool(checks) and all(x["value"] <= x["limit"] for x in checks.values()) \
        and out["failed"] == 0
    res = {"correct": correct, "attempted": int(out["attempted"]), "failed": int(out["failed"]),
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        res["breakdown"] = breakdown
    res["checks"] = checks
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env()
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for k, v in res["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
