"""Small cells for the benchmark's CPU tests: a cell's configuration and
traffic cut to 64 px and a few images, and the program's models built on
the CPU from a reference state dict."""

from __future__ import annotations

import copy
from typing import Dict

import torch

from perfbench import run

TINY = {"batch": 2, "pool_batches": 4, "pool_frames": 8, "checked_requests": 2,
        "traced_requests": 2, "traced_calls": 1, "marked_steps": 1, "traced_steps": 1}


# a cell whose files are in place but which BENCHMARK.json does not list yet
PENDING = {"n-serve-bs1": {"name": "n-serve-bs1", "config": "yolov8n-mcaq",
                           "traffic": "serve_single_host", "chips": 1, "why": "pending"}}


def cell(workload: str) -> Dict:
    if workload not in PENDING:
        return run.cell(workload)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    bench["workloads"] = bench["workloads"] + [PENDING[workload]]
    return run.cell(workload, bench)


def tiny_cell(workload: str, img: int = 64) -> Dict:
    c = copy.deepcopy(cell(workload))
    c["config"]["img_size"] = img
    for k, v in TINY.items():
        if k in c["traffic"]:
            c["traffic"][k] = v
    return c


def run_tiny(workload: str, seed: int = 1234567890123, trace: bool = False, c=None) -> Dict:
    torch.set_num_threads(2)
    return run.run_cell(workload, seed, 0.3, trace, device="cpu", c=c or tiny_cell(workload),
                        log=lambda obj: None)
