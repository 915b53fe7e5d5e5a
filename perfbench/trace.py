"""
The traced sub-window: ranges opened around the program's modules, a
`torch.profiler` capture of the card, and its reduction to kernels
attributed to ranges, the device's busy time, its idle gaps and the
breakdown of the result line.

Ranges are `record_function` annotations named `pb:<label>`, opened in a
forward pre-hook and closed in a forward hook of each module given to
`Ranges`, and by the drivers around each call (`span`).  A kernel belongs to
the innermost range open on the host thread when it was launched (matched
through the profiler's correlation ids).  The idle-share arithmetic (the
union of device intervals over the profiled wall time) is
`chip_smoke.py:phase_train_timing`'s at commit 00c80e2.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

PREFIX = "pb:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


class Ranges:
    """Profiler ranges around modules: `with Ranges({'backbone': m.backbone, ...})`."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.modules = modules
        self.handles = []
        self.open: List = []

    def _pre(self, label):
        def hook(module, args):
            rf = torch.autograd.profiler.record_function(PREFIX + label)
            rf.__enter__()
            self.open.append(rf)
        return hook

    def _post(self, module, args, out):
        self.open.pop().__exit__(None, None, None)

    def __enter__(self):
        for label, m in self.modules.items():
            self.handles.append(m.register_forward_pre_hook(self._pre(label)))
            self.handles.append(m.register_forward_hook(self._post))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []


def span(label: str):
    return torch.autograd.profiler.record_function(PREFIX + label)


@dataclass
class Kernel:
    name: str
    start_us: float
    dur_us: float
    ranges: Tuple[str, ...]  # outermost first, labels without the prefix


@dataclass
class Trace:
    kernels: List[Kernel] = field(default_factory=list)
    window_s: float = 0.0        # host clock around the profiled work, synchronised
    busy_s: float = 0.0          # union of device operations inside the window
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def device_seconds(self, pred: Callable[[Kernel], bool]) -> Optional[float]:
        picked = [k.dur_us for k in self.kernels if pred(k)]
        return sum(picked) * 1e-6 if picked else None

    def in_range(self, *labels: str) -> Callable[[Kernel], bool]:
        return lambda k: any(lab in k.ranges for lab in labels)

    def named(self, *parts: str) -> Callable[[Kernel], bool]:
        return lambda k: any(p in k.name for p in parts)


def _union(intervals: Sequence[Tuple[float, float]]):
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(ranges: List[Tuple[float, float, str]], starts: List[float], t: float):
    """Labels of the nested ranges (sorted by start) that contain t."""
    out = []
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        s, e, name = ranges[i]
        if e >= t and s <= t:
            out.append(name)
        if len(out) > 16:
            break
    return tuple(reversed(out))


def reduce(events: List[Dict], t0_us: float, t1_us: float) -> Trace:
    """Chrome-trace events -> `Trace` over [t0_us, t1_us]."""
    launches: Dict[int, Tuple[float, int]] = {}
    ann: Dict[int, List[Tuple[float, float, str]]] = {}
    host: Dict[int, List[Tuple[float, float, str]]] = {}
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append(ev)
            continue
        tid = ev.get("tid")
        if cat in LAUNCH_CATS and "correlation" in ev.get("args", {}):
            launches[ev["args"]["correlation"]] = (ts, tid)
        if cat == "user_annotation" and ev.get("name", "").startswith(PREFIX):
            ann.setdefault(tid, []).append((ts, ts + dur, ev["name"][len(PREFIX):]))
        if cat in HOST_CATS:
            host.setdefault(tid, []).append((ts, ts + dur, ev.get("name", "")))
    for d in (ann, host):
        for tid in d:
            d[tid].sort()
    starts = {tid: [r[0] for r in rs] for tid, rs in ann.items()}
    tr = Trace()
    busy, by_name = [], {}
    launch_tids: Dict = {}
    for ev in device:
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if ts + dur < t0_us or ts > t1_us:
            continue
        busy.append((max(ts, t0_us), min(ts + dur, t1_us)))
        name = ev.get("name", "")
        by_name[name] = by_name.get(name, 0.0) + dur
        if ev.get("cat") != "kernel":
            continue
        corr = ev.get("args", {}).get("correlation")
        labels: Tuple[str, ...] = ()
        if corr in launches:
            lts, tid = launches[corr]
            launch_tids[tid] = launch_tids.get(tid, 0) + 1
            if tid in ann:
                labels = _innermost(ann[tid], starts[tid], lts)
        tr.kernels.append(Kernel(name, ts, dur, labels))
    merged = _union(busy)
    tr.busy_s = sum(e - s for s, e in merged) * 1e-6
    tr.window_s = (t1_us - t0_us) * 1e-6
    tr.device_ops = sorted(((n[:120], d * 1e-6) for n, d in by_name.items()),
                           key=lambda kv: -kv[1])[:10]
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    if merged:
        gaps = [(t0_us, merged[0][0])] + gaps + [(merged[-1][1], t1_us)]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:10]
    main = max(launch_tids, key=launch_tids.get) if launch_tids else None
    hs = host.get(main, [])
    hstarts = [r[0] for r in hs]
    for s, e in gaps:
        inside = _innermost(hs, hstarts, s + min(1.0, (e - s) / 2))
        tr.idle_gaps.append((inside[-1][:120] if inside else "host idle", (e - s) * 1e-6))
    return tr


def profile(fn: Callable[[], None]) -> Trace:
    """Run fn() under the profiler (host and CUDA), synchronised at both
    ends; the chrome trace goes to a temporary file under TMPDIR, which is
    removed."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with tprofile(activities=acts) as prof:
        with span("window"):
            t = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    win = [ev for ev in events if ev.get("name") == PREFIX + "window" and ev.get("ph") == "X"
           and ev.get("cat") == "user_annotation"]
    t0 = float(win[0]["ts"])
    tr = reduce(events, t0, t0 + float(win[0]["dur"]))
    tr.window_s = wall
    return tr
