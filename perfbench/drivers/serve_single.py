"""
One client, closed loop, one frame a request: `Predictor.predict(frame)` on
host uint8 frames of the eight serving sizes (the host letterbox, the H2D
copy, the deployed program at batch 1, the D2H copy and the unletterbox),
cycled in an order drawn from the seed from a pool made from the seed.

Traffic parameters: `pool_frames` (a multiple of 8), `checked_requests`,
`traced_requests`.  End-to-end: the 95th percentile (nearest rank) of the
host-clock latency of every request of the window.  Check: requests drawn
from the seed among those of the window, against the reference on the same
frames (its own letterbox): complexity and bit maps, avg_bits, the raw maps
and the detections in the frame's coordinates.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from .. import gen, trace, weights
from ..reference import network as rn
from . import common
from .serve_batch import device_stamp, launch_counters


def nearest_rank(xs: List[float], q: float) -> float:
    s = sorted(xs)
    return s[max(0, math.ceil(q * len(s)) - 1)]


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, log):
        self.cfg, self.traffic, self.seed, self.device, self.log = cfg, traffic, seed, device, log
        self.S = int(cfg["img_size"])
        self.serve = cfg["serve"]

    def setup(self):
        cfg, dev = self.cfg, self.device
        self.ref = common.reference_model(cfg, self.seed, dev, self.serve["morph_downsample"])
        g = gen.generator(self.seed, dev, stream=5)
        sizes = gen.size_order(g, int(self.traffic["pool_frames"]), dev)
        frames = gen.serving_frames(g, sizes, dev)
        first = torch.stack([gen.letterbox(f[None], self.S)[0] for f in frames[:32]])
        with torch.no_grad():
            spread = weights.spread_(self.ref, first)
        self.frames = [f.cpu().numpy() for f in frames]
        self.order = torch.randperm(len(frames),
                                    generator=gen.generator(self.seed, "cpu", 6)).tolist()
        with common.Checkpoint(cfg, self.ref.state_dict(), dev) as ck:
            self.pred = common.predictor(cfg, ck.path, dev)
        self.ref.to("cpu")
        times = []
        for k in range(2 * len(gen.SERVING_SIZES)):  # every size, twice
            t = time.perf_counter()
            self.pred.predict(self.frames[self.order[k % len(self.order)]])
            times.append(time.perf_counter() - t)
        self.req_s = statistics.median(times[len(gen.SERVING_SIZES):])
        self.log({"info": "setup", "spread": spread, "warmup_request_s": times,
                  "device_stamp": device_stamp(dev)})

    def frame(self, n: int) -> int:
        return self.order[n % len(self.order)]

    def window(self, seconds: float) -> Dict:
        g = gen.generator(self.seed, "cpu", stream=7)
        expect = max(int(self.traffic["checked_requests"]),
                     int(seconds / max(self.req_s, 1e-6)) // 2)
        self.picks = sorted(torch.randperm(expect, generator=g)[
            :int(self.traffic["checked_requests"])].tolist())
        cap = common.Capture(self.pred.model)
        lat, self.kept, failed, n = [], {}, 0, 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        while True:
            cap.on = n in self.picks
            before = len(cap.raw)
            t = time.perf_counter()
            try:
                r = self.pred.predict(self.frames[self.frame(n)])
                ok = np.isfinite(r["avg_bits"]) and all(
                    np.isfinite(d["bbox"]).all() and np.isfinite(d["confidence"])
                    for d in r["detections"])
            except RuntimeError as e:  # a request that raises is a failed request
                self.log({"info": "request raised", "error": str(e)[:500]})
                r, ok = None, False
            # a request that failed counts as a miss of any limit
            lat.append((time.perf_counter() - t) * 1e3 if ok else math.inf)
            failed += not ok
            if cap.on and r is not None:
                self.kept[n] = (r, before)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        common.sync(self.device)
        wall = time.perf_counter() - t0
        cap.on = False
        cap.remove()
        self.cap = cap
        ms = sorted(lat)
        p95 = nearest_rank(ms, 0.95)
        self.peak_window = torch.cuda.max_memory_allocated(self.device) \
            if self.device.type == "cuda" else 0
        gated = [len(r["detections"]) for r, _ in self.kept.values()]
        info = {"requests": n, "window_s": wall, "latency_p50_ms": statistics.median(ms),
                "latency_p95_ms": p95, "latency_max_ms": ms[-1],
                "requests_beyond_p95": sum(x > p95 for x in ms),
                "checked_requests": sorted(self.kept), "detections_per_checked_request": gated,
                **launch_counters()}
        return {"metrics": {"serve_p95_ms": p95}, "attempted": n, "failed": failed,
                "info": info}

    def traced(self) -> Dict:
        n = int(self.traffic["traced_requests"])
        orig = self.pred._predict_device
        spans: List[float] = []

        def timed(x):
            t = time.perf_counter()
            out = orig(x)
            spans.append(time.perf_counter() - t)
            return out

        self.pred._predict_device = timed
        host = []
        try:
            for k in range(n):
                spans.clear()
                t = time.perf_counter()
                self.pred.predict(self.frames[self.frame(k)])
                host.append((time.perf_counter() - t - sum(spans)) * 1e3)
        finally:
            self.pred._predict_device = orig
        m = self.pred.model
        ranges = trace.Ranges({"model": m, "backbone": m.backbone, "neck": m.neck,
                               "head": m.head, "complexity_analyzer": m.complexity_analyzer,
                               "bit_mapper": m.bit_mapper})

        def work():
            for k in range(n):
                with trace.span("request"):
                    self.pred.predict(self.frames[self.frame(k)])

        with ranges:
            tr = trace.profile(work)
        return {"trace": tr, "requests": n, "host_ms": statistics.median(host),
                "peak_window_bytes": self.peak_window}

    def release(self):
        del self.pred
        common.free(self.device)

    def _frame(self, n: int):
        f = torch.from_numpy(self.frames[self.frame(n)]).to(self.device)
        return f, gen.letterbox(f[None], self.S)

    def _unbox(self, dets, f):
        for d in dets:
            d["boxes"] = gen.unletterbox(d["boxes"], f.shape[0], f.shape[1], self.S)
        return dets

    def check(self) -> Dict[str, float]:
        self.ref.to(self.device)
        progs, self.own = [], []
        for n in sorted(self.kept):
            r, before = self.kept[n]
            dets = r["detections"]
            progs.append({**self.cap.call(before // 3), "dets": [{
                "boxes": torch.tensor([d["bbox"] for d in dets], dtype=torch.float32,
                                      device=self.device).reshape(-1, 4),
                "scores": torch.tensor([d["confidence"] for d in dets], device=self.device),
                "classes": torch.tensor([d["class_id"] for d in dets], device=self.device)}]})
            f, x = self._frame(n)
            own = common.reference_state(self.ref, x, self.serve)
            own["dets"] = self._unbox(own["dets"], f)
            self.own.append(own)
        return self.numbers(progs)

    def numbers(self, progs: List[Dict]) -> Dict[str, float]:
        """Per checked request, the reference following `progs` (the
        program's states, or the control's), merged over the requests."""
        given, of_raw = [], []
        for p, n in zip(progs, sorted(self.kept)):
            f, x = self._frame(n)
            given.append(common.reference_state(self.ref, x, self.serve, p["feats"], p["bits"]))
            of_raw += self._unbox(common.detections(p["raw"], self.serve), f)
        return common.serve_numbers(merge(progs), merge(self.own), merge(given), of_raw)

    def control(self) -> Dict[str, float]:
        ctrl = []
        rn.set_precision(self.ref, "fp8")
        try:
            for n in sorted(self.kept):
                f, x = self._frame(n)
                st = common.reference_state(self.ref, x, self.serve, lower=True)
                st["dets"] = self._unbox(st["dets"], f)
                ctrl.append(st)
        finally:
            rn.set_precision(self.ref, "fp32")
        return self.numbers(ctrl)


def merge(states: List[Dict]) -> Dict:
    """Per-request states as one: the lists joined."""
    return {k: [t for st in states for t in st[k]]
            for k in ("feats", "complexity", "bits", "raw", "dets")}
