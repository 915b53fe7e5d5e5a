"""
Closed-loop batch serving on the card: one client calls the Predictor's
deployed program (`Predictor._predict_device`: the quantized forward at the
deploy temperature, decode and NMS at the Predictor's gate and pool) back to
back on uint8 letterboxed batches already on the card, cycled from a pool
made from the seed.

Traffic parameters: `batch`, `pool_batches`.  End-to-end: images of all
calls completed in the window over the window's seconds (synchronised at its
end).  Check: one call of the window, drawn from the seed, against the
reference on the same batch: complexity and bit maps of the three scales,
avg_bits, the Detect head's raw maps and the detections.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from .. import gen, trace, weights, yardsticks
from ..compare import per_image
from ..reference import network as rn
from . import common


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, log):
        self.cfg, self.traffic, self.seed, self.device, self.log = cfg, traffic, seed, device, log
        self.B = int(traffic["batch"])
        self.S = int(cfg["img_size"])
        self.serve = cfg["serve"]

    def setup(self):
        cfg, dev = self.cfg, self.device
        self.ref = common.reference_model(cfg, self.seed, dev, self.serve["morph_downsample"])
        self.batches = gen.letterboxed_batches(self.seed, int(self.traffic["pool_batches"]),
                                               self.B, self.S, dev)
        with torch.no_grad():
            spread = weights.spread_(self.ref, self.batches[0][:32])
        with common.Checkpoint(cfg, self.ref.state_dict(), dev) as ck:
            self.pred = common.predictor(cfg, ck.path, dev)
        self.ref.to("cpu")
        self.entry = self.pred._predict_device
        times = []
        for i in range(3):
            t = time.perf_counter()
            self.entry(self.batches[i % len(self.batches)])
            common.sync(dev)
            times.append(time.perf_counter() - t)
        self.call_s = min(times)
        self.log({"info": "setup", "spread": spread, "warmup_call_s": times,
                  "device_stamp": device_stamp(dev)})

    def window(self, seconds: float) -> Dict:
        g = gen.generator(self.seed, "cpu", stream=4)
        expect = max(1, int(seconds / max(self.call_s, 1e-6)) // 2)
        self.pick = int(torch.randint(0, expect, (1,), generator=g))
        cap = common.Capture(self.pred.model)
        fails = torch.zeros((), dtype=torch.int64, device=self.device)
        n = raised = 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        half = None  # (calls, seconds) at the first call that ends past the window's middle
        while True:
            x = self.batches[n % len(self.batches)]
            cap.on = n == self.pick
            try:
                out = self.entry(x)
            except RuntimeError as e:  # a call that raises is a failed call
                raised += 1
                self.log({"info": "call raised", "error": str(e)[:500]})
                out = None
            if out is not None:
                fails += ~(torch.isfinite(out[0]).all() & torch.isfinite(out[1]).all()
                           & torch.isfinite(out[4]))
                if cap.on:
                    self.picked = {"x": n % len(self.batches), "out": [o.clone() for o in out]}
            n += 1
            now = time.perf_counter() - t0
            if half is None and now >= seconds / 2:
                common.sync(self.device)
                half = (n, time.perf_counter() - t0)
            if now >= seconds:
                break
        common.sync(self.device)
        wall = time.perf_counter() - t0
        cap.on = False
        cap.remove()
        self.cap = cap
        self.window_s = wall
        self.calls = n
        rate = n * self.B / wall
        self.rate = rate
        self.peak_window = torch.cuda.max_memory_allocated(self.device) \
            if self.device.type == "cuda" else 0
        failed = int(fails) + raised
        return {"metrics": {"serve_images_per_s": rate}, "attempted": n, "failed": failed,
                "info": {"calls": n, "images": n * self.B, "window_s": wall,
                         "images_per_s_by_half": halves(n, wall, half, self.B),
                         "checked_call": self.pick, **self.program_info()}}

    def program_info(self) -> Dict:
        out = self.picked["out"]
        gated = out[7].float()
        bits = torch.cat([b.reshape(-1) for b in self.cap.bits])
        hist = torch.bincount(torch.round(bits).long().clamp(2, 8) - 2, minlength=7)
        info = {"above_gate_candidates_per_image": float(gated.mean()),
                "above_gate_max": int(gated.max()), "pool": self.serve["pool"],
                "tile_bits_histogram_2_to_8": hist.tolist(),
                "avg_bits": float(out[4])}
        info.update(launch_counters())
        return info

    def traced(self) -> Dict:
        m = self.pred.model
        ranges = trace.Ranges({"model": m, "backbone": m.backbone, "neck": m.neck,
                               "head": m.head, "complexity_analyzer": m.complexity_analyzer,
                               "bit_mapper": m.bit_mapper, "quantizer_p3": m.quantizer_p3,
                               "quantizer_p4": m.quantizer_p4, "quantizer_p5": m.quantizer_p5})
        calls = int(self.traffic["traced_calls"])

        def work():
            for j in range(calls):
                with trace.span("call"):
                    self.entry(self.batches[j % len(self.batches)])

        with ranges:
            tr = trace.profile(work)
        q, p = yardsticks.serve_bounds(self.B, self.S, self.cfg["variant"],
                                       self.cfg["mcaq"]["grid_size"],
                                       self.serve["morph_downsample"])
        return {"trace": tr, "images": calls * self.B, "calls": calls,
                "images_per_s": self.rate,
                "flops_per_image": yardsticks.network_flops(self.cfg["variant"], self.cfg["nc"],
                                                            self.S),
                "quant_bound_s": q * calls, "phi_bound_s": p * calls,
                "peak_window_bytes": self.peak_window}

    def release(self):
        del self.pred, self.entry
        common.free(self.device)

    def check(self) -> Dict[str, float]:
        out = self.picked["out"]
        prog = {**self.cap.call(0), "dets": per_image(*out[:4])}
        self.ref.to(self.device)
        self.own = common.reference_state(self.ref, self.batches[self.picked["x"]], self.serve)
        return self.numbers(prog)

    def numbers(self, prog: Dict) -> Dict[str, float]:
        x = self.batches[self.picked["x"]]
        given = common.reference_state(self.ref, x, self.serve, prog["feats"], prog["bits"])
        return common.serve_numbers(prog, self.own, given,
                                    common.detections(prog["raw"], self.serve))

    def control(self) -> Dict[str, float]:
        """The numbers of the control: the reference one precision below the
        configuration's (float8 convolutions, TF32 MCAQ math, bfloat16
        decode and NMS) in the program's place, on the checked batch."""
        rn.set_precision(self.ref, "fp8")
        try:
            ctrl = common.reference_state(self.ref, self.batches[self.picked["x"]], self.serve,
                                          lower=True)
        finally:
            rn.set_precision(self.ref, "fp32")
        return self.numbers(ctrl)


def halves(n: int, wall: float, half, per: int):
    """Rates of the window's two halves (a whole window's noise against the
    noise between windows); None when the first half held every call."""
    if half is None or half[0] >= n:
        return None
    return [half[0] * per / half[1], (n - half[0]) * per / (wall - half[1])]


def launch_counters() -> Dict:
    """The program's two launch counters (fixed by design: 3 + 3 a forward)."""
    from mcaq_yolo_tpu_torch.core import morphology_lanes
    from mcaq_yolo_tpu_torch.ops import spatial_quant

    return {"spatial_quantize_launches": spatial_quant.spatial_quantize.launches,
            "phi_tiles_launches": morphology_lanes.phi_tiles.launches}


def device_stamp(device) -> Dict:
    if torch.device(device).type != "cuda":
        return {"device": "cpu"}
    from mcaq_yolo_tpu_torch.utils.profiling import device_stamp as stamp

    return stamp(device)
