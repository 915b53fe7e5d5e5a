"""
`serve_batch`'s closed loop on a YOLO11 configuration (cell
`l11-serve-bs256`): the same calls of `Predictor._predict_device`, inputs,
window and stage-by-stage check, with

  * the reference built from `reference/yolo11.py` (YOLO11 with
    `reference.mcaq`'s transform on its taps, layers 4, 6 and 10), weights
    from the seed and the spread of `weights.py`;
  * a `psa` range on the backbone's C2PSA in the traced sub-window;
  * `flops_per_image`: 2 x MACs of every convolution plus the attention's two
    products (`reference.yolo11.network_flops`), from the shapes;
  * `quant_bound_s` / `phi_bound_s` at YOLO11's tap shapes (`serve_bounds`).

A program without the configuration's family fails at the start of set-up.
"""

from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple

import torch

from .. import gen, trace, weights, yardsticks
from ..reference import yolo11 as ry
from ..reference.mcaq import gray_geometry, tile_size_for
from ..reference.network import STRIDES
from . import common, serve_batch


def serve_bounds(B: int, img: int, channels: Sequence[int], grid: int, downsample: int,
                 elem: int = 2) -> Tuple[float, float]:
    """(quantize, phi) least seconds of one deployed call of batch B on taps
    of `channels` at strides 8 / 16 / 32 (`yardsticks.serve_bounds`' rule)."""
    q = p = 0.0
    for s, C in zip(STRIDES, channels):
        H = W = img // s
        t0 = tile_size_for(H, grid)
        Hc, Wc, ds, tile = gray_geometry(H, W, grid, downsample)
        Hg, Wg = Hc // ds, Wc // ds
        q += yardsticks.bound_s(yardsticks.quant_bytes(B, H, W, C, elem, H // t0, W // t0),
                                yardsticks.quant_ops(B, H, W, C))
        p += yardsticks.bound_s(yardsticks.phi_tiles_bytes(B, Hg, Wg, tile),
                                yardsticks.phi_tiles_ops(B * Hg * Wg))
    return q, p


def flops_per_image(variant: str, nc: int, img: int) -> int:
    return sum(ry.network_flops(variant, nc, img))


class Driver(serve_batch.Driver):
    def setup(self):
        from mcaq_yolo_tpu_torch.models.yolo import variant_channels

        cfg, dev = self.cfg, self.device
        taps = list(variant_channels(cfg["variant"]))  # raises on a program without YOLO11
        if taps != list(ry.variant_channels(cfg["variant"])):
            raise SystemExit(f"program taps {taps} differ from the reference's")
        ref = weights.build(ry.MCAQYOLO, dev, cfg["variant"], cfg["nc"],
                            cfg["mcaq"]["grid_size"], self.serve["morph_downsample"])
        self.ref = weights.init_(ref, self.seed, cfg["nc"]).eval()
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
                  "device_stamp": serve_batch.device_stamp(dev)})

    def traced(self) -> Dict:
        m = self.pred.model
        ranges = trace.Ranges({"model": m, "backbone": m.backbone, "neck": m.neck,
                               "head": m.head, "psa": m.backbone.C2PSA_0,
                               "complexity_analyzer": m.complexity_analyzer,
                               "bit_mapper": m.bit_mapper, "quantizer_p3": m.quantizer_p3,
                               "quantizer_p4": m.quantizer_p4, "quantizer_p5": m.quantizer_p5})
        calls = int(self.traffic["traced_calls"])

        def work():
            for j in range(calls):
                with trace.span("call"):
                    self.entry(self.batches[j % len(self.batches)])

        with ranges:
            tr = trace.profile(work)
        cfg = self.cfg
        q, p = serve_bounds(self.B, self.S, cfg["c3_c4_c5_channels"], cfg["mcaq"]["grid_size"],
                            self.serve["morph_downsample"])
        return {"trace": tr, "images": calls * self.B, "calls": calls,
                "images_per_s": self.rate,
                "flops_per_image": flops_per_image(cfg["variant"], cfg["nc"], self.S),
                "quant_bound_s": q * calls, "phi_bound_s": p * calls,
                "peak_window_bytes": self.peak_window}
