"""
`serve_batch`'s closed loop on YOLO12-L (cell `l12-serve-bs256`): the same
calls of `Predictor._predict_device`, inputs, window and stage-by-stage
check, with

  * the reference built from `reference/yolo12.py` (YOLO12 with
    `reference.mcaq`'s transform on its taps, yaml layers 4, 6 and 8),
    weights from the seed (`reference.yolo12.init_`) and the spread of
    `weights.py`;
  * an `area` range on each of the backbone's two A2C2f blocks with
    attention and an `area_sdpa` range on each of their attention cores
    (the program's parameter-free `sdpa` submodule of every AAttn) in the
    traced sub-window;
  * `flops_per_image`: 2 x MACs of every convolution plus the area
    attentions' two products (`reference.yolo12.network_flops`);
  * `quant_bound_s` / `phi_bound_s` at the 512-channel taps
    (`serve_batch_y11.serve_bounds`), and `area_attn_bound_s`, the least
    time of the attention cores (`area_attn_bytes`, `area_attn_flops`);
  * the check: `serve_batch`'s numbers, stage by stage, and
    `attn_rel_err_given`, the relative L2 of the last P4 AAttn's output
    against the float32 reference's AAttn on the program's own input to
    it.  Each A2C2f with attention adds gamma (0.01) times its output to
    its input, so the taps alone would not show an attention computed too
    coarsely.

A program without the configuration's family fails at the start of set-up.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

from .. import compare, gen, trace, weights, yardsticks
from ..reference import mcaq as rm
from ..reference import network as rn
from ..reference import yolo12 as ry
from . import common, serve_batch, serve_batch_y11

ATTN_ELEMENT_BYTES = 2  # q, k, v and o in the network's bfloat16


def flops_per_image(variant: str, nc: int, img: int) -> int:
    return sum(ry.network_flops(variant, nc, img))


def area_attn_bytes(B: int, img: int, variant: str) -> int:
    """Bytes the area attentions' cores of one call must move: per image
    and attention q, k and v read once and o written once, N x C each."""
    return B * sum(4 * N * C * ATTN_ELEMENT_BYTES
                   for N, C, _, _ in ry.attention_shapes(variant, img))


def area_attn_flops(B: int, img: int, variant: str) -> int:
    """The cores' two products of one call: q^T k and v attn^T (2 x MACs)."""
    return B * ry.network_flops(variant, 80, img)[1]


def area_attn_bound_s(B: int, img: int, variant: str) -> float:
    """The least time of one call's attention cores: its bytes at the HBM
    rate or its products at the bf16 tensor-core rate, the longer."""
    return max(area_attn_bytes(B, img, variant) / yardsticks.HBM_BYTES_PER_S,
               area_attn_flops(B, img, variant) / yardsticks.BF16_TENSOR_FLOPS)


def last_p4_attention(model):
    """The last AAttn of the P4 stage (yaml layer 6), the program's or the
    reference's (the two share the module names)."""
    a2 = model.backbone.A2C2f_0
    return [m for name, m in a2.named_modules() if name.endswith("AAttn_0")][-1]


def attention_cores(model) -> List[torch.nn.Module]:
    """The attention cores (`sdpa`) of the program's backbone A2C2f blocks."""
    return [m for a2 in (model.backbone.A2C2f_0, model.backbone.A2C2f_1)
            for name, m in a2.named_modules() if name.endswith("AAttn_0.sdpa")]


class Capture(common.Capture):
    """`common.Capture`'s hooks and the last P4 AAttn's input and output
    (`attn`)."""

    def __init__(self, model):
        super().__init__(model)
        self.attn: List[tuple] = []
        self.handles.append(last_p4_attention(model).register_forward_hook(self._attn))

    def _attn(self, m, args, out):
        if self.on:
            self.attn.append((args[0].detach().clone(), out.detach().clone()))

    def call(self, k: int) -> Dict:
        out = super().call(k)
        out["attn"] = self.attn[k]
        return out


@torch.no_grad()
def attn_rel_err(ref: ry.MCAQYOLO, attn: tuple, block: int = 32) -> float:
    """Relative L2 of an AAttn output (`Capture.attn`: input, output)
    against the reference's last P4 AAttn, as its precision stands, on the
    same input (as float32)."""
    x, out = attn
    att = last_p4_attention(ref)
    with rm.float32_products():
        want = torch.cat([att(x[i:i + block].float()) for i in range(0, x.shape[0], block)])
    return compare.rel_err([out], [want])


class Driver(serve_batch.Driver):
    def setup(self):
        from mcaq_yolo_tpu_torch.models.yolo import variant_channels

        cfg, dev = self.cfg, self.device
        taps = list(variant_channels(cfg["variant"]))  # raises on a program without YOLO12
        if taps != list(ry.variant_channels(cfg["variant"])):
            raise SystemExit(f"program taps {taps} differ from the reference's")
        ref = weights.build(ry.MCAQYOLO, dev, cfg["variant"], cfg["nc"],
                            cfg["mcaq"]["grid_size"], self.serve["morph_downsample"])
        self.ref = ry.init_(ref, self.seed, cfg["nc"]).eval()
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

    def window(self, seconds: float) -> Dict:
        """`serve_batch.Driver.window` with this file's `Capture` in place
        of `common.Capture` for the window's duration."""
        base = common.Capture
        common.Capture = Capture
        try:
            return super().window(seconds)
        finally:
            common.Capture = base

    def traced(self) -> Dict:
        m = self.pred.model
        ranges = [trace.Ranges({"model": m, "backbone": m.backbone, "neck": m.neck,
                                "head": m.head, "complexity_analyzer": m.complexity_analyzer,
                                "bit_mapper": m.bit_mapper, "quantizer_p3": m.quantizer_p3,
                                "quantizer_p4": m.quantizer_p4,
                                "quantizer_p5": m.quantizer_p5})]
        ranges += [trace.Ranges({"area": a2}) for a2 in (m.backbone.A2C2f_0,
                                                         m.backbone.A2C2f_1)]
        ranges += [trace.Ranges({"area_sdpa": core}) for core in attention_cores(m)]
        calls = int(self.traffic["traced_calls"])

        def work():
            for j in range(calls):
                with trace.span("call"):
                    self.entry(self.batches[j % len(self.batches)])

        with contextlib.ExitStack() as stack:
            for r in ranges:
                stack.enter_context(r)
            tr = trace.profile(work)
        cfg = self.cfg
        q, p = serve_batch_y11.serve_bounds(self.B, self.S, cfg["c3_c4_c5_channels"],
                                            cfg["mcaq"]["grid_size"],
                                            self.serve["morph_downsample"])
        return {"trace": tr, "images": calls * self.B, "calls": calls,
                "images_per_s": self.rate,
                "flops_per_image": flops_per_image(cfg["variant"], cfg["nc"], self.S),
                "quant_bound_s": q * calls, "phi_bound_s": p * calls,
                "area_attn_bound_s": area_attn_bound_s(self.B, self.S, cfg["variant"]) * calls,
                "peak_window_bytes": self.peak_window}

    def numbers(self, prog: Dict) -> Dict[str, float]:
        out = super().numbers(prog)
        out["attn_rel_err_given"] = attn_rel_err(self.ref, prog["attn"])
        return out

    def control(self) -> Dict[str, float]:
        """The numbers of the control: the reference one precision below the
        configuration's (float8 convolutions and attention operands, TF32
        MCAQ math, bfloat16 decode and NMS) in the program's place, on the
        checked batch, its own last P4 attention's input and output
        included."""
        rows = []
        hook = last_p4_attention(self.ref).register_forward_hook(
            lambda m, args, out: rows.append((args[0], out)))
        rn.set_precision(self.ref, "fp8")
        try:
            ctrl = common.reference_state(self.ref, self.batches[self.picked["x"]], self.serve,
                                          lower=True)
        finally:
            rn.set_precision(self.ref, "fp32")
            hook.remove()
        ctrl["attn"] = (torch.cat([r[0] for r in rows]), torch.cat([r[1] for r in rows]))
        return self.numbers(ctrl)
