"""
`serve_batch`'s closed loop on RT-DETR-L (cell `rtdetr-l-serve-bs256`): the
same calls of `Predictor._predict_device`, inputs and window, with

  * the reference built from `reference/rtdetr.py` (RT-DETR-L with
    `reference.mcaq`'s transform on its taps, yaml layers 3, 7 and 9),
    weights from the seed (`reference.rtdetr.init_`) and its own spread
    (`reference.rtdetr.spread_`);
  * the Predictor at the configuration's gate and max_det (no IoU, no NMS
    pool: the post-process is NMS-free);
  * a `decoder` range on the RTDETRDecoder and a `deform` range on each of
    its six deformable samplings in the traced sub-window;
  * `flops_per_image`: 2 x MACs of every convolution and linear layer plus
    the attentions' products (`reference.rtdetr.network_flops`);
  * `quant_bound_s` / `phi_bound_s` at the 512 / 1024 / 2048-channel taps
    (`serve_batch_y11.serve_bounds`), and `deform_bound_s`, the least time
    of the deformable samplings (`deform_bytes`, `deform_ops`);
  * the check stage by stage, each stage from the program's own output
    before it: the taps from the images (`feat_rel_err`); the complexity and
    bit maps from the program's taps; the encoder logits (B, 8400, nc) from
    the program's taps and bit maps (`enc_rel_err_given`, relative L2); the
    selection of the program's encoder logits (`query_mismatch_given`, the
    share of the B x 300 ranks whose anchor differs; exact); the last
    decoder layer's deformable sampling from the program's value map,
    locations and weights (`deform_rel_err_given`, relative L2); the
    decoder's boxes and logits from the program's selection
    (`dec_rel_err_given`, the larger relative L2 of the two); the
    post-process of the program's decoder output (`det_mismatch_given`,
    `det_box_gap_given`; exact).  The end-to-end numbers from the images
    (`bits_mismatch`, `query_mismatch`, `query_set_mismatch`,
    `det_mismatch`) are kept for the record, under no limit.

A program without the RT-DETR family fails at the start of set-up.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

from .. import compare, gen, trace, weights, yardsticks
from ..compare import per_image
from ..reference import mcaq as rm
from ..reference import rtdetr as rr
from . import common, serve_batch, serve_batch_y11

# the sampling's shape (reference.rtdetr: 6 layers, 300 queries, 8 heads of
# 32 channels, 3 levels, 4 points) and its arithmetic: 4 bilinear taps a
# point and channel (a multiply-add each) and the weighted sum (one)
DEFORM_LAYERS, DEFORM_QUERIES, DEFORM_HEADS, DEFORM_HEAD_DIM = 6, 300, 8, 32
DEFORM_LEVELS, DEFORM_POINTS = 3, 4
DEFORM_OPS_PER_POINT_CHANNEL = 10


def deform_tokens(img: int) -> int:
    return sum((img // s) ** 2 for s in (8, 16, 32))


def deform_bytes(B: int, img: int) -> int:
    """Bytes the deformable samplings of one call must move: per image and
    layer the bfloat16 value map read once, the float32 locations (x, y)
    and weights read once, the bfloat16 output written once."""
    d = DEFORM_HEADS * DEFORM_HEAD_DIM
    points = DEFORM_QUERIES * DEFORM_HEADS * DEFORM_LEVELS * DEFORM_POINTS
    per = deform_tokens(img) * d * 2 + points * 3 * 4 + DEFORM_QUERIES * d * 2
    return B * DEFORM_LAYERS * per


def deform_ops(B: int) -> int:
    points = DEFORM_QUERIES * DEFORM_HEADS * DEFORM_LEVELS * DEFORM_POINTS
    return B * DEFORM_LAYERS * points * DEFORM_HEAD_DIM * DEFORM_OPS_PER_POINT_CHANNEL


def deform_bound_s(B: int, img: int) -> float:
    return yardsticks.bound_s(deform_bytes(B, img), deform_ops(B))


def flops_per_image(nc: int, img: int) -> int:
    return sum(rr.network_flops(nc, img))


def last_sample(head):
    """The last decoder layer's deformable sampling module of a head, the
    program's or the reference's."""
    return getattr(head, f"layers_{head.n_layers - 1}").cross_attn.sample


class Capture(common.Capture):
    """`common.Capture`'s hooks, the decoder's output [boxes, logits] as
    `raw`, the selection's input and output (`enc_logits`, `selection`),
    and the last decoder layer's sampling: its value map, level shapes,
    locations, weights and output (`sample`)."""

    def __init__(self, model):
        super().__init__(model)
        self.enc_logits: List[torch.Tensor] = []
        self.selection: List[torch.Tensor] = []
        self.sample: List[tuple] = []
        self.handles += [model.head.selection.register_forward_hook(self._select),
                         last_sample(model.head).register_forward_hook(self._sample)]

    def _select(self, m, args, out):
        if self.on:
            self.enc_logits.append(args[0].detach().clone())
            self.selection.append(out.detach().clone())

    def _sample(self, m, args, out):
        if self.on:
            value, shapes, loc, weights = args
            self.sample.append((value.detach().clone(), list(shapes), loc.detach().clone(),
                                weights.detach().clone(), out.detach().clone()))

    def call(self, k: int) -> Dict[str, List[torch.Tensor]]:
        out = {name: getattr(self, name)[3 * k:3 * k + 3]
               for name in ("feats", "complexity", "bits")}
        out["raw"] = self.raw[2 * k:2 * k + 2]
        out["enc_logits"], out["selection"] = self.enc_logits[k], self.selection[k]
        out["sample"] = self.sample[k]
        return out


def reference_state(ref: rr.MCAQYOLO, x: torch.Tensor, serve: Dict, img: int, feats=None,
                    bit_maps=None, selection=None, lower: bool = False,
                    sample: bool = False) -> Dict:
    """`reference.rtdetr.MCAQYOLO.forward_blocks` on the batch, and the
    post-process of its decoder output: float32 without TF32, or with
    `lower` (the control; its convolutions, linears and locations are set
    by `set_precision`) the MCAQ math with TF32 and the post-process in
    bfloat16.  With `sample`, also the last decoder layer's sampling as
    `Capture` keeps it (`sample`: value map, shapes, locations, weights,
    output; the locations as they enter, before a control rounds them)."""
    rows = []
    hook = last_sample(ref.head).register_forward_hook(
        lambda m, args, out: rows.append((*args, out))) if sample else None
    try:
        with torch.no_grad(), rm.float32_products(tf32=lower):
            out = ref.forward_blocks(x, serve["temperature"], feats=feats, bit_maps=bit_maps,
                                     selection=selection)
    finally:
        if hook is not None:
            hook.remove()
    if sample:
        value, shapes, loc, weights, o = zip(*rows)
        out["sample"] = (torch.cat(value), list(shapes[0]), torch.cat(loc),
                         torch.cat(weights), torch.cat(o))
    dt = torch.bfloat16 if lower else torch.float32
    out["dets"] = rr.select_queries(out["boxes"].to(dt), out["logits"].to(dt), (img, img),
                                    serve["conf"], serve["max_det"])
    return out


def selection_mismatch(p: torch.Tensor, r: torch.Tensor) -> float:
    """Share of the B x Q ranks whose anchor differs (1 when the shapes
    differ)."""
    if p.shape != r.shape:
        return 1.0
    return float((p.to(r.device) != r).float().mean())


def selection_set_mismatch(p: torch.Tensor, r: torch.Tensor) -> float:
    """Share of each image's Q selected anchors that the other selection
    does not hold, whatever their ranks (1 when the shapes differ)."""
    if p.shape != r.shape:
        return 1.0
    p = p.to(r.device).sort(1).values
    held = torch.searchsorted(p, r.sort(1).values.contiguous())
    return float((torch.gather(p, 1, held.clamp(max=p.shape[1] - 1))
                  != r.sort(1).values).float().mean())


@torch.no_grad()
def sample_rel_err(ref: rr.MCAQYOLO, sample: tuple, block: int = 32) -> float:
    """Relative L2 of a sampling's output (`Capture.sample`) against the
    reference's last-layer sampling, as its precision stands, from the same
    value map (as float32), locations and weights."""
    value, shapes, loc, weights, out = sample
    s = last_sample(ref.head)
    want = torch.cat([s(value[i:i + block].float(), shapes, loc[i:i + block],
                        weights[i:i + block]) for i in range(0, value.shape[0], block)])
    return compare.rel_err([out], [want])


class Driver(serve_batch.Driver):
    def setup(self):
        from mcaq_yolo_tpu_torch.inference import Predictor
        from mcaq_yolo_tpu_torch.models.yolo import variant_channels

        cfg, dev, s = self.cfg, self.device, self.serve
        taps = list(variant_channels(cfg["variant"]))  # raises on a program without RT-DETR
        if taps != list(rr.variant_channels(cfg["variant"])):
            raise SystemExit(f"program taps {taps} differ from the reference's")
        ref = weights.build(rr.MCAQYOLO, dev, cfg["variant"], cfg["nc"],
                            cfg["mcaq"]["grid_size"], s["morph_downsample"])
        self.ref = rr.init_(ref, self.seed, cfg["nc"]).eval()
        self.batches = gen.letterboxed_batches(self.seed, int(self.traffic["pool_batches"]),
                                               self.B, self.S, dev)
        with torch.no_grad():
            spread = rr.spread_(self.ref, self.batches[0][:32])
        with common.Checkpoint(cfg, self.ref.state_dict(), dev) as ck:
            self.pred = Predictor(str(ck.path), conf_threshold=s["conf"], max_det=s["max_det"],
                                  warmup=False, dtype=common.DTYPES[s["dtype"]], device=dev)
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
        of `common.Capture` (which keeps the Detect head's three maps) for
        the window's duration."""
        base = common.Capture
        common.Capture = Capture
        try:
            return super().window(seconds)
        finally:
            common.Capture = base

    def program_info(self) -> Dict:
        out = self.picked["out"]
        gated = out[7].float()
        bits = torch.cat([b.reshape(-1) for b in self.cap.bits])
        hist = torch.bincount(torch.round(bits).long().clamp(2, 8) - 2, minlength=7)
        return {"above_gate_queries_per_image": float(gated.mean()),
                "above_gate_max": int(gated.max()),
                "tile_bits_histogram_2_to_8": hist.tolist(), "avg_bits": float(out[4]),
                **serve_batch.launch_counters()}

    def traced(self) -> Dict:
        m = self.pred.model
        ranges = [trace.Ranges({"model": m, "backbone": m.backbone, "neck": m.neck,
                                "head": m.head, "decoder": m.head,
                                "complexity_analyzer": m.complexity_analyzer,
                                "bit_mapper": m.bit_mapper, "quantizer_p3": m.quantizer_p3,
                                "quantizer_p4": m.quantizer_p4,
                                "quantizer_p5": m.quantizer_p5})]
        ranges += [trace.Ranges({"deform": layer.cross_attn.sample})
                   for layer in (getattr(m.head, f"layers_{i}")
                                 for i in range(m.head.n_layers))]
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
                "flops_per_image": flops_per_image(cfg["nc"], self.S),
                "quant_bound_s": q * calls, "phi_bound_s": p * calls,
                "deform_bound_s": deform_bound_s(self.B, self.S) * calls,
                "peak_window_bytes": self.peak_window}

    def check(self) -> Dict[str, float]:
        out = self.picked["out"]
        prog = {**self.cap.call(0), "dets": per_image(*out[:4])}
        self.ref.to(self.device)
        self.own = reference_state(self.ref, self.batches[self.picked["x"]], self.serve, self.S)
        return self.numbers(prog)

    def numbers(self, prog: Dict) -> Dict[str, float]:
        x = self.batches[self.picked["x"]]
        s = self.serve
        given = reference_state(self.ref, x, s, self.S, prog["feats"], prog["bits"],
                                prog["selection"])
        boxes, logits = prog["raw"]
        dets = rr.select_queries(boxes.float(), logits.float(), (self.S, self.S), s["conf"],
                                 s["max_det"])
        sel = rr.stable_top(prog["enc_logits"].float().amax(-1), given["selection"].shape[1])
        return {
            "feat_rel_err": compare.rel_err(prog["feats"], self.own["feats"]),
            "complexity_gap_given": compare.mean_abs(prog["complexity"], given["complexity"]),
            "bits_mismatch_given": compare.bits_mismatch(prog["bits"], given["bits"]),
            "enc_rel_err_given": compare.rel_err([prog["enc_logits"]], [given["enc_logits"]]),
            "query_mismatch_given": selection_mismatch(prog["selection"], sel),
            "deform_rel_err_given": sample_rel_err(self.ref, prog["sample"]),
            "dec_rel_err_given": max(compare.rel_err([boxes], [given["boxes"]]),
                                     compare.rel_err([logits], [given["logits"]])),
            "det_mismatch_given": compare.det_mismatch(prog["dets"], dets),
            "det_box_gap_given": compare.det_box_gap(prog["dets"], dets),
            # end to end from the images, for the record
            "bits_mismatch": compare.bits_mismatch(prog["bits"], self.own["bits"]),
            "query_mismatch": selection_mismatch(prog["selection"], self.own["selection"]),
            "query_set_mismatch": selection_set_mismatch(prog["selection"],
                                                         self.own["selection"]),
            "det_mismatch": compare.det_mismatch(prog["dets"], self.own["dets"])}

    def control(self, part: str = "all") -> Dict[str, float]:
        """The numbers of the control: the reference one precision below
        the configuration's (float8 convolutions, linears and attention
        products, TF32 MCAQ math, bfloat16 sampling locations and
        post-process) in the program's place, on the checked batch.  With
        `part` 'locations', only the samplings' locations are lowered to
        bfloat16; the rest is the float32 reference."""
        if part not in ("all", "locations"):
            raise ValueError(f"part must be 'all' or 'locations', got {part!r}")
        rr.set_precision(self.ref, "fp8", (rr.DeformSample,) if part == "locations" else None)
        try:
            ctrl = reference_state(self.ref, self.batches[self.picked["x"]], self.serve,
                                   self.S, lower=part == "all", sample=True)
        finally:
            rr.set_precision(self.ref, "fp32")
        return self.numbers(ctrl)
