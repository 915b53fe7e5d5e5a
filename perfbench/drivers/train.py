"""
Closed-loop training steps on the card: the step that
`train.make_train_step(model, loss, teacher, amp_dtype=torch.bfloat16)`
returns, with `train.Optimizer`, at the configuration's Stage-3 settings
(quantize on, fractional bits, KD from a float32 teacher), on synthetic
batches cycled from a pool made on the card from the seed.

Traffic parameters: `batch`, `pool_batches`, `boxes`, `max_boxes`,
`checked_steps`, `marked_steps`, `traced_steps`.  Set-up builds the model,
the teacher, the loss and the optimizer once and drives them through the
first `checked_steps` steps, on batches 0, 1, 2 of the pool, recording
each step's loss, the first clipped gradient as AdamW holds it after one
step (its first moment over 1 - beta1), the quantizers' EMA ranges after
one step and the parameters after the last; the window continues with the
same objects.  End-to-end: images of all steps completed in the window over
its seconds (synchronised at the end).  Check: the reference follows the
same steps from the same initial state.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict

import torch

from .. import compare, gen, trace, yardsticks
from ..reference import mcaq as rm
from ..reference import train as rt
from . import common
from .serve_batch import device_stamp, halves


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, log):
        self.cfg, self.traffic, self.seed, self.device, self.log = cfg, traffic, seed, device, log
        self.t = cfg["train"]
        self.B = int(traffic["batch"])
        self.S = int(cfg["img_size"])

    def args(self):
        w = self.t["loss_weights"]
        return (self.t["temperature"], self.t["target_bits"], w["bit_budget"], w["smoothness"],
                w["distillation"], w["regularization"])

    def setup(self):
        from mcaq_yolo_tpu_torch.models.losses import MCAQYOLOLoss
        from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
        from mcaq_yolo_tpu_torch.train import Optimizer, make_train_step

        cfg, dev, tr = self.cfg, self.device, self.traffic
        ds = self.t["morph_downsample"]
        self.ref = common.reference_model(cfg, self.seed, dev, ds)
        self.batches = gen.train_batches(self.seed, int(tr["pool_batches"]), self.B, self.S,
                                         cfg["nc"], int(tr["max_boxes"]), tuple(tr["boxes"]), dev)
        init = {k: v.clone() for k, v in self.ref.state_dict().items()}
        teacher_sd = {k: v for k, v in init.items()
                      if k.split(".")[0] in ("backbone", "neck", "head")}
        model = common.program_model(cfg, dev, torch.float32, ds)
        model.load_state_dict(init, strict=True)
        teacher = YOLOv8(cfg["variant"], cfg["nc"], dtype=torch.float32, device=dev)
        teacher.load_state_dict(teacher_sd, strict=True)
        self.ref.to("cpu")
        self.init = {k: v.to("cpu") for k, v in init.items()}
        lr = float(self.t["lr"])
        self.opt = Optimizer(model, lambda step: lr, betas=tuple(self.t["betas"]),
                             weight_decay=float(self.t["weight_decay"]), kind=self.t["optimizer"])
        self.step = make_train_step(model, MCAQYOLOLoss(cfg["nc"], self.t["target_bits"]),
                                    teacher, amp_dtype=self.amp)
        self.model, self.teacher = model, teacher
        names = [n for n, _ in model.named_parameters()]
        self.losses, times = [], []
        for k in range(int(tr["checked_steps"])):
            t = time.perf_counter()
            m = self.run_step(k)
            self.losses.append(m["loss_total"].detach().clone())
            if k == 0:
                st = self.opt.opt.state
                b1 = float(self.t["betas"][0])
                # a step that took no update leaves no moment: no gradient
                self.grad1 = {n: float((st[p]["exp_avg"] / (1.0 - b1)).float().norm())
                              if "exp_avg" in st.get(p, {}) else 0.0
                              for n, p in model.named_parameters()}
                self.ema1 = [torch.cat([q.running_min, q.running_max]).clone()
                             for q in model.quantizers]
            common.sync(dev)
            times.append(time.perf_counter() - t)
        self.after = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.names = names
        self.step_s = times[-1]
        self.log({"info": "setup", "checked_steps_s": times, "device_stamp": device_stamp(dev)})

    fault = None  # "half": the checked steps see the first half of each batch
    amp = torch.bfloat16  # the configuration's autocast; None runs the program in float32

    def run_step(self, k: int, mark=None):
        batch = self.batches[k % len(self.batches)]
        if self.fault == "half" and k < int(self.traffic["checked_steps"]):
            batch = {key: v[:self.B // 2] for key, v in batch.items()}
        return self.step(self.opt, batch, *self.args(),
                         quantize=bool(self.t["quantize"]), use_kd=bool(self.t["use_kd"]),
                         mark=mark)

    def window(self, seconds: float) -> Dict:
        k0 = int(self.traffic["checked_steps"])
        fails = torch.zeros((), dtype=torch.int64, device=self.device)
        n = raised = 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        half = None  # (steps, seconds) at the first step that ends past the window's middle
        while True:
            try:
                m = self.run_step(k0 + n)
                fails += ~torch.isfinite(m["loss_total"])
            except RuntimeError as e:  # a step that raises is a failed step
                raised += 1
                self.log({"info": "step raised", "error": str(e)[:500]})
            n += 1
            now = time.perf_counter() - t0
            if half is None and now >= seconds / 2:
                common.sync(self.device)
                half = (n, time.perf_counter() - t0)
            if now >= seconds:
                break
        common.sync(self.device)
        wall = time.perf_counter() - t0
        self.steps = k0 + n
        self.rate = n * self.B / wall
        self.peak_window = torch.cuda.max_memory_allocated(self.device) \
            if self.device.type == "cuda" else 0
        return {"metrics": {"train_images_per_s": self.rate}, "attempted": n,
                "failed": int(fails) + raised,
                "info": {"steps": n, "images": n * self.B, "window_s": wall,
                         "images_per_s_by_half": halves(n, wall, half, self.B),
                         "checked_losses": [float(x) for x in self.losses]}}

    def traced(self) -> Dict:
        splits = []
        for j in range(int(self.traffic["marked_steps"])):
            if self.device.type != "cuda":
                break
            ev = [("start", torch.cuda.Event(enable_timing=True))]
            ev[0][1].record()

            def mark(name, ev=ev):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                ev.append((name, e))

            self.run_step(self.steps + j, mark)
            torch.cuda.synchronize(self.device)
            splits.append({b[0]: a[1].elapsed_time(b[1]) for a, b in zip(ev, ev[1:])})
        self.steps += int(self.traffic["marked_steps"])
        split = {k: statistics.median(s[k] for s in splits) for k in splits[0]} if splits else {}
        n = int(self.traffic["traced_steps"])

        def work():
            for j in range(n):
                with trace.span("step"):
                    self.run_step(self.steps + j)

        tr = trace.profile(work)
        return {"trace": tr, "split_ms": split, "images_per_s": self.rate, "steps": n,
                "flops_per_image": yardsticks.train_flops_per_image(
                    self.cfg["variant"], self.cfg["nc"], self.S),
                "peak_window_bytes": self.peak_window}

    def release(self):
        del self.step, self.opt, self.model, self.teacher
        common.free(self.device)

    def _reference(self, precision: str):
        """The reference's checked steps from the initial state: (losses,
        first clipped gradient norms, EMA ranges after one step, parameters
        after the last step)."""
        from ..reference import network as rn

        ref = self.ref.to(self.device)
        ref.load_state_dict(self.init, strict=True)
        teacher = common.reference_teacher(self.cfg, ref, self.device)
        # the control: the student's convolutions in float8 (the network is
        # bfloat16), its float32 MCAQ math and the float32 teacher with TF32
        rn.set_precision(ref, precision)
        opt = rt.AdamW(list(ref.named_parameters()), float(self.t["lr"]),
                       float(self.t["weight_decay"]), betas=tuple(self.t["betas"]),
                       max_norm=float(self.t["max_grad_norm"]), decay=rt.decay_mask(ref))
        losses, grad1, ema1 = [], None, None
        with rm.float32_products(tf32=precision == "fp8"):
            for k in range(int(self.traffic["checked_steps"])):
                losses.append(float(rt.step(ref, teacher, opt, self.batches[k % len(self.batches)],
                                                 self.t)))
                if k == 0:
                    grad1 = rt.leaf_norms(opt.last_clipped)
                    ema1 = [torch.cat([ref.quantizer(i).running_min,
                                       ref.quantizer(i).running_max]).clone() for i in range(3)]
        after = {n: p.detach().clone() for n, p in ref.named_parameters()}
        del teacher, opt
        common.free(self.device)
        return losses, grad1, ema1, after

    def check(self) -> Dict[str, float]:
        losses, grad1, ema1, after = self._reference("fp32")
        self.ref_out = (losses, grad1, ema1, after)
        return self.numbers([float(x) for x in self.losses], self.grad1, self.ema1, self.after)

    def numbers(self, losses, grad1, ema1, after) -> Dict[str, float]:
        r_losses, r_grad1, r_ema1, r_after = self.ref_out
        init = {n: self.init[n].to(self.device) for n in self.names}
        norms = sorted(r_grad1.values())
        median = norms[len(norms) // 2]
        # leaves whose reference gradient is nought to rounding move under
        # Adam by round-off alone: left out of both comparisons
        keep = [n for n in self.names if r_grad1[n] >= 1e-3 * median]
        d_prog = {n: float((after[n] - init[n]).double().norm()) for n in keep}
        d_ref = {n: float((r_after[n] - init[n]).double().norm()) for n in keep}
        self.worst = {"grad": compare.worst_leaves(grad1, r_grad1, keep),
                      "change": compare.worst_leaves(d_prog, d_ref, keep),
                      "left_out": [n for n in self.names if n not in keep]}
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
                "grad_gap": compare.worst_leaf_gap(grad1, r_grad1, keep),
                "grad_median_gap": compare.median_leaf_gap(grad1, r_grad1, keep),
                "change_gap": compare.worst_leaf_gap(d_prog, d_ref, keep),
                "change_median_gap": compare.median_leaf_gap(d_prog, d_ref, keep),
                "ema_gap": compare.rel_err(ema1, r_ema1)}

    def control(self) -> Dict[str, float]:
        losses, grad1, ema1, after = self._reference("fp8")
        return self.numbers(losses, grad1, ema1, after)
