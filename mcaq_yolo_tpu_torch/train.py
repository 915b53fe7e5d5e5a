"""
Training (port of `mcaq_yolo_tpu/train.py:76-260, 268-326, 379-449,
484-518, 682-873`): the train step, its optimizer, the eval and
validation-loss steps, the teacher export, and the `Trainer`'s core.

  * `make_train_step` — one forward in train mode (BatchNorm on batch
    statistics, continuous bits, the quantizers' fractional compose and EMA
    step), the float32 teacher's maps and features for distillation, the
    Eq.20 loss, backward, global-norm clip 1.0, AdamW on the warmup-cosine
    schedule, the Eq.18 projection of the bit mapper, and the 7-bin
    integer-bit histogram.  The training forward and backward are PyTorch
    ops with autograd: the reference runs them in XLA, not in its Pallas
    kernel.
  * `Optimizer` — optax.chain(clip_by_global_norm(1.0), adamw(schedule,
    mask=weight_decay_mask)) with optax's arithmetic: the clip scales by
    max_norm / ||g|| only when ||g|| >= max_norm, the first update uses the
    schedule's value at step 0, and a parameter without a gradient is
    updated with a zero one (decay and moments still move), as optax does.
  * `Trainer` — the reference's config schema (`configs/train_config.yaml`)
    with the loaders passed in: batches are dicts {"image": uint8 (B, H, W,
    3), "gt_boxes": (B, M, 4), "gt_classes": (B, M), "gt_mask": (B, M)}.
    `training.amp` runs the network's convolutions in bfloat16 under
    autocast on CUDA, with float32 weights (the reference's TPU gate); the
    MCAQ math, the teacher and the losses stay float32.

Not ported yet (ROADMAP A.5, A.6): building the loaders from
`data.yaml_path`, complexity scoring and curriculum subset sampling, mAP
`evaluate`, resume with the optimizer state in optax's layout, the full
`train()` loop with best/last checkpoints, FSDP, the command line.
"""

from __future__ import annotations

import contextlib
import math
import warnings
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from .core.bit_allocation import bit_histogram, enforce_monotonic_params
from .core.curriculum import CurriculumScheduler
from .device import DeviceLike, resolve_device
from .models.losses import MCAQYOLOLoss, kd_feature_loss
from .models.mcaq_yolo import MCAQYOLO
from .models.weights_io import load_jax_variables, to_jax_variables
from .models.yolo import YOLOv8, decode_and_nms
from .utils.checkpoint import load_checkpoint, save_checkpoint, write_msgpack

# ---------------------------------------------------------------------------
# Optimizer: clip + AdamW + warmup-cosine schedule
# ---------------------------------------------------------------------------

MAX_GRAD_NORM = 1.0  # Table X: gradient clipping 1.0


def warmup_cosine_schedule(lr: float, warmup_steps: int, total_steps: int,
                           eta_min: float) -> Callable[[int], float]:
    """optax.join_schedules([linear_schedule(0.01 lr, lr, max(1, warmup)),
    cosine_decay_schedule(lr, max(1, total - warmup), alpha=eta_min / lr)],
    [warmup]) as a function of the 0-based update count."""
    n_warm = max(1, warmup_steps)
    n_decay = max(1, total_steps - warmup_steps)
    alpha = eta_min / lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - min(max(step, 0), n_warm) / n_warm
            return (lr * 0.01 - lr) * frac + lr
        count = min(step - warmup_steps, n_decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / n_decay))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def weight_decay_mask(model: nn.Module, decay_bit_mapper: bool = False) -> Dict[str, bool]:
    """AdamW decay per parameter name: every parameter decays (biases and
    BatchNorm affine terms included) except, by default, those under the
    bit mapper, whose Eq.18 projection makes decay a one-way ratchet."""
    return {name: decay_bit_mapper or "bit_mapper" not in name.split(".")
            for name, _ in model.named_parameters()}


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g * max_norm / ||g|| when the
    global norm ||g|| >= max_norm, else g unchanged.  Returns ||g||; no
    host synchronisation."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


class Optimizer:
    """Global-norm clip to MAX_GRAD_NORM, then AdamW (or Adam) on a
    per-step schedule, over every parameter of `model`; `step()` applies one
    update and leaves the clipped gradients in `.grad`."""

    def __init__(self, model: nn.Module, schedule: Callable[[int], float],
                 betas=(0.9, 0.999), weight_decay: float = 0.05,
                 decay_bit_mapper: bool = False, kind: str = "adamw"):
        if kind not in ("adamw", "adam"):
            raise ValueError(f"unknown optimizer type {kind!r}")
        mask = weight_decay_mask(model, decay_bit_mapper)
        named = list(model.named_parameters())
        self.params = [p for _, p in named]
        wd = weight_decay if kind == "adamw" else 0.0
        groups = [{"params": [p for n, p in named if mask[n]], "weight_decay": wd},
                  {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0}]
        fused = self.params[0].device.type == "cuda"
        self.opt = torch.optim.AdamW([g for g in groups if g["params"]], lr=schedule(0),
                                     betas=tuple(betas), eps=1e-8, fused=fused)
        self.schedule = schedule
        self.step_count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, AdamW at lr = schedule(step_count), count.  Returns the
        gradients' global norm before the clip."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_([p.grad for p in self.params], MAX_GRAD_NORM)
        lr = self.schedule(self.step_count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.step_count += 1
        return norm


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def _teacher_outputs(teacher: YOLOv8, images: torch.Tensor):
    """The teacher's raw maps and its backbone features as NHWC, from one
    backbone pass, without gradient."""
    with torch.no_grad():
        feats = teacher.features(images)
        maps = teacher.head(teacher.neck(*feats))
    return maps, [f.permute(0, 2, 3, 1) for f in feats]


def make_train_step(model: MCAQYOLO, loss_obj: MCAQYOLOLoss,
                    teacher: Optional[YOLOv8] = None,
                    amp_dtype: Optional[torch.dtype] = None):
    """The train step.  `amp_dtype` (e.g. torch.bfloat16): the student's
    forward runs under autocast to it; the MCAQ transform, the teacher and
    the loss stay float32.

    train_step(optimizer, batch, temperature, target_bits, lw_bit,
    lw_smooth, lw_kd, lw_reg, quantize=True, use_kd=False, mark=None)
    -> metrics (device tensors: the loss terms, avg_bits, bit_hist (7,),
    grad_norm).  `mark(name)`, when given, is called after each phase
    ('forward', 'teacher', 'loss', 'backward', 'optimizer'), e.g. to record
    CUDA events."""
    device_type = next(model.parameters()).device.type

    def autocast():
        if amp_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(device_type, dtype=amp_dtype)

    def train_step(optimizer: Optimizer, batch: Dict[str, torch.Tensor], temperature: float,
                   target_bits: float, lw_bit: float, lw_smooth: float, lw_kd: float,
                   lw_reg: float, quantize: bool = True, use_kd: bool = False,
                   mark: Optional[Callable[[str], None]] = None):
        mark = mark or (lambda name: None)
        images = batch["image"]
        with autocast():
            raw_maps, aux = model(images, temperature=temperature, quantize=quantize,
                                  training=True)
        mark("forward")
        teacher_maps = None
        if use_kd and teacher is not None:
            teacher_maps, t_feats = _teacher_outputs(teacher, images)
            # student's QUANTIZED C3/C4/C5 against the teacher's float32 ones
            aux["kd_feature_loss"] = kd_feature_loss(aux["quantized_features"], t_feats)
        mark("teacher")
        loss_weights = {"detection": 1.0, "bit_budget": lw_bit, "smoothness": lw_smooth,
                        "distillation": lw_kd, "regularization": lw_reg}
        total, loss_dict = loss_obj(raw_maps, batch, aux, teacher_maps=teacher_maps,
                                    mapper=model.bit_mapper, loss_weights=loss_weights,
                                    target_bits=target_bits)
        mark("loss")
        optimizer.zero_grad()
        total.backward()
        mark("backward")
        grad_norm = optimizer.step()
        enforce_monotonic_params(model.bit_mapper)  # Eq.18, after every step
        mark("optimizer")

        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["avg_bits"] = aux["avg_bits"].detach()
        metrics["bit_hist"] = sum(bit_histogram(b) for b in aux["bit_map"])
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_eval_step(model: MCAQYOLO, num_classes: int, conf_threshold: float = 0.001,
                   iou_threshold: float = 0.65, max_det: int = 300):
    """Eval-mode forward + decode + NMS: eval_step(images, temperature,
    quantize=True) -> (boxes, scores, classes, valid, avg_bits)."""

    def eval_step(images, temperature, quantize: bool = True):
        raw_maps, aux = model(images, temperature=temperature, quantize=quantize,
                              training=False)
        det = decode_and_nms(raw_maps, num_classes, conf_threshold=conf_threshold,
                             iou_threshold=iou_threshold, max_det=max_det)
        return tuple(det) + (aux["avg_bits"],)

    return eval_step


def make_val_loss_step(model: MCAQYOLO, loss_obj: MCAQYOLOLoss):
    """Validation loss: eval-mode forward at the epoch's temperature and
    quantize flag; detection + bit + smoothness + regularization, no KD."""

    @torch.no_grad()
    def val_loss_step(batch, temperature, target_bits, lw_bit, lw_smooth, lw_reg,
                      quantize: bool = True):
        raw_maps, aux = model(batch["image"], temperature=temperature, quantize=quantize,
                              training=False)
        loss_weights = {"detection": 1.0, "bit_budget": lw_bit, "smoothness": lw_smooth,
                        "distillation": 0.0, "regularization": lw_reg}
        total, _ = loss_obj(raw_maps, batch, aux, teacher_maps=None,
                            mapper=model.bit_mapper, loss_weights=loss_weights,
                            target_bits=target_bits)
        return total

    return val_loss_step


def load_teacher(path, variant: str, num_classes: int, device: DeviceLike = None) -> YOLOv8:
    """A float32 YOLOv8 from a flax `YOLOv8` variables msgpack ('params' and
    'batch_stats'); raises ValueError when a leaf is missing or extra."""
    teacher = YOLOv8(variant, num_classes, device=device)
    payload = load_checkpoint(path)
    template = to_jax_variables(teacher)
    for col in template:
        missing = _leaf_paths(template[col]) - _leaf_paths(payload.get(col, {}))
        if missing:
            raise ValueError(f"teacher checkpoint {path} lacks {col}/{sorted(missing)[0]} "
                             f"and {len(missing) - 1} more leaves")
    load_jax_variables(teacher, {c: payload[c] for c in template})
    return teacher


def _leaf_paths(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        out |= _leaf_paths(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k}
    return out


def export_teacher_from_ckpt(ckpt_path: str, out_path: str, variant: str,
                             num_classes: int) -> str:
    """Extract the detector (backbone / neck / head parameters and BatchNorm
    statistics) of an MCAQ checkpoint into a plain-YOLOv8 variables msgpack,
    the teacher format `Trainer` loads.  The structure and shapes are checked
    against a YOLOv8 of the given variant."""
    payload = load_checkpoint(ckpt_path)
    teacher = YOLOv8(variant, num_classes, device="cpu")
    load_jax_variables(teacher, {
        "params": {k: payload["params"][k] for k in ("backbone", "neck", "head")},
        "batch_stats": {k: payload["batch_stats"][k] for k in ("backbone", "neck", "head")},
    })
    Path(out_path).write_bytes(write_msgpack(to_jax_variables(teacher)))
    return out_path


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


class Trainer:
    """MCAQ-YOLO trainer core on the reference's config schema, with the
    loaders passed in (`train_loader` must have a length: the schedule's
    steps per epoch).  Builds the model, loss, teacher (required when
    `distillation.enabled`, read from `model.teacher_path`), curriculum,
    optimizer and schedule on `device` (default CUDA)."""

    def __init__(self, config: Dict, train_loader, val_loader=None,
                 device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.seed = int(config.get("seed", 0))
        self.epochs = int(config.get("epochs", 300))
        self.batch_size = int(config.get("batch_size", 16))
        self.lr = float(config.get("learning_rate", 1e-3))
        self.output_dir = Path(config.get("output_dir", "outputs"))
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.train_loader, self.val_loader = train_loader, val_loader

        mcfg = config.get("model", {})
        qcfg = config.get("quantization", {})
        ccfg = config.get("curriculum", {})
        dcfg = config.get("data", {})
        morph = config.get("morphology", {})
        self.num_classes = int(mcfg.get("num_classes", 80))
        self.img_size = int(dcfg.get("img_size", 640))
        self.variant = str(mcfg.get("name", "yolov8n"))
        if not self.variant.startswith("yolov8"):
            self.variant = f"yolov8{self.variant[-1]}"
        self.morph_tile_engine = str(morph.get("tile_engine", "lanes"))

        # amp: bfloat16 convolutions on CUDA, float32 weights
        amp = bool(config.get("training", {}).get("amp", True))
        self.amp_dtype = torch.bfloat16 if (amp and self.device.type == "cuda") else None
        self.model = MCAQYOLO(
            variant=self.variant, num_classes=self.num_classes,
            min_bits=int(qcfg.get("min_bits", 2)), max_bits=int(qcfg.get("max_bits", 8)),
            target_bits=float(qcfg.get("target_bits", 4.0)),
            grid_size=int(qcfg.get("grid_size", 8)),
            bit_mapping=str(qcfg.get("bit_mapping", "mlp")),
            monotone_param=str(qcfg.get("monotone_param", "softplus")),
            normalize_complexity=bool(qcfg.get("normalize_complexity", False)),
            morph_downsample=int(morph.get("downsample", 1)),
            device=self.device, seed=self.seed)
        enforce_monotonic_params(self.model.bit_mapper)
        self.loss_obj = MCAQYOLOLoss(self.num_classes, float(qcfg.get("target_bits", 4.0)))

        self.kd_enabled = bool(config.get("distillation", {}).get("enabled", True))
        self.teacher = None
        if self.kd_enabled:
            tpath = mcfg.get("teacher_path")
            if not (tpath and Path(str(tpath)).exists()):
                # distilling from a random teacher trains against noise
                raise FileNotFoundError(
                    f"distillation.enabled=true but model.teacher_path {tpath!r} does not "
                    "exist: export one (export_teacher_from_ckpt) or set "
                    "distillation.enabled: false.")
            self.teacher = load_teacher(tpath, self.variant, self.num_classes, self.device)

        self.curriculum = CurriculumScheduler(
            warmup_epochs=int(ccfg.get("warmup_epochs", 20)),
            transition_epochs=int(ccfg.get("transition_epochs", 50)),
            total_epochs=self.epochs,
            initial_complexity=float(ccfg.get("initial_complexity", 0.2)),
            initial_temperature=float(ccfg.get("initial_temperature", 10.0)),
            lambda_smooth=float(ccfg.get("lambda_smooth", 0.1)),
            target_bits=float(qcfg.get("target_bits", 4.0)),
            lambda_bit_gate=bool(ccfg.get("lambda_bit_gate", True)),
            min_bits=float(qcfg.get("min_bits", 2)),
            max_bits=float(qcfg.get("max_bits", 8)),
            anneal_epochs=(int(ccfg["anneal_epochs"]) if ccfg.get("anneal_epochs") else None),
            budget_anneal=str(ccfg.get("budget_anneal", "exp")),
            budget_controller=bool(ccfg.get("budget_controller", False)),
            controller_kp=float(ccfg.get("controller_kp", 0.3)),
            controller_deadband=float(ccfg.get("controller_deadband", 0.1)),
        )

        ocfg = config.get("optimizer", {})
        scfg = config.get("scheduler", {})
        steps_per_epoch = max(1, len(train_loader))
        warmup_steps = int(scfg.get("warmup_epochs", 5)) * steps_per_epoch
        self.schedule = warmup_cosine_schedule(
            self.lr, warmup_steps, self.epochs * steps_per_epoch,
            float(scfg.get("eta_min", 1e-6)))
        self.optimizer = Optimizer(
            self.model, self.schedule, betas=ocfg.get("betas", [0.9, 0.999]),
            weight_decay=float(ocfg.get("weight_decay", 0.05)),
            decay_bit_mapper=bool(ocfg.get("decay_bit_mapper", False)),
            kind=str(ocfg.get("type", "adamw")).lower())

        self.train_step = make_train_step(self.model, self.loss_obj, self.teacher,
                                          self.amp_dtype)
        self.eval_step = make_eval_step(self.model, self.num_classes)
        self.val_loss_step = make_val_loss_step(self.model, self.loss_obj)

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items() if k != "paths"}

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One pass over `train_loader` at the epoch's curriculum settings
        (Stage 1 trains without quantization)."""
        stage = self.curriculum.get_stage(epoch)
        temp = self.curriculum.get_effective_temperature(epoch)
        tau_t = self.curriculum.get_complexity_threshold(epoch)
        weights = self.curriculum.get_loss_weights(epoch)
        target_bits = self.curriculum.get_target_bits(epoch)
        quantize = stage >= 2

        agg: Dict[str, float] = {}
        hist = np.zeros(7, np.int64)
        n_batches = 0
        for batch in self.train_loader:
            metrics = self.train_step(
                self.optimizer, self._to_device(batch), temp, target_bits,
                weights["bit_budget"], weights["smoothness"], weights["distillation"],
                weights["regularization"], quantize=quantize, use_kd=self.kd_enabled)
            hist += metrics.pop("bit_hist").cpu().numpy().astype(np.int64)
            for k, v in metrics.items():
                agg[k] = agg.get(k, 0.0) + float(v)
            n_batches += 1
        out = {k: v / max(1, n_batches) for k, v in agg.items()}
        out.update(stage=stage, temperature=temp, tau=tau_t, target_bits=target_bits,
                   quantize=float(quantize), bit_hist=hist.tolist())
        self._log_epoch(epoch, out, hist)
        return out

    def _log_epoch(self, epoch: int, m: Dict, hist: np.ndarray) -> None:
        print(f"[epoch {epoch:3d}] stage={int(m['stage'])} "
              f"loss={m.get('loss_total', 0):.4f} det={m.get('loss_det', 0):.4f} "
              f"bits={m.get('avg_bits', 0):.2f} temp={m['temperature']:.2f} "
              f"tau={m['tau']:.2f}")
        total = max(1, int(hist.sum()))
        bars = " ".join(f"{b}b:{'#' * int(20 * c / total)}({c})"
                        for b, c in zip(range(2, 9), hist) if c > 0)
        print(f"          bit-dist {bars}")

    def compute_val_loss(self, epoch: int) -> float:
        """Mean validation loss over the full batches of `val_loader` at the
        epoch's curriculum settings (a ragged tail is skipped)."""
        stage = self.curriculum.get_stage(epoch)
        temp = self.curriculum.get_effective_temperature(epoch)
        weights = self.curriculum.get_loss_weights(epoch)
        target_bits = self.curriculum.get_target_bits(epoch)
        total, n, n_skipped = 0.0, 0, 0
        for batch in self.val_loader or ():
            if batch["image"].shape[0] != self.batch_size:
                n_skipped += 1
                continue
            total += float(self.val_loss_step(
                self._to_device(batch), temp, target_bits, weights["bit_budget"],
                weights["smoothness"], weights["regularization"], quantize=stage >= 2))
            n += 1
        if n_skipped and n == 0:
            warnings.warn(f"compute_val_loss: all {n_skipped} val batches were ragged "
                          f"(< batch_size={self.batch_size}) and skipped; returning 0.0",
                          stacklevel=2)
        elif n_skipped:
            warnings.warn(f"compute_val_loss: skipped {n_skipped} ragged val batch(es); "
                          f"loss averaged over {n} full batches", stacklevel=2)
        return total / max(1, n)

    def save_checkpoint(self, name: str, epoch: int) -> Path:
        """`output_dir/name`: params, batch_stats, quant_stats and buffers in
        the flax layout (and the update count), plus `name.json` meta with the
        resolved model-defining keys, so that the port's and the reference's
        `Predictor` both serve it."""
        payload = dict(to_jax_variables(self.model), step=int(self.optimizer.step_count))
        cfg = {k: v for k, v in self.config.items()
               if isinstance(v, (int, float, str, bool, dict, list))}
        m = self.model
        cfg["quantization"] = dict(
            cfg.get("quantization", {}), min_bits=int(m.min_bits), max_bits=int(m.max_bits),
            target_bits=float(m.target_bits), grid_size=int(m.grid_size),
            bit_mapping=m.bit_mapping, monotone_param=m.monotone_param,
            normalize_complexity=bool(m.normalize_complexity))
        cfg["morphology"] = dict(cfg.get("morphology", {}),
                                 downsample=int(m.morph_downsample),
                                 tile_engine=self.morph_tile_engine)
        meta = {"epoch": epoch, "variant": self.variant, "num_classes": self.num_classes,
                "img_size": self.img_size,
                "deploy_temperature": float(self.curriculum.bit_scale), "config": cfg}
        path = self.output_dir / name
        save_checkpoint(path, payload, meta)
        return path
