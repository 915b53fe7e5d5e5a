"""
Training (port of `mcaq_yolo_tpu/train.py`): the train step, its
optimizer, the eval and validation-loss steps, the teacher export, the
`Trainer` and the command line

    python -m mcaq_yolo_tpu_torch.train --config configs/train_config.yaml [--device cpu]

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
    Its state converts to and from optax's layout (`state_tree`), so
    checkpoints resume in either package.
  * `Trainer` — the reference's config schema (`configs/train_config.yaml`):
    loaders from a YOLO-format dataset on disk (host `DataLoader` or the
    device-resident pipeline) or passed in as batches {"image": uint8 (B,
    H, W, 3), "gt_boxes": (B, M, 4), "gt_classes": (B, M), "gt_mask": (B,
    M)}; Eq.(8) curriculum scoring and tau_t subset sampling; mAP
    `evaluate` (on CUDA its eval forward runs the spatial_quant kernel,
    three launches per batch from Stage 2 on); best / last checkpoints and
    resume; `train()`.  `training.amp` runs the network's convolutions in
    bfloat16 under autocast on CUDA, with float32 weights; the MCAQ math,
    the teacher and the losses stay float32.

`training.parallel` takes the reference's 'dp' and 'fsdp' (anything else
raises); the port trains on one device in both.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from .core import morphology_cv2
from .core.bit_allocation import bit_histogram, enforce_monotonic_params
from .core.curriculum import CurriculumScheduler
from .core.morphology import compute_phi_tiles, score_image_eq8
from .data.dataset import DataLoader, YOLODataset, compute_dataset_complexity, load_dataset_yaml
from .device import DeviceLike, resolve_device
from .models.losses import MCAQYOLOLoss, kd_feature_loss
from .models.mcaq_yolo import MCAQYOLO
from .models.weights_io import (
    COLLECTIONS,
    load_jax_variables,
    params_from_tree,
    params_tree,
    to_jax_variables,
)
from .models.yolo import YOLOv8, decode_and_nms
from .utils.checkpoint import load_checkpoint, save_checkpoint, write_msgpack
from .utils.evaluation import (
    compute_map,
    compute_map50_95,
    detections_to_numpy,
    extract_targets_per_image,
)
from .utils.repro import set_global_seed

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
        self.kind = kind
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

    def state_tree(self, model: nn.Module) -> Dict:
        """The optimizer state as `flax.serialization.to_state_dict` gives it
        for the reference's optax.chain(clip_by_global_norm, adamw(schedule,
        mask)) (adam: no mask state): {'0': {}, '1': {'0': {'count', 'mu',
        'nu'}, '1': {'inner_state': {}}, '2': {'count'}}}, with `mu` and
        `nu` (AdamW's exp_avg and exp_avg_sq) in the flax params layout and
        both counts equal to `step_count`."""

        def moment(key):
            def value_of(p):
                st = self.opt.state.get(p, {})
                return st[key] if key in st else torch.zeros_like(p)
            return params_tree(model, value_of)

        def count():
            return np.asarray(self.step_count, np.int32)

        adam = {"count": count(), "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}
        if self.kind == "adamw":
            inner = {"0": adam, "1": {"inner_state": {}}, "2": {"count": count()}}
        else:
            inner = {"0": adam, "1": {"count": count()}}
        return {"0": {}, "1": inner}

    def load_state_tree(self, model: nn.Module, tree: Dict) -> None:
        """Restore AdamW's moments and the update count from a `state_tree`
        layout (one the reference's `Trainer.save_checkpoint` wrote).
        Raises ValueError on another layout or unequal counts."""
        keys = ("0", "1", "2") if self.kind == "adamw" else ("0", "1")
        inner = tree.get("1", {})
        if set(tree) != {"0", "1"} or set(inner) != set(keys):
            raise ValueError(f"optimizer state is not optax's {self.kind} chain layout: "
                             f"{sorted(tree)} / {sorted(inner)}")
        adam = inner["0"]
        count = int(np.asarray(adam["count"]))
        if int(np.asarray(inner[keys[-1]]["count"])) != count:
            raise ValueError("the optimizer state's Adam and schedule counts differ")
        mu = params_from_tree(model, adam["mu"])
        nu = params_from_tree(model, adam["nu"])
        sd = self.opt.state_dict()
        order = [p for g in self.opt.param_groups for p in g["params"]]
        sd["state"] = {} if count == 0 else {
            i: {"step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": mu[p], "exp_avg_sq": nu[p]} for i, p in enumerate(order)}
        self.opt.load_state_dict(sd)  # moves the moments onto the parameters' device
        self.step_count = count


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
    """End-to-end MCAQ-YOLO trainer on the reference's config schema
    (`configs/train_config.yaml`), on `device` (default CUDA).

    Without loaders it builds them from `data.yaml_path` (or the
    `data.train` / `data.val` image directories) with the reference's
    augmentation defaults, through the host `DataLoader` or, with
    `data.device_pipeline: true`, the device-resident pipeline; it then
    scores every training image with Eq.(8) for the curriculum (cached in
    `output_dir`).  Loaders passed in (e.g. lists of in-memory batches; the
    train loader must have a length) are used as they are, without
    curriculum scoring.  The teacher is required when
    `distillation.enabled` (read from `model.teacher_path`)."""

    def __init__(self, config: Dict, train_loader=None, val_loader=None,
                 device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.seed = int(config.get("seed", 0))
        set_global_seed(self.seed, bool(config.get("deterministic", False)))
        self.epochs = int(config.get("epochs", 300))
        self.batch_size = int(config.get("batch_size", 16))
        self.lr = float(config.get("learning_rate", 1e-3))
        self.output_dir = Path(config.get("output_dir", "outputs"))
        self.output_dir.mkdir(parents=True, exist_ok=True)

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
            morph_tile_engine=self.morph_tile_engine, device=self.device, seed=self.seed)
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

        # ---- data ----
        self.train_dataset = self.val_dataset = None
        self.device_pipeline = bool(dcfg.get("device_pipeline", False))
        self.num_workers = int(dcfg.get("num_workers", 0))
        if train_loader is None:
            self._build_loaders(dcfg)
        else:
            self.device_pipeline = False
            self.train_loader, self.val_loader = train_loader, val_loader

        # ---- curriculum ----
        self.curriculum_cfg = ccfg
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
        self.complexity_scores = None
        if ccfg.get("enabled", True) and self.train_dataset is not None:
            self.complexity_scores = self._compute_complexity_scores()

        # ---- optimizer: clip + AdamW + warmup-cosine ----
        ocfg = config.get("optimizer", {})
        scfg = config.get("scheduler", {})
        steps_per_epoch = max(1, len(self.train_loader))
        warmup_steps = int(scfg.get("warmup_epochs", 5)) * steps_per_epoch
        self.schedule = warmup_cosine_schedule(
            self.lr, warmup_steps, self.epochs * steps_per_epoch,
            float(scfg.get("eta_min", 1e-6)))
        self.optimizer = Optimizer(
            self.model, self.schedule, betas=ocfg.get("betas", [0.9, 0.999]),
            weight_decay=float(ocfg.get("weight_decay", 0.05)),
            decay_bit_mapper=bool(ocfg.get("decay_bit_mapper", False)),
            kind=str(ocfg.get("type", "adamw")).lower())

        # 'dp' replicates and 'fsdp' shards the state over the reference's
        # device mesh; the port trains on one device in either mode
        self.parallel_mode = str(config.get("training", {}).get("parallel", "dp")).lower()
        if self.parallel_mode not in ("dp", "fsdp"):
            raise ValueError(f"training.parallel must be 'dp' or 'fsdp', got "
                             f"{self.parallel_mode!r}")
        if self.device.type == "cuda" and torch.cuda.device_count() > 1:
            print(f"[MCAQ] training.parallel={self.parallel_mode!r}: training on "
                  f"{self.device} only ({torch.cuda.device_count()} devices visible)")

        self.map_interval = max(1, int(config.get("training", {}).get("map_interval", 1)))
        self.train_step = make_train_step(self.model, self.loss_obj, self.teacher,
                                          self.amp_dtype)
        self.eval_step = make_eval_step(self.model, self.num_classes)
        self.val_loss_step = make_val_loss_step(self.model, self.loss_obj)
        self.history: list = []
        self.best_map = -1.0

    def _build_loaders(self, dcfg: Dict) -> None:
        """The train / val datasets and loaders from `data.yaml_path` or
        `data.train` / `data.val`, with the reference's augmentation
        defaults (mosaic 1.0, hflip 0.5, HSV 0.5, scale 0.5, translate
        0.1, image cache on)."""
        yaml_path = dcfg.get("yaml_path")
        if yaml_path and os.path.exists(str(yaml_path)):
            ds = load_dataset_yaml(str(yaml_path))
            train_dir, val_dir = ds["train"], ds["val"]
        else:
            train_dir = dcfg.get("train")
            val_dir = dcfg.get("val", train_dir)
        if not train_dir:
            raise ValueError("no training data: set data.yaml_path or data.train, or pass "
                             "train_loader")
        max_boxes = int(dcfg.get("max_boxes", 128))
        self.train_dataset = YOLODataset(
            train_dir, self.img_size, max_boxes, augment=True, seed=self.seed,
            hflip_p=float(dcfg.get("hflip_p", 0.5)), hsv_p=float(dcfg.get("hsv_p", 0.5)),
            mosaic_p=float(dcfg.get("mosaic_p", 1.0)),
            scale_jitter=float(dcfg.get("scale", 0.5)),
            translate=float(dcfg.get("translate", 0.1)),
            cache_images=bool(dcfg.get("cache", True)))
        self.val_dataset = YOLODataset(val_dir, self.img_size, max_boxes, augment=False,
                                       seed=self.seed)
        if self.device_pipeline:
            # both splits in device memory; batches ship augmentation plans
            from .data.device_pipeline import DevicePipeline

            self._dev_train = DevicePipeline(self.train_dataset, device=self.device)
            self._dev_val = DevicePipeline(self.val_dataset, device=self.device)
            self.train_loader = self._dev_train.loader(self.batch_size, shuffle=True,
                                                       seed=self.seed)
            self.val_loader = self._dev_val.loader(self.batch_size, shuffle=False,
                                                   drop_last=False, augment=False)
        else:
            self.train_loader = DataLoader(self.train_dataset, self.batch_size, shuffle=True,
                                           seed=self.seed, num_workers=self.num_workers)
            self.val_loader = DataLoader(self.val_dataset, self.batch_size, shuffle=False,
                                         drop_last=False, num_workers=self.num_workers)

    # ------------------------------------------------------------------
    # Curriculum scoring and sampling
    # ------------------------------------------------------------------

    def _score_backend(self) -> str:
        return str(self.curriculum_cfg.get("score_backend", "train"))

    def _scoring_dataset(self) -> YOLODataset:
        return YOLODataset(self.train_dataset.img_dir, self.img_size,
                           self.train_dataset.max_boxes, augment=False)

    def _score_fn(self):
        """The deterministic per-image Eq.(8) scorer: uint8 images -> (B,)
        scores.  'cv2': the exact OpenCV metrics on the host (uniform
        weights); otherwise the analyzer's phi with its (refit)
        `feature_weights`."""
        if self._score_backend() == "cv2":
            return lambda images: morphology_cv2.score_image_cv2(np.asarray(images))

        def fn(images):
            x = torch.as_tensor(images).to(self.device)
            return self.model.score_image(x).cpu().numpy()

        return fn

    def _compute_complexity_scores(self, use_cache: bool = True) -> np.ndarray:
        """Offline Algorithm-3 scoring of the training images, without
        augmentation, cached with a fingerprint in `output_dir` ('train':
        Eq.8 with the uniform initial weights, a pure function of the image;
        'cv2': the same with the exact OpenCV metrics, on the host; 'edge':
        the model-free edge density)."""
        backend = self._score_backend()
        cache = str(self.output_dir / "complexity_scores.npy") if use_cache else None
        if backend == "cv2":
            return compute_dataset_complexity(self._scoring_dataset(), self._score_fn(),
                                              cache_path=cache, backend="cv2",
                                              img_size=self.img_size)
        if backend == "edge":
            return compute_dataset_complexity(self._scoring_dataset(), None, cache_path=cache,
                                              backend="edge", img_size=self.img_size)
        grid = self.model.grid_size

        def eq8(images):
            x = torch.as_tensor(images).to(self.device)
            return score_image_eq8(x, grid_size=grid).cpu().numpy()

        return compute_dataset_complexity(self._scoring_dataset(), eq8, cache_path=cache,
                                          backend="train-eq8", img_size=self.img_size)

    def fit_feature_weights(self, max_batches: int = 16) -> np.ndarray:
        """NNLS refit of the Eq.(8) `feature_weights` to the trained
        complexity MLP over up to `max_batches` training batches, so that the
        offline ordering follows the learned notion of complexity."""
        analyzer = self.model.complexity_analyzer
        phis, cs = [], []
        with torch.no_grad():
            for i, batch in enumerate(self.train_loader):
                x = torch.as_tensor(batch["image"]).to(self.device)
                phi, _ = compute_phi_tiles(x, grid_size=self.model.grid_size)
                c = analyzer.complexity_mlp(phi.reshape(-1, 8))
                phis.append(phi.reshape(-1, 8).cpu().numpy())
                cs.append(c.reshape(-1).cpu().numpy())
                if i + 1 >= max_batches:
                    break
        alpha = morphology_cv2.fit_feature_weights(np.concatenate(phis), np.concatenate(cs))
        with torch.no_grad():
            analyzer.feature_weights.copy_(torch.as_tensor(alpha, dtype=torch.float32))
        return alpha

    def rescore_curriculum(self) -> None:
        """Score the training images again with the (refit) analyzer."""
        self.complexity_scores = compute_dataset_complexity(
            self._scoring_dataset(), self._score_fn(), cache_path=None)

    def _curriculum_indices(self, tau_t: float) -> Optional[np.ndarray]:
        """Algorithm 3 line 9: D_t = {x : C(x) <= tau_t}, or the easiest
        max(batch, 64) images when fewer qualify; None = the whole split."""
        if tau_t >= 1.0 or self.complexity_scores is None:
            return None
        idx = np.where(self.complexity_scores <= tau_t)[0]
        min_needed = max(self.batch_size, 64)
        if len(idx) < min_needed:
            idx = np.argsort(self.complexity_scores)[:min_needed]
        return idx

    # ------------------------------------------------------------------
    # Epochs
    # ------------------------------------------------------------------

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items() if k != "paths"}

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One pass at the epoch's curriculum settings over the tau_t subset
        (Stage 1 trains without quantization)."""
        stage = self.curriculum.get_stage(epoch)
        temp = self.curriculum.get_effective_temperature(epoch)
        tau_t = self.curriculum.get_complexity_threshold(epoch)
        weights = self.curriculum.get_loss_weights(epoch)
        target_bits = self.curriculum.get_target_bits(epoch)
        quantize = stage >= 2

        indices = self._curriculum_indices(tau_t)
        if indices is None:
            loader = self.train_loader
        elif self.device_pipeline:
            loader = self._dev_train.loader(self.batch_size, shuffle=True, indices=indices,
                                            seed=self.seed + epoch)
        else:
            loader = DataLoader(self.train_dataset, self.batch_size, shuffle=True,
                                indices=indices, seed=self.seed + epoch,
                                num_workers=self.num_workers)

        agg: Dict[str, float] = {}
        hist = np.zeros(7, np.int64)
        n_batches = 0
        for batch in loader:
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
                   quantize=float(quantize), bit_hist=hist.tolist(), batches=n_batches,
                   subset_size=None if indices is None else int(len(indices)))
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

    def evaluate(self, epoch: int) -> Dict[str, float]:
        """Validation mAP@0.5 and mAP@[.5:.95] at the epoch's temperature and
        quantize flag (eval-mode forward + decode + NMS on the device, the
        matching on the host), and the mean avg_bits."""
        stage = self.curriculum.get_stage(epoch)
        temp = self.curriculum.get_effective_temperature(epoch)
        quantize = stage >= 2
        predictions, targets, bits = [], [], []
        for batch in self.val_loader or ():
            images = torch.as_tensor(batch["image"]).to(self.device)
            b, s, c, v, avg_bits = self.eval_step(images, temp, quantize=quantize)
            predictions.extend(detections_to_numpy(b, s, c, v))
            targets.extend(extract_targets_per_image(batch))
            bits.append(float(avg_bits))
        res = compute_map(predictions, targets, 0.5)
        res5095 = compute_map50_95(predictions, targets)
        return {"map50": res["map"], "map50_95": res5095["map50_95"],
                "avg_bits": float(np.mean(bits)) if bits else 0.0,
                "quantized": float(quantize)}

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def save_checkpoint(self, name: str, epoch: int) -> Path:
        """`output_dir/name` in the reference's layout: params, batch_stats,
        quant_stats and buffers in the flax layout, `opt_state` in optax's
        and the update count `step`; plus `name.json` meta with the resolved
        model-defining keys, so that both packages' `Predictor` serve it and
        both `Trainer.load_checkpoint` resume it."""
        payload = dict(to_jax_variables(self.model),
                       opt_state=self.optimizer.state_tree(self.model),
                       step=int(self.optimizer.step_count))
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

    def load_checkpoint(self, path) -> None:
        """Resume: parameters, BatchNorm statistics, quantizer statistics,
        buffers, AdamW's moments and the update count from a checkpoint of
        either package.  Raises ValueError when a leaf is missing."""
        payload = load_checkpoint(path)
        template = to_jax_variables(self.model)
        for col in COLLECTIONS:
            missing = _leaf_paths(template.get(col, {})) - _leaf_paths(payload.get(col, {}))
            if missing:
                raise ValueError(f"checkpoint {path} lacks {col}/{sorted(missing)[0]} "
                                 f"and {len(missing) - 1} more leaves")
        if "opt_state" not in payload:
            raise ValueError(f"checkpoint {path} has no opt_state: it cannot be resumed")
        load_jax_variables(self.model, {c: payload[c] for c in COLLECTIONS if c in payload})
        self.optimizer.load_state_tree(self.model, payload["opt_state"])
        if int(payload.get("step", self.optimizer.step_count)) != self.optimizer.step_count:
            raise ValueError(f"checkpoint {path}: step {payload['step']} differs from the "
                             f"optimizer's count {self.optimizer.step_count}")

    # ------------------------------------------------------------------

    def train(self) -> Dict:
        """The training loop: the Stage-2 Eq.(8) refit and rescore,
        validation loss every epoch, the budget controller's feedback, mAP
        every `training.map_interval` epochs and at the end, `best.ckpt` at
        the best quantized mAP@0.5 from Stage 3 on, `last.ckpt` every epoch,
        `history.json` at the end.  Each history entry also holds the
        epoch's wall seconds (`epoch_s`, of which `train_s` and `eval_s`)."""
        t0 = time.time()
        rescored = False
        for epoch in range(self.epochs):
            t_epoch = time.perf_counter()
            self.curriculum.current_epoch = epoch
            # Stage-2 boundary: the complexity MLP has trained through the
            # warm-up; refit the Eq.(8) weights to it and re-sort, so that the
            # tau_t filter of Stages 2-3 uses the learned ordering
            if (not rescored and self.complexity_scores is not None
                    and self.curriculum.get_stage(epoch) >= 2):
                rescored = True
                try:
                    alpha = self.fit_feature_weights(max_batches=8)
                    self.rescore_curriculum()
                    print(f"[MCAQ] stage-2 Eq.8 alpha refit: {np.round(alpha, 4)}")
                except Exception as e:  # the reference goes on without the refit
                    print(f"[MCAQ][WARN] stage-2 rescore skipped: {type(e).__name__}: {e}")

            t_train = time.perf_counter()
            train_metrics = self.train_epoch(epoch)
            train_metrics["train_s"] = time.perf_counter() - t_train
            train_metrics["val_loss"] = self.compute_val_loss(epoch)

            # closed-loop bit-budget controller (a no-op unless enabled):
            # this epoch's mean bits trim the next epoch's bit_scale
            if "avg_bits" in train_metrics:
                scale = self.curriculum.update_budget_controller(
                    train_metrics["avg_bits"], epoch)
                train_metrics["bit_scale"] = scale
                train_metrics["lambda1_boost"] = self.curriculum.lambda1_boost
                if scale != 1.0 or self.curriculum.lambda1_boost > 1.0:
                    print(f"          budget controller: bits="
                          f"{train_metrics['avg_bits']:.2f} -> bit_scale {scale:.3f}, "
                          f"lambda1 boost {self.curriculum.lambda1_boost:.2f}x")

            eval_metrics = {}
            if (epoch + 1) % self.map_interval == 0 or epoch == self.epochs - 1:
                t_eval = time.perf_counter()
                eval_metrics = self.evaluate(epoch)
                eval_metrics["eval_s"] = time.perf_counter() - t_eval
                if (self.curriculum.get_stage(epoch) >= 3
                        and eval_metrics["map50"] > self.best_map):
                    self.best_map = eval_metrics["map50"]
                    self.save_checkpoint("best.ckpt", epoch)
                print(f"          val mAP@0.5={eval_metrics['map50']:.4f} "
                      f"mAP@0.5:0.95={eval_metrics['map50_95']:.4f} "
                      f"bits={eval_metrics['avg_bits']:.2f}")

            self.save_checkpoint("last.ckpt", epoch)
            self.history.append({**train_metrics, **eval_metrics, "epoch": epoch,
                                 "epoch_s": time.perf_counter() - t_epoch})

        if self.best_map < 0:
            print("[MCAQ] NOTE: training ended before Stage 3: best.ckpt was never "
                  "written; last.ckpt holds the final weights.")
        (self.output_dir / "history.json").write_text(
            json.dumps(self.history, indent=2, default=float))
        return {"best_map50": self.best_map, "epochs": self.epochs,
                "wall_time_s": time.time() - t0}


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


def main(argv=None):
    parser = argparse.ArgumentParser(description="MCAQ-YOLO training (PyTorch)")
    parser.add_argument("--config", required=True, help="YAML config path")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs on the CPU)")
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)  # no CUDA: fail before reading anything

    import yaml

    with open(args.config) as f:
        config = yaml.safe_load(f)
    if args.output_dir:
        config["output_dir"] = args.output_dir
    if args.seed is not None:
        config["seed"] = args.seed
    results = Trainer(config, device=device).train()
    print(json.dumps(results, indent=2, default=float))
    return results


if __name__ == "__main__":
    main()
