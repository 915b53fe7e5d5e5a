"""Quality evidence (port of `mcaq_yolo_tpu/scripts/quality_evidence.py`):
the arms of the accuracy protocol, trained and evaluated on one synthetic
dataset (v3 by default: 16 classes with color as a nuisance, small and
occluded objects, distractor shapes; v2: 8 appearance-defined classes).

  arm A  float-trained baseline: the curriculum pinned to Stage 1, so
         quantization never activates; evaluated unquantized.
  arm B  MCAQ-trained: the full 3-stage curriculum with the MLP bit mapper
         and per-image complexity normalization; evaluated quantized at the
         budget controller's deployment temperature, with the deployed
         rounded bit maps' spatial std and 2..8 histogram.
  arm C  post-hoc quantized: arm A's weights in an MCAQ model with the
         parameter-free linear mapper, EMA-calibrated, evaluated quantized.
  arm M  matched-budget uniform PTQ: as C, at a constant bit width pinned
         to arm B's achieved average (or --matched-bits).
  KD arm (--kd-epochs) arm A's checkpoint exported as the float32 teacher;
         a distilled student at the same bit target.

The alpha_t and target-bits anneals complete at --anneal-frac of the run
(budget anneal 'exp_exact', which lands on the target).

Usage: python -m mcaq_yolo_tpu_torch.scripts.quality_evidence
           [--img-size 640] [--epochs 60] [--fp-epochs 50] [--n-images 192]
           [--kd-epochs 0] [--out FILE]

Runs on CUDA and raises without it; QUALITY_ALLOW_CPU=1 lets it fall back
to the CPU when there is no CUDA device (tests, small runs).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..calibrate import calibrate
from ..data.dataset import (
    YOLODataset,
    load_dataset_yaml,
    make_synthetic_dataset_v2,
    make_synthetic_dataset_v3,
)
from ..data.device_pipeline import DevicePipeline
from ..device import resolve_device
from ..models.mcaq_yolo import MCAQYOLO
from ..train import Trainer, export_teacher_from_ckpt, make_eval_step
from ..utils.evaluation import (
    compute_map,
    compute_map50_95,
    detections_to_numpy,
    evaluate_quantization_impact,
    extract_targets_per_image,
)
from ..utils.model_utils import restore_into


def _images(batch, device) -> torch.Tensor:
    return torch.as_tensor(batch["image"]).to(device)


@torch.no_grad()
def _eval_quantized_arm(model, val_loader, num_classes, temperature=1.0, quantize=True):
    """Shared eval: mAP@0.5 / mAP@50-95 / avg_bits over the val loader."""
    device = next(model.parameters()).device
    eval_step = make_eval_step(model, num_classes)
    preds, targets, bits = [], [], []
    for batch in val_loader:
        b, s, c, v, avg_bits = eval_step(_images(batch, device), temperature,
                                         quantize=quantize)
        preds.extend(detections_to_numpy(b, s, c, v))
        targets.extend(extract_targets_per_image(batch))
        bits.append(float(avg_bits))
    return {
        "map50": compute_map(preds, targets, 0.5)["map"],
        "map50_95": compute_map50_95(preds, targets)["map50_95"],
        "avg_bits": float(np.mean(bits)) if quantize else 32.0,
    }


@torch.no_grad()
def _deployed_bitmap_stats(model, val_loader, max_batches=2, temperature=1.0):
    """Rounded deployed bit maps: per-image spatial std (> 0 means the
    mapper allocates spatially) and the 2..8 histogram, at the checkpoint's
    deployment temperature."""
    device = next(model.parameters()).device
    stds, cont_stds, cplx_stds, all_bits = [], [], [], []
    for i, batch in enumerate(val_loader):
        _, aux = model(_images(batch, device), temperature=temperature, quantize=True)
        for m, c in zip(aux["bit_map"], aux["complexity_map"]):  # per scale (B, Ht, Wt)
            m = m.cpu().numpy().astype(np.float64)
            cont_stds.extend(m.reshape(m.shape[0], -1).std(axis=1).tolist())
            r = np.round(m)
            stds.extend(r.reshape(r.shape[0], -1).std(axis=1).tolist())
            all_bits.extend(r.reshape(-1).tolist())
            c = c.cpu().numpy().astype(np.float64)
            cplx_stds.extend(c.reshape(c.shape[0], -1).std(axis=1).tolist())
        if i + 1 >= max_batches:
            break
    hist = {int(b): int((np.asarray(all_bits) == b).sum()) for b in range(2, 9)}
    return {"rounded_map_spatial_std_mean": float(np.mean(stds)),
            "rounded_map_spatial_std_max": float(np.max(stds)),
            "continuous_map_spatial_std_mean": float(np.mean(cont_stds)),
            "complexity_map_spatial_std_mean": float(np.mean(cplx_stds)),
            "bit_histogram": hist}


def run(img_size=640, epochs=60, n_images=192, batch_size=16,
        variant="yolov8n", root="outputs/quality_evidence_v2", seed=0,
        kd_epochs=0, fp_epochs=None, n_val=None, lr=2e-3,
        target_bits=4.0, arms="abcm", fp_ckpt=None, lambda_smooth=0.1,
        monotone_param="softplus", min_bits=2, max_bits=8,
        dataset="v3", matched_bits=None, anneal_frac=0.5, device=None):
    n_classes = {"v2": 8, "v3": 16}[dataset]
    n_val = n_val or max(batch_size, n_images // 4)
    fp_epochs = fp_epochs or epochs

    # fail fast: arms C / M and the KD stage need a float checkpoint, from
    # arm A in this run or from --fp-ckpt
    needs_fp = ("c" in arms) or ("m" in arms) or kd_epochs > 0
    if needs_fp and "a" not in arms and fp_ckpt is None:
        raise ValueError(
            f"arms={arms!r}"
            + (f" with kd_epochs={kd_epochs}" if kd_epochs else "")
            + " requires an FP checkpoint: include 'a' in --arms or pass"
            " --fp-ckpt <path to a trained FP baseline checkpoint>")
    if fp_ckpt is not None and not Path(fp_ckpt).exists():
        raise FileNotFoundError(f"--fp-ckpt not found: {fp_ckpt}")
    if "m" in arms and "b" not in arms and matched_bits is None:
        raise ValueError("arm 'm' (matched-budget PTQ) pins its uniform bit"
                         " width to arm B's achieved budget: include 'b' in"
                         " --arms or pass --matched-bits explicitly")
    device = resolve_device(device)

    root = Path(root).resolve()
    root.mkdir(parents=True, exist_ok=True)
    make_ds = {"v2": make_synthetic_dataset_v2, "v3": make_synthetic_dataset_v3}[dataset]
    yaml_path = make_ds(str(root / "data"), n_images=n_images, img_size=img_size,
                        n_val=n_val, seed=seed)

    def base_config(output_dir, n_epochs):
        warmup = max(2, n_epochs // 6)
        transition = max(warmup + 2, n_epochs // 2)
        # the alpha_t and target-bits anneals complete at anneal_frac of the
        # run, so the model trains at deployment temperature for the rest
        anneal = max(transition, int(round(n_epochs * anneal_frac)))
        return {
            "model": {"name": variant, "num_classes": n_classes, "teacher_path": None},
            # v3's small objects: mosaic halves object scale again, so v3
            # runs with a lower mosaic probability
            "data": {"yaml_path": yaml_path, "img_size": img_size,
                     "max_boxes": 16, "num_workers": 2, "device_pipeline": True,
                     "mosaic_p": 0.25 if dataset == "v3" else 0.5},
            "epochs": n_epochs,
            "batch_size": batch_size,
            "learning_rate": lr,
            "quantization": {"min_bits": min_bits, "max_bits": max_bits,
                             "target_bits": target_bits, "grid_size": 8,
                             "bit_mapping": "mlp", "monotone_param": monotone_param,
                             "normalize_complexity": True},
            "curriculum": {"enabled": True, "warmup_epochs": warmup,
                           "transition_epochs": transition,
                           "initial_temperature": 10.0,
                           "lambda_smooth": lambda_smooth,
                           "anneal_epochs": anneal,
                           "budget_anneal": "exp_exact",
                           "budget_controller": True},
            "distillation": {"enabled": False},
            "training": {"map_interval": max(1, n_epochs // 8), "amp": True},
            "seed": seed,
            "output_dir": str(output_dir),
        }

    table = {"config": {"variant": variant, "img_size": img_size,
                        "epochs": epochs, "fp_epochs": fp_epochs,
                        "n_images": n_images, "n_val": n_val, "seed": seed,
                        "target_bits": target_bits, "arms": arms,
                        "min_bits": min_bits, "max_bits": max_bits,
                        "lambda_smooth": lambda_smooth,
                        "monotone_param": monotone_param,
                        "anneal_frac": anneal_frac,
                        "budget_anneal": "exp_exact",
                        "n_classes": n_classes,
                        "dataset": f"synthetic_{dataset}"}}
    t0 = time.time()
    fp_arm = mcaq_arm = None
    mcaq_trainer = None

    def make_val_loader():
        """The val loader when neither arm A nor B trained in this run;
        drop_last=False, as the Trainer's, so every invocation evaluates the
        same images."""
        data = load_dataset_yaml(yaml_path)
        return DevicePipeline(YOLODataset(data["val"], img_size, 16, augment=False),
                              device=device).loader(batch_size, shuffle=False,
                                                    drop_last=False, augment=False)

    # ---------------- arm A: float-trained baseline ----------------------
    if "a" in arms:
        fp_cfg = base_config(root / "train_fp", fp_epochs)
        # the curriculum pinned to Stage 1: quantization never activates
        fp_cfg["curriculum"]["warmup_epochs"] = fp_epochs + 1
        fp_cfg["curriculum"]["transition_epochs"] = fp_epochs + 2
        fp_trainer = Trainer(fp_cfg, device=device)
        fp_res = fp_trainer.train()
        fp_arm = _eval_quantized_arm(fp_trainer.model, fp_trainer.val_loader, n_classes,
                                     quantize=False)
        fp_arm["best_map50_during_training"] = fp_res["best_map50"]
        fp_arm["wall_time_s"] = round(time.time() - t0, 1)
        table["fp_trained_arm"] = fp_arm
        fp_ckpt = root / "train_fp" / (
            "best.ckpt" if (root / "train_fp" / "best.ckpt").exists() else "last.ckpt")
    elif fp_ckpt is not None:
        fp_ckpt = Path(fp_ckpt)

    # ---------------- arm B: MCAQ-trained --------------------------------
    if "b" in arms:
        t1 = time.time()
        mcaq_trainer = Trainer(base_config(root / "train_mcaq", epochs), device=device)
        mcaq_res = mcaq_trainer.train()
        # deploy at the trained bit_scale trim (1.0 when the controller is off)
        deploy_t = float(mcaq_trainer.curriculum.bit_scale)
        mcaq_arm = _eval_quantized_arm(mcaq_trainer.model, mcaq_trainer.val_loader,
                                       n_classes, temperature=deploy_t, quantize=True)
        mcaq_arm["compression"] = round(32.0 / max(mcaq_arm["avg_bits"], 1e-9), 2)
        mcaq_arm["deploy_temperature"] = deploy_t
        mcaq_arm["best_map50_during_training"] = mcaq_res["best_map50"]
        mcaq_arm.update(_deployed_bitmap_stats(mcaq_trainer.model, mcaq_trainer.val_loader,
                                               temperature=deploy_t))
        mcaq_arm["wall_time_s"] = round(time.time() - t1, 1)
        table["mcaq_trained_arm"] = mcaq_arm

    # ---------------- arms C + M: post-hoc quantized float ---------------
    def _posthoc_eval(**mapper_kwargs):
        """Arm A's weights in a fresh MCAQ model, EMA-calibrated, evaluated
        quantized.  warn=False: a float checkpoint leaves the quantizer and
        mapper leaves at their initial values, which is what post-hoc means."""
        ph_model = MCAQYOLO(variant=variant, num_classes=n_classes, grid_size=8,
                            normalize_complexity=True, device=device, **mapper_kwargs)
        restore_into(ph_model, fp_ckpt, warn=False)
        train_dir = load_dataset_yaml(yaml_path)["train"]
        calib_loader = DevicePipeline(YOLODataset(train_dir, img_size, 16, augment=False),
                                      device=device).loader(batch_size, shuffle=False)
        calibrate(ph_model, calib_loader, num_images=min(n_images, 256))
        val_loader = (mcaq_trainer.val_loader if mcaq_trainer is not None
                      else make_val_loader())
        arm = _eval_quantized_arm(ph_model, val_loader, n_classes, quantize=True)
        arm["compression"] = round(32.0 / max(arm["avg_bits"], 1e-9), 2)
        return arm

    if "c" in arms:
        t2 = time.time()
        posthoc_arm = _posthoc_eval(bit_mapping="linear")
        posthoc_arm["wall_time_s"] = round(time.time() - t2, 1)
        table["posthoc_quant_arm"] = posthoc_arm
        if fp_arm is not None:
            table["delta_posthoc_vs_fp_map50_95"] = round(
                posthoc_arm["map50_95"] - fp_arm["map50_95"], 4)
        if mcaq_arm is not None:
            table["mcaq_recovers_over_posthoc_map50_95"] = round(
                mcaq_arm["map50_95"] - posthoc_arm["map50_95"], 4)

    # arm M: arm C's weights and calibration at a constant bit width pinned
    # to arm B's achieved average, so the MCAQ-vs-PTQ delta compares equal
    # budgets
    if "m" in arms:
        t2m = time.time()
        pin = matched_bits if matched_bits is not None else mcaq_arm["avg_bits"]
        matched_arm = _posthoc_eval(bit_mapping="constant", constant_bits=float(round(pin)))
        matched_arm["pinned_bits"] = float(round(pin))
        matched_arm["pin_source"] = ("--matched-bits" if matched_bits is not None
                                     else "arm B achieved avg_bits")
        matched_arm["wall_time_s"] = round(time.time() - t2m, 1)
        table["matched_ptq_arm"] = matched_arm
        if mcaq_arm is not None:
            table["mcaq_vs_matched_ptq_map50_95"] = round(
                mcaq_arm["map50_95"] - matched_arm["map50_95"], 4)
        if fp_arm is not None:
            table["delta_matched_ptq_vs_fp_map50_95"] = round(
                matched_arm["map50_95"] - fp_arm["map50_95"], 4)
    if fp_arm is not None and mcaq_arm is not None:
        table["delta_mcaq_vs_fp_map50_95"] = round(
            mcaq_arm["map50_95"] - fp_arm["map50_95"], 4)

    # raw-map divergence between the float and the quantized forward of arm B
    if mcaq_trainer is not None:
        model = mcaq_trainer.model

        def fwd(quantize):
            return lambda im: model(_images({"image": im}, device), temperature=1.0,
                                    quantize=quantize)[0]

        div = evaluate_quantization_impact(fwd(False), fwd(True), mcaq_trainer.val_loader,
                                           max_batches=2)
        div.pop("per_image", None)
        table["raw_map_divergence"] = div

    # ---------------- KD arm ---------------------------------------------
    if kd_epochs > 0:
        t3 = time.time()
        teacher_path = export_teacher_from_ckpt(str(fp_ckpt), str(root / "teacher.ckpt"),
                                                variant, n_classes)
        kd_cfg = base_config(root / "train_kd", kd_epochs)
        kd_cfg["model"]["teacher_path"] = teacher_path
        kd_cfg["distillation"] = {"enabled": True}
        kd_trainer = Trainer(kd_cfg, device=device)
        kd_res = kd_trainer.train()
        kd_deploy_t = float(kd_trainer.curriculum.bit_scale)
        kd_arm = _eval_quantized_arm(kd_trainer.model, kd_trainer.val_loader, n_classes,
                                     temperature=kd_deploy_t, quantize=True)
        kd_arm["deploy_temperature"] = kd_deploy_t
        kd_arm["best_map50_during_training"] = kd_res["best_map50"]
        kd_arm.update(_deployed_bitmap_stats(kd_trainer.model, kd_trainer.val_loader,
                                             temperature=kd_deploy_t))
        final = kd_trainer.history[-1] if kd_trainer.history else {}
        kd_arm["final_kd_loss"] = final.get("loss_kd")
        kd_arm["wall_time_s"] = round(time.time() - t3, 1)
        table["kd_arm"] = kd_arm
        if mcaq_arm is not None:
            table["delta_kd_vs_mcaq_map50_95"] = round(
                kd_arm["map50_95"] - mcaq_arm["map50_95"], 4)

    table["wall_time_s"] = round(time.time() - t0, 1)
    return table


def main(argv=None):
    import os

    p = argparse.ArgumentParser()
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--fp-epochs", type=int, default=None)
    p.add_argument("--n-images", type=int, default=192)
    p.add_argument("--n-val", type=int, default=None,
                   help="val images (default max(batch_size, n_images//4))")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--variant", default="yolov8n")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--root", default="outputs/quality_evidence_v2")
    p.add_argument("--out", default=None)
    p.add_argument("--kd-epochs", type=int, default=0,
                   help="also run the FP-teacher-export + KD-student arm")
    p.add_argument("--target-bits", type=float, default=4.0)
    p.add_argument("--arms", default="abcm",
                   help="which arms to run (subset of 'abcm': a=FP-trained, "
                        "b=MCAQ-trained, c=post-hoc linear PTQ, m=matched-"
                        "budget uniform PTQ; arms needing the FP ckpt can "
                        "reuse one via --fp-ckpt)")
    p.add_argument("--dataset", default="v3", choices=["v2", "v3"],
                   help="synthetic dataset generation (v3 = headroom: 16 "
                        "nuisance-color classes, small objects, occlusion)")
    p.add_argument("--matched-bits", type=float, default=None,
                   help="pin arm m's uniform bit width explicitly (default: "
                        "arm B's achieved avg_bits)")
    p.add_argument("--anneal-frac", type=float, default=0.5,
                   help="fraction of the run over which alpha_t/target-bits "
                        "anneal completes (1.0 = reference full-run anneal)")
    p.add_argument("--fp-ckpt", default=None,
                   help="existing arm-A checkpoint to reuse when 'a' is "
                        "not in --arms")
    p.add_argument("--lambda-smooth", type=float, default=0.1)
    p.add_argument("--monotone-param", default="softplus",
                   choices=["abs", "softplus"])
    p.add_argument("--min-bits", type=int, default=2)
    p.add_argument("--max-bits", type=int, default=8,
                   help="cap the bit range (e.g. 3) to force the damaging "
                        "regime for discriminative KD-vs-no-KD runs")
    args = p.parse_args(argv)
    # CUDA, or raise (after argparse, so --help and flag errors return at
    # once); QUALITY_ALLOW_CPU=1 takes the CPU when there is no CUDA device
    if os.environ.get("QUALITY_ALLOW_CPU", "0") == "1" and not torch.cuda.is_available():
        device = resolve_device("cpu")
    else:
        device = resolve_device(None)
    table = run(args.img_size, args.epochs, args.n_images,
                batch_size=args.batch_size, variant=args.variant,
                n_val=args.n_val,
                root=args.root, seed=args.seed, kd_epochs=args.kd_epochs,
                fp_epochs=args.fp_epochs, target_bits=args.target_bits,
                monotone_param=args.monotone_param,
                arms=args.arms, fp_ckpt=args.fp_ckpt,
                lambda_smooth=args.lambda_smooth,
                min_bits=args.min_bits, max_bits=args.max_bits,
                dataset=args.dataset, matched_bits=args.matched_bits,
                anneal_frac=args.anneal_frac, device=device)
    s = json.dumps(table, indent=2, default=float)
    print(s)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(s + "\n")


if __name__ == "__main__":
    main()
