"""Deploy-time fidelity of the `morphology.downsample` throughput lever (port
of `mcaq_yolo_tpu/scripts/downsample_fidelity.py`).

`morphology.downsample` changes how the per-tile phi statistics are
estimated (metrics on a 2x average-pooled gray map), not any trained
parameter: it is a pure inference-config lever, so its quality cost is
measured by evaluating ONE trained checkpoint under both settings on the
same val split:

  * mAP@0.5 / mAP@0.5:0.95 / deployed avg_bits under downsample 1 vs 2;
  * per-scale Pearson r between the two settings' complexity maps;
  * the fraction of tiles whose rounded deployed bit width changes (the
    only channel through which the lever can move accuracy).

At yolov8 geometry the 2x request applies at P3 (tile 8 -> 4) and disables
itself at P4 / P5 (tile floor 4); a checkpoint whose maps vary spatially is
the discriminative input, a uniform-map checkpoint is insensitive by
construction.

Usage:
    python -m mcaq_yolo_tpu_torch.scripts.downsample_fidelity \\
        --ckpt .../train_mcaq/best.ckpt --data .../data/dataset.yaml \\
        --num-classes 16 [--out FILE]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..data.dataset import DataLoader, YOLODataset, load_dataset_yaml
from ..device import resolve_device
from ..models.mcaq_yolo import MCAQYOLO
from ..train import make_eval_step
from ..utils.evaluation import (
    compute_map,
    compute_map50_95,
    detections_to_numpy,
    extract_targets_per_image,
)
from ..utils.model_utils import restore_into


@torch.no_grad()
def evaluate_setting(model, val_loader, num_classes):
    """mAP + avg_bits + per-scale complexity / bit maps for one model config."""
    device = next(model.parameters()).device
    eval_step = make_eval_step(model, num_classes)
    preds, targets, bits = [], [], []
    cmaps, bmaps = [], []
    for batch in val_loader:
        images = torch.as_tensor(batch["image"]).to(device)
        b, s, c, v, avg_bits = eval_step(images, 1.0, quantize=True)
        preds.extend(detections_to_numpy(b, s, c, v))
        targets.extend(extract_targets_per_image(batch))
        bits.append(float(avg_bits))
        _, aux = model(images, temperature=1.0, quantize=True)
        cmaps.append([m.cpu().numpy().astype(np.float64) for m in aux["complexity_map"]])
        bmaps.append([m.cpu().numpy().astype(np.float64) for m in aux["bit_map"]])
    return {
        "map50": compute_map(preds, targets, 0.5)["map"],
        "map50_95": compute_map50_95(preds, targets)["map50_95"],
        "avg_bits": float(np.mean(bits)),
    }, cmaps, bmaps


def run(ckpt, data_yaml, img_size=640, variant="yolov8n", num_classes=8,
        batch_size=16, grid_size=8, bit_mapping="mlp", monotone_param="softplus",
        target_bits=4.0, min_bits=2, max_bits=8, normalize_complexity=True,
        downsample=2, device=None):
    device = resolve_device(device)
    data = load_dataset_yaml(data_yaml)
    val_loader = DataLoader(YOLODataset(data["val"], img_size, 16, augment=False),
                            batch_size, shuffle=False)

    result = {"config": {
        "ckpt": str(ckpt), "img_size": img_size, "variant": variant,
        "grid_size": grid_size, "bit_mapping": bit_mapping,
        "monotone_param": monotone_param, "target_bits": target_bits,
        "downsample": downsample,
    }}
    arms = {}
    for ds in (1, downsample):
        model = MCAQYOLO(
            variant=variant, num_classes=num_classes, grid_size=grid_size,
            bit_mapping=bit_mapping, monotone_param=monotone_param,
            target_bits=target_bits, min_bits=min_bits, max_bits=max_bits,
            normalize_complexity=normalize_complexity, morph_downsample=ds,
            device=device)
        restore_into(model, ckpt, warn=False)
        metrics, cmaps, bmaps = evaluate_setting(model, val_loader, num_classes)
        arms[ds] = (metrics, cmaps, bmaps)
        result[f"downsample_{ds}"] = metrics

    (m1, c1, b1), (m2, c2, b2) = arms[1], arms[downsample]
    # per-scale fidelity: Pearson r between the two settings' complexity
    # maps, and the fraction of tiles whose rounded bit width changed
    per_scale = []
    for s in range(len(c1[0])):
        x = np.concatenate([batch[s].reshape(-1) for batch in c1])
        y = np.concatenate([batch[s].reshape(-1) for batch in c2])
        bx = np.concatenate([np.round(batch[s]).reshape(-1) for batch in b1])
        by = np.concatenate([np.round(batch[s]).reshape(-1) for batch in b2])
        if x.std() < 1e-12 or y.std() < 1e-12:
            r = 1.0 if np.allclose(x, y) else 0.0
        else:
            r = float(np.corrcoef(x, y)[0, 1])
        per_scale.append({
            "scale": f"P{s + 3}",
            "complexity_pearson_r": round(r, 4),
            "rounded_bit_changed_frac": round(float((bx != by).mean()), 4),
            "mean_abs_bit_delta": round(float(np.abs(bx - by).mean()), 4),
        })
    result["per_scale_fidelity"] = per_scale
    result["delta_map50_95"] = round(m2["map50_95"] - m1["map50_95"], 4)
    result["delta_map50"] = round(m2["map50"] - m1["map50"], 4)
    result["delta_avg_bits"] = round(m2["avg_bits"] - m1["avg_bits"], 4)
    return result


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--variant", default="yolov8n")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--grid-size", type=int, default=8)
    p.add_argument("--bit-mapping", default="mlp")
    p.add_argument("--monotone-param", default="softplus")
    p.add_argument("--target-bits", type=float, default=4.0)
    p.add_argument("--min-bits", type=int, default=2)
    p.add_argument("--max-bits", type=int, default=8)
    p.add_argument("--no-normalize-complexity", action="store_true")
    p.add_argument("--downsample", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = resolve_device(None)  # CUDA, or raise

    res = run(args.ckpt, args.data, args.img_size, args.variant,
              args.num_classes, args.batch_size, args.grid_size,
              args.bit_mapping, args.monotone_param, args.target_bits,
              args.min_bits, args.max_bits,
              not args.no_normalize_complexity, args.downsample, device=device)
    s = json.dumps(res, indent=2)
    print(s)
    if args.out:
        with open(args.out, "w") as f:
            f.write(s + "\n")


if __name__ == "__main__":
    main()
