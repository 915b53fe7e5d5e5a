"""
M4: does spatially adaptive allocation help more on images whose complexity
varies more?  (port of `mcaq_yolo_tpu/scripts/m4_variation_gain.py`)

Per-image AP@0.5 under (a) the model's spatial bit maps and (b) uniform
constant bits at the same per-image rounded mean; the gain (a - b) is binned
by the quartiles of the P3 tile-complexity std, with bootstrap CIs and a
Spearman trend test, plus an optional matplotlib figure.

Usage:
    python -m mcaq_yolo_tpu_torch.scripts.m4_variation_gain --model best.ckpt \\
        --data dataset.yaml [--json OUT] [--figure OUT.png]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..data.dataset import DataLoader, YOLODataset, load_dataset_yaml
from ..device import resolve_device
from ..inference import Predictor
from ..models.yolo import decode_predictions
from ..ops.nms import batched_nms
from ..utils.evaluation import compute_map, detections_to_numpy, extract_targets_per_image
from .m3_permutation import apply_external_bit_maps


def per_image_ap(pred, target, iou_threshold: float = 0.5) -> float:
    return compute_map([pred], [target], iou_threshold)["map"]


def bootstrap_ci(values: np.ndarray, reps: int = 2000, seed: int = 0):
    if len(values) == 0:
        return (float("nan"), float("nan"))
    rng = np.random.default_rng(seed)
    means = [float(np.mean(rng.choice(values, len(values), replace=True)))
             for _ in range(reps)]
    return (float(np.percentile(means, 2.5)), float(np.percentile(means, 97.5)))


@torch.no_grad()
def run(model_path: str, data_yaml: str, img_size: int = 640,
        num_classes: int = 80, variant: str = "yolov8n",
        batch_size: int = 4, reps: int = 2000, figure: str = None,
        model_uniform: str = None, device=None):
    """model_uniform: an optional second checkpoint trained with uniform
    bits (the two-checkpoint protocol: spatial-trained vs uniform-trained).
    Without it the uniform arm reuses the spatial model with per-image
    constant bit maps."""
    from scipy import stats

    device = resolve_device(device)
    pred = Predictor(model_path, num_classes=num_classes, variant=variant,
                     img_size=img_size, warmup=False, device=device)
    model = pred.model
    uniform_model = model
    if model_uniform:
        # the external-map forward reads no mapper: only the weights differ
        uniform_model = Predictor(model_uniform, num_classes=num_classes, variant=variant,
                                  img_size=img_size, warmup=False, device=device).model

    ds_cfg = load_dataset_yaml(data_yaml)
    ds = YOLODataset(ds_cfg["val"], img_size, augment=False)
    loader = DataLoader(ds, batch_size, shuffle=False, drop_last=False)

    def nms(raw):
        boxes, scores, _, _ = decode_predictions(raw, num_classes)
        return batched_nms(boxes, scores, conf_threshold=0.001, iou_threshold=0.65,
                           max_det=300)

    records = []
    for batch in loader:
        images = torch.as_tensor(batch["image"]).to(device)
        raw, aux = model(images, temperature=1.0, quantize=True)
        preds_s = detections_to_numpy(*nms(raw))
        targets = extract_targets_per_image(batch)

        # uniform arm: per-image rounded-mean constant maps, same shapes
        uni_maps = []
        for m in aux["bit_map"]:
            m = m.cpu().numpy()
            means = np.round(m.reshape(m.shape[0], -1).mean(1))
            uni_maps.append(torch.as_tensor(
                np.broadcast_to(means[:, None, None], m.shape).copy(), device=device))
        preds_u = detections_to_numpy(*nms(apply_external_bit_maps(uniform_model, images,
                                                                   uni_maps)))

        c0 = aux["complexity_map"][0].cpu().numpy()  # P3-scale complexity
        for i, t in enumerate(targets):
            records.append({"ap_spatial": per_image_ap(preds_s[i], t),
                            "ap_uniform": per_image_ap(preds_u[i], t),
                            "c_std": float(c0[i].std())})

    c_std = np.array([r["c_std"] for r in records])
    gain = np.array([r["ap_spatial"] - r["ap_uniform"] for r in records])

    qs = np.quantile(c_std, [0.25, 0.5, 0.75]) if len(c_std) >= 4 else [0, 0, 0]
    bins = np.digitize(c_std, qs)
    quartiles = {}
    for q in range(4):
        sel = gain[bins == q]
        lo, hi = bootstrap_ci(sel, reps)
        quartiles[f"Q{q + 1}"] = {"n": int((bins == q).sum()),
                                  "mean_gain": float(sel.mean()) if len(sel) else float("nan"),
                                  "ci95": [lo, hi]}

    rho, p = (stats.spearmanr(c_std, gain) if len(c_std) > 2
              else (float("nan"), float("nan")))
    summary = {"num_images": len(records),
               "mean_gain": float(gain.mean()) if len(gain) else float("nan"),
               "spearman_rho": float(rho), "spearman_p": float(p),
               "quartiles": quartiles}

    if figure:
        from ..utils.visualization import visualize_complexity_vs_performance

        visualize_complexity_vs_performance(c_std, gain, figure,
                                            xlabel="tile complexity std",
                                            ylabel="AP gain (spatial - uniform)")
        summary["figure"] = figure
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True)
    parser.add_argument("--data", required=True)
    parser.add_argument("--img-size", type=int, default=640)
    parser.add_argument("--num-classes", type=int, default=80)
    parser.add_argument("--variant", default="yolov8n")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--reps", type=int, default=2000)
    parser.add_argument("--model-uniform", default=None,
                        help="optional uniform-trained checkpoint (reference's two-ckpt protocol)")
    parser.add_argument("--json", default=None)
    parser.add_argument("--figure", default=None)
    args = parser.parse_args(argv)
    device = resolve_device(None)  # CUDA, or raise

    summary = run(args.model, args.data, args.img_size, args.num_classes,
                  args.variant, args.batch_size, args.reps, args.figure,
                  args.model_uniform, device=device)
    out = json.dumps(summary, indent=2)
    print(out)
    if args.json:
        Path(args.json).write_text(out + "\n")


if __name__ == "__main__":
    main()
