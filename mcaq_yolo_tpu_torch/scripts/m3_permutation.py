"""
M3: bit-placement ablation (port of `mcaq_yolo_tpu/scripts/m3_permutation.py`).

Does MCAQ's complexity-guided spatial placement matter, beyond the bit
histogram?  Three arms at a fixed per-image bit histogram:
  mcaq     — the model's own complexity -> bit placement
  permuted — a per-image seeded random permutation of the same tiles' bits
  inverted — the high-complexity tiles get the low bits (rank inversion)

Evaluates val mAP@0.5 and mAP@50-95 per arm from a trained checkpoint; the
placement arms run the quantized forward with the maps supplied from
outside (`apply_external_bit_maps`), then `decode_predictions` +
`batched_nms`.  JSON summary.

Usage:
    python -m mcaq_yolo_tpu_torch.scripts.m3_permutation --model best.ckpt \\
        --data dataset.yaml [--img-size 640] [--num-classes 80] [--json OUT]
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
from ..utils.evaluation import (
    compute_map,
    compute_map50_95,
    detections_to_numpy,
    extract_targets_per_image,
)


def permute_bit_map(bit_map: np.ndarray, mode: str, seed: int) -> np.ndarray:
    """Rearrange a (Ht, Wt) integer bit map keeping its histogram fixed."""
    flat = bit_map.reshape(-1)
    if mode == "mcaq":
        return bit_map
    if mode == "permuted":
        rng = np.random.default_rng(seed)
        return rng.permutation(flat).reshape(bit_map.shape)
    if mode == "inverted":
        # rank inversion: the tile with the highest bits gets the lowest
        order = np.argsort(flat)
        out = np.empty_like(flat)
        out[order] = np.sort(flat)[::-1]
        return out.reshape(bit_map.shape)
    raise ValueError(mode)


def apply_external_bit_maps(model, images: torch.Tensor, maps, training: bool = False):
    """The MCAQ model's quantized forward with externally supplied
    per-scale bit maps [(B, Ht, Wt)]: backbone -> quantize(maps) -> neck ->
    head, through `MCAQYOLO.forward_with_bit_maps`, i.e. the normal
    forward's input normalization, float32 MCAQ block and no_grad (uint8
    batches fed raw into the backbone silently zero the detector).  Returns
    the raw per-scale maps; the model's own maps reproduce
    `model(images, quantize=True)` bitwise.  Shared by M3 and M4."""
    return model.forward_with_bit_maps(images, maps, training=training)


@torch.no_grad()
def run(model_path: str, data_yaml: str, img_size: int = 640,
        num_classes: int = 80, variant: str = "yolov8n",
        batch_size: int = 8, conf: float = 0.001, iou: float = 0.65,
        max_det: int = 300, seed: int = 0, device=None):
    device = resolve_device(device)
    pred = Predictor(model_path, num_classes=num_classes, variant=variant,
                     img_size=img_size, warmup=False, device=device)
    model = pred.model

    ds_cfg = load_dataset_yaml(data_yaml)
    ds = YOLODataset(ds_cfg["val"], img_size, augment=False)
    loader = DataLoader(ds, batch_size, shuffle=False, drop_last=False)

    # the model's own integer bit maps at the checkpoint's deployment
    # temperature (the budget controller's trim, which the Predictor reads
    # from the meta): the placement arms ablate the histogram it deploys
    deploy_t = float(getattr(pred, "deploy_temperature", 1.0))

    def forward_given_maps(images, maps):
        raw = apply_external_bit_maps(model, images, maps)
        boxes, scores, _, _ = decode_predictions(raw, num_classes)
        return batched_nms(boxes, scores, conf_threshold=conf, iou_threshold=iou,
                           max_det=max_det)

    arms = {m: {"preds": [], "targets": []} for m in ("mcaq", "permuted", "inverted")}
    for bi, batch in enumerate(loader):
        images = torch.as_tensor(batch["image"]).to(device)
        _, aux = model(images, temperature=deploy_t, quantize=True)
        own_maps = [m.cpu().numpy() for m in aux["bit_map"]]
        targets = extract_targets_per_image(batch)

        for mode in arms:
            maps = []
            for m in own_maps:
                out = np.stack([permute_bit_map(m[i], mode, seed + bi * 1000 + i)
                                for i in range(m.shape[0])])
                maps.append(torch.as_tensor(out, device=device))
            det = forward_given_maps(images, maps)
            arms[mode]["preds"].extend(detections_to_numpy(*det))
            arms[mode]["targets"].extend(targets)

    summary = {}
    for mode, d in arms.items():
        res = compute_map(d["preds"], d["targets"], 0.5)
        # mAP@50-95 too: at budgets that do no damage mAP@0.5 saturates
        res5095 = compute_map50_95(d["preds"], d["targets"])
        summary[mode] = {"map50": res["map"], "map50_95": res5095["map50_95"],
                         "num_images": res["num_images"]}
    for metric in ("map50", "map50_95"):
        summary[f"placement_gain_vs_permuted_{metric}"] = (
            summary["mcaq"][metric] - summary["permuted"][metric])
        summary[f"placement_gain_vs_inverted_{metric}"] = (
            summary["mcaq"][metric] - summary["inverted"][metric])
    # legacy aliases (the older evidence schema)
    summary["placement_gain_vs_permuted"] = summary["placement_gain_vs_permuted_map50"]
    summary["placement_gain_vs_inverted"] = summary["placement_gain_vs_inverted_map50"]
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True)
    parser.add_argument("--data", required=True)
    parser.add_argument("--img-size", type=int, default=640)
    parser.add_argument("--num-classes", type=int, default=80)
    parser.add_argument("--variant", default="yolov8n")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--json", default=None)
    args = parser.parse_args(argv)
    device = resolve_device(None)  # CUDA, or raise

    summary = run(args.model, args.data, args.img_size, args.num_classes,
                  args.variant, args.batch_size, seed=args.seed, device=device)
    out = json.dumps(summary, indent=2)
    print(out)
    if args.json:
        Path(args.json).write_text(out + "\n")


if __name__ == "__main__":
    main()
