"""Measure whether shrinking the NMS candidate pool changes the deployed
results (port of `mcaq_yolo_tpu/scripts/pretopk_equivalence.py`).

The suppression's cost grows with the candidate-pool size `pre_topk`, so
the serving path takes the smallest pool that can still fill max_det
(`inference.auto_pre_topk`).  Shrinking the pool is only sound if a trained
model's conf-gated candidate set fits in it, so this script checks:

  * per-image count of anchors whose best-class score clears the gate, at
    the deployed gate (conf=0.25) and the eval gate (conf=0.001);
  * bitwise detection equality between pool sizes at each gate;
  * mAP at each (pool, gate) operating point.

Usage (after training any checkpoint, e.g. quality_evidence --arms b):
    python -m mcaq_yolo_tpu_torch.scripts.pretopk_equivalence \\
        --ckpt outputs/.../best.ckpt --data-yaml outputs/.../data/dataset.yaml
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..data.dataset import DataLoader, YOLODataset, load_dataset_yaml
from ..device import resolve_device
from ..models.mcaq_yolo import MCAQYOLO
from ..models.yolo import REG_MAX, decode_and_nms
from ..utils.evaluation import (
    compute_map,
    compute_map50_95,
    detections_to_numpy,
    extract_targets_per_image,
)
from ..utils.model_utils import restore_into


@torch.no_grad()
def run(ckpt, data_yaml, img_size=None, batch_size=16, pools=(512, 1024),
        deployed_conf=0.25, eval_conf=0.001, max_det=300, device=None):
    device = resolve_device(device)
    meta = json.loads(Path(str(ckpt) + ".json").read_text())
    qcfg = meta.get("config", {}).get("quantization", {})
    img_size = img_size or int(meta.get("img_size", 640))
    num_classes = int(meta.get("num_classes", 8))
    model = MCAQYOLO(
        variant=meta.get("variant", "yolov8n"), num_classes=num_classes,
        grid_size=int(qcfg.get("grid_size", 8)),
        bit_mapping=qcfg.get("bit_mapping", "mlp"),
        # meta-less checkpoints predate the softplus default: 'abs'
        monotone_param=qcfg.get("monotone_param", "abs"),
        target_bits=float(qcfg.get("target_bits", 4.0)),
        min_bits=int(qcfg.get("min_bits", 2)),
        max_bits=int(qcfg.get("max_bits", 8)),
        normalize_complexity=bool(qcfg.get("normalize_complexity", True)),
        device=device)
    restore_into(model, ckpt, warn=False)

    data = load_dataset_yaml(data_yaml)
    val_loader = DataLoader(YOLODataset(data["val"], img_size, 16, augment=False),
                            batch_size, shuffle=False, drop_last=False)

    def gated_counts(raw):
        """Per-image number of anchors whose best-class sigmoid score clears
        each gate: what must fit in the pool."""
        B = raw[0].shape[0]
        logits = torch.cat([m.reshape(B, -1, m.shape[-1])[..., 4 * REG_MAX:].amax(-1)
                            for m in raw], dim=1).to(torch.float32)
        score = torch.sigmoid(logits)
        return (score >= deployed_conf).sum(-1), (score >= eval_conf).sum(-1)

    gates = {"deployed": (deployed_conf, 0.45), "eval": (eval_conf, 0.65)}
    counts = {"deployed": [], "eval": []}
    dets = {(g, p): [] for g in gates for p in pools}
    targets = []
    for batch in val_loader:
        images = torch.as_tensor(batch["image"]).to(device)
        raw, _ = model(images, temperature=1.0, quantize=True)
        cd, ce = gated_counts(raw)
        counts["deployed"].extend(cd.tolist())
        counts["eval"].extend(ce.tolist())
        targets.extend(extract_targets_per_image(batch))
        for (g, p) in dets:  # one forward feeds every (gate, pool) program
            conf, iou = gates[g]
            det = decode_and_nms(raw, num_classes, conf_threshold=conf, iou_threshold=iou,
                                 max_det=max_det, pre_topk=p)
            dets[(g, p)].extend(detections_to_numpy(*det))

    res = {"config": {"ckpt": str(ckpt), "img_size": img_size,
                      "n_val": len(targets), "pools": list(pools),
                      "max_det": max_det}}
    for g in gates:
        arr = np.asarray(counts[g])
        res[f"gated_candidates_{g}"] = {
            "conf": gates[g][0], "mean": round(float(arr.mean()), 2),
            "max": int(arr.max()),
            "p99": int(np.percentile(arr, 99)),
        }

    for g in gates:
        for p in pools:
            m50 = compute_map(dets[(g, p)], targets, 0.5)["map"]
            m5095 = compute_map50_95(dets[(g, p)], targets)["map50_95"]
            res[f"map_{g}_pool{p}"] = {"map50": round(m50, 6), "map50_95": round(m5095, 6)}

    # bitwise detection equality between the smallest and the largest pool
    for g in gates:
        lo, hi = dets[(g, min(pools))], dets[(g, max(pools))]
        n_diff = 0
        for a, b in zip(lo, hi):
            same = (a["boxes"].shape == b["boxes"].shape
                    and np.array_equal(a["boxes"], b["boxes"])
                    and np.array_equal(a["scores"], b["scores"])
                    and np.array_equal(a["classes"], b["classes"]))
            n_diff += 0 if same else 1
        res[f"images_with_any_detection_diff_{g}"] = n_diff
    return res


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--data-yaml", required=True)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--pools", type=int, nargs="+", default=[512, 1024])
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = resolve_device(None)  # CUDA, or raise

    res = run(args.ckpt, args.data_yaml, args.img_size, args.batch_size,
              tuple(args.pools), max_det=args.max_det, device=device)
    s = json.dumps(res, indent=2)
    print(s)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(s + "\n")


if __name__ == "__main__":
    main()
