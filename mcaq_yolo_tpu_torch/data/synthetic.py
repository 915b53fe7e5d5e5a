"""
Seeded synthetic detection batches in the loader's format, for driving the
training path without a dataset on disk: a textured background with filled
rectangles, one box label per rectangle.

Each batch is {"image": uint8 (B, S, S, 3), "gt_boxes": float32 (B, M, 4)
xyxy pixels, "gt_classes": int32 (B, M), "gt_mask": bool (B, M)}, the
layout of the reference's `data/dataset.py` collate, with M box slots of
which the first n_i are valid.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def synthetic_batches(n_batches: int, batch_size: int, img_size: int, num_classes: int,
                      max_boxes: int = 128, boxes_per_image: Tuple[int, int] = (5, 30),
                      seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """`n_batches` batches from `seed`; each image holds a number of boxes
    drawn uniformly from `boxes_per_image` (inclusive, capped at max_boxes),
    each box 4-40% of the side."""
    rng = np.random.default_rng(seed)
    lo, hi = boxes_per_image
    batches = []
    for _ in range(n_batches):
        images = rng.integers(0, 96, (batch_size, img_size, img_size, 3), dtype=np.uint8)
        gt_boxes = np.zeros((batch_size, max_boxes, 4), np.float32)
        gt_classes = np.zeros((batch_size, max_boxes), np.int32)
        gt_mask = np.zeros((batch_size, max_boxes), bool)
        for b in range(batch_size):
            n = min(int(rng.integers(lo, hi + 1)), max_boxes)
            wh = rng.uniform(0.04, 0.4, (n, 2)) * img_size
            x1y1 = rng.uniform(0.0, 1.0, (n, 2)) * (img_size - wh)
            boxes = np.concatenate([x1y1, x1y1 + wh], axis=1)
            classes = rng.integers(0, num_classes, n)
            for (x1, y1, x2, y2), c in zip(boxes.astype(int), classes):
                images[b, y1:y2, x1:x2] = 96 + (c * 37 + np.arange(3) * 53) % 160
            gt_boxes[b, :n] = boxes
            gt_classes[b, :n] = classes
            gt_mask[b, :n] = True
        batches.append({"image": images, "gt_boxes": gt_boxes, "gt_classes": gt_classes,
                        "gt_mask": gt_mask})
    return batches
