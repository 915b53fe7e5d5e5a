"""
Letterbox and its inverse (port of `mcaq_yolo_tpu/data/dataset.py:50-88`).
Host-side numpy; cv2's bilinear resize when cv2 can be imported, else the
reference's nearest-index fallback.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

try:
    import cv2

    HAS_CV2 = True
except ImportError:  # cv2 is optional
    HAS_CV2 = False


def letterbox(img: np.ndarray, new_size: int = 640,
              pad_value: int = 114) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Resize keeping aspect ratio, pad to a square with gray 114.
    Returns (letterboxed HxWx3, scale, (pad_x, pad_y))."""
    h, w = img.shape[:2]
    scale = min(new_size / h, new_size / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if HAS_CV2:
        resized = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    else:
        yi = (np.arange(nh) * h / nh).astype(int)
        xi = (np.arange(nw) * w / nw).astype(int)
        resized = img[yi][:, xi]
    out = np.full((new_size, new_size, 3), pad_value, img.dtype)
    pad_y = (new_size - nh) // 2
    pad_x = (new_size - nw) // 2
    out[pad_y:pad_y + nh, pad_x:pad_x + nw] = resized
    return out, scale, (pad_x, pad_y)


def unletterbox_boxes(boxes: np.ndarray, scale: float, pad: Tuple[int, int],
                      orig_hw: Tuple[int, int]) -> np.ndarray:
    """Invert the letterbox on xyxy boxes and clamp to the original image."""
    b = boxes.copy().astype(np.float32)
    b[:, [0, 2]] = (b[:, [0, 2]] - pad[0]) / scale
    b[:, [1, 3]] = (b[:, [1, 3]] - pad[1]) / scale
    h, w = orig_hw
    b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
    b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
    return b
