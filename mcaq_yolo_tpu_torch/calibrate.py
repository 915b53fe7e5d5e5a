"""
Post-training calibration (port of `mcaq_yolo_tpu/calibrate.py:24-63`;
paper Sec IV-D): collect per-channel min/max EMA statistics (momentum
0.99; in 'entropy' mode also the EMA histogram) over the calibration images
with the quantizers in stats-update mode, then freeze them, so that
inference uses fixed statistics.  The calibration mode is the model's
(`MCAQYOLO(calibration_mode=...)`), as in the reference.  The passes run the
eval quantizer, i.e. the CUDA kernel on CUDA, three launches per forward in
every mode; the explicit protocol for a model trained elsewhere, such as
Ultralytics weights loaded with `models.weights_io.load_pretrained_into`.
"""

from __future__ import annotations

import torch

from .core.quantization import freeze_calibration
from .models.mcaq_yolo import MCAQYOLO


@torch.no_grad()
def calibrate(model: MCAQYOLO, dataloader, num_images: int = 1000,
              temperature: float = 1.0) -> MCAQYOLO:
    """EMA-statistics collection over the loader's batches (dicts with
    "image" (B, H, W, 3)) until `num_images` are seen, then freeze; in
    place.  Returns the model."""
    device = next(model.parameters()).device
    seen = 0
    for batch in dataloader:
        images = torch.as_tensor(batch["image"]).to(device)
        model(images, temperature=temperature, quantize=True, training=False,
              update_stats=True)
        seen += images.shape[0]
        if seen >= num_images:
            break
    freeze_calibration(model)
    print(f"[MCAQ] Calibration frozen after {seen} images.")
    return model
