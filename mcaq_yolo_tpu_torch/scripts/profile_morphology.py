"""Sub-stage profile of the per-tile morphology engine (port of
`mcaq_yolo_tpu/scripts/profile_morphology.py`, same flags and keys).

`utils.profiling.component_breakdown` gives the morphology stage as one
number; this splits it into its operators — tile extraction, blur, Sobel,
Otsu, Canny NMS, hysteresis, binarization, LBP entropy, fractal box count,
Euler / contour — each timed alone (`utils.profiling.timed`), and counts
the CUDA kernels each launches (`cuda_kernels`, under "cuda_kernels"): the
stage is paced by the host's launches, so the count is what a fused
kernel would remove.

    python -m mcaq_yolo_tpu_torch.scripts.profile_morphology \\
        [--batch 128] [--hw 80] [--tile 8] [--out FILE]

(--hw 80 --tile 8 is the P3 scale of yolov8n at 640 px; P4 / P5 are 40/4
and 20/2.)  `main` runs on CUDA and raises without it; `run(...,
device="cpu")` is for the tests (no kernel count there: null).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..core import image_ops as iops
from ..core import morphology as tm
from ..device import resolve_device
from ..utils.profiling import cuda_kernels, device_stamp, timed


def run(batch: int = 128, hw: int = 80, tile: int = 8, iters: int = 30,
        dtype: str = "float32", device=None):
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    gray = iops.normalize01(torch.as_tensor(rng.random((batch, hw, hw)), dtype=torch.float32,
                                            device=device))
    gray = gray.to(getattr(torch, dtype))
    packed = tm.extract_tiles(gray, tile)[0]

    res = {"config": {"batch": batch, "hw": hw, "tile": tile,
                      "platform": device.type, "dtype": dtype, **device_stamp(device)},
           "cuda_kernels": {}}

    def bench(name, fn, *args):
        ms = timed(fn, *args, iters=iters, device=device) * 1e3
        res[name] = round(ms, 3)
        res["cuda_kernels"][name] = cuda_kernels(fn, *args) if device.type == "cuda" else None
        print(f"{name:24s}: {ms:7.3f} ms  {res['cuda_kernels'][name]} kernels", flush=True)

    def hyst(strong, weak):
        return tm._hysteresis(strong, weak > 0, 8)

    with torch.inference_mode():
        bench("pack_tiles", lambda g: tm.extract_tiles(g, tile)[0], gray)
        bench("gaussian_blur5",
              lambda p: tm._sep_filter(p, tm._gaussian_taps(5, 1.0), "edge"), packed)
        bench("sobel", tm.sobel, packed)
        bench("otsu", tm.otsu_threshold, packed)
        gx, gy = tm.sobel(packed)
        mag = torch.abs(gx) + torch.abs(gy)
        bench("canny_nms", tm._canny_nms, mag, gx, gy)
        strong = (mag > 0.5).to(packed.dtype)
        weak = (mag > 0.25).to(packed.dtype)
        bench("hysteresis_x8", hyst, strong, weak)
        bench("canny_full", tm.canny_cv2compat, packed)
        bench("adaptive_binarize", tm.adaptive_binarize, packed)
        bench("lbp_entropy", tm.lbp_entropy, packed)
        edge = tm.canny_cv2compat(packed)
        bench("fractal", lambda e: tm.fractal_dimension(e, tile), edge)
        binm = tm.adaptive_binarize(packed)
        bench("euler", tm.euler_components, binm)
        bench("contour_incl_euler", lambda b: tm.contour_complexity(b, True), binm)
        bench("phi_full", lambda g: tm.phi_metrics_tiled(g, tile, "cv2compat", "adaptive",
                                                         True), gray)
    return res


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--hw", type=int, default=80)
    p.add_argument("--tile", type=int, default=8)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = resolve_device(None)  # CUDA, or raise
    res = run(args.batch, args.hw, args.tile, args.iters, args.dtype, device=device)
    s = json.dumps(res, indent=1)
    print(s)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(s + "\n")


if __name__ == "__main__":
    main()
