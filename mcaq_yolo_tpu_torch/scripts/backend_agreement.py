"""Backend agreement: the port's tile-metric surrogates (`core/morphology.py`,
computed on the device) against the exact OpenCV backend
(`core/morphology_cv2.py`, on the host) — the numerical-fidelity harness of
the metric pipeline (port of `mcaq_yolo_tpu/scripts/backend_agreement.py`,
same flags, defaults and JSON keys).

Per-metric and fused-map Pearson / Spearman over N images from a directory,
or from a procedural corpus when none is given: 'synthetic' (rectangles on
noise, `make_synthetic_dataset`) or 'natural' (1/f spectra, fractal
textures, mixed scenes, `make_natural_statistics_images`).  `--legacy`
switches the surrogate to the legacy Canny / Otsu binarization without the
Euler-K division; `--mode global` to the whole-image metric mode.

Usage:
    python -m mcaq_yolo_tpu_torch.scripts.backend_agreement \\
        [--images DIR] [--num 16] [--img-size 256] [--legacy] \\
        [--mode tiled|global] [--corpus synthetic|natural] [--json OUT]

`main` runs the surrogate on CUDA and raises without it; `run(...,
device="cpu")` is for the tests.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..core import morphology_cv2
from ..core.morphology import compute_phi_tiles
from ..data.dataset import (
    IMG_EXTS,
    letterbox,
    make_natural_statistics_images,
    make_synthetic_dataset,
    read_image,
)
from ..device import resolve_device

METRICS = ("fractal", "texture", "gradient", "edge", "contour")


def _corpus_files(images_dir, corpus: str, num_images: int, img_size: int, tmp: str):
    if images_dir is None:
        if corpus == "natural":
            images_dir = make_natural_statistics_images(tmp, n_images=num_images,
                                                        img_size=img_size)
        else:
            make_synthetic_dataset(tmp, n_images=num_images, img_size=img_size)
            images_dir = str(Path(tmp) / "images" / "train")
        print(f"[backend_agreement] no --images given; {corpus} set at {images_dir}")
    files = sorted(str(p) for p in Path(images_dir).rglob("*")
                   if p.suffix.lower() in IMG_EXTS)[:num_images]
    if not files:
        raise FileNotFoundError(f"no images in {images_dir}")
    return files


def run(images_dir=None, num_images: int = 16, img_size: int = 256,
        legacy: bool = False, grid_size: int = 8, metric_mode: str = "tiled",
        corpus: str = "synthetic", device=None):
    """The agreement table: per metric Pearson, Spearman and both means,
    then the fused (uniform-alpha) map's Pearson and Spearman."""
    from scipy import stats

    device = resolve_device(device)
    canny_impl = "legacy" if legacy else "cv2compat"
    binarize_impl = "otsu" if legacy else "adaptive"

    dev_vals = {k: [] for k in METRICS}
    cv2_vals = {k: [] for k in METRICS}
    with tempfile.TemporaryDirectory(prefix="backend_agreement_") as tmp:
        files = _corpus_files(images_dir, corpus, num_images, img_size, tmp)
        for f in files:
            lb, _, _ = letterbox(read_image(f), img_size)
            x = (lb.astype(np.float32) / 255.0)[None]
            _, detailed = compute_phi_tiles(
                torch.from_numpy(x).to(device), grid_size=grid_size,
                canny_impl=canny_impl, binarize_impl=binarize_impl,
                contour_components=not legacy, metric_mode=metric_mode)
            _, detailed_cv2 = morphology_cv2.phi_tiles_cv2(x, grid_size)
            for k in METRICS:
                dev_vals[k].append(detailed[k].cpu().numpy().reshape(-1))
                cv2_vals[k].append(detailed_cv2[k].reshape(-1))

    results = {"backend": canny_impl, "metric_mode": metric_mode,
               "corpus": "dir" if images_dir is not None else corpus,
               "num_images": len(files), "device": str(device)}
    fused_dev, fused_cv2 = [], []
    alpha = np.ones(5) / 5.0
    for i, k in enumerate(METRICS):
        g = np.concatenate(dev_vals[k])
        c = np.concatenate(cv2_vals[k])
        varied = g.std() > 0 and c.std() > 0
        results[k] = {
            "pearson": float(stats.pearsonr(g, c)[0]) if varied else float("nan"),
            "spearman": float(stats.spearmanr(g, c)[0]) if varied else float("nan"),
            # the JAX harness's key names, kept so the two tables line up
            "mean_jax": float(g.mean()), "mean_cv2": float(c.mean()),
        }
        fused_dev.append(alpha[i] * g)
        fused_cv2.append(alpha[i] * c)
    fg = np.sum(fused_dev, axis=0)
    fc = np.sum(fused_cv2, axis=0)
    results["fused"] = {"pearson": float(stats.pearsonr(fg, fc)[0]),
                        "spearman": float(stats.spearmanr(fg, fc)[0])}
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--images", default=None)
    parser.add_argument("--num", type=int, default=16)
    parser.add_argument("--img-size", type=int, default=256)
    parser.add_argument("--grid-size", type=int, default=8)
    parser.add_argument("--legacy", action="store_true")
    parser.add_argument("--mode", default="tiled", choices=["tiled", "global"])
    parser.add_argument("--corpus", default="synthetic", choices=["synthetic", "natural"],
                        help="procedural corpus when --images is absent: 'natural' = "
                             "1/f-spectrum / fractal-texture / mixed scenes")
    parser.add_argument("--json", default=None)
    args = parser.parse_args(argv)
    device = resolve_device(None)  # CUDA, or raise

    results = run(args.images, args.num, args.img_size, args.legacy, args.grid_size,
                  args.mode, corpus=args.corpus, device=device)
    results["gpu"] = torch.cuda.get_device_name(0)
    out = json.dumps(results, indent=2)
    print(out)
    if args.json:
        Path(args.json).write_text(out + "\n")


if __name__ == "__main__":
    main()
