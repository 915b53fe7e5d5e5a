"""
Side-by-side device time of the phi kernel (`csrc/morph_tiles.cu`) and
another source of it, on one GPU, with each library's resource use.

Run from the repository root:

    python -m mcaq_yolo_tpu_torch.ops.morph_tiles_ab --baseline SRC [--out DIR]

SRC is a CUDA source with the first version's C interface and launch
geometry (groups of 256 pixel slots a block), for example that version
taken out with
`mkdir -p build/ab && git show 1375767:mcaq_yolo_tpu_torch/csrc/morph_tiles.cu > build/ab/base.cu`.
It is built with the committed kernel's nvcc flags (`build.nvcc_flags`).

Shapes: the serving cell's three scales (tile 4 on 40 x 40, 40 x 40 and
20 x 20 gray maps, downsample 2) at bs 32 and 256, P3 with downsample 1
(tile 8 on 80 x 80) at bs 32, and Eq.(8) scoring at bs 8 (640 px: tile 64 on
640 x 640; 1280 px: tile 128 on 1280 x 1280), on seeded random gray maps
normalized as `compute_phi_tiles` does.  Each kernel is first held bitwise
against `phi_tiles_torch` on the card, then timed in turns (baseline,
committed, committed, baseline) by chip_smoke.py's device-only method: 8
back-to-back launches queued behind a device sleep, median of 21.  Then the
deployed program (`inference.deployed_program`: a seeded MCAQ-YOLOv8n at
640 px, bf16, downsample 2, 3 phi launches, then decode + NMS at pool 256,
conf 0.25, max_det 300) at bs 32 and 256 with each kernel behind the op, in
the same turns, host-paced as a caller sees it (median of 21).  Each library's
registers, stack and shared memory per kernel come from `cuobjdump
--dump-resource-usage`, its SASS instruction count per kernel from
`cuobjdump -sass` (dumped to DIR), the committed build's ptxas lines from
its build log.  One JSON line per reading; exits non-zero on any mismatch or
failed build.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from ..core import image_ops as iops
from ..core import morphology_lanes as ml
from ..utils.cuda_timing import bound_ms, cuda_ms
from . import build
from .spatial_quant_ab import sass_counts

# (name, batch, gray side, tile)
SHAPES = (("P3", 32, 40, 4), ("P4", 32, 40, 4), ("P5", 32, 20, 4),
          ("P3", 256, 40, 4), ("P4", 256, 40, 4), ("P5", 256, 20, 4),
          ("P3_ds1", 32, 80, 8), ("score_640px", 8, 640, 64), ("score_1280px", 8, 1280, 128))


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def first_version_args(B: int, ht: int, wt: int, tile: int):
    """The first version's launch geometry (its own copy: groups of 256
    pixel slots, 256 threads, planes in shared memory up to tile 64):
    (tiles per group, grid, planes global, plane bytes per group, shared
    memory bytes), and the global scratch bytes."""
    n_tiles, n = B * ht * wt, tile * tile
    tpc = max(1, 256 // n)
    groups = -(-n_tiles // tpc)
    ws_bytes = 25 * tpc * n
    counters = tpc * (24 + 2) * 4 + 256 * 4
    ws_global = counters + ws_bytes > ml.MAX_SMEM
    grid = min(groups, ml.GLOBAL_BLOCKS) if ws_global else groups
    return ((tpc, grid, int(ws_global), ws_bytes, counters + (0 if ws_global else ws_bytes)),
            grid * ws_bytes if ws_global else 0)


def _build_baseline(src: Path, out_dir: Path) -> Path:
    lib = out_dir / "libmorph_tiles_baseline.so"
    cmd = [build._nvcc(), *build.nvcc_flags("morph_tiles"), "-o", str(lib), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")
    _emit({"built": str(src), "ptxas": [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                                        if "registers" in ln or "spill" in ln or "stack" in ln]})
    return lib


def _bind(lib_path: Path):
    fn = ctypes.CDLL(str(lib_path)).mcaq_phi_tiles
    taps = ctypes.POINTER(ctypes.c_float)
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_longlong]
                   + [ctypes.c_int, taps, taps, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@contextlib.contextmanager
def first_version_installed(lib_path: Path):
    """While the context lasts, the op `mcaq::phi_tiles` launches the first
    version's library with its own geometry; the rest of the program is
    unchanged."""
    fn, kernel_args = _bind(lib_path), ml.kernel_args

    def first_version_kernel_args(gray, tile, *options):
        ints, geo = kernel_args(gray, tile, *options)
        old, scratch_bytes = first_version_args(*ints[:3], tile)
        return ints[:7] + old, geo._replace(ws_global=bool(old[2]), scratch_bytes=scratch_bytes)

    saved = ml._kernel(), ml.kernel_args
    ml._kernel_fn, ml.kernel_args = fn, first_version_kernel_args
    try:
        yield
    finally:
        ml._kernel_fn, ml.kernel_args = saved


def _tool(name: str) -> str:
    return shutil.which(name) or f"/usr/local/cuda/bin/{name}"


def resource_usage(lib: Path) -> list:
    """[{kernel, REG, STACK, SHARED, LOCAL}] of every kernel in the library
    (`cuobjdump --dump-resource-usage`, names demangled by cu++filt when
    it is there)."""
    r = subprocess.run([_tool("cuobjdump"), "--dump-resource-usage", str(lib)],
                       capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {lib}: {r.stderr}")
    rows, name = [], None
    for line in r.stdout.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        if name and "REG:" in line:
            row = {"kernel": name}
            for key in ("REG", "STACK", "SHARED", "LOCAL"):
                v = re.search(rf"\b{key}:(\d+)", line)
                row[key] = int(v.group(1)) if v else None
            rows.append(row)
            name = None
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt and rows:
        d = subprocess.run([filt], input="\n".join(r["kernel"] for r in rows),
                           capture_output=True, text=True, timeout=60)
        names = d.stdout.splitlines()
        if d.returncode == 0 and len(names) == len(rows):
            for row, n in zip(rows, names):
                row["kernel"] = n.split("(")[0].replace("(anonymous namespace)::", "")
    return rows


def _short_names(counts: dict) -> dict:
    """SASS instruction counts keyed by kernel<template arguments>."""
    out = {}
    for name, n in counts.items():
        m = re.search(r"(phi_\w+?_kernel)I(.*?)EEv", name)
        args = re.findall(r"L(i|b)(\d+)E", m.group(2)) if m else []
        out[f"{m.group(1)}<{','.join(v for _, v in args)}>" if m else name] = n
    return out


def _gray(B: int, side: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return iops.normalize01(torch.rand((B, side, side), generator=g, device="cuda")).contiguous()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="a CUDA source with the first version's C interface")
    ap.add_argument("--out", type=Path, default=Path("build/morph_tiles_ab"),
                    help="directory for the baseline library and the SASS dumps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("morph_tiles_ab: no CUDA device is available", file=sys.stderr)
        return 2
    args.out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    _emit({"gpu": smi.stdout.strip(), "torch": torch.__version__, "cuda": torch.version.cuda})

    libs = {"committed": build.build_all(["morph_tiles"])["morph_tiles"],
            "baseline": _build_baseline(args.baseline, args.out)}
    _emit({"ptxas_committed": [ln.strip() for ln in build.build_log("morph_tiles").splitlines()
                               if "registers" in ln or "spill" in ln or "stack" in ln]})
    for tag, lib in libs.items():
        usage = resource_usage(lib)
        warp = [u for u in usage if "phi_warp_kernel" in u["kernel"]]
        _emit({"resource_usage": tag, "library": lib.name, "kernels": usage,
               "warp_path_max_reg": max((u["REG"] for u in warp), default=None),
               "warp_path_max_stack": max((u["STACK"] for u in warp), default=None),
               "sass_instructions": _short_names(sass_counts(lib, args.out, tag))})

    def installed(tag):
        return (first_version_installed(libs["baseline"]) if tag == "baseline"
                else contextlib.nullcontext())

    kernels = {tag: (lambda gray, tile, tag=tag: _in(installed(tag), ml.phi_tiles, gray, tile))
               for tag in ("baseline", "committed")}
    order = ("baseline", "committed", "committed", "baseline")
    ok = True
    for seed, (name, B, side, tile) in enumerate(SHAPES):
        gray = _gray(B, side, seed)
        ref = ml.phi_tiles_torch(gray, tile)
        n_bytes, n_ops = ml.phi_tiles_bytes(gray, tile), ml.phi_tiles_ops(gray.numel())
        row = {"scale": name, "batch": B, "gray": list(gray.shape), "tile": tile,
               "geometry": ml.launch_geometry(gray.numel() // (tile * tile), tile)._asdict(),
               "first_version_geometry": first_version_args(B, side // tile, side // tile,
                                                            tile)[0]}
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops)
        for tag, fn in kernels.items():
            out = fn(gray, tile)
            torch.cuda.synchronize()
            mism = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
            row[f"{tag}_mismatches"] = mism
            ok &= mism == 0
        for tag in order:
            fn = kernels[tag]
            row.setdefault(f"{tag}_ms", []).append(cuda_ms(
                lambda k, fn=fn: fn(gray, tile), inner=8, device_only=True))
        base, new = (sum(row[f"{t}_ms"]) / 2 for t in ("baseline", "committed"))
        row.update({"speedup": base / new, "committed_bound_share": row["bound_ms"] / new,
                    "baseline_bound_share": row["bound_ms"] / base})
        _emit(row)
        del gray, ref
    forward_rows(installed, order)
    return 0 if ok else 1


def _in(context, fn, *args):
    with context:
        return fn(*args)


def forward_rows(installed, order) -> None:
    """The deployed program with each kernel behind the op, in turns."""
    from ..inference import deployed_program
    from ..models.mcaq_yolo import MCAQYOLO

    model = MCAQYOLO(variant="yolov8n", num_classes=80, bit_mapping="mlp",
                     monotone_param="softplus", morph_downsample=2, dtype=torch.bfloat16,
                     device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    for bs in (32, 256):
        x = torch.randint(0, 256, (bs, 640, 640, 3), generator=g, device="cuda",
                          dtype=torch.uint8)
        row = {"program": "deployed_program(yolov8n, nc 80, bf16, downsample 2, pool 256, "
                          "conf 0.25, max_det 300)", "batch": bs, "img_size": 640,
               "timing": "host-paced, median of 21"}
        with torch.inference_mode():
            for tag in order:
                with installed(tag):
                    n0 = ml.phi_tiles.launches
                    row.setdefault(f"{tag}_ms", []).append(cuda_ms(
                        lambda k: deployed_program(model, x, 80, 0.25, 0.45, 300, 256)))
                    row[f"{tag}_phi_launches_per_call"] = (ml.phi_tiles.launches - n0) / 24
        _emit(row)
        del x


if __name__ == "__main__":
    sys.exit(main())
