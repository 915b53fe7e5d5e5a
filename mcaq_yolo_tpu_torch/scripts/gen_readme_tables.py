"""Regenerate the README's rows for the PyTorch + CUDA port from its
committed records (port of `mcaq_yolo_tpu/scripts/gen_readme_tables.py`):
the headline tables are generated from the measurement artifacts, never
hand-edited.

Reads `evidence/torch/bench_last.json` (written by `python -m
mcaq_yolo_tpu_torch.bench` on the card) and
`evidence/torch/quality_3seed.json` (the 3-seed accuracy evidence), and
rewrites the block between `<!-- GENERATED:BENCH_TORCH:BEGIN -->` /
`<!-- GENERATED:BENCH_TORCH:END -->` in README.md, in the port's section.
The JAX package's block (`GENERATED:BENCH`) is left as it is.

Usage: python -m mcaq_yolo_tpu_torch.scripts.gen_readme_tables [--check]
  --check  exit 1 if the block is stale instead of rewriting it
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BEGIN = "<!-- GENERATED:BENCH_TORCH:BEGIN -->"
END = "<!-- GENERATED:BENCH_TORCH:END -->"
BENCH = "evidence/torch/bench_last.json"
QUALITY = "evidence/torch/quality_3seed.json"
PEAK = "the H100's 989 TFLOP/s bf16 peak"


def fmt_pm(stat: dict, nd=3) -> str:
    return f"{stat['mean']:.{nd}f} ± {stat['std']:.{nd}f}"


def _spread(runs) -> str:
    return f"runs {min(runs):,.0f}-{max(runs):,.0f}" if runs else "runs not recorded"


def _card(stamp: dict) -> str:
    """The card and its power limit as nvidia-smi printed them, else the
    device's name ('cpu' for a CPU run)."""
    return stamp.get("nvidia_smi") or stamp.get("device", "device not recorded")


def build_rows(bench: dict, quality: dict | None) -> str:
    bsrc, qsrc = BENCH, QUALITY
    ex = bench.get("extra", {})
    card = _card(ex.get("device", {}))
    rows = ["| Metric | Value | Source |", "|---|---|---|"]
    cfg = ex.get("headline_config", "bs256_ds2")
    sweep = ex.get("e2e_decode_nms_sweep_imgs_per_sec", {})
    sweep_runs = ex.get("e2e_decode_nms_sweep_imgs_per_sec_runs", {})
    rows.append(
        f"| yolov8n MCAQ DEPLOYED inference (forward + decode + NMS), 640 px, bf16, {cfg}, "
        f"{card} | **{bench['value']:,.0f} images/s** (median of "
        f"{len(sweep_runs.get(cfg, []))} runs, {_spread(sweep_runs.get(cfg))}; "
        f"{bench['vs_baseline']:.1f}x the paper's 151 FPS anchor) | {bsrc} |")
    if sweep:
        s = ", ".join(f"{k}: {v:,.0f} ({_spread(sweep_runs.get(k))})"
                      for k, v in sorted(sweep.items()))
        rows.append(f"| e2e config sweep, images/s | {s} | {bsrc} `extra` |")
    fwd = ex.get("fwd_only_imgs_per_sec", {})
    if fwd:
        k, v = next(iter(fwd.items()))
        mfu = ex.get("fwd_mfu_pct_bf16_peak")
        mfu_s = f" = **{mfu}% of {PEAK}**" if mfu is not None else ""
        rows.append(f"| yolov8n forward only, {k} | {v:,.0f} images/s{mfu_s} "
                    f"({_spread(ex.get('fwd_only_imgs_per_sec_runs', {}).get(k))}) | "
                    f"{bsrc} `extra` |")
    if "e2e_mfu_pct_bf16_peak" in ex:
        rows.append(f"| e2e MFU (decode + NMS included) | {ex['e2e_mfu_pct_bf16_peak']}% "
                    f"of {PEAK} | {bsrc} `extra` |")
    if "infer_torch_backend_imgs_per_sec" in ex:
        rows.append(
            f"| yolov8n forward, bs 32, the quantizer's plain PyTorch version "
            f"(`quant_backend='torch'`) | {ex['infer_torch_backend_imgs_per_sec']:,.0f} "
            f"images/s ({_spread(ex.get('infer_torch_backend_imgs_per_sec_runs'))}) | "
            f"{bsrc} `extra` |")
    if "train_yolov8m_bs32_imgs_per_sec_per_chip" in ex:
        rows.append(
            f"| yolov8m MCAQ TRAIN step, 640 px, bs 32, bf16 autocast, AdamW with the "
            f"port's gradient clip at global norm 1.0 (the JAX bench does not clip) | "
            f"{ex['train_yolov8m_bs32_imgs_per_sec_per_chip']:,.0f} images/s "
            f"({_spread(ex.get('train_yolov8m_bs32_imgs_per_sec_per_chip_runs'))}) | "
            f"{bsrc} `extra` |")
    head = ex.get("launches", {}).get("headline")
    if head:
        rows.append(f"| hand-written kernel launches per forward of the headline program | "
                    f"spatial_quant {head['spatial_quant']:g}, phi_tiles "
                    f"{head['phi_tiles']:g} | {bsrc} `extra` |")
    if "vs_torch_cpu_fallback" in ex:
        rows.append(
            f"| vs the reference's executable path (torch-CPU fallback, measured) | "
            f"**{ex['vs_torch_cpu_fallback']:,.0f}x** "
            f"({ex.get('torch_cpu_fallback_imgs_per_sec', '?')} img/s) | {bsrc} `extra` |")
    for arm, why in ex.get("skip_reasons", {}).items():
        rows.append(f"| arm `{arm}` | skipped: {why} | {bsrc} `extra` |")

    if quality:
        arms = []
        if "mcaq_trained_arm" in quality:
            a = quality["mcaq_trained_arm"]
            arms.append("MCAQ-trained **" + fmt_pm(a["map50_95"]) + " mAP@50-95 @ "
                        + fmt_pm(a["avg_bits"], 2) + " bits**")
        if "fp_trained_arm" in quality:
            arms.append("FP32-trained " + fmt_pm(quality["fp_trained_arm"]["map50_95"]))
        if "matched_ptq_arm" in quality:
            m = quality["matched_ptq_arm"]
            arms.append("matched-budget PTQ " + fmt_pm(m["map50_95"])
                        + f" @ {m['avg_bits']['mean']:.1f} bits")
        seeds = quality.get("protocol", {}).get("seeds")
        n_seeds = len(seeds) if seeds else "?"
        ds = quality.get("protocol", {}).get("per_seed_config", {}).get("dataset", "synthetic")
        qcard = _card(quality.get("device", {}))
        rows.append(f"| quality protocol, {n_seeds}-seed replication ({ds}, 640 px), "
                    f"{qcard} | " + "; ".join(arms) + f" | {qsrc} |")
        d = quality.get("delta_mcaq_vs_fp_map50_95")
        if isinstance(d, dict):
            rows.append("| delta MCAQ − FP (mAP@50-95) | **" + fmt_pm(d) + f"** | {qsrc} |")
        dm = quality.get("mcaq_vs_matched_ptq_map50_95")
        if isinstance(dm, dict):
            rows.append("| delta MCAQ − matched-budget PTQ (mAP@50-95) | **"
                        + fmt_pm(dm) + f"** | {qsrc} |")
    return "\n".join(rows)


def regenerate(text: str, repo: Path) -> str:
    """`text` (a README) with the port's block rebuilt from `repo`'s records."""
    if BEGIN not in text or END not in text:
        sys.exit(f"README.md is missing the {BEGIN} / {END} markers")
    bench = json.loads((repo / BENCH).read_text())
    qpath = repo / QUALITY
    quality = json.loads(qpath.read_text()) if qpath.exists() else None
    block = BEGIN + "\n" + build_rows(bench, quality) + "\n" + END
    return re.sub(re.escape(BEGIN) + r".*?" + re.escape(END), lambda _: block, text,
                  flags=re.S)


def main(argv=None, repo: Path = REPO):
    """Rewrite (or with --check verify) `repo`'s README block from `repo`'s
    records; `repo` is this checkout unless a test passes another."""
    p = argparse.ArgumentParser()
    p.add_argument("--check", action="store_true")
    args = p.parse_args(argv)

    readme = repo / "README.md"
    text = readme.read_text()
    new = regenerate(text, repo)
    if args.check:
        if new != text:
            sys.exit("README.md port benchmark block is STALE — run "
                     "python -m mcaq_yolo_tpu_torch.scripts.gen_readme_tables")
        print("README.md port benchmark block is up to date")
        return
    readme.write_text(new)
    print("README.md port benchmark block regenerated")


if __name__ == "__main__":
    main()
