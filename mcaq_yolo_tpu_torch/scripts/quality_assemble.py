"""Assemble per-seed quality-evidence JSONs into the replicated table
(port of `mcaq_yolo_tpu/scripts/quality_assemble.py`): mean, sample std and
per-seed values over the seeds for the FP / MCAQ / post-hoc / matched-PTQ
arms and their deltas, the per-seed deployed bit histograms, and the KD
protocol's when KD files are given.  Pure Python: no device.

Usage:
    python -m mcaq_yolo_tpu_torch.scripts.quality_assemble \
        --main evidence/torch/quality_seed0.json ... [--kd ...] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path


def _mean_std(xs):
    xs = [float(x) for x in xs if x is not None]
    if not xs:
        return None
    m = sum(xs) / len(xs)
    # sample std (ddof=1); null for a single seed
    std = (round(math.sqrt(sum((x - m) ** 2 for x in xs) / (len(xs) - 1)), 4)
           if len(xs) > 1 else None)
    return {"mean": round(m, 4), "std": std,
            "per_seed": [round(x, 4) for x in xs], "n": len(xs)}


def assemble(main_paths, kd_paths=()):
    mains = [json.loads(Path(p).read_text()) for p in main_paths]
    out = {
        "protocol": {
            "seeds": [m["config"]["seed"] for m in mains],
            "per_seed_config": mains[0]["config"],
            "note": ("fresh synthetic dataset draw per seed; DEFAULT "
                     "mapper config (monotone_param=softplus + lambda1/2 "
                     "saturation gate + closed-loop budget controller)"),
        },
    }

    def arm(key, fields=("map50", "map50_95", "avg_bits")):
        rows = [m.get(key) for m in mains if m.get(key)]
        if not rows:
            return None
        return {f: _mean_std([r.get(f) for r in rows]) for f in fields}

    out["fp_trained_arm"] = arm("fp_trained_arm")
    out["mcaq_trained_arm"] = arm(
        "mcaq_trained_arm",
        ("map50", "map50_95", "avg_bits", "compression",
         "deploy_temperature",
         "rounded_map_spatial_std_mean", "rounded_map_spatial_std_max"))
    out["posthoc_quant_arm"] = arm(
        "posthoc_quant_arm", ("map50", "map50_95", "avg_bits"))
    out["matched_ptq_arm"] = arm(
        "matched_ptq_arm", ("map50", "map50_95", "avg_bits", "pinned_bits"))
    for delta in ("delta_mcaq_vs_fp_map50_95",
                  "delta_posthoc_vs_fp_map50_95",
                  "mcaq_recovers_over_posthoc_map50_95",
                  "mcaq_vs_matched_ptq_map50_95",
                  "delta_matched_ptq_vs_fp_map50_95"):
        out[delta] = _mean_std([m.get(delta) for m in mains])
    # per-seed deployed bit histograms (is the allocation spatial at all?)
    out["mcaq_bit_histograms_per_seed"] = {
        str(m["config"]["seed"]): m["mcaq_trained_arm"].get("bit_histogram")
        for m in mains if m.get("mcaq_trained_arm")
    }

    if kd_paths:
        kds = [json.loads(Path(p).read_text()) for p in kd_paths]
        out["kd_protocol"] = {
            "seeds": [k["config"]["seed"] for k in kds],
            "per_seed_config": kds[0]["config"],
            "note": ("short-budget damaging regime (bits capped, "
                     "below-convergence budget): no_kd = MCAQ arm, kd = "
                     "same budget + FP-teacher logit/feature KD"),
        }
        out["kd_no_kd_map50_95"] = _mean_std(
            [k.get("mcaq_trained_arm", {}).get("map50_95") for k in kds])
        out["kd_kd_map50_95"] = _mean_std(
            [k.get("kd_arm", {}).get("map50_95") for k in kds])
        out["kd_delta_kd_minus_no_kd_map50_95"] = _mean_std(
            [k.get("delta_kd_vs_mcaq_map50_95") for k in kds])
        out["kd_bits"] = {
            "no_kd": _mean_std([k.get("mcaq_trained_arm", {}).get("avg_bits")
                                for k in kds]),
            "kd": _mean_std([k.get("kd_arm", {}).get("avg_bits")
                             for k in kds]),
        }
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--main", nargs="+", required=True)
    p.add_argument("--kd", nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    table = assemble(args.main, args.kd)
    s = json.dumps(table, indent=2, default=float)
    print(s)
    if args.out:
        Path(args.out).write_text(s + "\n")


if __name__ == "__main__":
    main()
