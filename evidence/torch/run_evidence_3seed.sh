#!/usr/bin/env bash
# The port's accuracy evidence at the JAX record's three seeds, on one CUDA
# card:
#   - quality_evidence's four arms at QUALITY_r05.json's per_seed_config
#     (640 px, 50 epochs, FP 40, 192 images, v3, softplus) for seeds 1 and 2
#     (seed 0 is quality_seed0.json, run alone earlier),
#   - M3 (m3_permutation) on each of those seeds' arm-B best.ckpt,
#   - the KD rows of QUALITY_r03_kd.json's damaging regime at seeds 0 1 2
#     (256 px, 12 epochs, target 2.0, bits 2..3, v2, lambda_smooth 0.02,
#     the FP teacher trained in the same run at 25 epochs),
#   - quality_assemble over the three main seeds and the three KD seeds,
#   - with STEPS=dryrun: `python -m mcaq_yolo_tpu_torch.entry 8` (entry.py's
#     dryrun over 8 ranks), its three lines into multichip_dryrun.json.
# Each JSON gets "device" (the card's name and power limit, as
# `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
# them), "command" and "wall_s" (host clock around the command).
#
# Usage: bash evidence/torch/run_evidence_3seed.sh [OUT_DIR] [WORK_DIR]
#   OUT_DIR  where the JSONs go (default evidence/torch)
#   WORK_DIR datasets and checkpoints (default build/evidence_3seed)
# STEPS (default "main m3 kd assemble"; also "dryrun") picks the steps to run.
set -euo pipefail
OUT=${1:-evidence/torch}
WORK=${2:-build/evidence_3seed}
STEPS=${STEPS:-main m3 kd assemble}
mkdir -p "$OUT" "$WORK"
export PYTHONUNBUFFERED=1
CARD=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | head -n 1)
echo "card: $CARD"

# stamp FILE WALL_S COMMAND...: add device, command and wall_s to FILE
stamp() {
  python3 - "$CARD" "$@" <<'EOF'
import json, sys
card, path, wall = sys.argv[1], sys.argv[2], float(sys.argv[3])
name, limit = [s.strip() for s in card.split(",", 1)]
d = json.load(open(path))
d["device"] = {"name": name, "power_limit": limit, "nvidia_smi": card}
d["command"] = " ".join(sys.argv[4:])
d["wall_s"] = round(wall, 1)
with open(path, "w") as f:
    f.write(json.dumps(d, indent=2) + "\n")
EOF
}

# timed FILE COMMAND...: run COMMAND, then stamp FILE with its wall time
timed() {
  local file=$1; shift
  local t0 t1
  t0=$(date +%s.%N)
  "$@"
  t1=$(date +%s.%N)
  stamp "$file" "$(python3 -c "print($t1 - $t0)")" "$@"
  echo "== $file: $(python3 -c "print(round($t1 - $t0, 1))") s" >&2
}

has() { [[ " $STEPS " == *" $1 "* ]]; }

for s in 1 2; do
  if has main; then
    timed "$OUT/quality_seed$s.json" python3 -m mcaq_yolo_tpu_torch.scripts.quality_evidence \
      --arms abcm --epochs 50 --fp-epochs 40 --n-images 192 --img-size 640 \
      --dataset v3 --seed "$s" --root "$WORK/quality_seed$s" \
      --out "$OUT/quality_seed$s.json" > "$WORK/quality_seed$s.log"
  fi
  if has m3; then
    timed "$OUT/m3_permutation_seed$s.json" python3 -m mcaq_yolo_tpu_torch.scripts.m3_permutation \
      --model "$WORK/quality_seed$s/train_mcaq/best.ckpt" \
      --data "$WORK/quality_seed$s/data/dataset.yaml" --num-classes 16 \
      --json "$OUT/m3_permutation_seed$s.json" > "$WORK/m3_permutation_seed$s.log"
  fi
done

if has kd; then
  for s in 0 1 2; do
    timed "$OUT/quality_kd_seed$s.json" python3 -m mcaq_yolo_tpu_torch.scripts.quality_evidence \
      --arms ab --img-size 256 --epochs 12 --fp-epochs 25 --kd-epochs 12 \
      --n-images 192 --target-bits 2.0 --max-bits 3 --dataset v2 \
      --lambda-smooth 0.02 --seed "$s" --root "$WORK/quality_kd_seed$s" \
      --out "$OUT/quality_kd_seed$s.json" > "$WORK/quality_kd_seed$s.log"
  done
fi

if has assemble; then
  timed "$OUT/quality_3seed.json" python3 -m mcaq_yolo_tpu_torch.scripts.quality_assemble \
    --main "$OUT"/quality_seed{0,1,2}.json --kd "$OUT"/quality_kd_seed{0,1,2}.json \
    --out "$OUT/quality_3seed.json" > /dev/null
fi

if has dryrun; then
  t0=$(date +%s.%N)
  python3 -m mcaq_yolo_tpu_torch.entry 8 2>&1 | tee "$WORK/multichip_dryrun.log"
  t1=$(date +%s.%N)
  python3 - "$WORK/multichip_dryrun.log" "$OUT/multichip_dryrun.json" <<'PY'
import json, sys
lines = [ln.rstrip("\n") for ln in open(sys.argv[1]) if ln.startswith("[dryrun_multichip]")]
json.dump({"n_devices": 8, "lines": lines}, open(sys.argv[2], "w"))
PY
  stamp "$OUT/multichip_dryrun.json" "$(python3 -c "print($t1 - $t0)")" \
    python3 -m mcaq_yolo_tpu_torch.entry 8
fi
