"""Offline evidence scripts (run as `python -m mcaq_yolo_tpu_torch.scripts.<name>`;
ports of `mcaq_yolo_tpu/scripts/`, same flags, defaults and JSON keys):

quality_evidence    — FP / MCAQ / post-hoc / matched-budget PTQ arms on a
                      synthetic dataset (+ an optional KD arm)
quality_assemble    — per-seed quality JSONs -> mean +- std table
m3_permutation      — bit-placement ablation (MCAQ vs random vs inverted)
m4_variation_gain   — spatial-allocation gain vs complexity variation
downsample_fidelity — one checkpoint under morphology downsample 1 and 2
pretopk_equivalence — NMS candidate-pool size vs the detections it keeps
backend_agreement   — the metric surrogates against the exact cv2 metrics
roofline            — the serving program's per-stage times and bounds
profile_morphology  — the morphology operators one by one, with kernel counts
perf_sweep_diag     — the forward's stages over a batch sweep
train_breakdown     — the train step's stages and its bound

Each `main` runs on CUDA and raises without it; each `run` takes `device=`
(the tests pass "cpu").
"""
