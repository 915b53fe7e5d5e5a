"""A new cell, with a configuration, a traffic mix, a per-layer metric and
limits of its own, runs from files and entries added to a copy of the
benchmark, with no existing file edited."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent

METRIC = '''"""Calls a second in the window."""


def read(ctx):
    return ctx["images_per_s"] / (ctx["images"] / ctx["calls"])
'''


def _digests(root: Path):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_from_new_files_only(tmp_path):
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "perfbench")
    pb = tmp_path / "perfbench"

    cfg = json.loads((pb / "configs" / "yolov8n-mcaq.json").read_text())
    cfg.update(name="yolov8n-tiny", img_size=64)
    (pb / "configs" / "yolov8n-tiny.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "serve_batch_tiny.json").write_text(json.dumps(
        {"driver": "serve_batch", "batch": 2, "pool_batches": 2, "traced_calls": 1}))
    (pb / "metrics" / "calls_per_s.serve.py").write_text(METRIC)
    limits = json.loads((pb / "limits" / "n-serve-bs256.json").read_text())
    (pb / "limits" / "n-serve-tiny.json").write_text(json.dumps(
        {k: 1e9 for k in limits if not k.startswith("_")}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "yolov8n-tiny", "source": "https://example.org/tiny",
                             "file": "perfbench/configs/yolov8n-tiny.json",
                             "reduced": ["img_size"], "why": "test"})
    bench["workloads"].append({"name": "n-serve-tiny", "config": "yolov8n-tiny",
                               "traffic": "serve_batch_tiny", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_images_per_s":
            m["workloads"].append("n-serve-tiny")
    bench["per_layer"].append({"name": "calls_per_s.serve", "unit": "calls/s", "better": "higher",
                               "source": "host_clock", "layer": "the whole deployed program",
                               "moves": "serve_images_per_s", "workloads": ["n-serve-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json, torch; torch.set_num_threads(2); from perfbench import run; "
            "print(json.dumps(run.run_cell('n-serve-tiny', 5, 0.3, True, device='cpu', "
            "log=lambda o: None)))")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{tmp_path}:{REPO}"})
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] > 0
    assert res["metrics"]["calls_per_s.serve"]["unit"] == "calls/s"
    assert res["metrics"]["calls_per_s.serve"]["value"] > 0
    after = _digests(pb)
    assert {p: d for p, d in after.items() if p in before} == before
