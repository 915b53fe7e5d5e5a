"""The port's serving export (`mcaq_yolo_tpu_torch/export.py`) on the CPU:
MCAQ-YOLOv8n (nc 4, 96 px, batch 2, float32, morph downsample 2) with
seeded weights made informative as in `test_torch_trainer_loop._spread`
(bits spread over several widths, a few detections above conf 0.25).

Contracts:
  * the exported program (forward + decode + NMS) holds exactly three
    `mcaq::spatial_quantize` nodes, one per scale, and no `while` loop
    left in Python: the NMS sweep is one loop node;
  * saved (`mcaq_yolo.pt2` + graph text), loaded in this process and in a
    fresh one, it is BITWISE equal to the eager `make_inference_fn`
    (boxes, scores, classes, valid, avg_bits) and to the eager NMS keep
    masks (the loop formulation did not change a keep bit); it holds no
    profiler op (the program's spans do nothing under torch.export);
  * against the JAX package's `export_inference(...).call` on the same
    weights and images, with `tests/test_torch_slice.py`'s tolerances:
    valid-detection count within +-1 per image, matched boxes within
    0.5 px with the same class, avg_bits within 1e-6 relative.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcaq_yolo_tpu.export import export_inference as jax_export_inference
from mcaq_yolo_tpu.models import MCAQYOLO as JaxMCAQYOLO
from mcaq_yolo_tpu_torch.export import (
    count_quant_nodes,
    make_inference_fn,
    save_exported,
)
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.weights_io import to_jax_variables
from test_torch_slice import _match
from test_torch_trainer_loop import _spread

IMG, NC, B = 96, 4, 2
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    rng = np.random.default_rng(0)
    uint8 = rng.integers(0, 256, (4, IMG, IMG, 3), dtype=np.uint8)
    model = MCAQYOLO(num_classes=NC, morph_downsample=2, device="cpu", seed=3)
    _spread(model, uint8)
    images = torch.from_numpy(uint8[:B].astype(np.float32) / 255.0)
    with torch.no_grad():
        eager = make_inference_fn(model)(images)
    out = tmp_path_factory.mktemp("export")
    paths = save_exported(model, out, batch_size=B, img_size=IMG)
    loaded = torch.export.load(paths["serialized"])  # once: a load takes ~10 s on a CPU
    return {"model": model, "images": images, "eager": eager, "paths": paths,
            "loaded": loaded}


def test_graph_holds_three_quant_nodes(exported):
    ep = exported["loaded"]
    assert count_quant_nodes(ep) == 3
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert sum("while_loop" in t for t in targets) == 1
    assert [tuple(n.meta["val"].shape) for n in ep.graph.nodes
            if n.op == "placeholder" and n.name == "images"] == [(B, IMG, IMG, 3)]
    text = Path(exported["paths"]["graph"]).read_text()
    assert text.count("mcaq.spatial_quantize") == 3
    with torch.no_grad():  # without NMS: three raw maps and avg_bits
        raw = make_inference_fn(exported["model"], with_nms=False)(exported["images"])
    assert len(raw) == 4 and raw[0].shape == (B, IMG // 8, IMG // 8, 64 + NC)


def test_graph_holds_no_profiler_op(exported):
    """The program's spans (`utils/profiling.py`) leave no node behind."""
    targets = [str(n.target) for n in exported["loaded"].graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


def test_loaded_program_bitwise_equals_eager(exported):
    """In this process (`load_exported` is `torch.export.load(path).module()`;
    the fresh-process test below calls it by name)."""
    program = exported["loaded"].module()
    with torch.no_grad():
        out = program(exported["images"])
    eager = exported["eager"]
    assert len(out) == 5 and int(eager[3].sum()) > 0
    for a, b in zip(out, eager):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_fresh_process_loads_the_artifact(exported, tmp_path):
    np.save(tmp_path / "x.npy", exported["images"].numpy())
    code = ("import sys, numpy as np, torch\n"
            "from mcaq_yolo_tpu_torch.export import load_exported\n"
            "p = load_exported(sys.argv[1])\n"
            "with torch.no_grad():\n"
            "    out = p(torch.from_numpy(np.load(sys.argv[2])))\n"
            "np.savez(sys.argv[3], *[o.numpy() for o in out])\n")
    r = subprocess.run([sys.executable, "-c", code, exported["paths"]["serialized"],
                        str(tmp_path / "x.npy"), str(tmp_path / "out.npz")], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got = np.load(tmp_path / "out.npz")
    for i, e in enumerate(exported["eager"]):
        np.testing.assert_array_equal(got[f"arr_{i}"], e.numpy())


def test_keep_masks_bitwise_equal_the_python_loop():
    """The `while_loop` keep that export traces (called eagerly here) and
    the eager `greedy_keep` against the Python fixed-point loop, on random
    overlapping candidates with and without dead ones."""
    from mcaq_yolo_tpu_torch.ops.nms import greedy_keep, iou_matrix, keep_fixed_point_traced

    rng = np.random.default_rng(4)
    for k in (8, 64, 256):
        xy = rng.uniform(0, 100, (3, k, 2))
        wh = rng.uniform(5, 40, (3, k, 2))
        boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))
        alive = torch.from_numpy(rng.uniform(size=(3, k)) > 0.2)
        idx = torch.arange(k)
        suppress = (iou_matrix(boxes) > 0.45) & (idx[:, None] < idx[None, :])
        keep = alive
        for _ in range(k):
            new = alive & ~(suppress & keep[..., :, None]).any(dim=-2)
            if torch.equal(new, keep):
                break
            keep = new
        assert torch.equal(greedy_keep(boxes, alive, 0.45), keep)
        assert torch.equal(keep_fixed_point_traced(suppress, alive), keep)


def test_matches_the_jax_export(exported):
    model, images = exported["model"], exported["images"]
    jm = JaxMCAQYOLO(variant="yolov8n", num_classes=NC, morph_downsample=2)
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(model))
    ref = [np.asarray(a) for a in jax_export_inference(
        jm, variables, batch_size=B, img_size=IMG).call(jnp.asarray(images.numpy()))]
    out = [a.numpy() for a in exported["eager"]]
    assert float(out[4]) == pytest.approx(float(ref[4]), rel=1e-6)
    for b in range(B):
        v, rv = out[3][b], ref[3][b]
        assert rv.sum() > 0 and abs(int(v.sum()) - int(rv.sum())) <= 1
        dets = list(zip(out[0][b][v], out[2][b][v]))
        ref_dets = list(zip(ref[0][b][rv], ref[2][b][rv]))
        assert _match(dets, ref_dets) <= 1
