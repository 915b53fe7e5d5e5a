"""The profiling layer (`utils/profiling.py`) and its scripts
(`scripts/{roofline,profile_morphology,perf_sweep_diag,train_breakdown,
backend_agreement}.py`) on the CPU, against the JAX reference where it
computes the same thing.

  * `KernelFloorMode` on one layer equals the hand count exactly (forward,
    and backward as two convolutions); on the yolov8n MCAQ forward at 64
    px, float32, its convolution and matmul bytes equal JAX's
    `kernel_floor_bytes(...)["kernel_bytes"]` within 1% (the port counts
    the convolution and dense biases, which flax adds outside the
    convolution: ~3 KB of ~15.5 MB), and its input/output bytes within 1%.
  * `component_breakdown`, `roofline`, `profile_morphology`,
    `perf_sweep_diag` and `train_breakdown` at bs 2, 64 px, iters 1: JAX's
    keys; `with_mcaq`'s features equal the forward's bitwise.  The times
    here are the CPU's and name it ("device": "cpu").
  * `backend_agreement.run(num_images=3, img_size=96)`: the per-metric and
    fused Pearson equal JAX's `run` within 1e-3 (both score the same
    images with the same cv2 code; the surrogates agree within 1e-5).
    The surrogate's means within 5e-4: uint8 images, the class of the
    Eq.(8) scores in ROADMAP C (XLA rounds x / 255 and the channel mean
    through FMAs, which moves LBP's neighbour ties on flat regions; 2.0e-5
    measured).  Spearman is not compared: at 3 small images many tiles hold exactly
    equal values (fractal 0.5 on edgeless tiles), whose ranks a last-ulp
    difference reorders.
  * `trace` without a directory writes under the temporary directory;
    `inference.deployed_program` keeps the Predictor's output contract.
  * every new script's `main` raises without CUDA.
"""

import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mcaq_yolo_tpu.models import MCAQYOLO as JaxMCAQYOLO
from mcaq_yolo_tpu.scripts import backend_agreement as jba
from mcaq_yolo_tpu.utils.profiling import kernel_floor_bytes
from mcaq_yolo_tpu_torch.inference import deployed_program
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.scripts import (backend_agreement, perf_sweep_diag,
                                         profile_morphology, roofline, train_breakdown)
from mcaq_yolo_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: many small CPU ops under the gate's
    six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return MCAQYOLO(variant="yolov8n", num_classes=80, device="cpu")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))


def test_kernel_floor_hand_count_one_conv():
    x = torch.randn(2, 3, 8, 8)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    b = torch.randn(4)
    macs = 2 * 4 * 8 * 8 * 3 * 3 * 3  # output elements x Cin x kh x kw
    io = 4 * (x.numel() + w.numel() + b.numel() + 2 * 4 * 8 * 8)
    for grad in (False, True):  # conv2d whole, or decomposed to convolution
        with torch.set_grad_enabled(grad), profiling.KernelFloorMode() as m:
            y = F.conv2d(x, w, b, padding=1)
        assert (m.flops, m.kernel_bytes) == (2 * macs, io)
    with profiling.KernelFloorMode() as m:
        y.sum().backward()  # only the weight gradient: x needs none
    assert m.ops["aten.convolution_backward"] == 1
    assert m.flops == 2 * macs
    assert m.kernel_bytes == 4 * (y.numel() + x.numel() + w.numel())


def test_kernel_floor_hand_count_matmul():
    a, w, b = torch.randn(5, 8), torch.randn(6, 8), torch.randn(6)
    for grad in (False, True):
        with torch.inference_mode(not grad), profiling.KernelFloorMode() as m:
            F.linear(a, w, b)
            a @ w.T
        assert m.flops == 2 * (2 * 5 * 8 * 6)
        assert m.kernel_bytes == 4 * ((40 + 48 + 6 + 30) + (40 + 48 + 30))


def test_kernel_floor_bytes_match_jax(model, images):
    x = images.numpy().astype(np.float32) / 255.0
    jm = JaxMCAQYOLO(variant="yolov8n", num_classes=80, bit_mapping="mlp")
    v = jax.jit(lambda k, a: jm.init(k, a, training=False))(jax.random.PRNGKey(0),
                                                             jnp.asarray(x[:1]))
    ref = kernel_floor_bytes(lambda v, a: jm.apply(v, a, temperature=1.0, training=False),
                             v, jnp.asarray(x))
    with torch.inference_mode():
        c = profiling.program_cost(profiling.breakdown_programs(model)["full"],
                                   torch.from_numpy(x),
                                   state=list(model.state_dict().values()))
    assert c["ops"]["aten.conv2d"] == 72  # 57 in the backbone and neck, 15 in the head
    assert abs(c["kernel_bytes"] / ref["kernel_bytes"] - 1) < 0.01
    assert abs(c["io_bytes"] / ref["io_bytes"] - 1) < 0.01
    assert c["flops"] > 0


def test_component_breakdown_keys_and_with_mcaq(model, images):
    bd = profiling.component_breakdown(model, images, iters=1, cost=True)
    stages = ("morphology", "bitmap_quantize", "neck_head")
    keys = {"full_ms", "backbone_ms"} | {f"{s}_ms" for s in stages}
    keys |= {f"{p}_{k}" for p in ("full", "backbone", "cum_complexity", "cum_mcaq") + stages
             for k in ("gflops", "gb", "gb_floor")}
    assert keys <= set(bd) and bd["device"] == "cpu"
    assert bd["full_gflops"] > bd["backbone_gflops"] > 0
    assert all(bd[f"{p}_gb"] is None for p in ("full", "morphology"))
    progs = profiling.breakdown_programs(model)
    with torch.inference_mode():
        _, aux = progs["full"](images)
        q = progs["with_mcaq"](images)
    assert len(q) == 3
    for a, b in zip(aux["quantized_features"], q):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_timed_and_trace(tmp_path):
    s = profiling.timed(lambda a: a * 2, torch.ones(4), iters=3, warmup=1, device="cpu")
    assert s > 0
    with profiling.trace(str(tmp_path / "t")) as d:
        torch.ones(8).sum()
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0 and d == str(tmp_path / "t")


def test_trace_default_dir_under_tmpdir(monkeypatch, tmp_path):
    """Without a directory, `trace` writes into a new one under the
    temporary directory (`TMPDIR`), never a fixed path."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with profiling.trace() as d:
        torch.ones(8).sum()
    assert Path(d).parent == tmp_path and (Path(d) / "trace.json").stat().st_size > 0


def test_deployed_program_contract(model, images):
    """`inference.deployed_program`, which `Predictor` serves and `roofline`
    times: detections padded to max_det, the mean bits, the P3 maps and
    the above-gate count per image."""
    with torch.inference_mode():
        boxes, scores, classes, valid, bits, cmap, bmap, gated = deployed_program(
            model, images, 80, max_det=300)
    assert boxes.shape == (2, 300, 4) and scores.shape == classes.shape == valid.shape
    assert cmap.shape == bmap.shape == (2, 2, 2) and gated.shape == (2,)  # 8 x 8 P3, tile 4
    assert 2.0 <= float(bits) <= 8.0


def test_roofline_keys():
    res = roofline.run(batch=2, img=64, iters=1, device="cpu")
    assert {"byte_model", "config", "stages", "full_ms", "e2e_ms", "e2e_img_per_s",
            "forward_img_per_s", "sum_stage_bound_ms", "e2e_pct_of_composite_bound"} <= set(res)
    assert [r["stage"] for r in res["stages"]] == list(roofline.STAGES)
    row_keys = {"stage", "ms", "gflops", "gb_floor", "gb_oplevel", "bound_ms", "bound_by",
                "pct_of_bound", "achieved_tflops", "floor_gbps_if_at_bound"}
    assert all(set(r) == row_keys and r["bound_ms"] >= 0 for r in res["stages"])
    assert res["config"]["peak_tflops"] == 989.0 and res["config"]["peak_gbps"] == 3350.0
    assert res["device"] == "cpu"


def test_profile_morphology_keys():
    res = profile_morphology.run(batch=2, hw=16, tile=4, iters=1, device="cpu")
    keys = ("pack_tiles", "gaussian_blur5", "sobel", "otsu", "canny_nms", "hysteresis_x8",
            "canny_full", "adaptive_binarize", "lbp_entropy", "fractal", "euler",
            "contour_incl_euler", "phi_full")
    assert all(res[k] >= 0 for k in keys)
    assert res["cuda_kernels"] == {k: None for k in keys}  # no card: not counted
    assert res["config"]["platform"] == "cpu"


def test_perf_sweep_diag_keys():
    res = perf_sweep_diag.run([2], img=64, iters=1, dtype="float32", device="cpu")
    entry = res["sweep"]["bs2"]
    assert {"ms", "us_per_image", "imgs_per_sec", "roofline"} <= set(entry)
    assert set(entry["roofline"]) <= {"backbone", "morphology", "bitmap_quantize",
                                      "neck_head", "full"}
    assert entry["roofline"]["full"]["gb"] is None
    assert set(res["attribution"]) == set(entry["us_per_image"])
    assert res["config"]["device"] == "cpu"


def test_train_breakdown_keys():
    res = train_breakdown.run("yolov8n", batch=2, img=64, iters=1, kd=True, device="cpu")
    assert {"config", "raw_ms", "stages_ms", "stages_pct", "imgs_per_sec", "step_gflops",
            "step_gb_floor", "step_bound_ms", "bound_by", "pct_of_bound", "achieved_tflops",
            "mfu_pct_bf16_peak"} <= set(res)
    assert list(res["stages_ms"]) == ["backbone_fwd", "morphology", "quantize_neck_head_fwd",
                                      "tal_loss", "backward", "optimizer_projection",
                                      "teacher_fwd_kd_increment"]
    # the backward counted: 72 convolutions, each two convolutions' work
    assert res["step_ops"]["aten.convolution_backward"] == res["step_ops"]["aten.convolution"]
    assert res["step_gflops"] > 0 and res["config"]["device"] == "cpu"


@pytest.mark.parametrize("legacy,mode,corpus", [
    (False, "tiled", "synthetic"), (True, "tiled", "natural"), (False, "global", "synthetic"),
])
def test_backend_agreement_matches_jax(legacy, mode, corpus):
    kw = dict(num_images=3, img_size=96, legacy=legacy, metric_mode=mode, corpus=corpus)
    ref = jba.run(**kw)
    res = backend_agreement.run(device="cpu", **kw)
    for k in ("backend", "metric_mode", "corpus", "num_images"):
        assert res[k] == ref[k]
    for k in backend_agreement.METRICS:
        if np.isnan(ref[k]["pearson"]):
            assert np.isnan(res[k]["pearson"])
        else:
            assert abs(res[k]["pearson"] - ref[k]["pearson"]) < 1e-3, k
        assert abs(res[k]["mean_jax"] - ref[k]["mean_jax"]) < 5e-4
        assert res[k]["mean_cv2"] == ref[k]["mean_cv2"]
    assert abs(res["fused"]["pearson"] - ref["fused"]["pearson"]) < 1e-3


@pytest.mark.parametrize("script,argv", [
    (backend_agreement, []), (profile_morphology, []), (roofline, []),
    (perf_sweep_diag, ["--out", "never-written.json"]), (train_breakdown, []),
])
def test_main_raises_without_cuda(script, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(argv)
