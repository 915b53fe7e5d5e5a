"""The port's YOLO11 (`models/layers.py` C3k, C3k2, Attention, PSABlock,
C2PSA and the depthwise class branch; `models/yolo.py` family table) on the
CPU against the plain float32 reference `perfbench/reference/yolo11.py`:

  * the network's raw maps on one seeded state dict (BatchNorm statistics
    drawn too), scales n and l at 64-96 px, batch 2, within 1e-5 relative
    L2 (float32 rounding of channels-last convolutions against NCHW ones);
  * the attention against a loop over heads that reads q, k and v out of
    `qkv`'s per-head channel blocks;
  * `MCAQYOLO('yolo11n')`'s quantized forward against the reference's MCAQ
    model with spread weights: bit maps equal, raw maps within 1e-5;
  * `Predictor` on a checkpoint of it: detections equal the reference's
    decode + NMS of the program's raw maps;
  * the structure at 640 px on the meta device: convolution GFLOPs of
    every scale within 0.05 of Ultralytics' published figures, parameters,
    and the modules the `bn_silu` counter reads;
  * `Trainer` builds YOLO11 by name and refuses an unknown one, the KD
    teacher round-trips through `export_teacher_from_ckpt` /
    `load_teacher`, and one train step reaches C2PSA's `qkv`;
  * under a profiler capture one forward records 1 'model.psa',
    n_PSA 'psa.attention' and the counter `psa_attention` = n_PSA; a
    YOLOv8 forward none.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from mcaq_yolo_tpu_torch.inference import Predictor
from mcaq_yolo_tpu_torch.models.layers import Attention, ConvBnSiLU
from mcaq_yolo_tpu_torch.models.losses import MCAQYOLOLoss
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.weights_io import to_jax_variables
from mcaq_yolo_tpu_torch.models.yolo import YOLOv8, build_network, variant_channels
from mcaq_yolo_tpu_torch.train import (Optimizer, Trainer, export_teacher_from_ckpt,
                                       load_teacher, make_train_step)
from mcaq_yolo_tpu_torch.utils import profiling
from mcaq_yolo_tpu_torch.utils.checkpoint import save_checkpoint
from perfbench import gen, weights
from perfbench.drivers import common
from perfbench.reference import yolo11 as ry

CPU = torch.device("cpu")
NETWORK = ("backbone", "neck", "head")
SERVE = {"temperature": 1.0, "conf": 0.25, "iou": 0.45, "max_det": 300, "pool": 256}
# Ultralytics' yolo11.yaml summaries at 640 px: GFLOPs and millions of parameters
PUBLISHED = {"yolo11n": (6.5, 2.6), "yolo11s": (21.5, 9.4), "yolo11m": (68.0, 20.1),
             "yolo11l": (86.9, 25.3), "yolo11x": (194.9, 56.9)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _reference(variant, seed=3, ds=2):
    """The reference's MCAQ model from the seed, with BatchNorm statistics
    of the network drawn too (the seed's are 0 and 1)."""
    ref = weights.init_(weights.build(ry.MCAQYOLO, CPU, variant, 80, 8, ds), seed, 80).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in ref.named_buffers():
            if name.split(".")[0] in NETWORK and name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
            elif name.split(".")[0] in NETWORK and name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
    return ref


def _network_state(ref):
    return {k: v for k, v in ref.state_dict().items() if k.split(".")[0] in NETWORK}


def _port(ref, variant, ds=2):
    port = MCAQYOLO(variant, 80, bit_mapping="mlp", monotone_param="softplus",
                    morph_downsample=ds, device="cpu")
    port.load_state_dict(ref.state_dict(), strict=True)
    return port


@pytest.mark.parametrize("variant,img", [("yolo11n", 64), ("yolo11l", 96)])
def test_network_matches_the_reference(variant, img):
    ref = _reference(variant)
    net = YOLOv8(variant, 80, device="cpu")
    net.load_state_dict(_network_state(ref), strict=True)
    plain = ry.YOLO11(variant, 80).eval()
    plain.load_state_dict(_network_state(ref), strict=True)
    x = gen.letterboxed_batches(5, 1, 2, img, CPU)[0]
    with torch.no_grad():
        got, want = net(x), plain(x)
    assert [tuple(m.shape) for m in got] == [(2, img // s, img // s, 144) for s in (8, 16, 32)]
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-5


def test_attention_matches_a_loop_over_heads():
    torch.manual_seed(0)
    att = Attention(128, 2).eval()
    for m in att.modules():
        if isinstance(m, ConvBnSiLU):
            bn = m.BatchNorm_0
            with torch.no_grad():
                nn.init.normal_(m.Conv_0.weight, 0, 0.2)
                bn.weight.uniform_(0.5, 1.5), bn.bias.normal_(0, 0.1)
                bn.running_mean.normal_(0, 0.1), bn.running_var.uniform_(0.5, 1.5)
    x = torch.randn(2, 128, 5, 6).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = att(x)
        qkv = att.qkv(x).contiguous()                     # (B, 2 * 64 + 128, H, W)
        per = 2 * att.key_dim + att.head_dim
        assert (att.heads, att.head_dim, att.key_dim) == (2, 64, 32) and qkv.shape[1] == 2 * per
        outs, vs = [], []
        for h in range(att.heads):
            block = qkv[:, h * per:(h + 1) * per].flatten(2)   # (B, per, N)
            q, k, v = block[:, :32], block[:, 32:64], block[:, 64:]
            a = torch.softmax(q.transpose(1, 2) @ k / math.sqrt(32), dim=-1)  # (B, N, N)
            outs.append(v @ a.transpose(1, 2))
            vs.append(v)
        y = torch.cat(outs, 1).reshape(2, 128, 5, 6)
        v = torch.cat(vs, 1).reshape(2, 128, 5, 6)
        pe = F.batch_norm(F.conv2d(v, att.pe.Conv_0.weight, None, 1, 1, 1, 128),
                          att.pe.BatchNorm_0.running_mean, att.pe.BatchNorm_0.running_var,
                          att.pe.BatchNorm_0.weight, att.pe.BatchNorm_0.bias, False, 0.0,
                          att.pe.BatchNorm_0.eps)
        want = att.proj(y + pe)
    # float32: the fused products against the loop's, to rounding
    assert _rel(got, want) < 1e-6


@pytest.fixture(scope="module")
def spread_n():
    """yolo11n's reference MCAQ model spread on 64-px frames (bits 2-8,
    detections above the gate), its frames and the port loaded from it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = _reference("yolo11n", seed=5)
        x = gen.letterboxed_batches(6, 1, 4, 64, CPU)[0]
        with torch.no_grad():
            weights.spread_(ref, x)
        return ref, x, _port(ref, "yolo11n")
    finally:
        torch.set_num_threads(n)


def test_mcaq_yolo11n_matches_the_reference(spread_n):
    ref, x, port = spread_n
    with torch.no_grad():
        raw, aux = port(x)
        want_raw, want = ref(x)
    assert aux["feature_layers"] == [4, 6, 10]
    bits = torch.cat([b.reshape(-1) for b in aux["bit_map"]])
    assert len(torch.unique(bits)) > 1  # the spread mapper gives more than one width
    for a, b in zip(aux["bit_map"], want["bit_map"]):
        assert torch.equal(a, b)
    for a, b in zip(aux["complexity_map"], want["complexity"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(raw, want_raw):
        assert _rel(a, b) < 1e-5


def test_predictor_serves_a_yolo11_checkpoint(spread_n, tmp_path):
    """A checkpoint of the spread yolo11n round-trips, the Predictor builds
    YOLO11 from its meta, and its detections are the reference's decode +
    NMS of the program's raw maps."""
    ref, x, port = spread_n
    path = tmp_path / "y11.ckpt"
    save_checkpoint(path, to_jax_variables(port), {
        "variant": "yolo11n", "num_classes": 80, "img_size": 64,
        "config": {"quantization": {"monotone_param": "softplus"},
                   "morphology": {"downsample": 2}}})
    pred = Predictor(str(path), conf_threshold=0.25, iou_threshold=0.45, max_det=300,
                     pre_topk=256, warmup=False, device="cpu")
    assert pred.model.variant == "yolo11n" and hasattr(pred.model.backbone, "C2PSA_0")
    saved, restored = to_jax_variables(port), to_jax_variables(pred.model)
    for col in saved:
        for a, b in zip(_leaves(saved[col]), _leaves(restored[col])):
            assert a[0] == b[0] and np.array_equal(a[1], b[1])
    cap = common.Capture(pred.model)
    cap.on = True
    with torch.inference_mode():
        out = pred._predict_device(x)
    raw = cap.call(0)["raw"]
    dets = common.detections(raw, SERVE)
    n = 0
    for b, d in enumerate(dets):
        v = out[3][b]
        assert int(v.sum()) == len(d["boxes"])
        torch.testing.assert_close(out[0][b][v], d["boxes"], rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(out[1][b][v], d["scores"], rtol=1e-5, atol=1e-6)
        assert torch.equal(out[2][b][v].long(), d["classes"].long())
        n += len(d["boxes"])
    assert n > 0


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(tree[k])


@pytest.mark.parametrize("variant", sorted(PUBLISHED))
def test_structure_at_640_matches_the_published_model(variant):
    flops = [0]

    def hook(m, args, out):
        flops[0] += 2 * out.numel() * (m.in_channels // m.groups) * math.prod(m.kernel_size)

    with torch.device("meta"):
        body = nn.ModuleList(build_network(variant, 80))
        hs = [m.register_forward_hook(hook) for m in body.modules() if isinstance(m, nn.Conv2d)]
        body[2](body[1](*body[0](torch.empty(1, 3, 640, 640))))
    for h in hs:
        h.remove()
    gflops, mparams = PUBLISHED[variant]
    assert abs(flops[0] / 1e9 - gflops) < 0.05
    assert flops[0] == ry.network_flops(variant, 80, 640)[0]
    assert abs(sum(p.numel() for p in body.parameters()) / 1e6 - mparams) < 0.1
    acts = sum(isinstance(m, ConvBnSiLU) and m.act for m in body.modules())
    if variant == "yolo11l":  # the bn_silu launches a call of cell l11-serve-bs256
        assert acts == 159 and variant_channels(variant) == (512, 512, 512)
        assert sum(isinstance(m, nn.Conv2d) and m.groups > 1 for m in body.modules()) == 8


def _batch(nc=4, B=2, img=64, seed=1):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, img - 24, (B, 3, 2))
    return {"image": torch.from_numpy(rng.integers(0, 256, (B, img, img, 3), dtype=np.uint8)),
            "gt_boxes": torch.from_numpy(np.concatenate([xy, xy + 20], -1).astype(np.float32)),
            "gt_classes": torch.from_numpy(rng.integers(0, nc, (B, 3)).astype(np.int32)),
            "gt_mask": torch.ones(B, 3, dtype=torch.bool)}


def _config(name, out):
    return {"epochs": 1, "batch_size": 2, "seed": 0, "output_dir": str(out),
            "model": {"name": name, "num_classes": 4}, "data": {"img_size": 64},
            "distillation": {"enabled": False}, "training": {"amp": False}}


def test_trainer_builds_yolo11_and_refuses_unknown_names(tmp_path):
    tr = Trainer(_config("yolo11l", tmp_path / "l"), [_batch()], [], device="cpu")
    assert tr.variant == "yolo11l" and hasattr(tr.model.backbone, "C2PSA_0")
    assert tr.model.quantizer_p3.running_min.shape[0] == 512
    for name in ("yolo11", "yolov9c", "l", "yolo11q"):
        with pytest.raises(ValueError, match="unknown variant"):
            Trainer(_config(name, tmp_path / name), [_batch()], [], device="cpu")
        with pytest.raises(ValueError, match="unknown variant"):
            MCAQYOLO(name, device="cpu")


def test_train_step_reaches_the_attention_and_the_teacher_round_trips(tmp_path):
    student = MCAQYOLO("yolo11n", 4, device="cpu", seed=0)
    path = tmp_path / "s.ckpt"
    save_checkpoint(path, to_jax_variables(student), {"variant": "yolo11n"})
    export_teacher_from_ckpt(str(path), str(tmp_path / "t.msgpack"), "yolo11n", 4)
    teacher = load_teacher(str(tmp_path / "t.msgpack"), "yolo11n", 4, "cpu")
    sd = student.state_dict()
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, sd[k])
    step = make_train_step(student, MCAQYOLOLoss(4, 4.0), teacher)
    opt = Optimizer(student, lambda s: 1e-3)
    m = step(opt, _batch(), 1.0, 4.0, 0.01, 0.1, 0.5, 1e-4, quantize=True, use_kd=True)
    assert math.isfinite(float(m["loss_total"]))
    qkv = student.backbone.C2PSA_0.PSABlock_0.Attention_0.qkv.Conv_0.weight
    assert qkv.grad is not None and float(qkv.grad.abs().sum()) > 0


@pytest.mark.parametrize("variant,n_psa", [("yolo11n", 1), ("yolo11l", 2), ("yolov8n", 0)])
def test_psa_spans_and_counter(variant, n_psa, tmp_path):
    model = MCAQYOLO(variant, 80, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3),
                                                           dtype=np.uint8))
    before = profiling.counters().get("psa_attention", 0)
    with profiling.trace(str(tmp_path)):
        with torch.inference_mode():
            model(x)
    assert profiling.counters().get("psa_attention", 0) - before == n_psa
    recs = profiling.span_records()
    names = [r["name"] for r in recs]
    assert names.count("model.psa") == (1 if n_psa else 0)
    assert names.count("psa.attention") == n_psa
    by_index = {r["index"]: r for r in recs}
    for r in recs:
        if r["name"] == "model.psa":
            assert by_index[r["parent"]]["name"] == "model.backbone"
            assert r["attrs"] == {"tokens": 4}  # 64 px / 32, squared
            assert r["counts"] == {}
        if r["name"] == "psa.attention":
            assert r["counts"] == {"psa_attention": 1}
            assert by_index[r["parent"]]["name"] == "model.psa"
