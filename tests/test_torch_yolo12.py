"""The port's YOLO12 (`models/layers.py` AreaSDPA, AAttn, ABlock, A2C2f;
`models/yolo.py` family table, YOLO12Backbone, YOLO12Neck) on the CPU
against the plain float32 reference `perfbench/reference/yolo12.py`:

  * the network's raw maps on one seeded state dict (BatchNorm statistics
    and the layer scales drawn too), scales n at 64 px and l at 96 px (P4:
    6 x 6 tokens in 4 areas of 9, runs that end mid-row), batch 2, within
    1e-5 relative L2 (float32 rounding of channels-last convolutions
    against NCHW ones);
  * the area attention against a loop over row strips and heads that reads
    q, k and v out of `qkv`'s per-head channel blocks; a column-strip split
    does not match it; an area that does not divide the tokens raises;
  * `MCAQYOLO('yolo12n')`'s quantized forward against the reference's MCAQ
    model with spread weights: bit maps equal, raw maps within 1e-5;
  * `Predictor` on a checkpoint of it: detections equal the reference's
    decode + NMS of the program's raw maps; yolo12l's layer scales
    round-trip through `utils/checkpoint` and `weights_io`;
  * the structure at 640 px on the meta device: parameters equal to
    yolo12.yaml's summaries less the DFL's 16 fixed weights (the port holds
    the DFL as no parameter), convolution GFLOPs within 0.05 of Ultralytics'
    figures and equal to the reference's count, and at l the modules the
    `bn_silu` counter reads (141, 16 of them 307 wide), and `chip_smoke.py`
    holds the kernel to its plain version at each of those maps of the
    cell's bs-256 forward and reads the launches of a served YOLO12-L call;
  * `Trainer` builds YOLO12 by name, the KD teacher round-trips, and one
    train step of yolo12l reaches the attention and the layer scale;
  * under a profiler capture one forward records the counter
    `area_attention` and the spans 'a2.attention' (16 at l, 8 at n) inside
    'model.a2c2f' (2, inside 'model.backbone', with `tokens` and `area`);
    YOLOv8, YOLO11 and RT-DETR forwards none.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from mcaq_yolo_tpu_torch.inference import Predictor
from mcaq_yolo_tpu_torch.models.layers import A2C2f, AAttn, ConvBnSiLU
from mcaq_yolo_tpu_torch.models.losses import MCAQYOLOLoss
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.weights_io import load_jax_variables, to_jax_variables
from mcaq_yolo_tpu_torch.models.yolo import YOLOv8, build_network, variant_channels
from mcaq_yolo_tpu_torch.train import (Optimizer, Trainer, export_teacher_from_ckpt,
                                       load_teacher, make_train_step)
from mcaq_yolo_tpu_torch.utils import profiling
from mcaq_yolo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from perfbench import gen, weights
from perfbench.drivers import common
from perfbench.reference import yolo12 as ry

CPU = torch.device("cpu")
NETWORK = ("backbone", "neck", "head")
SERVE = {"temperature": 1.0, "conf": 0.25, "iou": 0.45, "max_det": 300, "pool": 256}
# Ultralytics' yolo12.yaml summaries at 640 px: parameters (the DFL's 16
# included) and GFLOPs of the convolutions (published 6.5 / 21.4 / 67.5 /
# 88.9 / 199.0, here to the second decimal from the equations)
PUBLISHED = {"yolo12n": (2_602_288, 6.49), "yolo12s": (9_284_096, 21.37),
             "yolo12m": (20_199_168, 67.45), "yolo12l": (26_450_784, 88.88),
             "yolo12x": (59_210_784, 199.02)}
DFL_WEIGHTS = 16


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
    of the network and the layer scales drawn too (the seed's are 0, 1 and
    0.01)."""
    ref = ry.init_(weights.build(ry.MCAQYOLO, CPU, variant, 80, 8, ds), seed, 80).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in ref.named_buffers():
            if name.split(".")[0] in NETWORK and name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
            elif name.split(".")[0] in NETWORK and name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
        for name, p in ref.named_parameters():
            if name.endswith("gamma"):
                p.copy_(0.5 * torch.rand(p.shape, generator=g))
    return ref


def _network_state(ref):
    return {k: v for k, v in ref.state_dict().items() if k.split(".")[0] in NETWORK}


def _port(ref, variant, ds=2):
    port = MCAQYOLO(variant, 80, bit_mapping="mlp", monotone_param="softplus",
                    morph_downsample=ds, device="cpu")
    port.load_state_dict(ref.state_dict(), strict=True)
    return port


@pytest.mark.parametrize("variant,img", [("yolo12n", 64), ("yolo12l", 96)])
def test_network_matches_the_reference(variant, img):
    ref = _reference(variant)
    net = YOLOv8(variant, 80, device="cpu")
    net.load_state_dict(_network_state(ref), strict=True)
    plain = ry.YOLO12(variant, 80).eval()
    plain.load_state_dict(_network_state(ref), strict=True)
    x = gen.letterboxed_batches(5, 1, 2, img, CPU)[0]
    with torch.no_grad():
        got, want = net(x), plain(x)
    assert [tuple(m.shape) for m in got] == [(2, img // s, img // s, 144) for s in (8, 16, 32)]
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-5


def _area_attention(c=64, heads=2, area=4):
    torch.manual_seed(0)
    att = AAttn(c, heads, area).eval()
    for m in att.modules():
        if isinstance(m, ConvBnSiLU):
            bn = m.BatchNorm_0
            with torch.no_grad():
                nn.init.normal_(m.Conv_0.weight, 0, 0.2)
                bn.weight.uniform_(0.5, 1.5), bn.bias.normal_(0, 0.1)
                bn.running_mean.normal_(0, 0.1), bn.running_var.uniform_(0.5, 1.5)
    return att


def _loop(att, x, strips):
    """The attention as a loop over areas and heads; `strips` 'rows' cuts
    the map into runs of whole rows (the row-major areas), 'columns' into
    runs of whole columns."""
    B, C, H, W = x.shape
    a, d = att.area, att.head_dim
    qkv = att.qkv(x).contiguous()                          # (B, 3C, H, W)
    y = torch.zeros(B, C, H, W)
    for j in range(a):
        if strips == "rows":
            part = (slice(None), slice(None), slice(j * H // a, (j + 1) * H // a), slice(None))
        else:
            part = (slice(None), slice(None), slice(None), slice(j * W // a, (j + 1) * W // a))
        for h in range(att.heads):
            block = qkv[:, h * 3 * d:(h + 1) * 3 * d][part]    # (B, 3d, h', w')
            shape = block.shape
            block = block.flatten(2)
            q, k, v = block[:, :d], block[:, d:2 * d], block[:, 2 * d:]
            p = torch.softmax(q.transpose(1, 2) @ k / math.sqrt(d), dim=-1)
            y[(slice(None), slice(h * d, (h + 1) * d)) + part[2:]] = \
                (v @ p.transpose(1, 2)).reshape(B, d, *shape[2:])
    v = torch.cat([qkv[:, h * 3 * d + 2 * d:(h + 1) * 3 * d] for h in range(att.heads)], 1)
    bn = att.pe.BatchNorm_0
    pe = F.batch_norm(F.conv2d(v, att.pe.Conv_0.weight, None, 1, 3, 1, C), bn.running_mean,
                      bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
    return att.proj(y + pe)


def test_area_attention_matches_a_loop_over_row_strips_and_heads():
    att = _area_attention()
    x = torch.randn(2, 64, 8, 8).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = att(x)
        rows, columns = _loop(att, x, "rows"), _loop(att, x, "columns")
    assert (att.heads, att.head_dim, att.area) == (2, 32, 4)
    assert att.pe.Conv_0.kernel_size == (7, 7) and att.pe.Conv_0.groups == 64
    # float32: the fused products against the loop's, to rounding
    assert _rel(got, rows) < 1e-6
    # the areas are runs of the row-major tokens, not column strips
    assert _rel(got, columns) > 1e-2


def test_an_area_that_does_not_divide_the_tokens_raises():
    att = _area_attention(area=3)
    with pytest.raises(ValueError, match="does not divide"):
        with torch.no_grad():
            att(torch.randn(1, 64, 8, 8))


@pytest.fixture(scope="module")
def spread_n():
    """yolo12n's reference MCAQ model spread on 64-px frames (bits 2-8,
    detections above the gate), its frames and the port loaded from it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = _reference("yolo12n", seed=5)
        x = gen.letterboxed_batches(6, 1, 4, 64, CPU)[0]
        with torch.no_grad():
            weights.spread_(ref, x)
        return ref, x, _port(ref, "yolo12n")
    finally:
        torch.set_num_threads(n)


def test_mcaq_yolo12n_matches_the_reference(spread_n):
    ref, x, port = spread_n
    with torch.no_grad():
        raw, aux = port(x)
        want_raw, want = ref(x)
    assert aux["feature_layers"] == [4, 6, 8]
    bits = torch.cat([b.reshape(-1) for b in aux["bit_map"]])
    assert len(torch.unique(bits)) > 1  # the spread mapper gives more than one width
    for a, b in zip(aux["bit_map"], want["bit_map"]):
        assert torch.equal(a, b)
    for a, b in zip(aux["complexity_map"], want["complexity"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(raw, want_raw):
        assert _rel(a, b) < 1e-5


def test_predictor_serves_a_yolo12_checkpoint(spread_n, tmp_path):
    """A checkpoint of the spread yolo12n round-trips, the Predictor builds
    YOLO12 from its meta, and its detections are the reference's decode +
    NMS of the program's raw maps."""
    ref, x, port = spread_n
    path = tmp_path / "y12.ckpt"
    save_checkpoint(path, to_jax_variables(port), {
        "variant": "yolo12n", "num_classes": 80, "img_size": 64,
        "config": {"quantization": {"monotone_param": "softplus"},
                   "morphology": {"downsample": 2}}})
    pred = Predictor(str(path), conf_threshold=0.25, iou_threshold=0.45, max_det=300,
                     pre_topk=256, warmup=False, device="cpu")
    assert pred.model.variant == "yolo12n" and hasattr(pred.model.backbone, "A2C2f_1")
    for k, v in port.state_dict().items():
        assert torch.equal(v, pred.model.state_dict()[k]), k
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


def test_layer_scales_round_trip_through_the_checkpoint(tmp_path):
    """yolo12l's two layer scales (the network's only bare parameters) are
    leaves of the flax tree at `<A2C2f>/gamma`, and a checkpoint written and
    read back restores them bitwise into a fresh model."""
    net = YOLOv8("yolo12l", 80, device="cpu")
    g = torch.Generator().manual_seed(7)
    gammas = {n: p for n, p in net.named_parameters() if n.endswith("gamma")}
    assert sorted(gammas) == ["backbone.A2C2f_0.gamma", "backbone.A2C2f_1.gamma"]
    with torch.no_grad():
        for p in gammas.values():
            assert torch.equal(p, torch.full_like(p, 0.01))
            p.copy_(torch.rand(p.shape, generator=g))
    tree = to_jax_variables(net)
    assert tree["params"]["backbone"]["A2C2f_0"]["gamma"].shape == (512,)
    path = tmp_path / "net.ckpt"
    save_checkpoint(path, tree, {"variant": "yolo12l"})
    fresh = load_jax_variables(YOLOv8("yolo12l", 80, device="cpu"), load_checkpoint(path))
    restored = dict(fresh.named_parameters())
    for n, p in gammas.items():
        assert torch.equal(restored[n], p)


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
    params, gflops = PUBLISHED[variant]
    assert sum(p.numel() for p in body.parameters()) == params - DFL_WEIGHTS
    assert abs(flops[0] / 1e9 - gflops) < 0.05
    assert flops[0] == ry.network_flops(variant, 80, 640)[0]
    acts = [m for m in body.modules() if isinstance(m, ConvBnSiLU) and m.act is True]
    attns = [m for m in body.modules() if isinstance(m, AAttn)]
    assert len(attns) == (16 if variant[-1] in "lx" else 8)
    if variant == "yolo12l":  # the bn_silu launches a call of cell l12-serve-bs256
        assert len(acts) == 141 and variant_channels(variant) == (512, 512, 512)
        assert sum(m.Conv_0.out_channels == 307 for m in acts) == 16
        assert sum(isinstance(m, ConvBnSiLU) and m.act is False for m in body.modules()) == 64
        # 6.55 GFLOPs of area-attention products an image at 640 px
        assert ry.network_flops(variant, 80, 640)[1] == 6_553_600_000


def test_chip_smoke_checks_the_l12_forward_and_its_served_call():
    """chip_smoke.py's phase 2c covers cell l12-serve-bs256's forward (bs 256,
    bfloat16): its 141 SiLU ConvBn maps, 16 of them 307 channels wide; its
    phase 3 serves a YOLO12-L checkpoint and expects 141 bn_silu launches
    and 16 area attentions in the call."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    assert ("yolo12l", "bfloat16", 256) in chip_smoke.BN_SILU_FORWARDS
    shapes = chip_smoke.conv_bn_silu_shapes("yolo12l", 256, 640)
    assert len(shapes) == 141 and all(s[0] == 256 for s in shapes)
    assert sorted({s[2] for s in shapes if s[1] == 307}) == [20, 40]
    assert sum(s[1] == 307 for s in shapes) == 16
    assert chip_smoke.FAMILY_CALLS["yolo12l"][1:] == (141, 16)


def _batch(nc=4, B=2, img=64, seed=1):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, img - 24, (B, 3, 2))
    return {"image": torch.from_numpy(rng.integers(0, 256, (B, img, img, 3), dtype=np.uint8)),
            "gt_boxes": torch.from_numpy(np.concatenate([xy, xy + 20], -1).astype(np.float32)),
            "gt_classes": torch.from_numpy(rng.integers(0, nc, (B, 3)).astype(np.int32)),
            "gt_mask": torch.ones(B, 3, dtype=torch.bool)}


def test_trainer_builds_yolo12_and_its_teacher_round_trips(tmp_path):
    cfg = {"epochs": 1, "batch_size": 2, "seed": 0, "output_dir": str(tmp_path / "n"),
           "model": {"name": "yolo12n", "num_classes": 4}, "data": {"img_size": 64},
           "distillation": {"enabled": False}, "training": {"amp": False}}
    tr = Trainer(cfg, [_batch()], [], device="cpu")
    assert tr.variant == "yolo12n" and hasattr(tr.model.backbone, "A2C2f_0")
    assert tr.model.quantizer_p5.running_min.shape[0] == 256
    path = tmp_path / "s.ckpt"
    save_checkpoint(path, to_jax_variables(tr.model), {"variant": "yolo12n"})
    export_teacher_from_ckpt(str(path), str(tmp_path / "t.msgpack"), "yolo12n", 4)
    teacher = load_teacher(str(tmp_path / "t.msgpack"), "yolo12n", 4, "cpu")
    sd = tr.model.state_dict()
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, sd[k])


def test_train_step_reaches_the_attention_and_the_layer_scale():
    student = MCAQYOLO("yolo12l", 4, device="cpu", seed=0)
    step = make_train_step(student, MCAQYOLOLoss(4, 4.0))
    opt = Optimizer(student, lambda s: 1e-3)
    m = step(opt, _batch(), 1.0, 4.0, 0.01, 0.1, 0.0, 1e-4, quantize=True)
    assert math.isfinite(float(m["loss_total"]))
    for i in (0, 1):
        a2 = getattr(student.backbone, f"A2C2f_{i}")
        qkv = a2.ABlock_7.AAttn_0.qkv.Conv_0.weight
        assert qkv.grad is not None and float(qkv.grad.abs().sum()) > 0
        assert a2.gamma.grad is not None and float(a2.gamma.grad.abs().sum()) > 0


@pytest.mark.parametrize("variant,n_attn", [("yolo12l", 16), ("yolo12n", 8), ("yolov8n", 0),
                                            ("yolo11n", 0), ("rtdetr-l", 0)])
def test_area_attention_spans_and_counter(variant, n_attn, tmp_path):
    model = MCAQYOLO(variant, 80, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3),
                                                           dtype=np.uint8))
    before = profiling.counters().get("area_attention", 0)
    with profiling.trace(str(tmp_path)):
        with torch.inference_mode():
            model(x)
    assert profiling.counters().get("area_attention", 0) - before == n_attn
    recs = profiling.span_records()
    names = [r["name"] for r in recs]
    assert names.count("model.a2c2f") == (2 if n_attn else 0)
    assert names.count("a2.attention") == n_attn
    by_index = {r["index"]: r for r in recs}
    blocks = [r for r in recs if r["name"] == "model.a2c2f"]
    for r, (tokens, area) in zip(blocks, [(16, 4), (4, 1)]):  # 64 px: P4 4 x 4, P5 2 x 2
        assert by_index[r["parent"]]["name"] == "model.backbone"
        assert r["attrs"] == {"tokens": tokens, "area": area}
        assert r["counts"] == {}
    for r in recs:
        if r["name"] == "a2.attention":
            assert r["counts"] == {"area_attention": 1}
            assert by_index[r["parent"]]["name"] == "model.a2c2f"


def test_a2c2f_without_attention_has_no_layer_scale_and_no_span():
    """The neck's A2C2f (a2 off) is cv1, C3k stages and cv2: no gamma, no
    span; a width whose half is not a multiple of 32 is refused."""
    block = A2C2f(96, 64, 2, a2=False, residual=True)
    assert block.gamma is None and [n for n, _ in block.named_children()] == [
        "ConvBnSiLU_0", "C3k_0", "C3k_1", "ConvBnSiLU_1"]
    with pytest.raises(ValueError, match="multiple of 32"):
        A2C2f(96, 96, 1)
