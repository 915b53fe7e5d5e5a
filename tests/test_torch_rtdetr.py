"""The port's RT-DETR-L (`models/rtdetr.py`, the HGNetv2 blocks of
`models/layers.py`, the `rtdetr` family of `models/yolo.py`) on the CPU
against the plain float32 reference `perfbench/reference/rtdetr.py`, at the
published widths, 160 px (525 anchors, at least the 300 queries), batch 2,
one torch thread:

  * the network's decoder boxes and logits, the reference's selection
    given to both (a near-tie in the 300th place may order the two
    selections differently);
  * the deformable sampling against a loop over points of `grid_sample`'s
    bilinear rule (align_corners False, zero padding);
  * the query selection and the post-process on tied logits: ties to the
    lower index;
  * AIFI's position embedding against its formula, meshgrid order included;
  * `MCAQYOLO('rtdetr-l')`'s quantized forward with spread weights: bit
    maps equal the reference's;
  * `Predictor` on a checkpoint of it: detections equal the reference's
    post-process of the program's decoder output;
  * the structure at 640 px on the meta device: 32,949,996 parameters,
    109.54 GFLOPs, 12 SiLU ConvBns (the `bn_silu` launches of a call);
  * under a profiler capture one deployed call records 'model.aifi',
    'rtdetr.decoder', six 'rtdetr.deform', 'select_queries' and the counter
    `deform_attn` = 6; a YOLOv8 call none of them;
  * `Trainer`, the KD teacher and `export` refuse `rtdetr-l` by name.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn as nn

from mcaq_yolo_tpu_torch.export import make_inference_fn
from mcaq_yolo_tpu_torch.inference import Predictor, deployed_program
from mcaq_yolo_tpu_torch.models import rtdetr
from mcaq_yolo_tpu_torch.models.layers import ConvBnSiLU
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.weights_io import to_jax_variables
from mcaq_yolo_tpu_torch.models.yolo import build_network, variant_channels
from mcaq_yolo_tpu_torch.train import Trainer, export_teacher_from_ckpt, load_teacher
from mcaq_yolo_tpu_torch.utils import profiling
from mcaq_yolo_tpu_torch.utils.checkpoint import save_checkpoint
from perfbench import gen, weights
from perfbench.drivers.serve_batch_rtdetr import Capture
from perfbench.reference import network as rn
from perfbench.reference import rtdetr as rr

CPU = torch.device("cpu")
IMG = 160


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def spread():
    """The reference's MCAQ model from a seed, spread on two 160-px frames,
    the frames, and the port (float32) loaded from it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = rr.init_(weights.build(rr.MCAQYOLO, CPU, "rtdetr-l", 80, 8, 2), 7, 80).eval()
        x = gen.letterboxed_batches(8, 1, 2, IMG, CPU)[0]
        with torch.no_grad():
            rr.spread_(ref, x)
        port = MCAQYOLO("rtdetr-l", 80, bit_mapping="mlp", monotone_param="softplus",
                        morph_downsample=2, device="cpu")
        port.load_state_dict(ref.state_dict(), strict=True)
        return ref, x, port
    finally:
        torch.set_num_threads(n)


def test_mcaq_rtdetr_matches_the_reference_given_one_selection(spread):
    """Bit maps equal; the decoder's boxes and logits from the reference's
    own selection within 2e-4 relative L2: float32 rounding of channels-last
    convolutions against NCHW ones, grown through the 60-odd layers."""
    ref, x, port = spread
    with torch.no_grad():
        want = ref.forward_blocks(x, 1.0)
        h = port.head.selection.register_forward_hook(lambda m, a, o: want["selection"])
        try:
            raw, aux = port(x)
        finally:
            h.remove()
    assert aux["feature_layers"] == [3, 7, 9]
    assert [q.running_min.shape[0] for q in port.quantizers] == [512, 1024, 2048]
    bits = torch.cat([b.reshape(-1) for b in aux["bit_map"]])
    assert len(torch.unique(bits)) > 1  # the spread mapper gives more than one width
    for a, b in zip(aux["bit_map"], want["bits"]):
        assert torch.equal(a, b)
    assert [tuple(t.shape) for t in raw] == [(2, 300, 4), (2, 300, 80)]
    assert raw[0].dtype == raw[1].dtype == torch.float32
    assert _rel(raw[0], want["boxes"]) < 2e-4 and _rel(raw[1], want["logits"]) < 2e-4


def _bilinear_loop(value, shapes, loc, weights):
    """grid_sample's bilinear rule written per point: pixel coordinates
    loc * size - 0.5, the four neighbours, zero outside the map."""
    B, _, nh, dh = value.shape
    Q, nl, npt = loc.shape[1], loc.shape[3], loc.shape[4]
    out = torch.zeros(B, Q, nh, dh, dtype=torch.float64)
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    for b in range(B):
        for q in range(Q):
            for hd in range(nh):
                for lvl, (h, w) in enumerate(shapes):
                    vmap = value[b, starts[lvl]:starts[lvl + 1], hd].double().reshape(h, w, dh)
                    for p in range(npt):
                        x = float(loc[b, q, hd, lvl, p, 0]) * w - 0.5
                        y = float(loc[b, q, hd, lvl, p, 1]) * h - 0.5
                        x0, y0 = math.floor(x), math.floor(y)
                        acc = torch.zeros(dh, dtype=torch.float64)
                        for yy, wy in ((y0, y0 + 1 - y), (y0 + 1, y - y0)):
                            for xx, wx in ((x0, x0 + 1 - x), (x0 + 1, x - x0)):
                                if 0 <= yy < h and 0 <= xx < w:
                                    acc += wy * wx * vmap[yy, xx]
                        out[b, q, hd] += float(weights[b, q, hd, lvl, p]) * acc
    return out.reshape(B, Q, nh * dh)


def test_sampling_matches_a_loop_over_points():
    g = torch.Generator().manual_seed(0)
    shapes = [(4, 5), (2, 3), (1, 2)]
    B, nh, dh, Q, npt = 2, 2, 3, 3, 2
    L = sum(h * w for h, w in shapes)
    value = torch.randn(B, L, nh, dh, generator=g)
    loc = torch.rand(B, Q, nh, len(shapes), npt, 2, generator=g) * 1.3 - 0.15  # some outside
    w = torch.rand(B, Q, nh, len(shapes), npt, generator=g)
    got = rtdetr.DeformSample()(value, shapes, loc, w)
    want = _bilinear_loop(value, shapes, loc, w)
    assert got.dtype == torch.float32 and got.shape == (B, Q, nh * dh)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)
    # the network's bf16 value map: sampled through a float32 copy, returned in bf16
    got16 = rtdetr.DeformSample()(value.bfloat16(), shapes, loc, w)
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(got16.float(), _bilinear_loop(value.bfloat16().float(), shapes,
                                                             loc, w).float(),
                               rtol=1e-2, atol=1e-2)
    # the reference's sampler is the same rule
    torch.testing.assert_close(rr.DeformSample()(value, shapes, loc, w).double(), want,
                               rtol=1e-5, atol=1e-6)


def test_selection_and_post_process_break_ties_to_the_lower_index():
    logits = torch.tensor([[[0.0, 2.0], [2.0, 1.0], [1.0, 1.0], [2.0, 2.0], [-1.0, 0.5]],
                           [[3.0, 3.0], [3.0, 0.0], [0.5, 0.5], [0.5, 3.0], [3.0, 1.0]]])
    best = logits.amax(-1)
    want = [sorted(range(5), key=lambda i: (-float(best[b, i]), i))[:4] for b in range(2)]
    assert rtdetr.QuerySelect(4)(logits).tolist() == want
    assert rr.stable_top(best, 4).tolist() == want
    boxes = torch.rand(2, 5, 4, generator=torch.Generator().manual_seed(1)) * 0.5 + 0.25
    b, s, c, v, n = rtdetr.select_queries(boxes, logits, (64, 96), conf_threshold=0.6,
                                          max_det=7)
    dets = rr.select_queries(boxes, logits, (64, 96), 0.6, 7)
    for i in range(2):
        kept = int(v[i].sum())
        assert kept == int(n[i]) == len(dets[i]["boxes"]) == int((best[i].sigmoid() > 0.6).sum())
        assert not v[i, kept:].any() and s.shape == (2, 7)
        assert torch.equal(b[i, :kept], dets[i]["boxes"])
        assert torch.equal(s[i, :kept], dets[i]["scores"])
        assert torch.equal(c[i, :kept].long(), dets[i]["classes"].long())
    # image 1: four tied best scores keep the query order, then query 2;
    # xywh -> xyxy in pixels of the (h 64, w 96) input
    order = [0, 1, 3, 4, 2]
    c1, half = boxes[1, order, :2], boxes[1, order, 2:] / 2
    want = torch.cat([c1 - half, c1 + half], -1) * torch.tensor([96.0, 64.0, 96.0, 64.0])
    assert int(v[1].sum()) == 5 and torch.equal(b[1, :5], want)


def test_aifi_position_embedding_follows_its_formula():
    w, h, dim = 5, 3, 8
    pos = rtdetr.sincos_position_embedding(w, h, dim, CPU)
    omega = [1.0 / 10000.0 ** (k / (dim // 4)) for k in range(dim // 4)]
    for t in range(w * h):
        i, j = divmod(t, h)  # meshgrid(grid_w, grid_h, 'ij'): w outer, h inner
        want = ([math.sin(i * o) for o in omega] + [math.cos(i * o) for o in omega]
                + [math.sin(j * o) for o in omega] + [math.cos(j * o) for o in omega])
        torch.testing.assert_close(pos[t].double(), torch.tensor(want, dtype=torch.float64),
                                   rtol=0, atol=1e-6)
    torch.testing.assert_close(pos, rr.sincos_position_embedding(w, h, dim), rtol=0, atol=1e-6)


def test_predictor_serves_an_rtdetr_checkpoint(spread, tmp_path):
    """The checkpoint round-trips every leaf (Linears, LayerNorms), the
    Predictor builds RT-DETR from its meta, and its detections are the
    reference's post-process of the program's decoder output."""
    ref, x, port = spread
    path = tmp_path / "rtdetr.ckpt"
    save_checkpoint(path, to_jax_variables(port), {
        "variant": "rtdetr-l", "num_classes": 80, "img_size": IMG,
        "config": {"quantization": {"monotone_param": "softplus"},
                   "morphology": {"downsample": 2}}})
    pred = Predictor(str(path), conf_threshold=0.25, max_det=300, warmup=False, device="cpu")
    assert pred.model.variant == "rtdetr-l" and pred.model.family == "rtdetr"
    saved, restored = to_jax_variables(port), to_jax_variables(pred.model)
    assert sorted(saved) == sorted(restored)
    for col in saved:
        a, b = dict(_leaves(saved[col])), dict(_leaves(restored[col]))
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    cap = Capture(pred.model)
    cap.on = True
    out = pred._predict_device(x)
    cap.remove()
    boxes, logits = cap.call(0)["raw"]
    dets = rr.select_queries(boxes, logits, (IMG, IMG), 0.25, 300)
    n = 0
    for b, d in enumerate(dets):
        v = out[3][b]
        assert int(v.sum()) == len(d["boxes"]) == int(out[7][b])
        assert torch.equal(out[0][b][v], d["boxes"]) and torch.equal(out[1][b][v], d["scores"])
        assert torch.equal(out[2][b][v].long(), d["classes"].long())
        n += len(d["boxes"])
    assert n > 0
    results = pred.predict_batch([np.zeros((120, 200, 3), np.uint8)], batch_size=1)
    assert len(results) == 1 and "detections" in results[0]


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(tree[k])


def test_structure_at_640_matches_the_published_model():
    flops = [0]

    def conv(m, args, out):
        flops[0] += 2 * out.numel() * (m.in_channels // m.groups) * math.prod(m.kernel_size)

    def linear(m, args, out):
        flops[0] += 2 * out.numel() * m.in_features

    with torch.device("meta"):
        body = nn.ModuleList(build_network("rtdetr-l", 80))
        hs = [m.register_forward_hook(conv if isinstance(m, nn.Conv2d) else linear)
              for m in body.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
        maps = body[0](torch.empty(1, 3, 640, 640))
        assert [tuple(m.shape) for m in maps] == [(1, 512, 80, 80), (1, 1024, 40, 40),
                                                  (1, 2048, 20, 20)]
        out = body[2](body[1](*maps))
    for h in hs:
        h.remove()
    assert [tuple(t.shape) for t in out] == [(1, 300, 4), (1, 300, 80)]
    # 32,970,476 with Ultralytics' training-only denoising embedding (80 x 256)
    assert sum(p.numel() for p in body.parameters()) == 32_949_996
    convs, products = rr.network_flops(80, 640)
    assert flops[0] == convs
    # AIFI over 400 tokens, six decoder self-attentions over 300 queries, d 256
    assert products == 2 * 2 * 256 * (400 * 400 + 6 * 300 * 300)
    assert abs((convs + products) / 109.54e9 - 1) < 0.005
    # the SiLU ConvBns, the bn_silu launches of a call: RepC3 cv1 / cv2, laterals, downs
    assert sum(isinstance(m, ConvBnSiLU) and m.act is True for m in body.modules()) == 12
    assert variant_channels("rtdetr-l") == (512, 1024, 2048)


@pytest.mark.parametrize("variant", ["rtdetr-l", "yolov8n"])
def test_rtdetr_spans_and_counter(variant, tmp_path):
    model = MCAQYOLO(variant, 80, morph_downsample=2, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, IMG, IMG, 3),
                                                           dtype=np.uint8))
    before = profiling.counters().get("deform_attn", 0)
    syncs = profiling.counters().get("host_syncs", 0)
    with profiling.trace(str(tmp_path)):
        deployed_program(model, x, 80, max_det=300)
    recs = profiling.span_records()
    names = [r["name"] for r in recs]
    by_index = {r["index"]: r for r in recs}
    ours = ("model.aifi", "rtdetr.decoder", "rtdetr.deform", "select_queries")
    if variant == "yolov8n":
        assert not any(n in names for n in ours)
        assert profiling.counters().get("deform_attn", 0) == before
        assert profiling.counters().get("host_syncs", 0) > syncs  # NMS's sync site
        return
    assert profiling.counters().get("deform_attn", 0) - before == 6
    # the NMS-free call has no host-sync site (`host_syncs.serve` does not list the cell)
    assert profiling.counters().get("host_syncs", 0) == syncs
    assert [names.count(n) for n in ours] == [1, 1, 6, 1] and "decode_and_nms" not in names
    for r in recs:
        parent = by_index[r["parent"]]["name"] if r["parent"] is not None else None
        if r["name"] == "model.aifi":
            assert parent == "model.neck" and r["attrs"] == {"tokens": (IMG // 32) ** 2}
        elif r["name"] == "rtdetr.decoder":
            assert parent == "model.head"
        elif r["name"] == "rtdetr.deform":
            assert parent == "rtdetr.decoder" and r["counts"] == {"deform_attn": 1}
        elif r["name"] == "select_queries":
            assert parent == "deployed_program"


def test_training_and_export_refuse_rtdetr(spread, tmp_path):
    cfg = {"epochs": 1, "batch_size": 2, "seed": 0, "output_dir": str(tmp_path),
           "model": {"name": "rtdetr-l", "num_classes": 4}, "data": {"img_size": 64},
           "distillation": {"enabled": False}, "training": {"amp": False}}
    with pytest.raises(ValueError, match="RT-DETR training is not supported.*Hungarian"):
        Trainer(cfg, [], [], device="cpu")
    with pytest.raises(ValueError, match="RT-DETR training"):
        load_teacher(str(tmp_path / "none.msgpack"), "rtdetr-l", 80, "cpu")
    with pytest.raises(ValueError, match="RT-DETR training"):
        export_teacher_from_ckpt(str(tmp_path / "none.ckpt"), str(tmp_path / "t.msgpack"),
                                 "rtdetr-l", 80)
    with pytest.raises(ValueError, match="RT-DETR export is not supported"):
        make_inference_fn(spread[2])
    assert rn.variant_channels("yolov8n") == variant_channels("yolov8n")  # YOLO unchanged
