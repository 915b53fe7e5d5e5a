"""The plain reference agrees with the measured program at a tiny size on
the CPU (where the program runs its kernels' plain versions)."""

import pytest
import torch

from mcaq_yolo_tpu_torch.inference import deployed_program
from mcaq_yolo_tpu_torch.models.losses import MCAQYOLOLoss
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
from mcaq_yolo_tpu_torch.train import Optimizer, make_train_step
from perfbench import compare, gen, weights
from perfbench.drivers import common
from perfbench.reference import mcaq as rm
from perfbench.reference import network as rn
from perfbench.reference import train as rt

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _ref(variant="yolov8n", seed=3, ds=2):
    m = weights.build(rm.MCAQYOLO, CPU, variant, 80, 8, ds)
    return weights.init_(m, seed, 80).eval()


def _port(ref, variant="yolov8n", ds=2):
    p = MCAQYOLO(variant=variant, num_classes=80, bit_mapping="mlp", monotone_param="softplus",
                 morph_downsample=ds, dtype=torch.float32, device="cpu")
    p.load_state_dict(ref.state_dict(), strict=True)
    return p


@pytest.mark.parametrize("variant", ["yolov8n", "yolov8m"])
def test_network_matches_the_program(variant):
    ref = _ref(variant)
    net = YOLOv8(variant, 80, dtype=torch.float32, device="cpu")
    net.load_state_dict({k: v for k, v in ref.state_dict().items()
                         if k.split(".")[0] in ("backbone", "neck", "head")}, strict=True)
    x = gen.letterboxed_batches(5, 1, 2, 64, CPU)[0]
    teacher = rn.YOLOv8(variant, 80)
    teacher.load_state_dict(net.state_dict(), strict=True)
    with torch.no_grad():
        for a, b in zip(net(x), teacher(x)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


SERVE = {"temperature": 1.0, "conf": 0.25, "iou": 0.45, "max_det": 300, "pool": 256}


def test_deployed_program_matches_the_reference():
    """Stage by stage from the program's backbone features: the analyzer,
    mapper, quantizer, neck, head and NMS of the reference give the
    program's complexity, bits, raw maps and detections; from the images,
    the backbone features agree to float32 rounding."""
    ref = _ref()
    x = gen.letterboxed_batches(6, 1, 4, 96, CPU)[0]
    with torch.no_grad():
        weights.spread_(ref, x)
    port = _port(ref)
    cap = common.Capture(port)
    cap.on = True
    with torch.no_grad():
        out = deployed_program(port, x, 80, 0.25, 0.45, 300, 256, 1.0)
    got = cap.call(0)
    own = common.reference_state(ref, x, SERVE)
    for a, b in zip(got["feats"], own["feats"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        for i, f in enumerate(got["feats"]):
            c = ref.complexity_analyzer(f.permute(0, 2, 3, 1))
            torch.testing.assert_close(got["complexity"][i], c, rtol=1e-5, atol=1e-6)
            assert torch.equal(got["bits"][i], ref.bit_mapper(c, 1.0))
    given = common.reference_state(ref, x, SERVE, got["feats"], got["bits"])
    for a, b in zip(got["raw"], given["raw"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert abs(float(out[4]) - float(given["avg_bits"])) < 1e-6
    n = 0
    for b in range(x.shape[0]):
        v = out[3][b]
        d = given["dets"][b]
        assert int(v.sum()) == len(d["boxes"])
        torch.testing.assert_close(out[0][b][v], d["boxes"], rtol=1e-4, atol=1e-3)
        assert torch.equal(out[2][b][v].long(), d["classes"].long())
        n += len(d["boxes"])
    assert n > 0


def test_train_step_matches_the_reference():
    ref = _ref("yolov8n", seed=4, ds=1)
    init = {k: v.clone() for k, v in ref.state_dict().items()}
    port = _port(ref, ds=1)
    teacher = YOLOv8("yolov8n", 80, dtype=torch.float32, device="cpu")
    teacher.load_state_dict({k: v for k, v in init.items()
                             if k.split(".")[0] in ("backbone", "neck", "head")}, strict=True)
    batch = gen.train_batches(8, 1, 2, 96, 80, 16, (5, 30), CPU)[0]
    cfg = {"temperature": 1.3, "target_bits": 6.0, "loss_weights": {
        "detection": 1.0, "bit_budget": 0.01, "smoothness": 0.1, "distillation": 0.5,
        "regularization": 1e-4}}
    w = cfg["loss_weights"]
    opt = Optimizer(port, lambda s: 1e-3, weight_decay=0.05)
    step = make_train_step(port, MCAQYOLOLoss(80, 6.0), teacher)
    m = step(opt, batch, 1.3, 6.0, w["bit_budget"], w["smoothness"], w["distillation"],
             w["regularization"], quantize=True, use_kd=True)
    r_teacher = common.reference_teacher({"variant": "yolov8n", "nc": 80}, ref, CPU)
    r_opt = rt.AdamW(list(ref.named_parameters()), 1e-3, 0.05, decay=rt.decay_mask(ref))
    loss = rt.step(ref, r_teacher, r_opt, batch, cfg)
    assert abs(float(m["loss_total"]) - float(loss)) <= 1e-4 * abs(float(loss))
    # the clipped gradients AdamW took (the program leaves them in .grad), by
    # the check's rule: leaf norms against the larger of the leaf's and the
    # median leaf's, leaves nought to rounding (BatchNorm-cancelled biases) out
    pp = dict(port.named_parameters())
    ref_norms = rt.leaf_norms(r_opt.last_clipped)
    prog_norms = rt.leaf_norms({n: pp[n].grad for n in ref_norms})
    med = sorted(ref_norms.values())[len(ref_norms) // 2]
    keep = [n for n, v in ref_norms.items() if v >= 1e-3 * med]
    assert len(keep) > 0.9 * len(ref_norms)
    assert compare.worst_leaf_gap(prog_norms, ref_norms, keep) < 2e-2
