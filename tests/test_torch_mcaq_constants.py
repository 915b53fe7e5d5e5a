"""The MCAQ transform's constants (`core/ste.py:clip`'s bounds, the bilateral
filter's spatial weights in `core/morphology.py`) on the CPU.

  * `clip` gives, in float32 and bfloat16, the forward value and the
    gradient of min(max(x, lo), hi) with the bounds as tensors of x's
    dtype, bitwise, with points exactly at lo and at hi (gradient 0.5);
    its bounds are host tensors under another default device too.
  * The analyzer's `spatial_w` buffer is the float32 tensor of
    `image_ops.spatial_weights`, and the bilateral filter and the analyzer
    with it are bitwise the filter that builds its weights on each call.
  * The buffer stays out of `state_dict()`, the flax tree and checkpoints:
    a state dict or checkpoint without it loads strictly and leaves it as
    it was.
  * A model serves under `torch.inference_mode()` and then trains a step
    in the same process.
"""

import warnings

import numpy as np
import pytest
import torch

from mcaq_yolo_tpu_torch.core import image_ops as iops
from mcaq_yolo_tpu_torch.core.morphology import (MorphologicalComplexityAnalyzer,
                                                 bilateral_filter)
from mcaq_yolo_tpu_torch.core.ste import clip
from mcaq_yolo_tpu_torch.inference import deployed_program
from mcaq_yolo_tpu_torch.models.losses import MCAQYOLOLoss
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.weights_io import load_jax_variables, to_jax_variables
from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
from mcaq_yolo_tpu_torch.train import Optimizer, make_train_step
from mcaq_yolo_tpu_torch.utils.checkpoint import save_checkpoint
from mcaq_yolo_tpu_torch.utils.model_utils import restore_into


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip_with_tensor_bounds(x, lo, hi):
    """min(max(x, lo), hi) with each bound a tensor of x's dtype on x's device."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _bilateral_building_its_weights(c_map, sigma_spatial=2.0, sigma_range=0.1,
                                    kernel_size=5):
    """The bilateral filter with its spatial weights built from the Python
    floats on every call."""
    B, H, W = c_map.shape
    pad = kernel_size // 2
    xp = iops.replicate_pad(c_map, pad)
    patches = torch.stack(
        [xp[:, pad + dy:pad + dy + H, pad + dx:pad + dx + W]
         for dy in range(-pad, pad + 1) for dx in range(-pad, pad + 1)], dim=-1)
    sw = torch.tensor(iops.spatial_weights(kernel_size, sigma_spatial),
                      dtype=torch.float32, device=c_map.device)
    range_w = torch.exp(-((patches - c_map[..., None]) ** 2) / (2.0 * sigma_range ** 2))
    weights = sw * range_w
    return (weights * patches).sum(dim=-1) / (weights.sum(dim=-1) + 1e-8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.5, 2.25)])
def test_clip_is_bitwise_the_tensor_bound_formula(dtype, lo, hi):
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(4096, generator=g) * (hi - lo + 2.0) + (lo - 1.0)).to(dtype)
    x[:4] = torch.tensor([lo, hi, lo, hi], dtype=dtype)   # exactly on the bounds
    up = torch.randn(x.shape, generator=g).to(dtype)
    outs, grads = [], []
    for fn in (clip, _clip_with_tensor_bounds):
        xi = x.clone().requires_grad_(True)
        y = fn(xi, lo, hi)
        y.backward(up)
        outs.append(y.detach())
        grads.append(xi.grad)
    assert outs[0].dtype == dtype
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(outs[0], torch.clamp(x, lo, hi))
    xi = x[:4].clone().requires_grad_(True)
    clip(xi, lo, hi).sum().backward()
    assert xi.grad.tolist() == [0.5] * 4   # a tie splits the gradient in half


def test_clip_bounds_stay_on_the_host_under_another_default_device(monkeypatch):
    made = []
    tensor = torch.tensor

    def spy(*args, **kwargs):
        made.append(tensor(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(torch, "tensor", spy)
    with torch.device("meta"):
        x = torch.empty(8)
        y = clip(x, 0.0, 1.0)
    assert x.device.type == y.device.type == "meta"
    assert [(t.device.type, t.dim(), t.dtype) for t in made] == [("cpu", 0, x.dtype)] * 2


def test_bilateral_filter_with_the_analyzers_buffer_is_bitwise_the_formula():
    analyzer = MorphologicalComplexityAnalyzer()
    assert analyzer.spatial_w.dtype == torch.float32
    assert torch.equal(analyzer.spatial_w,
                       torch.tensor(iops.spatial_weights(5, 2.0), dtype=torch.float32))
    g = torch.Generator().manual_seed(1)
    c = torch.rand((3, 10, 10), generator=g)
    c[0, :, :5] = 0.25                     # flat regions and an edge
    c[0, :, 5:] = 0.75
    ref = _bilateral_building_its_weights(c)
    assert torch.equal(bilateral_filter(c, analyzer.spatial_w), ref)

    torch.nn.init.normal_(analyzer.complexity_mlp.Dense_2.weight, 0.0, 1.0, g)
    feats = torch.randn((2, 32, 32, 16), generator=g)
    phi = analyzer._phi(feats)
    B, ht, wt, _ = phi.shape
    mlp = analyzer.complexity_mlp(phi.reshape(-1, 8)).reshape(B, ht, wt)
    with torch.no_grad():
        assert torch.equal(analyzer(feats),
                           torch.clamp(_bilateral_building_its_weights(mlp), 0.0, 1.0))


def _analyzers(model):
    return [m for m in model.modules() if isinstance(m, MorphologicalComplexityAnalyzer)]


def _leaf_names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_names(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}"


def test_spatial_weights_stay_out_of_state_dict_flax_tree_and_checkpoints(tmp_path):
    model = MCAQYOLO(num_classes=4, device="cpu", seed=0)
    const = torch.tensor(iops.spatial_weights(5, 2.0), dtype=torch.float32)
    assert _analyzers(model)
    buffers = {n for n, _ in model.named_buffers()}
    extra = {n for n in buffers if n.endswith(".spatial_w")}
    assert extra and len(extra) == len(_analyzers(model))
    sd = model.state_dict()
    # the state dict holds the parameters and every other buffer, as it did
    # before the analyzer held its weights
    assert set(sd) == {n for n, _ in model.named_parameters()} | (buffers - extra)
    tree = to_jax_variables(model)
    assert not [n for n in _leaf_names(tree) if "spatial_w" in n]

    fresh = MCAQYOLO(num_classes=4, device="cpu", seed=1)
    result = fresh.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k])

    path = tmp_path / "model.ckpt"
    save_checkpoint(path, tree)
    fresh = MCAQYOLO(num_classes=4, device="cpu", seed=2)
    load_jax_variables(fresh, tree)          # raises on a leaf with no tensor
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # a leaf the checkpoint lacks warns
        restore_into(MCAQYOLO(num_classes=4, device="cpu", seed=3), path)
    for m in _analyzers(fresh):
        assert torch.equal(m.spatial_w, const)


def test_serving_under_inference_mode_then_training_a_step():
    nc, B = 4, 2
    model = MCAQYOLO(num_classes=nc, device="cpu", seed=0)
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8))
    with torch.inference_mode():
        served = deployed_program(model, images, nc, max_det=300)
    assert all(torch.isfinite(t.float()).all() for t in served)

    xy = rng.uniform(0, 40, (B, 3, 2))
    batch = {"image": images,
             "gt_boxes": torch.from_numpy(np.concatenate([xy, xy + 20], -1).astype(np.float32)),
             "gt_classes": torch.from_numpy(rng.integers(0, nc, (B, 3)).astype(np.int32)),
             "gt_mask": torch.ones(B, 3, dtype=torch.bool)}
    step = make_train_step(model, MCAQYOLOLoss(nc, 4.0), YOLOv8("yolov8n", nc, device="cpu"))
    opt = Optimizer(model, lambda s: 1e-3)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = step(opt, batch, 1.0, 4.0, 0.01, 0.1, 0.5, 1e-4, quantize=True, use_kd=True)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert any(n.startswith("complexity_analyzer") for n in moved)
