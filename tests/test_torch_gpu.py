"""The port's CUDA kernel against its plain PyTorch version, and one train
step on the card against the same step on the CPU.

Every test here needs a CUDA device and nvcc; without them each skips.
This file imports neither jax nor the JAX package, so it also runs on a
GPU host that has no JAX. There `tests/conftest.py` (which imports jax)
is left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Contract: bitwise equality with `spatial_quantize_torch`, in float32 and
bfloat16, with and without the soft mask, on exact tile multiples, on a
non-multiple shape (tile floor(h * Ht / H)), on yolov8m's P3 width (24
groups of 8 channels, not a power of two) and on edge inputs (constant
channels, subnormal and huge x, a range that x overflows, bit maps on the
rint ties); one call counts one launch.  The kernel moves 16 bytes of
channels per thread and refuses a channel count or an alignment that does
not fit that group, and its C entry refuses a launch geometry that does
not fit the map."""

import numpy as np
import pytest
import torch

from mcaq_yolo_tpu_torch.ops import spatial_quant as sq


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the GPU")
    return torch.device("cuda")


def _inputs(device, B, H, W, C, Ht, Wt, seed, kind="normal"):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    x = rng.normal(0, 1, (B, H, W, C))
    bit_map = rng.uniform(1.5, 8.5, (B, Ht, Wt))  # the kernel rounds and clips
    if kind == "constant":     # range 0: clamped to 1e-8
        x[..., :4] = [0.75, -3.0, 0.0, 1e-30]
    elif kind == "subnormal":  # subnormal x; half the channels get a normal range
        x = x * 1e-39
        x[0, 0, 0, : C // 2] = 1.0
    elif kind in ("large", "overflow"):
        x = x * (1e36 if kind == "large" else 1e37)
    elif kind == "ties":       # 1.5 .. 8.5: rint rounds half to even
        bit_map = rng.integers(1, 9, (B, Ht, Wt)) + 0.5
    mask = rng.uniform(0.0, 1.0, (B, H, W))
    return t(x), t(bit_map), t(mask)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("shape,kind", [
    ((4, 80, 80, 64, 10, 10), "normal"),    # P3 of yolov8n at 640 px
    ((4, 40, 40, 128, 10, 10), "normal"),   # P4
    ((4, 20, 20, 256, 5, 5), "normal"),     # P5
    ((3, 12, 12, 24, 5, 5), "normal"),      # non-multiple tile grid
    ((2, 80, 80, 192, 10, 10), "normal"),   # yolov8m P3: C / 8 = 24
    ((2, 20, 20, 640, 5, 5), "normal"),     # yolov8x P5: C / 8 = 80
    ((2, 6, 6, 2056, 2, 2), "normal"),      # f32: 514 groups, a pixel takes 2 passes
    ((2, 40, 40, 128, 10, 10), "constant"),
    ((2, 20, 20, 256, 5, 5), "subnormal"),
    ((2, 40, 40, 128, 10, 10), "large"),
    ((2, 20, 20, 256, 5, 5), "overflow"),   # with a narrow range below
    ((2, 80, 80, 64, 10, 10), "ties"),
])
def test_kernel_bitwise_equals_plain(cuda, dtype, with_mask, shape, kind):
    B, H, W, C, Ht, Wt = shape
    x, bit_map, mask = _inputs(cuda, B, H, W, C, Ht, Wt, seed=H * C, kind=kind)
    x = x.to(dtype)
    if kind == "overflow":  # a frozen range far inside x's: x / scale overflows
        lo = torch.full((C,), -0.01, device=cuda)
        hi = torch.full((C,), 0.01, device=cuda)
    else:
        lo, hi = torch.aminmax(x.reshape(-1, C), dim=0)
        lo, hi = lo.float().contiguous(), hi.float().contiguous()
    m = mask if with_mask else None
    before = sq.spatial_quantize.launches
    out = sq.spatial_quantize(x, bit_map, lo, hi, m)
    ref = sq.spatial_quantize_torch(x, bit_map, lo, hi, m)
    torch.cuda.synchronize()
    assert sq.spatial_quantize.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    assert bool(torch.isfinite(out).all())
    ibits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(ibits), ref.view(ibits))


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    x, bit_map, mask = _inputs(cuda, 2, 16, 16, 8, 4, 4, seed=1)
    lo, hi = x.amin(dim=(0, 1, 2)).contiguous(), x.amax(dim=(0, 1, 2)).contiguous()
    before = sq.spatial_quantize.launches
    nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)  # not NHWC-contiguous
    with pytest.raises(ValueError, match="contiguous"):
        sq.spatial_quantize(nchw, bit_map, lo, hi)
    with pytest.raises(TypeError):
        sq.spatial_quantize(x.half(), bit_map, lo, hi)
    with pytest.raises(ValueError, match="bit_map on"):
        sq.spatial_quantize(x, bit_map.cpu(), lo, hi)
    with pytest.raises(ValueError, match="mask"):
        sq.spatial_quantize(x, bit_map, lo, hi, mask[:, :8])
    x6, bit6, _ = _inputs(cuda, 2, 9, 7, 6, 4, 3, seed=2)  # C not a multiple of 4 / 8
    lo6, hi6 = x6.amin(dim=(0, 1, 2)).contiguous(), x6.amax(dim=(0, 1, 2)).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="multiple"):
            sq.spatial_quantize(x6.to(dtype), bit6, lo6, hi6)
    shifted = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape).copy_(x)
    with pytest.raises(ValueError, match="aligned"):  # contiguous, 4 bytes off
        sq.spatial_quantize(shifted, bit_map, lo, hi)
    assert sq.spatial_quantize.launches == before


@pytest.mark.gpu
def test_kernel_entry_refuses_a_wrong_geometry(cuda):
    """The C entry checks the geometry the wrapper computes: a block run
    wider than one pass, or a multiplier that does not divide exactly,
    returns cudaErrorInvalidValue (1) and launches nothing."""
    B, H, W, C, Ht, Wt = 2, 16, 16, 24, 4, 4
    x, bit_map, _ = _inputs(cuda, B, H, W, C, Ht, Wt, seed=3)
    lo, hi = x.amin(dim=(0, 1, 2)).contiguous(), x.amax(dim=(0, 1, 2)).contiguous()
    geo = sq.launch_geometry(B, H, W, C, 4)
    fn = sq._kernel()
    table = torch.empty((2, sq.N_BITS, C), device=cuda)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def call(ppb=geo.pix_per_block, magic=geo.magic, shift=geo.shift):
        return fn(x.data_ptr(), bit_map.data_ptr(), lo.data_ptr(), hi.data_ptr(), None,
                  table.data_ptr(), out.data_ptr(), 0, B, H, W, C, Ht, Wt, ppb, magic,
                  shift, stream)

    assert call() == 0
    torch.cuda.synchronize()
    assert torch.equal(out, sq.spatial_quantize_torch(x, bit_map, lo, hi))
    assert call(ppb=geo.pix_per_block + 1) == 1  # run wider than one pass
    assert call(magic=geo.magic + 1) == 1        # inexact for some j
    assert call(magic=1, shift=2) == 1           # divides by 4, not 6


@pytest.mark.gpu
def test_train_step_cuda_matches_cpu(cuda):
    """One float32 train step (Stage 3, KD on) at 128 px, batch 2, on the
    card and on the CPU from the same seeded weights and batch, TF32 off:
    loss terms within 1e-3 relative and each top-level group's gradient
    within 1e-2 relative L2 (convolution rounding moves a few features
    across a quantization step, as between the port and JAX on the CPU)."""
    from mcaq_yolo_tpu_torch.data.synthetic import synthetic_batches
    from mcaq_yolo_tpu_torch.models.losses import MCAQYOLOLoss
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
    from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
    from mcaq_yolo_tpu_torch.train import Optimizer, make_train_step

    batch = synthetic_batches(1, 2, 128, 4, max_boxes=8, boxes_per_image=(3, 6), seed=0)[0]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {}
        for dev in ("cpu", "cuda"):
            model = MCAQYOLO(num_classes=4, morph_downsample=2, device=dev, seed=0)
            teacher = YOLOv8("yolov8n", 4, device=dev, seed=1)
            step = make_train_step(model, MCAQYOLOLoss(4, 4.0), teacher)
            opt = Optimizer(model, lambda s: 0.0)  # lr 0: the weights stay
            metrics = step(opt, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                           1.0, 4.0, 0.05, 0.1, 0.5, 1e-4, quantize=True, use_kd=True)
            unclip = max(float(metrics["grad_norm"]), 1.0)  # the step clipped to norm 1
            grads = {}
            for name, p in model.named_parameters():
                grads.setdefault(name.split(".")[0], []).append(
                    p.grad.detach().cpu().reshape(-1) * unclip)
            runs[dev] = ({k: float(v) for k, v in metrics.items() if v.numel() == 1},
                         {k: torch.cat(v) for k, v in grads.items()})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (m_cpu, g_cpu), (m_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    for k in ("loss_total", "loss_det", "loss_bit", "loss_smooth", "loss_kd", "loss_reg"):
        assert m_gpu[k] == pytest.approx(m_cpu[k], rel=1e-3), k
    for group, g in g_cpu.items():
        assert float(g.norm()) > 0, group
        err = float((g_gpu[group] - g).norm() / g.norm())
        assert err <= 1e-2, f"{group}: relative L2 error {err:.3g}"
