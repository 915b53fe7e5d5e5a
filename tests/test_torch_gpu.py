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
rint ties), and with per-bit range rows (7, C) / (7, 1); one call counts
one launch; the exported serving program launches the kernel three times
per call.  The kernel moves 16 bytes of
channels per thread and refuses a channel count or an alignment that does
not fit that group, and its C entry refuses a launch geometry that does
not fit the map.

Training from disk: the device-resident pipeline on the card equals its CPU
result (clean bank and mosaic bitwise, HSV and affine within 1 level); the
native letterbox builds and agrees with its float variant (and cv2's
resize, where installed); `evaluate` and the validation loss launch the
kernel three times per quantized forward and never in Stage 1.  The
evidence scripts' forward with bit maps supplied from outside (own,
permuted, constant) is bitwise the plain path's, in 3 launches.  Every
morphology option agrees with its CPU run, and the profiling layer's
`component_breakdown` times the card with `with_mcaq` bitwise equal to
the forward's features; its kernel counter is exact."""

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
                  table.data_ptr(), out.data_ptr(), 0, B, H, W, C, Ht, Wt, 0, ppb,
                  magic, shift, stream)

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


# ---------------------------------------------------------------------------
# Training from disk: the device pipeline, the native letterbox, evaluate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def disk_dataset(tmp_path_factory):
    from mcaq_yolo_tpu_torch.data.dataset import make_synthetic_dataset_v3

    root = tmp_path_factory.mktemp("disk")
    make_synthetic_dataset_v3(str(root), n_images=8, img_size=64, n_val=4, seed=2)
    return root


@pytest.mark.gpu
def test_device_pipeline_cuda_matches_cpu(cuda, disk_dataset):
    """Clean bank and mosaic bitwise; HSV and affine within 1 level (the
    batched products and the HSV arithmetic round differently on the card)."""
    from mcaq_yolo_tpu_torch.data.dataset import YOLODataset
    from mcaq_yolo_tpu_torch.data.device_pipeline import DevicePipeline, augment_batch

    ds = YOLODataset(str(disk_dataset / "images" / "train"), 64, 16, augment=True,
                     mosaic_p=0.5)
    on_gpu, on_cpu = DevicePipeline(ds, device=cuda), DevicePipeline(ds, device="cpu")
    assert on_gpu.bank.is_cuda and torch.equal(on_gpu.bank.cpu(), on_cpu.bank)
    B = 8
    idx4 = torch.tensor([[i, (i + 3) % 8, (i + 5) % 8, (i + 1) % 8] for i in range(B)])
    gains = torch.from_numpy(np.random.default_rng(0).uniform(0.6, 1.4, (B, 4, 3))
                             .astype(np.float32))
    plans = {
        "mosaic": (torch.ones(B, dtype=torch.bool), torch.zeros(B, 4, dtype=torch.bool),
                   torch.ones(B), torch.zeros(B), torch.zeros(B), torch.zeros(B, dtype=torch.bool)),
        "all": (torch.arange(B) % 2 == 0, torch.ones(B, 4, dtype=torch.bool),
                torch.linspace(0.6, 1.4, B), torch.linspace(-6, 6, B), torch.linspace(5, -5, B),
                torch.arange(B) % 3 == 0),
    }
    for name, (mosaic, hsv, s, tx, ty, flip) in plans.items():
        plan = (idx4, mosaic, hsv, gains, s, tx, ty, flip)
        cpu = augment_batch(on_cpu.bank, *plan)
        gpu = augment_batch(on_gpu.bank, *(t.to(cuda) for t in plan)).cpu()
        diff = (gpu.int() - cpu.int()).abs().max()
        assert diff == 0 if name == "mosaic" else diff <= 1, (name, int(diff))
    a = list(on_gpu.loader(4, shuffle=True, seed=3))
    b = list(on_cpu.loader(4, shuffle=True, seed=3))
    for x, y in zip(a, b):
        assert x["image"].is_cuda and x["paths"] == y["paths"]
        np.testing.assert_array_equal(x["gt_boxes"], y["gt_boxes"])
        assert int((x["image"].cpu().int() - y["image"].int()).abs().max()) <= 1


@pytest.mark.gpu
def test_native_letterbox_builds_on_this_host(cuda):
    """csrc/dataio.cpp builds with g++ here; its uint8 letterbox is within 1
    level of its float one and of cv2's resize when cv2 is installed, and
    the letterboxed batch normalizes on the card as on the host (within one
    float32 ulp)."""
    from mcaq_yolo_tpu_torch.data import dataset, native_loader
    from mcaq_yolo_tpu_torch.models.yolo import normalize_image

    rng = np.random.default_rng(1)
    for h, w in ((480, 640), (720, 1280), (640, 640), (333, 500)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        u8, scale, pad = native_loader.letterbox_u8(img, 640)
        f32, scale32, pad32 = native_loader.letterbox_f32(img, 640)
        assert (scale, pad) == (scale32, pad32) and u8.shape == (640, 640, 3)
        assert np.abs(u8 / 255.0 - f32).max() <= 0.5 / 255 + 1e-6
        if dataset.HAS_CV2:
            assert np.abs(u8.astype(int) - dataset.letterbox(img, 640)[0].astype(int)).max() <= 1
        # the card divides through a reciprocal: within one float32 ulp of 1.0
        on_card = normalize_image(torch.from_numpy(u8).to(cuda)).cpu().numpy()
        np.testing.assert_allclose(on_card, normalize_image(torch.from_numpy(u8)).numpy(),
                                   rtol=0, atol=1.2e-7)


@pytest.mark.gpu
def test_evaluate_launches_the_kernel_three_times_per_forward(cuda, disk_dataset, tmp_path):
    from mcaq_yolo_tpu_torch.train import Trainer

    config = {"epochs": 3, "batch_size": 2, "seed": 0, "output_dir": str(tmp_path / "out"),
              "model": {"name": "yolov8n", "num_classes": 16},
              "data": {"train": str(disk_dataset / "images" / "train"),
                       "val": str(disk_dataset / "images" / "val"), "img_size": 64,
                       "max_boxes": 16},
              "curriculum": {"warmup_epochs": 0, "transition_epochs": 1},
              "distillation": {"enabled": False}}
    trainer = Trainer(config, device=cuda)
    before = sq.spatial_quantize.launches
    stage1 = trainer.evaluate(0)  # Stage 1: no quantization, no kernel
    torch.cuda.synchronize()
    assert sq.spatial_quantize.launches == before and stage1["quantized"] == 0.0
    res = trainer.evaluate(2)
    val_loss = trainer.compute_val_loss(2)
    torch.cuda.synchronize()
    forwards = len(trainer.val_loader) + 2  # evaluate's batches, then val loss's full ones
    assert sq.spatial_quantize.launches - before == 3 * forwards
    assert res["quantized"] == 1.0 and 2.0 <= res["avg_bits"] <= 8.0
    assert np.isfinite(res["map50"]) and np.isfinite(val_loss)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("shape,width", [
    ((4, 80, 80, 64, 10, 10), "C"),     # P3, one row of C ranges per bit width
    ((4, 40, 40, 128, 10, 10), "C"),    # P4
    ((4, 20, 20, 256, 5, 5), "C"),      # P5
    ((3, 12, 12, 24, 5, 5), "C"),       # non-multiple tile grid
    ((4, 40, 40, 128, 10, 10), 1),      # mse calibration's (7, 1), expanded by the wrapper
])
def test_kernel_per_bit_rows_bitwise_equal_plain(cuda, dtype, with_mask, shape, width):
    """Per-bit ranges (7, C): the table kernel reads row b - 2 for bit
    width b (range stride C); bitwise equal to the plain version."""
    B, H, W, C, Ht, Wt = shape
    x, bit_map, mask = _inputs(cuda, B, H, W, C, Ht, Wt, seed=7 * C + H)
    x = x.to(dtype)
    g = torch.Generator(device=cuda).manual_seed(C)
    w = C if width == "C" else 1
    lo = -(torch.rand((7, w), generator=g, device=cuda) * 2.5 + 0.5)
    hi = torch.rand((7, w), generator=g, device=cuda) * 2.5 + 0.5
    m = mask if with_mask else None
    before = sq.spatial_quantize.launches
    out = sq.spatial_quantize(x, bit_map, lo, hi, m)
    ref = sq.spatial_quantize_torch(x, bit_map, lo, hi, m)
    torch.cuda.synchronize()
    assert sq.spatial_quantize.launches == before + 1
    ibits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(ibits), ref.view(ibits))


@pytest.mark.gpu
def test_exported_program_launches_the_kernel(cuda, tmp_path):
    """The exported serving program (64 px, bs 2) holds the op three times;
    loaded, one call launches the kernel three times and equals the eager
    program bitwise; an mse-calibrated model's eval forward goes through
    the kernel too (per-bit rows), bitwise equal to the plain version."""
    from mcaq_yolo_tpu_torch.calibrate import calibrate
    from mcaq_yolo_tpu_torch.export import (count_quant_nodes, load_exported,
                                            make_inference_fn, save_exported)
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((2, 64, 64, 3), generator=g, device=cuda)
    model = MCAQYOLO(num_classes=4, morph_downsample=2, device=cuda, seed=1)
    paths = save_exported(model, tmp_path, batch_size=2, img_size=64)
    assert count_quant_nodes(torch.export.load(paths["serialized"])) == 3
    program = load_exported(paths["serialized"])
    with torch.no_grad():
        ref = make_inference_fn(model)(x)
        before = sq.spatial_quantize.launches
        out = program(x)
        torch.cuda.synchronize()
    assert sq.spatial_quantize.launches - before == 3
    assert all(torch.equal(a, b) for a, b in zip(out, ref))

    mse = MCAQYOLO(num_classes=4, calibration_mode="mse", morph_downsample=2, device=cuda,
                   seed=1)
    before = sq.spatial_quantize.launches
    calibrate(mse, [{"image": (x * 255).to(torch.uint8)}] * 2, num_images=4)
    with torch.no_grad():
        raw_k, _ = mse(x)
        mse.set_quant_backend("torch")
        raw_p, _ = mse(x)
    torch.cuda.synchronize()
    assert sq.spatial_quantize.launches - before == 3 * 3
    assert all(torch.equal(a, b) for a, b in zip(raw_k, raw_p))


@pytest.mark.gpu
@pytest.mark.parametrize("maps", ["own", "permuted", "constant"])
def test_external_bit_maps_through_the_kernel(cuda, maps):
    """The M3 / M4 forward with bit maps supplied from outside: the model's
    own maps reproduce its quantized forward bitwise, and every map gives
    the plain path's raw maps bitwise, in 3 launches."""
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
    from mcaq_yolo_tpu_torch.scripts.m3_permutation import (apply_external_bit_maps,
                                                            permute_bit_map)

    model = MCAQYOLO(num_classes=16, device=cuda, seed=2)
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 256, 256, 3), dtype=np.uint8)).to(cuda)
    raw, aux = model(x, quantize=True)
    given = {"own": aux["bit_map"],
             "permuted": [torch.as_tensor(np.stack([permute_bit_map(m[i], "permuted", i)
                                                    for i in range(2)]), device=cuda)
                          for m in (b.cpu().numpy() for b in aux["bit_map"])],
             "constant": [torch.full_like(b, 5.0) for b in aux["bit_map"]]}[maps]
    sq.spatial_quantize.launches = 0
    out = apply_external_bit_maps(model, x, given)
    torch.cuda.synchronize()
    assert sq.spatial_quantize.launches == 3
    model.set_quant_backend("torch")
    plain = apply_external_bit_maps(model, x, given)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    if maps == "own":
        for a, b in zip(out, raw):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("canny_impl", ["cv2compat", "legacy"])
@pytest.mark.parametrize("binarize_impl", ["adaptive", "otsu"])
@pytest.mark.parametrize("contour_components", [True, False])
@pytest.mark.parametrize("metric_mode", ["tiled", "global"])
def test_morphology_options_cuda_match_cpu(cuda, canny_impl, binarize_impl,
                                           contour_components, metric_mode):
    """Each morphology option on the card against its CPU run: phi within
    1e-5 on at least 99% of the entries (the Canny-tie class of the CPU
    tests against JAX: a last-ulp difference on an exactly symmetric
    gradient flips an edge pixel); the global mode's convolutions run in
    full float32 (TF32 off inside `image_ops`)."""
    from mcaq_yolo_tpu_torch.core.morphology import compute_phi_tiles

    kw = dict(canny_impl=canny_impl, binarize_impl=binarize_impl,
              contour_components=contour_components, metric_mode=metric_mode)
    f = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (2, 64, 96, 8))
                         .astype(np.float32))
    ref, _ = compute_phi_tiles(f, **kw)
    out, _ = compute_phi_tiles(f.to(cuda), **kw)
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    far = (out.cpu() - ref).abs() > 1e-5
    assert float(far.float().mean()) <= 0.01


@pytest.mark.gpu
def test_component_breakdown_on_cuda(cuda):
    """Positive stage times on the card, and `with_mcaq`'s features (through
    the kernel) equal to the ones the forward feeds the neck, bitwise."""
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
    from mcaq_yolo_tpu_torch.utils import profiling

    model = MCAQYOLO(num_classes=80, morph_downsample=2, dtype=torch.bfloat16, device=cuda)
    x = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 128, 128, 3),
                                                           dtype=np.uint8)).to(cuda)
    before = sq.spatial_quantize.launches
    bd = profiling.component_breakdown(model, x, iters=2, cost=True)
    torch.cuda.synchronize()
    assert sq.spatial_quantize.launches - before == 3 * 2 * (3 + 2 + 1)
    assert bd["full_ms"] > 0 and bd["backbone_ms"] > 0 and bd["device"].startswith("NVIDIA")
    assert bd["full_gflops"] > 0
    progs = profiling.breakdown_programs(model)
    with torch.inference_mode():
        _, aux = progs["full"](x)
        q = progs["with_mcaq"](x)
    for a, b in zip(aux["quantized_features"], q):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.gpu
def test_cuda_kernels_counts_exactly(cuda):
    """`profiling.cuda_kernels` counts a call's kernels exactly (two
    elementwise ops: 2 kernels; the per-tile Otsu and the whole per-tile
    metric pipeline capture, every count the same in a fresh capture)."""
    from mcaq_yolo_tpu_torch.core import morphology as tm
    from mcaq_yolo_tpu_torch.utils import profiling

    a = torch.rand(1000, device=cuda)
    assert profiling.cuda_kernels(lambda t: (t + 1.0) * 2.0, a) == 2
    gray = torch.rand(2, 32, 32, device=cuda)
    tiles = tm.extract_tiles(gray, 8)[0]
    with torch.inference_mode():
        for fn, arg in ((tm.otsu_threshold, tiles),
                        (lambda g: tm.phi_metrics_tiled(g, 8), gray)):
            n = profiling.cuda_kernels(fn, arg)
            assert n > 0 and profiling.cuda_kernels(fn, arg) == n
