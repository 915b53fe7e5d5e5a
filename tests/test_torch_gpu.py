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
permuted, constant) is bitwise the plain path's, in 3 launches.  Two ranks
sharing the card over gloo (`tests/torch_parallel_worker.py`): the
quantizer's range reduced over them is the whole batch's and the kernel is
bitwise its plain version on it; sync-BN equals one rank's.  Every
morphology option agrees with its CPU run, and the profiling layer's
`component_breakdown` times the card with `with_mcaq` bitwise equal to
the forward's features; its kernel counter is exact.

The phi kernel (`csrc/morph_tiles.cu`, `core/morphology_lanes.py`) equals
its plain version bitwise at every power-of-two tile from 1 to 128 and in
all 8 option combinations, on random maps and on maps with constant, zero
and exactly tied tiles, and on ragged tails (1, 31 and 33 tiles, a batch
of 1, more 128 x 128 tiles than blocks); a tile's phi does not depend on
the batch size or on its position in the batch, on the warp path (tiles up
to 8 x 8) and on the block path; the deployed forward launches it once per
scale and the exported program holds it as 3 nodes; the 'rows' engine
launches no phi kernel; tiles of 256 to 1024 launch it too, bitwise but for
a tile whose Otsu bin the plain version's rounded float sums moved.

The program's spans and counters (`utils/profiling.py`): `host_syncs` over
one deployed call and over one train step equals the synchronizing
operations torch's sync debug mode reports there (the NMS keep sweeps'
reads; none in a train step), and repeats exactly; the MCAQ transform,
served and trained, runs under the mode's "error" setting; a
span's stream time covers the device time of the kernels launched inside
it, and the program's annotations in the profiler's trace match the span
summary's names and counts.

The training quantize (`csrc/frac_quant.cu`, `ops/frac_quant.py`): at
m-train-bs64's three maps, an odd C, a non-multiple tile grid and mse's
per-bit rows, in float32 and bfloat16, with and without the mask, the
forward and grad x are bitwise the plain path's, grad frac and grad mask
within 1e-5 relative L2, a second run bitwise the first; the wrapper and
its C entries refuse what they do not take; a bf16 train step counts 6
launches inside its root span.

YOLO11 (`models/layers.py`): the deployed YOLO11l at bs 8 and 640 px is
bitwise its path with every ConvBnSiLU on F.batch_norm + F.silu, and one
call launches the BatchNorm + SiLU kernel once a ConvBnSiLU with SiLU (159)
and the quantize and phi kernels three times each; each depthwise
ConvBnSiLU of YOLO11l's head through the kernel is bitwise the same module
without it.

YOLO12 (`models/layers.py` A2C2f, ABlock, AAttn): the deployed YOLO12-L at
bs 8 and 640 px, through cell l12-serve-bs256's driver, is within the
cell's limits at every stage of its check, launches bn_silu 141 times, the
quantize and phi kernels 3 times each, evaluates 16 area attentions, hands
its taps on in bfloat16, and runs its attention cores on a fused SDPA
backend; its 307-wide ConvBnSiLU (the kernel's element path) is bitwise the
same module without the kernel."""

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
    fn = sq._ENTRY.fn()
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


# ---------------------------------------------------------------------------
# Two ranks sharing the card (tests/torch_parallel_worker.py, over gloo)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_ranks_on_the_card(tmp_path_factory):
    """The worker's GPU cases at 2 ranks on cuda:0, and at 1 rank here."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the GPU")
    import os
    import pickle
    import subprocess
    import sys
    from pathlib import Path

    work = tmp_path_factory.mktemp("ranks_gpu")
    worker = Path(__file__).with_name("torch_parallel_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    procs = [subprocess.Popen([sys.executable, str(worker), str(work), str(r), "2", "gpu"],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    ranks = []
    for r in range(2):
        with open(work / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    sys.path.insert(0, str(Path(__file__).parent))
    import torch_parallel_worker as w

    return ranks, w.run_gpu(None)


@pytest.mark.gpu
def test_group_reduced_range_through_the_kernel(two_ranks_on_the_card):
    """The range the kernel quantizes with is the global batch's (equal to
    one rank's on the whole batch), the kernel is bitwise its plain version
    on it, one launch per call, and the ranks' rows are the one-rank
    output's."""
    ranks, one = two_ranks_on_the_card
    for r in ranks:
        got = r["kernel_range"]
        np.testing.assert_array_equal(got["lo"], one["kernel_range"]["lo"])
        np.testing.assert_array_equal(got["hi"], one["kernel_range"]["hi"])
        np.testing.assert_array_equal(got["kernel"], got["plain"])
        assert got["launches"] == 1
    np.testing.assert_array_equal(np.concatenate([r["kernel_range"]["kernel"] for r in ranks]),
                                  one["kernel_range"]["kernel"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bn2d", "bn1d"])
def test_sync_batchnorm_on_the_card(two_ranks_on_the_card, name):
    """Sync-BN at 2 ranks against 1 rank on the card (rtol 1e-5, the JAX
    package's DP bound): outputs, gradients, running statistics."""
    ranks, one = two_ranks_on_the_card
    ref = one["batchnorm"][name]
    two = [r["batchnorm"][name] for r in ranks]
    for k in ("y", "x_grad"):
        np.testing.assert_allclose(np.concatenate([t[k] for t in two]), ref[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(ref[k]).max())
    for t in two:
        for k in ("w_grad", "b_grad", "mean", "var"):
            np.testing.assert_allclose(t[k], ref[k], rtol=1e-5, atol=1e-5 * np.abs(ref[k]).max())


# ---------------------------------------------------------------------------
# The phi kernel (csrc/morph_tiles.cu)
# ---------------------------------------------------------------------------

PHI_OPTIONS = [(c, b, k) for c in ("cv2compat", "legacy") for b in ("adaptive", "otsu")
               for k in (True, False)]


def _gray_map(device, B, ht, wt, tile, seed):
    """A normalized gray map whose first tile row is constant, whose first
    tile column is zero, and whose last tile is a ramp with exactly tied
    gradients; random elsewhere."""
    from mcaq_yolo_tpu_torch.core import image_ops as iops

    rng = np.random.default_rng(seed)
    g = rng.random((B, ht * tile, wt * tile)).astype(np.float32)
    g[:, :tile, :] = 0.375
    g[:, :, :tile] = 0.0
    y, x = np.mgrid[:tile, :tile]
    g[:, -tile:, -tile:] = ((x + y) % 8) / 8.0
    return iops.normalize01(torch.from_numpy(g).to(device)).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [1, 2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("canny_impl,binarize_impl,contour_components", PHI_OPTIONS)
def test_phi_kernel_bitwise_equals_plain(cuda, tile, canny_impl, binarize_impl,
                                         contour_components):
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml

    B, ht, wt = (2, 2, 3) if tile >= 64 else (3, 5, 4)
    gray = _gray_map(cuda, B, ht, wt, tile, seed=tile)
    before = ml.phi_tiles.launches
    out = ml.phi_tiles(gray, tile, canny_impl, binarize_impl, contour_components)
    torch.cuda.synchronize()
    assert ml.phi_tiles.launches == before + 1
    ref = ml.phi_tiles_torch(gray, tile, canny_impl, binarize_impl, contour_components)
    assert out.shape == (B, ht, wt, 8) and bool(torch.isfinite(out).all())
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.gpu
def test_phi_kernel_does_not_depend_on_the_batch(cuda):
    """One image alone, in a batch of 5 and at another position give the
    same phi, bitwise."""
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml

    gray = _gray_map(cuda, 5, 10, 10, 4, seed=9)
    full = ml.phi_tiles(gray, 4)
    perm = torch.tensor([3, 0, 4, 1, 2], device=cuda)
    shuffled = ml.phi_tiles(gray[perm].contiguous(), 4)
    for i in range(5):
        alone = ml.phi_tiles(gray[i:i + 1].contiguous(), 4)
        assert torch.equal(alone[0], full[i])
    assert torch.equal(shuffled, full[perm])


@pytest.mark.gpu
@pytest.mark.parametrize("tile,shape", [(4, (1, 1, 1)), (4, (1, 1, 31)), (4, (1, 1, 33)),
                                        (1, (1, 3, 11)), (2, (3, 1, 9)), (8, (1, 1, 5)),
                                        (16, (1, 1, 3)), (128, (1, 17, 16))])
@pytest.mark.parametrize("canny_impl,binarize_impl,contour_components",
                         [PHI_OPTIONS[0], PHI_OPTIONS[-1]])
def test_phi_kernel_bitwise_on_ragged_tails(cuda, tile, shape, canny_impl, binarize_impl,
                                            contour_components):
    """Tile counts that leave a warp or a block partly filled, a batch of 1,
    and 272 tiles of 128 x 128 (more than the 264 blocks that stride over
    them): bitwise equal to the plain version, one launch."""
    from mcaq_yolo_tpu_torch.core import image_ops as iops
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml

    B, ht, wt = shape
    g = np.random.default_rng(tile * 100 + wt).random((B, ht * tile, wt * tile))
    gray = iops.normalize01(torch.from_numpy(g.astype(np.float32)).to(cuda)).contiguous()
    before = ml.phi_tiles.launches
    out = ml.phi_tiles(gray, tile, canny_impl, binarize_impl, contour_components)
    torch.cuda.synchronize()
    assert ml.phi_tiles.launches == before + 1
    ref = ml.phi_tiles_torch(gray, tile, canny_impl, binarize_impl, contour_components)
    assert out.shape == (B, ht, wt, 8)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [16, 128, 256])
def test_phi_block_path_does_not_depend_on_the_batch(cuda, tile):
    """The block path (tiles from 16 x 16): one image alone, in a batch of 3
    and at another position give the same phi, bitwise."""
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml

    gray = _gray_map(cuda, 3, 2, 3, tile, seed=tile + 1)
    full = ml.phi_tiles(gray, tile)
    perm = torch.tensor([2, 0, 1], device=cuda)
    shuffled = ml.phi_tiles(gray[perm].contiguous(), tile)
    for i in range(3):
        alone = ml.phi_tiles(gray[i:i + 1].contiguous(), tile)
        assert torch.equal(alone[0], full[i])
    assert torch.equal(shuffled, full[perm])


@pytest.mark.gpu
@pytest.mark.parametrize("tile,shape,options", [(256, (1, 2, 2), o) for o in PHI_OPTIONS]
                         + [(512, (1, 2, 1), PHI_OPTIONS[0]), (1024, (1, 1, 1), PHI_OPTIONS[0])])
def test_phi_kernel_above_128_equals_plain_but_for_otsu_rounding(cuda, tile, shape, options):
    """ROADMAP C.5: tiles above 128 (Eq.(8) scoring from 2048 px at grid 8)
    launch the kernel once.  Each tile's phi equals the plain version's
    bitwise unless the plain version's float Otsu sums, which round from 256
    x 256, picked another bin than the kernel's exact scan
    (`otsu_bins_differ`).  Above 1024 the kernel refuses."""
    from mcaq_yolo_tpu_torch.core import morphology as tm
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml

    B, ht, wt = shape
    gray = _gray_map(cuda, B, ht, wt, tile, seed=tile)
    before = ml.phi_tiles.launches
    out = ml.phi_tiles(gray, tile, *options)
    torch.cuda.synchronize()
    assert ml.phi_tiles.launches == before + 1
    ref = ml.phi_tiles_torch(gray, tile, *options)
    assert out.shape == (B, ht, wt, 8) and bool(torch.isfinite(out).all())
    same = (out.view(torch.int32) == ref.view(torch.int32)).reshape(-1, 8).all(1)
    rounding = ml.otsu_bins_differ(tm.extract_tiles(gray, tile)[0], *options[:2])
    assert bool((same | rounding).all())
    with pytest.raises(ValueError, match="power of two"):
        ml.kernel_args(torch.zeros((1, 2048, 2048), device=cuda), 2048, *options)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["lanes", "rows"])
def test_forward_launches_the_phi_kernel_once_per_scale(cuda, engine):
    """The deployed forward: 3 phi launches with 'lanes', none with 'rows',
    and the same raw maps, bitwise."""
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO

    x = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 128, 128, 3),
                                                           dtype=np.uint8)).to(cuda)
    model = MCAQYOLO(num_classes=4, morph_downsample=2, morph_tile_engine=engine,
                     device=cuda, seed=3)
    other = MCAQYOLO(num_classes=4, morph_downsample=2, device=cuda, seed=3,
                     morph_tile_engine="rows" if engine == "lanes" else "lanes")
    with torch.no_grad():
        before = ml.phi_tiles.launches
        raw, _ = model(x)
        torch.cuda.synchronize()
        launches = ml.phi_tiles.launches - before
        raw_other, _ = other(x)
    assert launches == (3 if engine == "lanes" else 0)
    for a, b in zip(raw, raw_other):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_exported_program_holds_three_phi_nodes(cuda, tmp_path):
    """The exported serving program (64 px, bs 2) holds 3 phi nodes beside
    its 3 quantize nodes; loaded, one call launches the phi kernel three
    times and equals the eager program bitwise."""
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml
    from mcaq_yolo_tpu_torch.export import (count_phi_nodes, count_quant_nodes,
                                            load_exported, make_inference_fn, save_exported)
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO

    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand((2, 64, 64, 3), generator=g, device=cuda)
    model = MCAQYOLO(num_classes=4, morph_downsample=2, device=cuda, seed=1)
    paths = save_exported(model, tmp_path, batch_size=2, img_size=64)
    exported = torch.export.load(paths["serialized"])
    assert count_phi_nodes(exported) == 3 and count_quant_nodes(exported) == 3
    program = load_exported(paths["serialized"])
    with torch.no_grad():
        ref = make_inference_fn(model)(x)
        before = ml.phi_tiles.launches
        out = program(x)
        torch.cuda.synchronize()
    assert ml.phi_tiles.launches - before == 3
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


# ---------------------------------------------------------------------------
# The program's spans and host-sync counter on the card (utils/profiling.py)
# ---------------------------------------------------------------------------


def _sync_warnings(fn):
    """fn()'s synchronizing CUDA operations as torch's sync debug mode
    reports them (its own first notice, that the mode is a prototype, left
    out), and fn's result."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught), out


def _served(cuda):
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO

    model = MCAQYOLO(num_classes=80, morph_downsample=2, dtype=torch.bfloat16, device=cuda)
    x = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (4, 256, 256, 3),
                                                           dtype=np.uint8)).to(cuda)
    return model, x


def _deployed(model, x):
    from mcaq_yolo_tpu_torch.inference import deployed_program

    with torch.inference_mode():
        # no gate, so the whole pool enters NMS, its boxes overlap and the
        # keep loop sweeps several times
        return deployed_program(model, x, 80, conf_threshold=0.0, max_det=300)


@pytest.mark.gpu
def test_host_syncs_match_the_sync_debug_mode(cuda):
    """`host_syncs` over one deployed call and over one train step equals
    the synchronizing operations torch's sync debug mode reports there,
    and repeats exactly on the same inputs."""
    from mcaq_yolo_tpu_torch.data.synthetic import synthetic_batches
    from mcaq_yolo_tpu_torch.models.losses import MCAQYOLOLoss
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
    from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
    from mcaq_yolo_tpu_torch.train import Optimizer, make_train_step
    from mcaq_yolo_tpu_torch.utils import profiling

    def counted(fn):
        before = profiling.counters()
        warned, _ = _sync_warnings(fn)
        after = profiling.counters()
        return warned, {k: after[k] - before.get(k, 0) for k in ("host_syncs", "nms_sweeps")}

    model, x = _served(cuda)
    _deployed(model, x)  # warm-up
    calls = [counted(lambda: _deployed(model, x)) for _ in range(2)]
    for warned, delta in calls:   # the keep sweeps' reads, and no MCAQ sync
        assert delta["host_syncs"] == warned == delta["nms_sweeps"]
    assert calls[0] == calls[1]
    assert calls[0][1]["nms_sweeps"] >= 2

    batch = synthetic_batches(1, 2, 128, 4, max_boxes=8, boxes_per_image=(3, 6), seed=0)[0]
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    student = MCAQYOLO(num_classes=4, device=cuda, seed=0)
    step = make_train_step(student, MCAQYOLOLoss(4, 4.0), YOLOv8("yolov8n", 4, device=cuda),
                           amp_dtype=torch.bfloat16)
    opt = Optimizer(student, lambda s: 1e-3)

    def one_step():
        return step(opt, batch, 4.85, 6.87, 0.0, 0.0, 0.5, 1e-4, quantize=True, use_kd=True)

    one_step()  # warm-up: AdamW's state
    steps = [counted(one_step) for _ in range(2)]
    for warned, delta in steps:   # a train step holds no sync at all
        assert delta["host_syncs"] == warned == 0
    assert steps[0] == steps[1]


@pytest.mark.gpu
def test_mcaq_transform_runs_under_the_sync_debug_mode_error(cuda):
    """`MCAQYOLO.mcaq_transform` holds no synchronizing operation: a served
    bs-4 batch through it, and a training forward + backward, run under
    torch.cuda.set_sync_debug_mode("error"), and the served outputs are
    bitwise the same call's before the mode was set.  `clip` on the card
    is bitwise min(max(x, lo), hi) with bounds copied to the card, its
    value and its gradient, in float32 and bfloat16."""
    from mcaq_yolo_tpu_torch.core.ste import clip
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO

    def in_error_mode(fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    model, x = _served(cuda)
    with torch.inference_mode():
        feats = model.backbone_features(x)

        def served():
            return [model.mcaq_transform(f, i, 1.0, True) for i, f in enumerate(feats)]

        ref = [[t.clone() for t in out] for out in served()]
        got = in_error_mode(served)
    for a, b in zip(ref, got):
        assert len(a) == len(b) == 3
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and torch.equal(u, v)

    student = MCAQYOLO(num_classes=4, device=cuda, seed=0)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        tfeats = [f.detach().requires_grad_(True)
                  for f in student.backbone_features(x, training=True)]

    def trained():
        loss = 0.0
        with torch.autocast("cuda", dtype=torch.bfloat16):
            for i, f in enumerate(tfeats):
                fq, c, b = student.mcaq_transform(f, i, 4.85, True, training=True)
                loss = loss + fq.float().square().mean() + c.mean() + b.mean()
        loss.backward()
        return [f.grad for f in tfeats]

    trained()  # warm-up
    for f in tfeats:
        f.grad = None
    grads = in_error_mode(trained)
    torch.cuda.synchronize()
    assert all(gr is not None and torch.isfinite(gr).all() for gr in grads)
    assert any(p.grad is not None and p.grad.abs().sum() > 0
               for p in student.complexity_analyzer.parameters())

    g = torch.Generator(device=cuda).manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        xs = (torch.rand(4096, generator=g, device=cuda) * 3 - 1).to(dtype)
        xs[:2] = torch.tensor([0.0, 1.0], dtype=dtype, device=cuda)
        up = torch.randn(xs.shape, generator=g, device=cuda).to(dtype)
        outs, grs = [], []
        for copied in (False, True):
            xi = xs.clone().requires_grad_(True)
            y = torch.minimum(torch.maximum(xi, xi.new_tensor(0.0)), xi.new_tensor(1.0)) \
                if copied else in_error_mode(lambda: clip(xi, 0.0, 1.0))
            y.backward(up)
            outs.append(y.detach())
            grs.append(xi.grad)
        assert torch.equal(outs[0], outs[1]) and torch.equal(grs[0], grs[1])
        assert torch.equal(grs[0][:2], up[:2] / 2)


@pytest.mark.gpu
def test_span_stream_time_covers_its_kernels(cuda, tmp_path):
    """Under `trace()`: the deployed program's outputs are bitwise those of
    a call without it; each program span's stream time (its CUDA events) is
    at least the device time the profiler gives the kernels launched inside
    it, and the trace's program annotations match the summary's names and
    counts."""
    import json

    from mcaq_yolo_tpu_torch.utils import profiling

    model, x = _served(cuda)
    off = _deployed(model, x)
    with profiling.trace(str(tmp_path)) as d:
        on = [_deployed(model, x) for _ in range(2)]
    for a, b in zip(off, on[-1]):   # tracing moves no output
        assert a.dtype == b.dtype and torch.equal(a, b)
    records = profiling.span_records()
    summary = profiling.span_summary()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert json.loads((tmp_path / "spans.json").read_text()) == json.loads(json.dumps(summary))
    assert d == str(tmp_path)

    ann = {}
    launches = []
    device = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "user_annotation" and e["name"] in summary["spans"]:
            ann.setdefault(e["name"], []).append(e)
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches.append(e)
        elif cat == "kernel":
            device[e["args"]["correlation"]] = float(e["dur"])
    assert {n: len(v) for n, v in ann.items()} == {n: v["count"]
                                                  for n, v in summary["spans"].items()}
    assert summary["roots"] == 2 and summary["by_root"]["deployed_program"]["count"] == 2

    seen = {}
    checked = 0
    for r in records:
        k = seen.get(r["name"], 0)
        seen[r["name"]] = k + 1
        a = sorted(ann[r["name"]], key=lambda e: e["ts"])[k]
        t0, t1 = float(a["ts"]), float(a["ts"]) + float(a["dur"])
        busy_us = sum(device.get(e["args"]["correlation"], 0.0) for e in launches
                      if e["tid"] == a["tid"] and t0 <= float(e["ts"]) <= t1)
        assert r["stream_ms"] is not None
        assert r["stream_ms"] * 1e3 >= 0.99 * busy_us - 2.0, (r["name"], r["stream_ms"], busy_us)
        checked += busy_us > 0
    assert checked >= 10


# ---------------------------------------------------------------------------
# YOLO11 on the card (models/layers.py C3k2, C2PSA, the depthwise head)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_yolo11l_deployed_bitwise_without_bn_silu_and_its_launches(cuda, monkeypatch):
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml
    from mcaq_yolo_tpu_torch.inference import deployed_program
    from mcaq_yolo_tpu_torch.models.layers import ConvBnSiLU
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
    from mcaq_yolo_tpu_torch.ops import bn_silu as bs

    model = MCAQYOLO("yolo11l", 80, morph_downsample=2, dtype=torch.bfloat16, device=cuda,
                     seed=2)
    acts = sum(isinstance(m, ConvBnSiLU) and m.act for m in model.modules())
    x = torch.from_numpy(np.random.default_rng(11).integers(0, 256, (8, 640, 640, 3),
                                                            dtype=np.uint8)).to(cuda)

    def call():
        with torch.inference_mode():
            return [t.clone() for t in deployed_program(model, x, 80, conf_threshold=0.0,
                                                        max_det=300)]

    call()  # warm-up
    before = (bs.launches(), sq.spatial_quantize.launches, ml.phi_tiles.launches)
    kernel = call()
    torch.cuda.synchronize()
    after = (bs.launches(), sq.spatial_quantize.launches, ml.phi_tiles.launches)
    assert acts == 159
    assert [a - b for a, b in zip(after, before)] == [159, 3, 3]
    monkeypatch.setattr(bs, "takes", lambda x, bn: False)
    unfused = call()
    assert bs.launches() == after[0]
    assert int(kernel[3].sum()) > 0
    for a, b in zip(kernel, unfused):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("C,H", [(256, 80), (512, 40), (256, 40), (512, 20), (256, 20)])
def test_depthwise_conv_bn_silu_through_the_kernel_is_bitwise(cuda, monkeypatch, C, H):
    """YOLO11l's head at bs 8: the depthwise 3x3 ConvBnSiLU of each class
    branch stage, bf16 on channels-last maps."""
    from mcaq_yolo_tpu_torch.models.layers import ConvBnSiLU
    from mcaq_yolo_tpu_torch.ops import bn_silu as bs

    g = torch.Generator().manual_seed(C + H)
    m = ConvBnSiLU(C, C, 3, groups=C)
    with torch.no_grad():
        m.Conv_0.weight.normal_(0, 0.3, generator=g)
        bn = m.BatchNorm_0
        bn.weight.uniform_(0.5, 1.5, generator=g), bn.bias.normal_(0, 1, generator=g)
        bn.running_mean.normal_(0, 1, generator=g), bn.running_var.uniform_(0.05, 2, generator=g)
    m.Conv_0.to(dtype=torch.bfloat16)
    m.to(device=cuda, memory_format=torch.channels_last)
    x = (torch.randn(8, C, H, H, generator=g) * 3).to(device=cuda, dtype=torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        before = bs.launches()
        out = m(x)
        torch.cuda.synchronize()
        assert bs.launches() == before + 1
        monkeypatch.setattr(bs, "takes", lambda x, bn: False)
        plain = m(x)
    assert torch.equal(out.view(torch.int16), plain.view(torch.int16))


# ---------------------------------------------------------------------------
# RT-DETR-L on the card (models/rtdetr.py: HGNetv2, AIFI, the deformable decoder)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_rtdetr_l_deployed_call_against_the_reference_and_its_launches(cuda):
    """The bf16 deployed call of cell rtdetr-l-serve-bs256 at its shapes (640
    px, every width; 32 images a call), through the cell's own driver: each
    stage of its check within the cell's limits (taps, complexity and bit
    maps, encoder logits, the selection exactly, the decoder's boxes and
    logits, the detections exactly); a call launches bn_silu 12 times, the
    quantize and phi kernels 3 times each, and samples 6 times."""
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml
    from mcaq_yolo_tpu_torch.ops import bn_silu as bs
    from mcaq_yolo_tpu_torch.utils import profiling
    from perfbench import run
    from perfbench.drivers import serve_batch_rtdetr as d

    run.cache_env()
    c = run.cell("rtdetr-l-serve-bs256")
    c["traffic"].update(batch=32, pool_batches=2)
    drv = d.Driver(c["config"], c["traffic"], 20261018, cuda, lambda o: None)
    drv.setup()
    drv.window(1.0)
    x = drv.batches[0]
    before = (bs.launches(), sq.spatial_quantize.launches, ml.phi_tiles.launches,
              profiling.counters().get("deform_attn", 0))
    drv.entry(x)
    torch.cuda.synchronize()
    after = (bs.launches(), sq.spatial_quantize.launches, ml.phi_tiles.launches,
             profiling.counters().get("deform_attn", 0))
    assert [a - b for a, b in zip(after, before)] == [12, 3, 3, 6]
    drv.release()
    numbers = drv.check()
    over = {k: numbers[k] for k, lim in c["limits"].items()
            if not k.startswith("_") and numbers[k] > lim}
    assert not over, numbers
    assert int(drv.picked["out"][3].sum()) > 0


# ---------------------------------------------------------------------------
# The training quantize's kernel pair (csrc/frac_quant.cu, ops/frac_quant.py)
# ---------------------------------------------------------------------------


def _frac_case(device, B, H, W, C, Ht, Wt, dtype, mse, seed):
    from mcaq_yolo_tpu_torch.core.quantization import calibrate_mse

    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(B, H, W, C, generator=g, device=device) * 1.5 + 0.2).to(dtype)
    bits = torch.rand(B, Ht, Wt, generator=g, device=device) * 6.0 + 2.0
    bits.view(-1)[::5] = 2.0   # exact bit widths, the top one among them
    bits.view(-1)[1::5] = 8.0
    bits.view(-1)[2::7] = 5.0
    if mse:
        lo, hi = calibrate_mse(x.float())
    else:
        lo, hi = torch.aminmax(x.reshape(-1, C).float(), dim=0)
    mask = torch.rand(B, H, W, 1, generator=g, device=device)
    up = torch.randn(B, H, W, C, generator=g, device=device).to(dtype)
    return x, bits, lo.contiguous(), hi.contiguous(), mask, up


def _frac_run(fn, x, bits, lo, hi, mask, up):
    """fn's output and its gradients to x, the bit map and the mask."""
    xt, bt = x.clone().requires_grad_(True), bits.clone().requires_grad_(True)
    m = mask.clone().requires_grad_(True) if mask is not None else None
    out = fn(xt, bt, lo, hi, m)
    out.backward(up)
    return out.detach(), xt.grad, bt.grad, (m.grad if m is not None else None)


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("shape,mse", [
    ((64, 80, 80, 192, 10, 10), False),   # m-train-bs64's P3 (ds 1: tiles of 8 x 8)
    ((64, 40, 40, 384, 10, 10), False),   # its P4 (4 x 4)
    ((64, 20, 20, 576, 5, 5), False),     # its P5 (4 x 4)
    ((8, 40, 40, 384, 10, 10), True),     # mse's per-bit rows (7, 1)
    ((4, 16, 16, 6, 4, 4), False),        # odd C: element by element
    ((3, 12, 10, 64, 5, 3), False),       # non-multiple tile grid
])
def test_frac_quant_kernel_equals_plain(cuda, dtype, with_mask, shape, mse):
    """The kernel pair against the plain path on the card: the forward and
    grad x bitwise, grad frac and grad mask within 1e-5 relative L2 (sums
    in another order), 2 launches (forward, backward), and a second run's
    gradients bitwise the first's (no atomics)."""
    from mcaq_yolo_tpu_torch.ops import frac_quant as fq

    x, bits, lo, hi, mask, up = _frac_case(cuda, *shape, dtype, mse, seed=sum(shape))
    mask = mask if with_mask else None
    before = fq.launches()
    out, gx, gb, gm = _frac_run(fq.frac_quantize, x, bits, lo, hi, mask, up)
    torch.cuda.synchronize()
    assert fq.launches() == before + 2
    ref, rx, rb, rm = _frac_run(fq.frac_quantize_torch, x, bits, lo, hi, mask, up)
    ibits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert out.dtype == dtype and torch.equal(out.view(ibits), ref.view(ibits))
    assert gx.dtype == dtype and torch.equal(gx, rx)
    assert float(rb.abs().max()) > 0 and _rel_l2(gb, rb) <= 1e-5
    assert (gm is None) == (mask is None)
    if mask is not None:
        assert _rel_l2(gm, rm) <= 1e-5
    yx, yb, ym = fq.frac_quant_backward_torch(x, up, bits, lo, hi, mask)
    assert torch.equal(yx, gx) and _rel_l2(gb, yb) <= 1e-5
    again = _frac_run(fq.frac_quantize, x, bits, lo, hi, mask, up)
    for a, b in zip((out, gx, gb, gm), again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("H,C,Ht", [(80, 192, 10), (40, 384, 10), (20, 576, 5)])
def test_soft_mask_of_a_bf16_map_is_that_of_its_float32_copy(cuda, H, C, Ht):
    """The quantizer's training branch hands the soft mask x in bfloat16
    (it reduces |x| in float32): on the card, at the training cell's three
    maps (bs 64), the mask is bitwise that of x's float32 copy."""
    from mcaq_yolo_tpu_torch.core.quantization import LearnedSoftMask

    g = torch.Generator(device=cuda).manual_seed(H)
    x = (torch.randn(64, H, H, C, generator=g, device=cuda) * 1.5).to(torch.bfloat16)
    bits = torch.rand(64, Ht, Ht, generator=g, device=cuda) * 6.0 + 2.0
    soft_mask = LearnedSoftMask()
    soft_mask.init_weights(torch.Generator().manual_seed(0))
    soft_mask = soft_mask.to(cuda)
    assert torch.equal(soft_mask(bits, x), soft_mask(bits, x.to(torch.float32)))


@pytest.mark.gpu
def test_frac_quant_rejects_what_it_does_not_take(cuda):
    from mcaq_yolo_tpu_torch.ops import frac_quant as fq

    x, bits, lo, hi, mask, _ = _frac_case(cuda, 2, 16, 16, 64, 2, 2, torch.float32, False, 1)
    fine = dict(x=x, bit_map=bits, x_min=lo, x_max=hi, mask=mask)
    bad = [
        dict(x=x.half()),                                        # dtype
        dict(x=x.permute(0, 2, 1, 3)),                           # not contiguous
        dict(bit_map=bits.double()),                             # bit map dtype
        dict(bit_map=bits[:1]),                                  # bit map batch
        dict(x_min=lo[:32], x_max=hi[:32]),                      # range width
        dict(x_min=lo.expand(3, 64).contiguous(), x_max=hi.expand(3, 64).contiguous()),
        dict(mask=mask[:, :8]),                                  # mask shape
        dict(mask=mask.cpu()),                                   # mask device
    ]
    for change in bad:
        with pytest.raises((TypeError, ValueError)):
            fq.frac_quantize(**{**fine, **change})
    # the C entry refuses a geometry that does not fit the map, launching nothing
    out = torch.empty_like(x)
    table = torch.empty(2, 7, 64, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for vec, lanes, threads in ((4, 32, 128), (3, 1, 128), (4, 8, 256), (4, 8, 48)):
        rc = fq._FORWARD.fn()(x.data_ptr(), bits.data_ptr(), lo.data_ptr(), hi.data_ptr(), 0, 1,
                              mask.data_ptr(), table.data_ptr(), out.data_ptr(), 0, 2, 16, 16,
                              64, 2, 2, vec, lanes, threads, stream)
        assert rc != 0, (vec, lanes, threads)


@pytest.mark.gpu
def test_train_step_counts_six_frac_quant_launches(cuda, tmp_path):
    """One bf16 train step with quantize on: the three quantizers' forwards
    and backwards launch the kernels 6 times, all counted inside the step's
    root span: the backwards, which run on autograd's worker thread, in the
    'train.backward' span open on the thread that ran the forwards."""
    from mcaq_yolo_tpu_torch.data.synthetic import synthetic_batches
    from mcaq_yolo_tpu_torch.models.losses import MCAQYOLOLoss
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
    from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
    from mcaq_yolo_tpu_torch.ops import frac_quant as fq
    from mcaq_yolo_tpu_torch.train import Optimizer, make_train_step
    from mcaq_yolo_tpu_torch.utils import profiling

    batch = synthetic_batches(1, 2, 128, 4, max_boxes=8, boxes_per_image=(3, 6), seed=0)[0]
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    student = MCAQYOLO(num_classes=4, device=cuda, seed=0)
    step = make_train_step(student, MCAQYOLOLoss(4, 4.0), YOLOv8("yolov8n", 4, device=cuda),
                           amp_dtype=torch.bfloat16)
    opt = Optimizer(student, lambda s: 1e-3)

    def one_step():
        return step(opt, batch, 4.85, 6.87, 0.0, 0.0, 0.5, 1e-4, quantize=True, use_kd=True)

    one_step()  # warm-up
    before = fq.launches()
    with profiling.trace(str(tmp_path)):
        metrics = one_step()
    torch.cuda.synchronize()
    assert fq.launches() == before + 6
    root = profiling.span_summary()["by_root"]["train_step"]
    assert root["count"] == 1 and root["counters"].get("frac_quant") == 6
    backward = [r for r in profiling.span_records() if r["name"] == "train.backward"]
    assert len(backward) == 1 and backward[0]["counts"].get("frac_quant") == 3
    assert bool(torch.isfinite(metrics["loss_total"]))


# ---------------------------------------------------------------------------
# YOLO12-L on the card (models/layers.py A2C2f, ABlock, AAttn, AreaSDPA)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_yolo12l_deployed_call_against_the_reference_and_its_launches(cuda):
    """The bf16 deployed call of cell l12-serve-bs256 at its shapes (640 px,
    every width; 8 images a call), through the cell's own driver: each
    stage of its check within the cell's limits (taps, complexity and bit
    maps, the last P4 attention, raw maps, the detections exactly); a call
    launches bn_silu 141 times, the quantize and phi kernels 3 times each,
    and evaluates 16 area attentions; the layer-scale residual hands the
    taps on in the network's dtype; the attention cores run a fused SDPA
    backend (no softmax kernel of the math path), whose kernel names the
    test prints."""
    from mcaq_yolo_tpu_torch.core import morphology_lanes as ml
    from mcaq_yolo_tpu_torch.ops import bn_silu as bs
    from mcaq_yolo_tpu_torch.utils import profiling
    from perfbench import run, trace
    from perfbench.drivers import serve_batch_y12 as d

    run.cache_env()
    c = run.cell("l12-serve-bs256")
    c["traffic"].update(batch=8, pool_batches=2)
    drv = d.Driver(c["config"], c["traffic"], 20261019, cuda, lambda o: None)
    drv.setup()
    drv.window(1.0)
    x = drv.batches[0]
    model = drv.pred.model
    feats = []
    hook = model.backbone.register_forward_hook(lambda m, args, out: feats.extend(out))
    before = (bs.launches(), sq.spatial_quantize.launches, ml.phi_tiles.launches,
              profiling.counters().get("area_attention", 0))
    drv.entry(x)
    torch.cuda.synchronize()
    after = (bs.launches(), sq.spatial_quantize.launches, ml.phi_tiles.launches,
             profiling.counters().get("area_attention", 0))
    hook.remove()
    assert [a - b for a, b in zip(after, before)] == [141, 3, 3, 16]
    assert [f.dtype for f in feats] == [torch.bfloat16] * 3
    assert model.backbone.A2C2f_0.gamma.dtype == torch.float32

    with trace.Ranges({"area_sdpa": d.attention_cores(model)[0]}):
        tr = trace.profile(lambda: drv.entry(x))
    names = sorted({k.name for k in tr.kernels if "area_sdpa" in k.ranges})
    print("SDPA kernels:", names)
    assert names and any(s in n.lower() for n in names for s in ("flash", "fmha", "efficient"))
    assert not any("softmax" in n.lower() for n in names)

    drv.release()
    numbers = drv.check()
    over = {k: numbers[k] for k, lim in c["limits"].items()
            if not k.startswith("_") and numbers[k] > lim}
    assert not over, numbers
    assert int(drv.picked["out"][3].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("H", [40, 20])
def test_307_wide_conv_bn_silu_through_the_kernel_is_bitwise(cuda, monkeypatch, H):
    """YOLO12-L's ABlock MLP at bs 8: the 1x1 ConvBnSiLU from 256 to 307
    channels (a width the kernel's 16-byte groups do not fit: its element
    path), bf16 on channels-last maps, bitwise the same module without the
    kernel, in one launch."""
    from mcaq_yolo_tpu_torch.models.layers import ConvBnSiLU
    from mcaq_yolo_tpu_torch.ops import bn_silu as bs

    g = torch.Generator().manual_seed(H)
    m = ConvBnSiLU(256, 307, 1)
    with torch.no_grad():
        m.Conv_0.weight.normal_(0, 0.1, generator=g)
        bn = m.BatchNorm_0
        bn.weight.uniform_(0.5, 1.5, generator=g), bn.bias.normal_(0, 1, generator=g)
        bn.running_mean.normal_(0, 1, generator=g), bn.running_var.uniform_(0.05, 2, generator=g)
    m.Conv_0.to(dtype=torch.bfloat16)
    m.to(device=cuda, memory_format=torch.channels_last)
    x = (torch.randn(8, 256, H, H, generator=g) * 3).to(device=cuda, dtype=torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        before = bs.launches()
        out = m(x)
        torch.cuda.synchronize()
        assert bs.launches() == before + 1
        monkeypatch.setattr(bs, "takes", lambda x, bn: False)
        plain = m(x)
    assert out.shape[1] == 307 and out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out.view(torch.int16), plain.view(torch.int16))
