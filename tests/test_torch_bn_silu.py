"""Eval BatchNorm + SiLU in one pass: the kernel `csrc/bn_silu.cu`, its
wrapper and plain version `ops/bn_silu.py`, and the path
`models/layers.py:ConvBnSiLU` takes in eval on the card.

On the CPU: ConvBnSiLU's output is bitwise what `F.batch_norm` then
`F.silu` give (the CPU never takes the kernel), in bfloat16 and float32, in
eval and in training; the plain version is that composition, bitwise; the
kernel's arithmetic, written out in PyTorch (`_kernel_arithmetic`), rounds
a BatchNorm output within one ulp of the CPU's `F.batch_norm` (the bound is
`_assert_within_one_ulp`'s) on maps of YOLOv8m's widths and applies the
same SiLU to it; the op's fake implementation leaves the map's shape, dtype
and channels-last strides under `torch.export` on meta tensors, one node a
call; the build compiles the kernel with `--fmad=false`; the kernel's
indexing, mirrored, covers every 16-byte group once and gives each its
channels; the wrapper's check refuses exactly what the kernel cannot take;
`needs_grad` decides the route as documented; and where the kernel takes
the convolution output, every ConvBnSiLU of YOLOv8n (57) and YOLOv8m (77)
goes through the op in eval and none in training.

On the card (`gpu`; each skips without CUDA; this file imports neither jax
nor the JAX package, so on a GPU host without JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_bn_silu.py

the kernel is bitwise its plain version, `F.batch_norm` (ATen's
channels-last kernel, cuDNN off) + `F.silu`, in bfloat16 and float32 at
every ConvBnSiLU shape of YOLOv8n and YOLOv8m at bs 2 and 640 px and at
the bs-256 P3 shape, and element by element at widths no 16-byte group
fits; within one ulp of the library's default (cuDNN's float32 BatchNorm);
and on NCHW maps (PyTorch's own convolution's, cuDNN off);
it refuses another dtype, layout, device or width and a misaligned map,
launching nothing; an input that requires grad (or whose BatchNorm
parameters do, with grad on) takes the old path; the counter `bn_silu`
equals the module count over one deployed call and one train step (the
float32 teacher's); the exported program carries one node a module and
launches it; the deployed program's outputs on `chip_smoke.py`'s serving
images are bitwise what they are without the kernel."""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mcaq_yolo_tpu_torch.ops import bn_silu as bs
from mcaq_yolo_tpu_torch.ops import conv_f32

REPO = Path(__file__).resolve().parents[1]
EPS = 1e-3                                # BN_EPS of models/layers.py
M_WIDTHS = (48, 96, 192, 288, 384, 576)   # YOLOv8m's ConvBnSiLU widths but the head's 64
MODULES = {"yolov8n": 57, "yolov8m": 77}  # ConvBnSiLU modules a forward


def _bn_params(C, seed, device="cpu"):
    """weight, bias, running_mean, running_var of a trained-looking BatchNorm."""
    g = torch.Generator().manual_seed(seed)
    w = torch.rand(C, generator=g) + 0.5
    b = torch.randn(C, generator=g)
    m = torch.randn(C, generator=g)
    v = torch.rand(C, generator=g) * 2.0 + 0.05
    return [t.to(device) for t in (w, b, m, v)]


def _map(shape, dtype, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 3.0
    return x.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _kernel_arithmetic(x, w, b, m, v):
    """(BatchNorm output z, SiLU output y) as csrc/bn_silu.cu computes them,
    in PyTorch: inv = rsqrt(v + eps) (the card's approximate rsqrt; on the
    CPU torch.rsqrt is exact), t = fma(w (x - m), inv, b) (the fused
    multiply-add in float64, exact up to a double rounding, rare and of one
    float32 ulp), z = t rounded to x's dtype, y = F.silu(z)."""
    inv = torch.rsqrt(v + EPS)[:, None, None].double()
    p = w[:, None, None] * (x.float() - m[:, None, None])
    z = (p.double() * inv + b[:, None, None].double()).float().to(x.dtype)
    return z, F.silu(z)


def _assert_within_one_ulp(new, old, x, w, b, m, v):
    """|new - old| <= one ulp of the output dtype at max(|old|, |z|), z the
    BatchNorm's output in float32, plus 8 float32 epsilons of the affine's
    terms |x a| + |mean a| + |bias|, a = w / sqrt(v + eps).  Two sides that
    compute the affine in float32 in another form (the kernel's
    fma(w (x - mean), invstd, bias), the CPU's x a + (bias - mean a),
    cuDNN's own) differ, where z cancels to near 0, by float32 roundings of
    those terms, not by ulps of z; elsewhere by the one rounding to the
    output dtype."""
    a = w / torch.sqrt(v + EPS)
    a, b, m = a[:, None, None], b[:, None, None], m[:, None, None]
    xf = x.float()
    z = xf * a + (b - m * a)
    mant = 7 if new.dtype == torch.bfloat16 else 23
    tiny = torch.finfo(new.dtype).tiny
    scale = torch.maximum(old.float().abs(), z.abs()).clamp(min=tiny)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - mant)
    tol = ulp + 2.0 ** -20 * ((xf * a).abs() + (m * a).abs() + b.abs())
    gap = (new.float() - old.float()).abs()
    worst = float((gap / tol).max())
    assert worst <= 1.0, f"gap {worst:.3g} x its bound"


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("training,grad", [(False, False), (False, True), (True, True)])
def test_conv_bn_silu_on_the_cpu_is_batch_norm_then_silu(dtype, training, grad):
    """The forward the layer had before the kernel: F.silu(BatchNorm(Conv(x)))."""
    from mcaq_yolo_tpu_torch.models.layers import ConvBnSiLU

    layer = ConvBnSiLU(32, 48, 3)
    w, b, m, v = _bn_params(48, seed=1)
    with torch.no_grad():
        layer.BatchNorm_0.weight.copy_(w)
        layer.BatchNorm_0.bias.copy_(b)
        layer.BatchNorm_0.running_mean.copy_(m)
        layer.BatchNorm_0.running_var.copy_(v)
    layer.Conv_0.to(dtype)
    layer.to(memory_format=torch.channels_last)
    twin = copy.deepcopy(layer)
    x = _map((2, 32, 16, 16), dtype, seed=2)
    with torch.set_grad_enabled(grad):
        out = layer(x, training)
        ref = F.silu(twin.BatchNorm_0(twin.Conv_0(x), training))
    assert out.dtype == dtype and out.stride() == ref.stride()
    assert torch.equal(_bits(out), _bits(ref))
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(layer.BatchNorm_0, name), getattr(twin.BatchNorm_0, name))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_composition_within_one_ulp_of_batch_norm_and_silu(dtype):
    """The plain version is F.batch_norm + F.silu, bitwise; the kernel's
    arithmetic gives a BatchNorm output within one ulp of the CPU's
    F.batch_norm (the affine in another float32 form) and F.silu of it."""
    for C in M_WIDTHS:
        w, b, m, v = _bn_params(C, seed=C)
        x = _map((2, C, 16, 16), dtype, seed=C + 1)
        plain = bs.bn_silu_torch(x, w, b, m, v, EPS)
        z_old = F.batch_norm(x, m, v, w, b, False, 0.0, EPS)
        old = F.silu(z_old)
        assert plain.dtype == dtype and plain.stride() == x.stride()
        assert torch.equal(_bits(plain), _bits(old))
        z, y = _kernel_arithmetic(x, w, b, m, v)
        _assert_within_one_ulp(z, z_old, x, w, b, m, v)
        assert torch.equal(_bits(y[z == z_old]), _bits(old[z == z_old]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fake_keeps_the_map_under_export_on_meta(dtype):
    from mcaq_yolo_tpu_torch.export import count_bn_silu_nodes

    class ConvThenBnSilu(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(8, 24, 3, padding=1, bias=False)
            self.bn = torch.nn.BatchNorm2d(24, eps=EPS)

        def forward(self, x):
            y = self.conv(x).contiguous(memory_format=torch.channels_last)
            return bs.bn_silu_(y, self.bn)

    mod = ConvThenBnSilu().eval()
    mod.conv.to(dtype)
    mod = mod.to("meta").to(memory_format=torch.channels_last)
    x = torch.empty((2, 8, 6, 10), dtype=dtype,
                    device="meta").contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        ep = torch.export.export(mod, (x,))
    assert count_bn_silu_nodes(ep) == 1
    (node,) = [n for n in ep.graph.nodes if n.target is torch.ops.mcaq.bn_silu.default]
    val = node.args[0].meta["val"]
    assert val.shape == (2, 24, 6, 10) and val.dtype == dtype
    assert val.stride() == (24 * 60, 1, 24 * 10, 24)  # channels-last
    (out,) = [n for n in ep.graph.nodes if n.op == "output"][0].args[0]
    assert out.meta["val"].shape == val.shape and out.meta["val"].stride() == val.stride()


def test_kernel_is_built_without_fma_contraction():
    from mcaq_yolo_tpu_torch.ops import build

    assert "bn_silu" in build.KERNELS
    assert "--fmad=false" in build.KERNEL_FLAGS["bn_silu"]
    assert "--fmad=false" in build.nvcc_flags("bn_silu")
    assert build._source_and_flags("bn_silu")[0].name == "bn_silu.cu"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [16, 24, 48, 80, 192, 288, 576, 2056])
@pytest.mark.parametrize("pixels", [1, 37, 6400])
def test_kernel_indexing_keeps_each_group_on_its_channels(dtype, C, pixels):
    """The kernel's indexing mirrored: block k's thread t takes the 16-byte
    groups k * TILE + r * THREADS + t (r < UNROLL), which cover the map once,
    and keeps their channel group by additions from
    (k % G * (TILE % G) + t % G) % G, which must be g % G for each."""
    vec = bs._VEC[dtype]
    G = C // vec
    groups = pixels * G
    tile = bs.THREADS * bs.UNROLL
    k = np.arange(-(-groups // tile))[:, None]
    t = np.arange(bs.THREADS)[None, :]
    c = ((k % G) * (tile % G) + t % G) % G
    seen = np.zeros(groups, np.int64)
    for r in range(bs.UNROLL):
        g = k * tile + r * bs.THREADS + t
        inside = g < groups
        assert (c[inside] == g[inside] % G).all()
        np.add.at(seen, g[inside], 1)
        c = c + bs.THREADS % G
        c = np.where(c >= G, c - G, c)
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype,C,layout,refusal", [
    (torch.bfloat16, 16, "channels_last", None),
    (torch.bfloat16, 576, "channels_last", None),
    (torch.float32, 12, "channels_last", None),
    (torch.bfloat16, 12, "channels_last", None),    # not whole groups of 8
    (torch.bfloat16, 85, "channels_last", None),    # a head of 85 classes
    (torch.float32, 6, "channels_last", None),
    (torch.bfloat16, 16, "nchw", None),             # PyTorch's own convolution's
    (torch.bfloat16, bs.MAX_CHANNELS + 8, "channels_last", ValueError),
    (torch.bfloat16, 16, "strided", ValueError),
    (torch.float16, 16, "channels_last", TypeError),
])
def test_check_refuses_only_what_the_kernel_cannot_take(dtype, C, layout, refusal):
    """Any width up to MAX_CHANNELS, in contiguous channels-last or NCHW
    memory, is taken (whole 16-byte groups, or element by element); another
    dtype, layout or a wider map raises.  The CPU never takes the kernel: it
    keeps F.batch_norm + F.silu."""
    x = torch.zeros((2, C, 3, 5), dtype=dtype)
    x = {"channels_last": x.contiguous(memory_format=torch.channels_last), "nchw": x,
         "strided": x.transpose(2, 3)}[layout]
    params = _bn_params(C, seed=0)
    if refusal is None:
        assert bs._check(x, *params) == C
        assert bs._plane(x) == (15 if layout == "nchw" else 1)
    else:
        with pytest.raises(refusal):
            bs._check(x, *params)
    assert not bs.takes(x, torch.nn.BatchNorm2d(C))


def test_needs_grad_where_autograd_would_record_the_epilogue():
    bn = torch.nn.BatchNorm2d(8).eval()
    x = torch.zeros((1, 8, 2, 2)).contiguous(memory_format=torch.channels_last)
    assert bs.needs_grad(x, bn)                      # the affine parameters require grad
    assert bs.needs_grad(x.requires_grad_(), bn.requires_grad_(False))
    x = x.detach()
    assert not bs.needs_grad(x, bn)                  # nothing to differentiate
    bn.bias.requires_grad_(True)
    assert bs.needs_grad(x, bn)
    with torch.no_grad():
        assert not bs.needs_grad(x, bn)
    with torch.inference_mode():
        assert not bs.needs_grad(x, bn)


@pytest.mark.parametrize("variant", ["yolov8n", "yolov8m"])
def test_every_conv_bn_silu_goes_through_the_op_where_the_kernel_takes_it(monkeypatch,
                                                                         variant):
    """With `takes` true (as on the card), an eval forward sends each
    ConvBnSiLU through the op (its plain version here) and a training
    forward none; the modules counted are those the counter `bn_silu` reads
    a deployed call in n-serve-bs256 (57) and m-serve-bs256 (77)."""
    from mcaq_yolo_tpu_torch.models.layers import ConvBnSiLU
    from mcaq_yolo_tpu_torch.models.yolo import YOLOv8

    calls = []
    real = bs.bn_silu_

    def counted(x, bn):
        calls.append(x.shape)
        return real(x, bn)

    monkeypatch.setattr(bs, "takes", lambda x, bn: True)
    monkeypatch.setattr(bs, "bn_silu_", counted)
    model = YOLOv8(variant, 80, device="cpu", seed=0)
    assert sum(isinstance(m, ConvBnSiLU) for m in model.modules()) == MODULES[variant]
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3),
                                                           dtype=np.uint8))
    with torch.no_grad():
        model(x)
    assert len(calls) == MODULES[variant]
    assert [tuple(c) for c in calls] == _chip_smoke().conv_bn_silu_shapes(variant, 1, 64)
    calls.clear()
    model(x, training=True)
    assert calls == []


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the GPU")
    return torch.device("cuda")


def _run_kernel(x, params):
    out = x.clone()  # its layout kept
    torch.ops.mcaq.bn_silu(out, *params, EPS)
    return out


def _plain(x, params):
    """F.batch_norm + F.silu with ATen's channels-last BatchNorm kernel (cuDNN
    off: it takes float32 maps otherwise)."""
    with torch.backends.cudnn.flags(enabled=False):
        return bs.bn_silu_torch(x, *params, EPS)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant,batch", [("yolov8n", 2), ("yolov8m", 2),
                                           ("yolov8n", 256), ("yolov8m", 256)])
def test_kernel_bitwise_equals_plain(cuda, dtype, variant, batch):
    """Every distinct ConvBnSiLU shape at 640 px (bs 2), or the widest 80 x 80
    (P3) map at bs 256, the serving cells' batch."""
    shapes = sorted(set(_chip_smoke().conv_bn_silu_shapes(variant, batch, 640)))
    if batch == 256:
        shapes = [s for s in shapes if s[2:] == (80, 80)][-1:]
    for k, shape in enumerate(shapes):
        params = _bn_params(shape[1], seed=k, device=cuda)
        x = _map(shape, dtype, seed=k + 100, device=cuda)
        before = bs.launches()
        out = _run_kernel(x, params)
        ref = _plain(x, params)
        torch.cuda.synchronize()
        assert bs.launches() == before + 1
        assert out.stride() == x.stride() and bool(torch.isfinite(out).all())
        assert torch.equal(_bits(out), _bits(ref)), f"{shape} {dtype}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,C,shape,nchw", [
    (torch.bfloat16, 85, (2, 85, 80, 80), False),   # a YOLOv8n head of 85 classes
    (torch.bfloat16, 12, (3, 12, 7, 5), False),
    (torch.float32, 6, (2, 6, 40, 40), False),
    (torch.float32, 85, (2, 85, 20, 20), False),
    (torch.bfloat16, 64, (2, 64, 40, 40), True),    # cuDNN off: NCHW convolution outputs
    (torch.float32, 85, (2, 85, 20, 20), True),
])
def test_kernel_runs_element_by_element_where_no_group_fits(cuda, dtype, C, shape, nchw):
    """Widths no 16-byte group fits, and NCHW maps, bitwise the plain
    version (ATen's BatchNorm for that layout)."""
    params = _bn_params(C, seed=C, device=cuda)
    x = _map(shape, dtype, seed=C + 2, device=cuda)
    if nchw:
        x = x.contiguous()
    before = bs.launches()
    out = _run_kernel(x, params)
    ref = _plain(x, params)
    torch.cuda.synchronize()
    assert bs.launches() == before + 1 and out.stride() == x.stride()
    assert torch.equal(_bits(out), _bits(ref))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_within_one_ulp_of_batch_norm_and_silu(cuda, dtype):
    """Against the library's default: cuDNN's BatchNorm where it takes the
    map (float32), ATen's channels-last kernel otherwise."""
    for C in M_WIDTHS + (64, 80, 256):
        w, b, m, v = params = _bn_params(C, seed=C, device=cuda)
        x = _map((4, C, 40, 40), dtype, seed=C + 1, device=cuda)
        new = _run_kernel(x, params)
        old = F.silu(F.batch_norm(x, m, v, w, b, False, 0.0, EPS))
        _assert_within_one_ulp(new, old, x, w, b, m, v)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    params = _bn_params(16, seed=3, device=cuda)
    x = _map((2, 16, 8, 8), torch.bfloat16, seed=4, device=cuda)
    before = bs.launches()
    with pytest.raises(TypeError):
        _run_kernel(x.half(), params)
    with pytest.raises(ValueError, match="channels-last or NCHW"):
        torch.ops.mcaq.bn_silu(x.transpose(2, 3), *params, EPS)
    with pytest.raises(ValueError, match="weight on"):
        torch.ops.mcaq.bn_silu(x, params[0].cpu(), *params[1:], EPS)
    C = bs.MAX_CHANNELS + 8
    wide = _map((1, C, 2, 2), torch.bfloat16, seed=5, device=cuda)
    with pytest.raises(ValueError, match="channels"):
        _run_kernel(wide, _bn_params(C, seed=6, device=cuda))
    # contiguous channels-last strides, one element off a 16-byte boundary
    flat = torch.empty(2 * 8 * 8 * 16 + 1, device=cuda)[1:]
    shifted = flat.view(2, 8, 8, 16).permute(0, 3, 1, 2)
    shifted.copy_(x.float())
    assert shifted.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="aligned"):
        torch.ops.mcaq.bn_silu(shifted, *params, EPS)
    torch.cuda.synchronize()
    assert bs.launches() == before


@pytest.mark.gpu
def test_input_that_requires_grad_takes_the_old_path(cuda):
    from mcaq_yolo_tpu_torch.models.layers import ConvBnSiLU

    layer = ConvBnSiLU(16, 32, 3).to(cuda, memory_format=torch.channels_last).eval()
    x = _map((2, 16, 24, 24), torch.float32, seed=7, device=cuda)
    ref = F.silu(layer.BatchNorm_0(layer.Conv_0(x)))
    before = bs.launches()
    out = layer(x)
    assert out.requires_grad and bs.launches() == before
    assert torch.equal(out, ref)
    out.sum().backward()
    assert layer.Conv_0.weight.grad is not None
    with torch.no_grad():
        fused = layer(x)
    assert bs.launches() == before + 1
    layer.requires_grad_(False)  # grad on, nothing to differentiate
    assert torch.equal(layer(x), fused) and bs.launches() == before + 2
    # without gradient a float32 convolution on the card is csrc/conv_f32.py's
    # (ops/conv_f32.py), so the epilogue is held on that convolution's output
    conv = conv_f32.conv2d(x, layer.Conv_0).detach()
    _assert_within_one_ulp(fused, F.silu(layer.BatchNorm_0(conv)), conv,
                           *[t.detach() for t in (layer.BatchNorm_0.weight,
                                                  layer.BatchNorm_0.bias,
                                                  layer.BatchNorm_0.running_mean,
                                                  layer.BatchNorm_0.running_var)])


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


@pytest.mark.gpu
def test_counter_equals_the_module_count_over_a_call_and_a_train_step(cuda):
    from mcaq_yolo_tpu_torch.data.synthetic import synthetic_batches
    from mcaq_yolo_tpu_torch.inference import deployed_program
    from mcaq_yolo_tpu_torch.models.layers import ConvBnSiLU
    from mcaq_yolo_tpu_torch.models.losses import MCAQYOLOLoss
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
    from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
    from mcaq_yolo_tpu_torch.train import Optimizer, make_train_step

    def modules(m):
        return sum(isinstance(x, ConvBnSiLU) for x in m.modules())

    model = MCAQYOLO(num_classes=80, morph_downsample=2, dtype=torch.bfloat16, device=cuda)
    x = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, 256, 256, 3),
                                                           dtype=np.uint8)).to(cuda)
    assert modules(model) == MODULES["yolov8n"]
    for _ in range(2):
        before = bs.launches()
        with torch.inference_mode():
            deployed_program(model, x, 80)
        assert bs.launches() - before == MODULES["yolov8n"]

    batch = synthetic_batches(1, 2, 128, 4, max_boxes=8, boxes_per_image=(3, 6), seed=0)[0]
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    student = MCAQYOLO(num_classes=4, device=cuda, seed=0)
    teacher = YOLOv8("yolov8n", 4, device=cuda)
    step = make_train_step(student, MCAQYOLOLoss(4, 4.0), teacher, amp_dtype=torch.bfloat16)
    opt = Optimizer(student, lambda s: 1e-3)
    for _ in range(2):
        before = bs.launches()
        step(opt, batch, 4.85, 6.87, 0.0, 0.0, 0.5, 1e-4, quantize=True, use_kd=True)
        assert bs.launches() - before == modules(teacher)


@pytest.mark.gpu
def test_exported_program_carries_one_node_a_module(cuda, tmp_path):
    from mcaq_yolo_tpu_torch.export import (count_bn_silu_nodes, count_phi_nodes,
                                            count_quant_nodes, load_exported, save_exported)
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO

    model = MCAQYOLO(num_classes=80, morph_downsample=2, dtype=torch.bfloat16, device=cuda)
    paths = save_exported(model, tmp_path, batch_size=2, img_size=128)
    ep = torch.export.load(paths["serialized"])
    assert count_bn_silu_nodes(ep) == MODULES["yolov8n"]
    assert count_quant_nodes(ep) == 3 and count_phi_nodes(ep) == 3
    x = torch.rand((2, 128, 128, 3), device=cuda)
    program = load_exported(paths["serialized"])
    before = bs.launches()
    with torch.no_grad():
        out = program(x)
        torch.cuda.synchronize()
        assert bs.launches() - before == MODULES["yolov8n"]
        from mcaq_yolo_tpu_torch.export import make_inference_fn

        eager = make_inference_fn(model)(x)
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_deployed_detections_unchanged_on_the_serving_images(cuda, monkeypatch):
    """chip_smoke.py's seeded, spread YOLOv8n on its first 8 serving images
    (640 px, bf16): every output of the deployed program (raw maps through
    NMS: boxes, scores, classes, counts) is bitwise what it is with each
    ConvBnSiLU on F.batch_norm + F.silu, the path without the kernel."""
    from mcaq_yolo_tpu_torch.data.dataset import letterbox
    from mcaq_yolo_tpu_torch.inference import deployed_program

    cs = _chip_smoke()
    model = cs.seeded_model(cuda, torch.bfloat16)
    x = torch.from_numpy(np.stack([letterbox(im, cs.IMG)[0] for im in
                                   cs.serving_images(seed=1, count=1)])).to(cuda)

    def detect():
        with torch.inference_mode():
            return [t.clone() for t in deployed_program(model, x, 80, conf_threshold=0.25,
                                                        iou_threshold=0.45, max_det=300)]

    before = bs.launches()
    kernel = detect()
    assert bs.launches() - before == MODULES["yolov8n"]
    monkeypatch.setattr(bs, "takes", lambda x, bn: False)
    before = bs.launches()
    unfused = detect()
    assert bs.launches() == before
    assert int(kernel[3].sum()) > 0  # detections to compare
    for a, b in zip(kernel, unfused):
        assert torch.equal(a, b)
