"""Float32 convolution at float32 accuracy on the tensor cores: the Triton
kernel `csrc/conv_f32.py`, its wrapper, tile rule and plain version
`ops/conv_f32.py`, and the path `models/layers.py:ConvBnSiLU` takes.

On the CPU: the 35 convolution shapes of YOLOv8m's 77 ConvBnSiLU are those
`chip_smoke.conv_bn_silu_convs` traces; at each, at a small batch and size,
the plain version (three float32 convolutions of TF32-split operands) is as
close to a float64 `F.conv2d` as float32's own `F.conv2d` (within 2x) and
at least 100x closer than TF32's; the split rounds to TF32 to nearest, ties
away, and hi + lo keeps ~22 bits; a weight changed between two calls,
through `.data` too, is read anew; the kernel's loop, mirrored in float64 on
the tensors' storages (`_kernel_loop`), is the convolution on the stem's
flattened K, ragged channels and outputs, channel slices, strides and
padding, and reads only elements of the map and the weight; the tile rule
wastes no step of K but the stem's, gives few configurations and leaves
N's waste at most 25%; the wrapper's check copies what has no channel
stride 1 and refuses what the kernel cannot take; the gate sends bf16,
autocast, grad-needing, grouped and CPU inputs to `Conv_0`; a traced
program records one `mcaq::conv_f32` node a call, with the map's shape and
channels-last strides, and runs the plain version on the CPU; and
where the gate takes a float32 network, every one of YOLOv8m's 77
ConvBnSiLU convolutions goes through the kernel's entry.

On the card (`gpu`; each skips without CUDA; this file imports neither jax
nor the JAX package, so on a GPU host without JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_conv_f32.py

at every teacher shape the kernel's output is channels-last, within 2x of
cuDNN float32's gap to float64 (TF32 off) and at least 100x below cuDNN
TF32's, and close to the plain version; the same over a whole YOLOv8m
teacher forward (raw maps: the 2x alone, and both without the head's
output biases; C3/C4/C5 features); a teacher forward counts
77 launches of `conv_f32` (and still 77 of `bn_silu`), a bf16 forward none;
and a launch the card refuses raises and counts nothing."""

import copy
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mcaq_yolo_tpu_torch.ops import conv_f32 as cf

REPO = Path(__file__).resolve().parents[1]

# (Cin, Cout, kernel, stride, padding, H = W at 640 px): count, YOLOv8m's
# 77 ConvBnSiLU convolutions in 35 shapes
TEACHER_CONVS = {
    (3, 48, 3, 2, 1, 640): 1, (48, 48, 3, 1, 1, 160): 4, (48, 96, 3, 2, 1, 320): 1,
    (64, 64, 3, 1, 1, 20): 1, (64, 64, 3, 1, 1, 40): 1, (64, 64, 3, 1, 1, 80): 1,
    (96, 96, 3, 1, 1, 80): 12, (96, 96, 1, 1, 0, 160): 1, (96, 192, 3, 2, 1, 160): 1,
    (192, 192, 3, 1, 1, 20): 1, (192, 192, 3, 1, 1, 40): 17, (192, 64, 3, 1, 1, 80): 1,
    (192, 192, 1, 1, 0, 80): 1, (192, 192, 3, 1, 1, 80): 2, (192, 192, 3, 2, 1, 80): 1,
    (192, 384, 3, 2, 1, 80): 1, (192, 96, 1, 1, 0, 160): 1, (288, 288, 3, 1, 1, 20): 8,
    (384, 64, 3, 1, 1, 40): 1, (384, 192, 3, 1, 1, 40): 1, (384, 384, 1, 1, 0, 40): 1,
    (384, 384, 3, 2, 1, 40): 1, (384, 576, 3, 2, 1, 40): 1, (384, 192, 1, 1, 0, 80): 1,
    (576, 64, 3, 1, 1, 20): 1, (576, 192, 3, 1, 1, 20): 1, (576, 288, 1, 1, 0, 20): 1,
    (576, 576, 1, 1, 0, 20): 1, (576, 384, 1, 1, 0, 40): 1, (576, 192, 1, 1, 0, 80): 2,
    (768, 384, 1, 1, 0, 40): 2, (960, 576, 1, 1, 0, 20): 1, (960, 384, 1, 1, 0, 40): 1,
    (1152, 576, 1, 1, 0, 20): 3, (1152, 384, 1, 1, 0, 40): 1,
}
SHAPES = sorted(TEACHER_CONVS)


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def _operands(cin, cout, k, size, batch=2, seed=0, device="cpu"):
    """A channels-last map of normal values and a weight of fan-in scale."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, cin, size, size, generator=g)
    w = torch.randn(cout, cin, k, k, generator=g) / (cin * k * k) ** 0.5
    return (x.to(device).contiguous(memory_format=torch.channels_last),
            w.to(device).contiguous(memory_format=torch.channels_last))


def _rel(a, ref):
    return float((a.double() - ref).norm() / ref.norm())


def test_teacher_shapes_are_yolov8ms_convolutions():
    convs = _chip_smoke().conv_bn_silu_convs("yolov8m", 1, 640)
    got = Counter((c[1], c[4], c[5], c[6], c[7], c[2]) for c in convs)
    assert dict(got) == TEACHER_CONVS
    assert sum(got.values()) == 77 and all(c[2] == c[3] for c in convs)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_is_float32_accurate_at_every_teacher_shape(shape):
    """At a batch of 2 and 12 output pixels a side (the stride-2 ones from
    24), with the shape's channels, kernel, stride and padding."""
    cin, cout, k, s, p, _ = shape
    x, w = _operands(cin, cout, k, 12 * s, seed=cin + cout + k + s)
    ref = F.conv2d(x.double(), w.double(), None, s, p)
    plain = cf.conv_f32_torch(x, w, (s, s), (p, p))
    assert plain.dtype == torch.float32 and plain.shape == ref.shape
    assert plain.is_contiguous(memory_format=torch.channels_last)
    f32 = _rel(F.conv2d(x, w, None, s, p), ref)
    tf32 = _rel(F.conv2d(cf.split_tf32(x)[0], cf.split_tf32(w)[0], None, s, p), ref)
    gap = _rel(plain, ref)
    assert gap <= 2 * f32, (gap, f32)
    assert tf32 >= 100 * gap, (tf32, gap)
    assert torch.equal(cf.conv_f32(x, w, (s, s), (p, p)), plain)  # the CPU's route


def test_split_rounds_to_nearest_tf32_ties_away():
    def f(bits):
        return torch.tensor(bits, dtype=torch.int32).view(torch.float32)

    one = 0x3F800000
    x = f([one + 0x0FFF, one + 0x1000, one + 0x1001, one + 0x3000, -(2 ** 31) + one + 0x1000])
    hi, lo = cf.split_tf32(x)
    assert hi.view(torch.int32).tolist() == [one, one + 0x2000, one + 0x2000, one + 0x4000,
                                             -(2 ** 31) + one + 0x2000]
    exact = hi + lo == x  # where x - hi fits TF32's 11 bits: the ties
    assert exact.tolist() == [False, True, False, True, True]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(100_000, generator=g) * torch.exp(torch.randn(100_000, generator=g) * 8)
    hi, lo = cf.split_tf32(x)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()  # 10 mantissa bits
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((x.double() - hi.double() - lo.double()).abs() <= x.abs().double() * 2.0 ** -21).all()


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("how", ["data_copy", "in_place", "data_assign"])
def test_a_changed_weight_is_read_anew(device, how):
    """A weight changed between two calls, in ways that leave its version
    (`.data` writes, as a broadcast or an unshard makes) or its address as
    they were, gives the convolution by its new values."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the GPU")
    x, w = _operands(16, 8, 3, 6, device=device)
    conv = torch.nn.Conv2d(16, 8, 3, 1, 1, bias=False).to(device)
    conv = conv.to(memory_format=torch.channels_last)
    with torch.no_grad():
        conv.weight.copy_(w)
    first = cf.conv2d(x, conv)
    new = (-2.0 * w).contiguous(memory_format=torch.channels_last)
    if how == "data_copy":
        conv.weight.data.copy_(new)
    elif how == "in_place":
        with torch.no_grad():
            conv.weight.mul_(-2.0)
    else:
        conv.weight.data = new.clone()
    got = cf.conv2d(x, conv)
    assert torch.equal(got, cf.conv_f32(x, new, (1, 1), (1, 1)))
    assert torch.equal(got, -2.0 * first)


def _storage(t):
    """t's whole storage as a flat float64 tensor."""
    return torch.empty(0, dtype=t.dtype).set_(t.untyped_storage()).double()


def _kernel_loop(x, w, stride, padding, tiles):
    """csrc/conv_f32.py's loop in float64, every output pixel at once: its
    pixel decomposition, K steps, taps, masks and pointer arithmetic on the
    storages.  Returns (y as (N, Cout, Ho, Wo), whether every unmasked
    address lay inside the tensor's own elements)."""
    N, Cin, H, W = x.shape
    Cout, _, KH, KW = w.shape
    (sh, sw), (ph, pw) = stride, padding
    Ho, Wo = cf.out_size(H, KH, sh, ph), cf.out_size(W, KW, sw, pw)
    xs, ws = _storage(x), _storage(w)
    sxb, sxh, sxw, swn = x.stride(0), x.stride(2), x.stride(3), w.stride(0)
    M = N * Ho * Wo
    m = torch.arange(M)
    ow, t = m % Wo, m // Wo
    oh = t % Ho
    ih0, iw0 = oh * sh - ph, ow * sw - pw
    x_rows = x.storage_offset() + (t // Ho) * sxb
    n = torch.arange(-(-Cout // tiles.bn) * tiles.bn)
    n_ok = n < Cout
    w_cols = w.storage_offset() + n * swn
    offs_k = torch.arange(tiles.bk)
    x_span = (x.storage_offset(), x.storage_offset() + sum((d - 1) * st for d, st in
                                                           zip(x.shape, x.stride())))
    w_span = (w.storage_offset(), w.storage_offset() + w.numel() - 1)
    inside = True

    def gather(flat, addr, ok, span):
        nonlocal inside
        inside &= bool(((addr[ok] >= span[0]) & (addr[ok] <= span[1])).all())
        return torch.where(ok, flat[addr.clamp(0, flat.numel() - 1)], 0.0)

    acc = torch.zeros(M, n.numel(), dtype=torch.float64)
    if tiles.flat:
        K = KH * KW * Cin
        for k0 in range(0, K, tiles.bk):
            k = k0 + offs_k
            k_ok = k < K
            rs = k // Cin
            c = k - rs * Cin
            r = rs // KW
            ih, iw = ih0[:, None] + r[None, :], iw0[:, None] + (rs - r * KW)[None, :]
            a_ok = k_ok[None, :] & (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
            a = gather(xs, x_rows[:, None] + ih * sxh + iw * sxw + c[None, :], a_ok, x_span)
            b = gather(ws, w_cols[None, :] + k[:, None], k_ok[:, None] & n_ok[None, :],
                       w_span)
            acc += a @ b
    else:
        c_steps = -(-Cin // tiles.bk)
        for kk in range(KH * KW * c_steps):
            rs = kk // c_steps
            c = (kk - rs * c_steps) * tiles.bk + offs_k
            r = rs // KW
            ih, iw = ih0 + r, iw0 + (rs - r * KW)
            row_ok = (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
            c_ok = c < Cin
            a = gather(xs, (x_rows + ih * sxh + iw * sxw)[:, None] + c[None, :],
                       row_ok[:, None] & c_ok[None, :], x_span)
            b = gather(ws, w_cols[None, :] + (rs * Cin + c)[:, None],
                       c_ok[:, None] & n_ok[None, :], w_span)
            acc += a @ b
    y = acc[:, :Cout].reshape(N, Ho, Wo, Cout).permute(0, 3, 1, 2)
    return y, inside


@pytest.mark.parametrize("cin,cout,k,size,stride,padding,view", [
    (3, 48, 3, 17, (2, 2), (1, 1), "map"),      # the stem: K flattened over the taps
    (48, 48, 3, 9, (1, 1), (1, 1), "map"),      # one tap a step, BN 64 > Cout
    (40, 24, 3, 9, (1, 1), (1, 1), "map"),      # ragged channels and outputs
    (96, 192, 3, 10, (2, 2), (1, 1), "map"),    # stride 2, even size
    (96, 96, 1, 7, (1, 1), (0, 0), "slice"),    # C2f's channel slice
    (32, 128, 3, 8, (2, 1), (1, 0), "map"),     # unequal strides and padding, BN 128
    (20, 16, 1, 6, (1, 1), (0, 0), "nchw"),     # an NCHW map, copied first
])
def test_kernel_loop_is_the_convolution(cin, cout, k, size, stride, padding, view):
    g = torch.Generator().manual_seed(cin * cout)
    if view == "slice":
        whole = torch.randn(2, 2 * cin, size, size, generator=g)
        x = whole.contiguous(memory_format=torch.channels_last)[:, cin:]
        assert x.stride(1) == 1 and not x.is_contiguous(memory_format=torch.channels_last)
    else:
        x = torch.randn(2, cin, size, size, generator=g)
        if view == "map":
            x = x.contiguous(memory_format=torch.channels_last)
    w = torch.randn(cout, cin, k, k, generator=g).contiguous(memory_format=torch.channels_last)
    x, w = cf._check(x, w, stride, padding)
    got, inside = _kernel_loop(x, w, stride, padding, cf.tiles(cin, cout, k, k))
    ref = F.conv2d(x.double(), w.double(), None, stride, padding)
    assert inside
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def test_tile_rule_over_the_teacher_shapes():
    configs = {cf.tiles(cin, cout, k, k) for cin, cout, k, *_ in SHAPES}
    assert len(configs) <= 8
    for cin, cout, k, *_ in SHAPES:
        t = cf.tiles(cin, cout, k, k)
        assert t.flat == (cin == 3)
        assert t.flat or cin % t.bk == 0                  # no half-empty step of K
        assert -(-cout // t.bn) * t.bn <= cout * 4 / 3    # at most 25% of N wasted
        assert t.bm % 64 == 0 and t.warps in (4, 8) and t.stages >= 2


def test_check_copies_layouts_and_refuses_what_the_kernel_cannot_take():
    x, w = _operands(8, 4, 3, 5)
    y, v = cf._check(x.contiguous(), w.contiguous(), (1, 1), (1, 1))
    assert y.is_contiguous(memory_format=torch.channels_last) and torch.equal(y, x)
    assert v.is_contiguous(memory_format=torch.channels_last) and torch.equal(v, w)
    assert cf._check(x, w, (1, 1), (1, 1))[0] is x
    for args, error in [((x.bfloat16(), w), TypeError), ((x, w.double()), TypeError),
                        ((x[0], w), ValueError), ((x, w[:, :4]), ValueError),
                        ((x, w.to("meta")), ValueError)]:
        with pytest.raises(error):
            cf._check(*args, (1, 1), (1, 1))
    for stride, padding in [((0, 1), (1, 1)), ((1, 1), (-1, 0)), ((1,), (1, 1))]:
        with pytest.raises(ValueError):
            cf._check(x, w, stride, padding)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on CUDA, for the gate alone."""

    @property
    def is_cuda(self):
        return True


def test_gate_takes_only_a_float32_card_input_with_nothing_to_differentiate(monkeypatch):
    conv = torch.nn.Conv2d(8, 8, 3, padding=1, bias=False)
    card = torch.zeros((1, 8, 4, 4)).as_subclass(_OnCard)
    with torch.no_grad():
        assert cf.takes(card, conv)
        assert not cf.takes(torch.zeros((1, 8, 4, 4)), conv)          # a CPU input
        assert not cf.takes(card.bfloat16(), conv)                     # bf16
        assert not cf.takes(card, copy.deepcopy(conv).bfloat16())      # a bf16 weight
        grouped = torch.nn.Conv2d(8, 8, 3, padding=1, bias=False, groups=2)
        assert not cf.takes(card, grouped)                             # grouped
        monkeypatch.setattr(torch, "is_autocast_enabled", lambda device=None: device == "cuda")
        assert not cf.takes(card, conv)                                # CUDA autocast
        monkeypatch.undo()
    assert not cf.takes(card, conv)                                    # the weight's grad
    conv.weight.requires_grad_(False)
    assert cf.takes(card, conv)
    assert not cf.takes(card.clone().requires_grad_(), conv)           # the input's grad


def test_export_records_one_op_node_a_call():
    class Two(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = torch.nn.Conv2d(8, 16, 3, 2, 1, bias=False)
            self.b = torch.nn.Conv2d(16, 4, 1, bias=False)

        def forward(self, x):
            return cf.conv2d(cf.conv2d(x, self.a), self.b)

    model = Two().to(memory_format=torch.channels_last)
    x, _ = _operands(8, 1, 1, 9)
    with torch.no_grad():
        program = torch.export.export(model, (x,))
    nodes = [n for n in program.graph.nodes if n.op == "call_function"]
    assert [str(n.target) for n in nodes] == ["mcaq.conv_f32.default"] * 2
    fake = nodes[0].meta["val"]
    assert fake.shape == (2, 16, 5, 5) and fake.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        assert torch.equal(program.module()(x), model(x))


@pytest.mark.parametrize("dtype,training", [(torch.bfloat16, False), (torch.float32, True)])
def test_conv_bn_silu_on_the_cpu_runs_conv_0(monkeypatch, dtype, training):
    """On the CPU (and for bf16, or under autograd, anywhere) ConvBnSiLU's
    convolution is `Conv_0`'s, bitwise."""
    from mcaq_yolo_tpu_torch.models.layers import ConvBnSiLU

    calls = []
    monkeypatch.setattr(cf, "conv2d", lambda x, conv: calls.append(x) or conv(x))
    m = ConvBnSiLU(8, 16, 3)
    m.Conv_0.to(dtype=dtype)
    m = m.to(memory_format=torch.channels_last)
    x, _ = _operands(8, 16, 3, 6)
    x = x.to(dtype)
    got = m(x, training)
    ref = m.BatchNorm_0(m.Conv_0(x), training)
    assert calls == [] and torch.equal(got, F.silu(ref))


def test_every_yolov8m_conv_goes_through_the_kernel_where_the_gate_takes_it(monkeypatch):
    """With `takes` true (as on the card for the float32 teacher), a YOLOv8m
    forward sends each of its 77 ConvBnSiLU convolutions through `conv2d`
    (here the plain version), and the maps stay within float32 rounding of
    `Conv_0`'s."""
    from mcaq_yolo_tpu_torch.models.yolo import YOLOv8

    model = YOLOv8("yolov8m", 80, device="cpu", seed=0)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3),
                                                           dtype=np.uint8))
    with torch.no_grad():
        ref = model(x)
    want = Counter((c[1], c[2]) for c in _chip_smoke().conv_bn_silu_convs("yolov8m", 1, 64))
    calls = []
    real = cf.conv2d
    monkeypatch.setattr(cf, "takes", lambda x, conv: True)
    monkeypatch.setattr(cf, "conv2d", lambda x, conv: calls.append(x.shape) or real(x, conv))
    with torch.no_grad():
        got = model(x)
    assert len(calls) == 77
    assert Counter((c[1], c[2]) for c in calls) == want
    for a, b in zip(got, ref):
        assert _rel(a, b.double()) < 1e-5


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the GPU")
    return torch.device("cuda")


def _cudnn(x, w, s, p, tf32):
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=tf32):
        return F.conv2d(x, w, None, s, p)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_is_float32_accurate_at_every_teacher_shape(cuda, shape):
    """At a batch of 2 and the shape's own size."""
    cin, cout, k, s, p, size = shape
    x, w = _operands(cin, cout, k, size, seed=cin + cout, device=cuda)
    before = cf.launches()
    y = cf.conv_f32(x, w, (s, s), (p, p))
    assert cf.launches() == before + 1
    ref = F.conv2d(x.double(), w.double(), None, s, p)
    assert y.dtype == torch.float32 and y.shape == ref.shape
    assert y.is_contiguous(memory_format=torch.channels_last)
    gap = _rel(y, ref)
    f32, tf32 = _rel(_cudnn(x, w, s, p, False), ref), _rel(_cudnn(x, w, s, p, True), ref)
    assert gap <= 2 * f32, (gap, f32)
    assert tf32 >= 100 * gap, (tf32, gap)
    plain = cf.conv_f32_torch(x, w, (s, s), (p, p))
    assert _rel(y, plain.double()) <= 2 * f32
    assert torch.equal(cf.conv_f32(x, w, (s, s), (p, p)), y)  # the same bits again


@pytest.mark.gpu
def test_kernel_reads_channel_slices_and_copies_nchw(cuda):
    x, w = _operands(192, 96, 3, 40, seed=3, device=cuda)
    xs = torch.cat([x, x], 1)[:, 192:]
    ref = F.conv2d(x.double(), w.double(), None, 1, 1)
    for inp in (xs, x.contiguous()):
        assert _rel(cf.conv_f32(inp, w, (1, 1), (1, 1)), ref) <= 2 * _rel(
            _cudnn(x, w, 1, 1, False), ref)


def _teachers(cuda):
    from mcaq_yolo_tpu_torch.models.yolo import YOLOv8

    teacher = YOLOv8("yolov8m", 80, device=cuda, seed=0)
    t64 = copy.deepcopy(teacher).double()
    t64.dtype = torch.float64
    return teacher, t64


@pytest.mark.gpu
def test_teacher_forward_is_float32_accurate_and_counts_77(cuda, monkeypatch):
    """YOLOv8m as the KD teacher at bs 2, 256 px: 77 launches of each
    kernel; raw maps and C3/C4/C5 within 2x of cuDNN float32's gap to a
    float64 teacher, and C3/C4/C5 100x below cuDNN TF32's.  A seeded
    teacher's raw maps are mostly the Detect head's biases, so their gap is
    float32's rounding of the output, the same for any float32 path (cuDNN
    float32's lies only 25-28x below TF32's there at bs 64 on an H100);
    with the head's six output biases zeroed, the raw maps (the
    convolutions' own output) are held to both."""
    from mcaq_yolo_tpu_torch.ops import bn_silu as bs
    from mcaq_yolo_tpu_torch.train import _teacher_outputs

    teacher, t64 = _teachers(cuda)
    images = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 256, 256, 3),
                                                                dtype=np.uint8)).to(cuda)

    def outputs(model, kernel=True, tf32=False):
        with monkeypatch.context() as m:
            m.setattr(torch.backends.cudnn, "allow_tf32", tf32)
            if not kernel:
                m.setattr(cf, "takes", lambda x, conv: False)
            if model is t64:
                m.setattr(bs, "takes", lambda x, bn: False)  # the kernel takes no float64
            maps, feats = _teacher_outputs(model, images)
            return [t.double() for t in list(maps) + list(feats)]

    before, bn_before = cf.launches(), bs.launches()
    outputs(teacher)
    assert (cf.launches() - before, bs.launches() - bn_before) == (77, 77)
    for biased in (True, False):
        if not biased:
            with torch.no_grad():
                for m in list(teacher.modules()) + list(t64.modules()):
                    if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                        m.bias.zero_()
        got, f32 = outputs(teacher), outputs(teacher, kernel=False)
        tf32, ref = outputs(teacher, kernel=False, tf32=True), outputs(t64)
        for i, (a, b, c, r) in enumerate(zip(got, f32, tf32, ref)):
            gap = _rel(a, r)
            assert gap <= 2 * _rel(b, r), (biased, i, gap, _rel(b, r))
            assert (biased and i < 3) or _rel(c, r) >= 100 * gap, (biased, i, _rel(c, r), gap)


@pytest.mark.gpu
def test_bf16_forward_launches_no_conv_f32(cuda):
    from mcaq_yolo_tpu_torch.models.yolo import YOLOv8

    model = YOLOv8("yolov8n", 80, dtype=torch.bfloat16, device=cuda)
    images = torch.zeros((2, 128, 128, 3), dtype=torch.uint8, device=cuda)
    before = cf.launches()
    with torch.no_grad():
        model(images)
    assert cf.launches() == before


@pytest.mark.gpu
def test_launch_error_raises_and_counts_nothing(cuda, monkeypatch):
    x, w = _operands(64, 64, 3, 8, device=cuda)
    before = cf.launches()
    with pytest.raises(TypeError):
        cf.conv_f32(x.double(), w.double(), (1, 1), (1, 1))
    # shared memory far beyond the card's 227 KB a block: the launch is refused
    monkeypatch.setattr(cf, "tiles", lambda *a: cf.Tiles(128, 128, 64, False, 4, 8))
    with pytest.raises(Exception, match="(?i)resource|shared memory"):
        cf.conv_f32(x, w, (1, 1), (1, 1))
        torch.cuda.synchronize()
    assert cf.launches() == before
