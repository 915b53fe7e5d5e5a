"""
Float32 convolution on Hopper's tensor cores at float32 accuracy: an
implicit-GEMM convolution over channels-last (NHWC) maps whose every product
is error-compensated TF32 (3xTF32), written in Triton.

Replaces no TPU kernel: the JAX teacher's convolutions are XLA's.  In the
port they were cuDNN's, and cuDNN has no tensor-core path for float32 with
TF32 off, so at YOLOv8m's shapes it picks FFT convolutions and CUDA-core
NCHW implicit GEMMs behind a channels-last -> NCHW transpose: about 24
TFLOP/s, 212 ms of a KD train step's 448 at bs 64.

The GEMM: M = N * Ho * Wo output pixels, N = Cout, K = KH * KW * Cin.  A
channels-last weight (Cout, KH, KW, Cin in memory) is K-major, and an NHWC
map is K-contiguous along Cin, so both operands load as they lie, with no
transposed copy (wgmma takes TF32 only K-major).  A block owns a BM x BN
tile of the output and walks K in steps of BK channels of one kernel tap
(r, s): the rows of a step are the input pixels (oh * stride_h - pad_h + r,
ow * stride_w - pad_w + s), zero where they fall in the padding (masked
loads), so the padding costs no copy either.  With FLAT_K (a Cin under 16,
the stem's 3) a step spans taps: K = 27 in two steps of 16.

The arithmetic.  Each float32 operand x splits into hi = x rounded to TF32
(10 mantissa bits, to nearest, ties away, as cvt.rna.tf32.f32) and lo =
x - hi rounded so; both are exact TF32 values, so every tensor-core product
is exact in float32.  The map splits in registers between its load and the
dot; the weight is split by the wrapper at each call (ops/conv_f32.py:
_launch, a few elementwise passes over the weight), and its two halves load
as they lie, straight into shared memory for wgmma.  A step computes
lo(a) hi(b) + hi(a) lo(b), then hi(a) hi(b), into a fresh float32 accumulator, and adds it to the running
sum on the CUDA cores: ~22 of float32's 24 bits a product against TF32's
11 (lo(a) lo(b), ~2**-22 of a product, is dropped).  The fresh accumulator
is what keeps float32's accuracy: the tensor cores' adder truncates, so a
running sum fed back as the MMA's C loses up to an ulp of itself at each
8-deep MMA, a bias that grows with K (on an H100, 1.2e-5 relative L2
against float64 at K = 1728, 16x cuDNN float32's gap; with the fresh step,
0.29x it).  No split-K and no atomics, so a map's bits are the same from
run to run.  The output is float32 NHWC (channels-last), written once.

What bounds it on this card: tensor-core operations.  Three TF32 products
a multiply-add are 495 / 3 = 165 TFLOP/s of float32 work; YOLOv8m's 77
ConvBnSiLU at bs 64 and 640 px are 5.03 TFLOP, 30.5 ms at that rate, while
their maps (~6 GB read and written) take ~2 ms at 3.35 TB/s.  So the design
feeds the tensor cores: tiles of 128 output pixels by 64 or 128 channels
and K steps of 16-32 channels reuse each loaded float32 of A 64-128 times
and of B 128 times, Triton's software pipeline keeps 3-4 steps' loads in
flight (cp.async), and only A's split runs in the loop (splitting B there
too cost 21% more time on an H100, 90.8 against 71.9 ms over the teacher's
77 convolutions at bs 64).  The tile rule (ops/conv_f32.py:tiles) picks BN from Cout so that
the teacher's 48/96/288-channel convolutions waste little of N, and BK from
Cin so that no step is half empty; seven configurations in all.
"""

import triton
import triton.language as tl


@triton.jit
def _tf32(x):
    """x rounded to TF32: to nearest, ties away from zero, on the bits."""
    return ((x.to(tl.int32, bitcast=True) + 0x1000) & -8192).to(tl.float32, bitcast=True)


@triton.jit
def _step(a, b_hi, b_lo):
    """a @ b in 3xTF32 into a fresh accumulator: lo(a) hi(b) + hi(a) lo(b),
    then hi(a) hi(b)."""
    a_hi = _tf32(a)
    step = tl.dot(_tf32(a - a_hi), b_hi, input_precision="tf32")
    step = tl.dot(a_hi, b_lo, step, input_precision="tf32")
    return tl.dot(a_hi, b_hi, step, input_precision="tf32")


@triton.jit(do_not_specialize=["M", "H", "W", "Ho", "Wo", "stride_h", "stride_w",
                               "pad_h", "pad_w"])
def conv_f32_kernel(x_ptr, wh_ptr, wl_ptr, y_ptr,
                    M, H, W, Ho, Wo, Cin, Cout,
                    sxb, sxh, sxw, swn,
                    stride_h, stride_w, pad_h, pad_w,
                    KH: tl.constexpr, KW: tl.constexpr,
                    BM: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr,
                    FLAT_K: tl.constexpr):
    """y[m, n] = sum_k x[pixel(m, k)] w[n, k] for one BM x BN tile.

    x: a (B, H, W, Cin) map with channel stride 1 and strides sxb, sxh, sxw
    (a channels-last tensor or a channel slice of one); wh, wl: the
    weight's TF32 hi and lo parts, each (Cout, KH, KW, Cin), row stride
    swn, the rest contiguous; y: (M, Cout) contiguous, M = B * Ho * Wo.
    The N tiles of one M tile are neighbouring programs, so the M tile's
    input rows are read from L2 after the first."""
    pid = tl.program_id(0)
    n_tiles = tl.cdiv(Cout, BN)
    pid_m = pid // n_tiles
    pid_n = pid - pid_m * n_tiles
    offs_m = pid_m * BM + tl.arange(0, BM)
    offs_n = pid_n * BN + tl.arange(0, BN)
    offs_k = tl.arange(0, BK)
    m_ok = offs_m < M
    n_ok = offs_n < Cout
    ow = offs_m % Wo
    t = offs_m // Wo
    oh = t % Ho
    ih0 = oh * stride_h - pad_h
    iw0 = ow * stride_w - pad_w
    x_rows = x_ptr + (t // Ho).to(tl.int64) * sxb   # each output pixel's image
    w_cols = offs_n * swn
    acc = tl.zeros((BM, BN), dtype=tl.float32)
    if FLAT_K:
        K = KH * KW * Cin
        for k0 in range(0, K, BK):
            k = k0 + offs_k
            k_ok = k < K
            rs = k // Cin
            c = k - rs * Cin
            r = rs // KW
            ih = ih0[:, None] + r[None, :]
            iw = iw0[:, None] + (rs - r * KW)[None, :]
            a_ok = (m_ok[:, None] & k_ok[None, :] & (ih >= 0) & (ih < H)
                    & (iw >= 0) & (iw < W))
            a = tl.load(x_rows[:, None] + ih * sxh + iw * sxw + c[None, :], mask=a_ok,
                        other=0.0)
            w = w_cols[None, :] + k[:, None]
            w_ok = k_ok[:, None] & n_ok[None, :]
            acc += _step(a, tl.load(wh_ptr + w, mask=w_ok, other=0.0),
                         tl.load(wl_ptr + w, mask=w_ok, other=0.0))
    else:
        c_steps = tl.cdiv(Cin, BK)
        for kk in range(0, KH * KW * c_steps):
            rs = kk // c_steps
            c = (kk - rs * c_steps) * BK + offs_k
            r = rs // KW
            ih = ih0 + r
            iw = iw0 + (rs - r * KW)
            row_ok = m_ok & (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
            c_ok = c < Cin
            a = tl.load((x_rows + ih * sxh + iw * sxw)[:, None] + c[None, :],
                        mask=row_ok[:, None] & c_ok[None, :], other=0.0)
            w = w_cols[None, :] + (rs * Cin + c)[:, None]
            w_ok = c_ok[:, None] & n_ok[None, :]
            acc += _step(a, tl.load(wh_ptr + w, mask=w_ok, other=0.0),
                         tl.load(wl_ptr + w, mask=w_ok, other=0.0))
    y = y_ptr + offs_m.to(tl.int64)[:, None] * Cout + offs_n[None, :]
    tl.store(y, acc, mask=m_ok[:, None] & n_ok[None, :])
