// Fused tile-wise quantize -> dequantize (x soft mask), for Hopper (sm_90a).
//
// Replaces the TPU kernel mcaq_yolo_tpu/ops/pallas_quant.py:
// spatial_quantize_pallas — all three of its pallas_call sites
// (_quant_kernel, _quant_kernel_masked, _quant_kernel_packed_masked) compute
// this one function; the C=64 lane packing of the third is a TPU register
// layout device and has no counterpart here.
//
// Per element of an NHWC map x (B, H, W, C), bf16 or f32:
//   b     = clip(rint(bit_map[b][floor(h*Ht/H)][floor(w*Wt/W)]), 2, 8)
//   qmin  = -2^(b-1);  d = 2^b - 1;  qmax = qmin + d
//   scale = max(x_max[r] - x_min[r], 1e-8) / d
//   zp    = clip(qmin - x_min[c] / scale, qmin, qmax)
//   out   = (clip(rint(x / scale + zp), qmin, qmax) - zp) * scale  [* mask]
// in f32, output in x's dtype.  r = c for one range per channel (C,), or
// r = (b - 2) * C + c for per-bit rows (7, C), the reference's mse
// calibration, whose 7-plane compose (quantization.py:439-449) quantizes each
// tile with the row of its bit width: per element the same arithmetic.
//
// Tile rule: floor(h*Ht/H), the rule of the reference model path
// (_compose_integer via upsample_nearest).  The Pallas kernel instead clamps
// remainder pixels into the last tile (pallas_quant.py:104-117).  The two agree
// whenever H and W are tile multiples, as at all three YOLOv8 scales at 640 px.
//
// Bitwise parity with the plain PyTorch version (ops/spatial_quant.py):
// round-half-to-even (rintf), correctly rounded division (__fdiv_rn) in the
// reference's literal operation order, explicit __f*_rn intrinsics so nothing
// is contracted into an FMA (the build also passes -fmad=false), and
// round-to-nearest-even conversion for the bf16 store.
//
// What bounds it on this card.  Each bf16 element moves ~4 bytes (2 read, 2
// written, 4/C of mask): 15.9 / 7.9 / 3.9 us at yolov8n's P3 / P4 / P5 at
// bs=32.  The card can issue ~40 thread-instructions per element in that
// time.  The first version spent 45 on its fast path (five 64-bit index
// divisions per 16-byte group, and every block rebuilt the 7 x C table
// before touching data), so issue set its pace.  This one spends ~25 per
// element, and what is left between it and the bound is each block's
// latency chain and the two launches, not arithmetic (PERF.md):
//   * two kernels from one C call.  qparams_kernel writes the 7 x C scale and
//     zero-point table (precompute_qparams' formulas, bit for bit) once per
//     call into scratch the wrapper allocates.  spatial_quant_kernel is
//     launched behind it with programmatic dependent launch: the table
//     kernel lets it start at once, its blocks fetch x and set up their
//     pixels, and only then wait (griddepcontrol.wait) for the table, which
//     they read through L1;
//   * a block owns a run of whole pixels, i.e. a contiguous run of x and of
//     the output, of at most kSpan 16-byte groups (one pixel, taken in
//     several passes, where a pixel alone has more).  One thread asks the
//     TMA unit for the whole run (cp.async.bulk into shared memory,
//     completing on an mbarrier): the run is in flight from the block's
//     first instructions, without holding registers;
//   * meanwhile each pixel's tile, rounded bit width and mask value are
//     worked out once per pixel, with 32-bit divisions, into shared memory;
//   * per 16-byte group: group j -> (pixel j / G, channel group j % G) is a
//     32-bit multiply and a shift by constants the wrapper precomputes
//     (magic 1, a plain shift, when G = C / VEC is a power of two, as in
//     yolov8n; a multiply-shift otherwise, as yolov8m's G = 24 / 48 / 72),
//     then the parity arithmetic in f32 and one 16-byte coalesced store.
// Later work: fuse the per-channel min/max pass that feeds x_min / x_max.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMinBits = 2;
constexpr int kMaxBits = 8;
constexpr int kNumBits = kMaxBits - kMinBits + 1;
constexpr int kThreads = 128;
constexpr int kItems = 3;                   // 16-byte groups per thread per pass
constexpr int kSpan = kThreads * kItems;    // groups per block pass (ops/spatial_quant.py SPAN)
constexpr int kTableThreads = 256;

template <typename T, int VEC>
struct alignas(16) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store16(float* dst, const float (&o)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
}
// two floats to bf16, each rounded to nearest even, the first in the low half
// (its place in memory)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float (&o)[8]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16x2(o[0], o[1]), pack_bf16x2(o[2], o[3]),
                                              pack_bf16x2(o[4], o[5]), pack_bf16x2(o[6], o[7]));
}

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// programmatic dependent launch (PTX ISA 7.8, sm_90): the primary lets its
// dependents start; the dependent waits until its primaries have completed
// and their writes are visible
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_primaries() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// one-dimensional TMA bulk copy global -> shared, completing on an mbarrier
// (PTX ISA 8.0, sm_90)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  // make the initialised barrier visible to the async proxy (the TMA unit)
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// bytes: a multiple of 16; src and dst 16-byte aligned
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}

// table[0][bi][c] = scale, table[1][bi][c] = zero point, bi = bits - 2, from
// the range x_min / x_max[bi * range_stride + c] (range_stride 0: one range
// per channel; C: one row per bit width)
__global__ void __launch_bounds__(kTableThreads)
qparams_kernel(const float* __restrict__ x_min, const float* __restrict__ x_max,
               float* __restrict__ table, int C, int range_stride) {
  // let the quantize kernel's blocks start now: they wait for this grid's
  // completion (griddepcontrol.wait) before they read the table, so the
  // trigger's place decides only how much of their set-up overlaps this
  launch_dependents();
  const int i = blockIdx.x * kTableThreads + threadIdx.x;
  if (i < kNumBits * C) {
    const int bi = i / C;
    const int c = i - bi * C;
    const float half = (float)(1 << (bi + kMinBits - 1));  // 2^(b-1), exact
    const float qmin = -half;
    const float d = __fsub_rn(__fmul_rn(2.0f, half), 1.0f);  // 2^b - 1, exact
    const float qmax = __fadd_rn(qmin, d);
    const int r = bi * range_stride + c;
    const float lo = x_min[r];
    const float range = fmaxf(__fsub_rn(x_max[r], lo), 1e-8f);
    const float scale = __fdiv_rn(range, d);
    table[i] = scale;
    table[kNumBits * C + i] = clipf(__fsub_rn(qmin, __fdiv_rn(lo, scale)), qmin, qmax);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
spatial_quant_kernel(const T* __restrict__ x, const float* __restrict__ bit_map,
                     const float* table, const float* __restrict__ mask,
                     T* __restrict__ out, int n_pix, int H, int W, int C, int Ht, int Wt,
                     int pix_per_block, unsigned magic, int shift) {
  __shared__ __align__(128) uint4 s_x[kSpan];  // one pass of the block's x, by TMA
  __shared__ unsigned char s_bi[kSpan];  // bit index (bits - 2) of each pixel of the run
  __shared__ float s_mask[kSpan];
  __shared__ __align__(8) uint64_t s_bar;  // completes when a pass of x has landed

  const int G = C / VEC;
  const int p0 = blockIdx.x * pix_per_block;  // n_pix < 2^31: the wrapper checks
  const int npb = min(pix_per_block, n_pix - p0);
  const int n = npb * G;  // 16-byte groups of this block, contiguous in x and out
  const T* xb = x + (int64_t)p0 * C;
  T* ob = out + (int64_t)p0 * C;
  const uint32_t bar = smem_addr(&s_bar);
  const uint32_t dst = smem_addr(s_x);

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) bulk_load(dst, xb, min(n, kSpan) * 16, bar);  // in flight from here

  for (int p = threadIdx.x; p < npb; p += kThreads) {
    const int pix = p0 + p;
    const int row = pix / W;
    const int w = pix - row * W;
    const int b = row / H;
    const int h = row - b * H;
    const int th = h * Ht / H;  // H * Ht, W * Wt < 2^31: the wrapper checks
    const int tw = w * Wt / W;
    const float bits = clipf(rintf(__ldg(bit_map + ((int64_t)b * Ht + th) * Wt + tw)),
                             (float)kMinBits, (float)kMaxBits);
    s_bi[p] = (unsigned char)((int)bits - kMinBits);
    s_mask[p] = mask != nullptr ? __ldg(mask + pix) : 1.0f;
  }
  __syncthreads();       // s_bi / s_mask written
  wait_for_primaries();  // the table written

  for (int j0 = 0, phase = 0;; phase ^= 1) {
    mbar_wait(bar, phase);
    const int end = min(n, j0 + kSpan);
#pragma unroll 1  // unrolling measured slower: more registers, fewer blocks per SM
    for (int j = j0 + (int)threadIdx.x; j < end; j += kThreads) {
      const Vec<T, VEC> in = *reinterpret_cast<const Vec<T, VEC>*>(&s_x[j - j0]);
      const int p = (int)(((uint64_t)(unsigned)j * magic) >> shift);  // j / G
      const int c0 = (j - p * G) * VEC;
      const int bi = s_bi[p];
      const float half = (float)(2 << bi);  // 2^(b-1)
      const float qmin = -half;
      const float qmax = __fadd_rn(qmin, __fsub_rn(__fmul_rn(2.0f, half), 1.0f));
      const Vec<float, VEC> scale =
          *reinterpret_cast<const Vec<float, VEC>*>(table + bi * C + c0);
      const Vec<float, VEC> zp =
          *reinterpret_cast<const Vec<float, VEC>*>(table + (kNumBits + bi) * C + c0);
      const float m = s_mask[p];
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float q = clipf(rintf(__fadd_rn(__fdiv_rn(to_f32(in.v[e]), scale.v[e]), zp.v[e])),
                              qmin, qmax);
        o[e] = __fmul_rn(__fsub_rn(q, zp.v[e]), scale.v[e]);
        if (mask != nullptr) o[e] = __fmul_rn(o[e], m);
      }
      store16(ob + j * VEC, o);
    }
    j0 += kSpan;  // more passes only when one pixel has more than kSpan groups
    if (j0 >= n) break;
    __syncthreads();  // every thread is done reading s_x
    if (threadIdx.x == 0) {
      fence_proxy_async();
      bulk_load(dst, xb + j0 * VEC, min(n - j0, kSpan) * 16, bar);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const T* x, const float* bit_map, const float* x_min, const float* x_max,
                   const float* mask, float* table, T* out, int n_pix, int H, int W, int C,
                   int Ht, int Wt, int range_stride, int pix_per_block, unsigned magic,
                   int shift, cudaStream_t stream) {
  const int entries = kNumBits * C;
  qparams_kernel<<<(entries + kTableThreads - 1) / kTableThreads, kTableThreads, 0, stream>>>(
      x_min, x_max, table, C, range_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n_pix + pix_per_block - 1) / pix_per_block));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* tab = table;
  err = cudaLaunchKernelEx(&cfg, spatial_quant_kernel<T, VEC>, x, bit_map, tab, mask, out,
                           n_pix, H, W, C, Ht, Wt, pix_per_block, magic, shift);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x_min / x_max hold C floats
// (range_stride 0) or 7 rows of C, one per bit width 2..8 (range_stride C).
// Each thread moves 16-byte groups of
// channels (4 f32 / 8 bf16), so C must be a multiple of that group and x and
// out 16-byte aligned.  table is scratch of 2 * 7 * C floats, 16-byte aligned.
// The launch geometry comes from the wrapper (ops/spatial_quant.py:
// launch_geometry): pix_per_block pixels per block, with groups G = C / VEC
// and (pix_per_block * G <= kSpan or pix_per_block = 1), and (magic, shift)
// such that (j * magic) >> shift == j / G for every j < pix_per_block * G.
// Anything else returns cudaErrorInvalidValue without a launch.  mask may be
// null.  Launches the table kernel and the quantize kernel on `stream`,
// returns the first CUDA error (0 on success), does not synchronise.
extern "C" int mcaq_spatial_quant(const void* x, const void* bit_map, const void* x_min,
                                  const void* x_max, const void* mask, void* table, void* out,
                                  int dtype, int B, int H, int W, int C, int Ht, int Wt,
                                  int range_stride, int pix_per_block, unsigned magic,
                                  int shift, void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Ht <= 0 || Wt <= 0 || C % vec != 0 ||
      (range_stride != 0 && range_stride != C) ||
      (dtype != 0 && dtype != 1) || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n_pix = (int64_t)B * H * W;
  const int64_t G = C / vec;
  if (n_pix >= INT32_MAX || (int64_t)H * Ht >= INT32_MAX || (int64_t)W * Wt >= INT32_MAX ||
      (int64_t)kNumBits * C >= INT32_MAX || pix_per_block < 1 || pix_per_block > kSpan ||
      (pix_per_block > 1 && pix_per_block * G > kSpan) || shift < 0 || shift > 63 ||
      magic == 0) {
    return (int)cudaErrorInvalidValue;
  }
  // the multiply-shift is exact for j < J = pix_per_block * G when
  // e = magic * G - 2^shift lies in [0, G) and (J - 1) * e < 2^shift
  const uint64_t two_s = (uint64_t)1 << shift;
  const uint64_t mg = (uint64_t)magic * (uint64_t)G;  // < 2^32 * 2^29
  const uint64_t J = (uint64_t)pix_per_block * (uint64_t)G;
  if (mg < two_s || mg - two_s >= (uint64_t)G || (J - 1) * (mg - two_s) >= two_s) {
    return (int)cudaErrorInvalidValue;
  }
  const float* bm = static_cast<const float*>(bit_map);
  const float* lo = static_cast<const float*>(x_min);
  const float* hi = static_cast<const float*>(x_max);
  const float* mk = static_cast<const float*>(mask);
  float* tab = static_cast<float*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float, 4>(static_cast<const float*>(x), bm, lo, hi, mk, tab,
                                 static_cast<float*>(out), (int)n_pix, H, W, C, Ht, Wt,
                                 range_stride, pix_per_block, magic, shift, s);
  }
  return (int)launch<__nv_bfloat16, 8>(static_cast<const __nv_bfloat16*>(x), bm, lo, hi, mk,
                                       tab, static_cast<__nv_bfloat16*>(out), (int)n_pix, H,
                                       W, C, Ht, Wt, range_stride, pix_per_block, magic,
                                       shift, s);
}

// Blocks of the quantize kernel that fit on one SM at once (dtype as above),
// for reporting how many waves a launch takes; -1 on error.
extern "C" int mcaq_spatial_quant_blocks_per_sm(int dtype) {
  int n = 0;
  const cudaError_t err =
      dtype == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, spatial_quant_kernel<float, 4>, kThreads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, spatial_quant_kernel<__nv_bfloat16, 8>, kThreads, 0);
  return err == cudaSuccess ? n : -1;
}
