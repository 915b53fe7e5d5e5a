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
//   scale = max(x_max[c] - x_min[c], 1e-8) / d
//   zp    = clip(qmin - x_min[c] / scale, qmin, qmax)
//   out   = (clip(rint(x / scale + zp), qmin, qmax) - zp) * scale  [* mask]
// in f32, output in x's dtype.
//
// Tile rule: floor(h*Ht/H), the rule of the reference model path
// (_compose_integer via upsample_nearest).  The Pallas kernel instead clamps
// remainder pixels into the last tile (pallas_quant.py:104-117).  The two agree
// whenever H and W are tile multiples, as at all three YOLOv8 scales at 640 px.
//
// Bitwise parity with the plain PyTorch version (ops/spatial_quant.py):
// round-half-to-even (rintf), correctly rounded division (__fdiv_rn), the
// reference's literal operation order, explicit __f*_rn intrinsics so nothing
// is contracted into an FMA (the build also passes -fmad=false), and
// __float2bfloat16_rn for the bf16 store.
//
// What bounds it on this card: memory bytes.  Each element is read once and
// written once (2 bytes each in bf16) plus one f32 mask value per pixel; the
// arithmetic is ~15 operations per element, far under the H100's
// operations-per-byte balance point.  The design keeps everything else off
// the memory bus:
//   * the small (B, Ht, Wt) bit map is read directly (L1/L2-resident) — no
//     pixel-resolution parameter planes as the TPU kernel had to ship;
//   * the per-(bit, channel) scale and zero point (7 x C, precompute_qparams'
//     table) are built once per block in shared memory, so per element there
//     is one division and no table traffic to device memory;
//   * each thread moves 16 bytes along C (8 bf16 or 4 f32), neighbouring
//     threads on neighbouring addresses, so loads and stores are fully
//     coalesced 128-bit transactions;
//   * a grid-stride loop over a grid sized to the SM count amortizes the
//     table build.
// Later work: TMA/persistent blocks, fusing the per-channel min/max pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMinBits = 2;
constexpr int kMaxBits = 8;
constexpr int kNumBits = kMaxBits - kMinBits + 1;
constexpr int kThreads = 256;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
spatial_quant_kernel(const T* __restrict__ x, const float* __restrict__ bit_map,
                     const float* __restrict__ x_min, const float* __restrict__ x_max,
                     const float* __restrict__ mask, T* __restrict__ out,
                     int B, int H, int W, int C, int Ht, int Wt) {
  // [kNumBits][C] scale table, then [kNumBits][C] zero-point table
  extern __shared__ __align__(32) float smem[];
  float* s_scale = smem;
  float* s_zp = smem + kNumBits * C;
  for (int i = threadIdx.x; i < kNumBits * C; i += blockDim.x) {
    const int bi = i / C;
    const int c = i - bi * C;
    const float half = (float)(1 << (bi + kMinBits - 1));  // 2^(b-1), exact
    const float qmin = -half;
    const float d = __fsub_rn(__fmul_rn(2.0f, half), 1.0f);  // 2^b - 1, exact
    const float qmax = __fadd_rn(qmin, d);
    const float lo = x_min[c];
    const float range = fmaxf(__fsub_rn(x_max[c], lo), 1e-8f);
    const float scale = __fdiv_rn(range, d);
    s_scale[i] = scale;
    s_zp[i] = clipf(__fsub_rn(qmin, __fdiv_rn(lo, scale)), qmin, qmax);
  }
  __syncthreads();

  const int groups = C / VEC;
  const int64_t total = (int64_t)B * H * W * groups;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int64_t pix = i / groups;
    const int c0 = (int)(i - pix * groups) * VEC;
    const int64_t bh = pix / W;
    const int w = (int)(pix - bh * W);
    const int b = (int)(bh / H);
    const int h = (int)(bh - (int64_t)b * H);
    const int th = (int)(((int64_t)h * Ht) / H);
    const int tw = (int)(((int64_t)w * Wt) / W);

    const float bits = clipf(rintf(__ldg(bit_map + ((int64_t)b * Ht + th) * Wt + tw)),
                             (float)kMinBits, (float)kMaxBits);
    const int bi = (int)bits - kMinBits;
    const float half = (float)(1 << (bi + kMinBits - 1));
    const float qmin = -half;
    const float qmax = __fadd_rn(qmin, __fsub_rn(__fmul_rn(2.0f, half), 1.0f));
    // the thread's VEC table entries as 16-byte shared loads (one 4-byte
    // load per channel would put a warp's reads 8 words apart: 8-way bank
    // conflicts at C >= 256)
    const Vec<float, VEC> scale = *reinterpret_cast<const Vec<float, VEC>*>(s_scale + bi * C + c0);
    const Vec<float, VEC> zp = *reinterpret_cast<const Vec<float, VEC>*>(s_zp + bi * C + c0);

    const Vec<T, VEC> in = *reinterpret_cast<const Vec<T, VEC>*>(x + i * VEC);
    Vec<T, VEC> res;
    const float m = mask != nullptr ? __ldg(mask + pix) : 1.0f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float q = clipf(rintf(__fadd_rn(__fdiv_rn(to_f32(in.v[j]), scale.v[j]), zp.v[j])),
                            qmin, qmax);
      float o = __fmul_rn(__fsub_rn(q, zp.v[j]), scale.v[j]);
      if (mask != nullptr) o = __fmul_rn(o, m);
      res.v[j] = from_f32<T>(o);
    }
    *reinterpret_cast<Vec<T, VEC>*>(out + i * VEC) = res;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const float* bit_map, const float* x_min,
                   const float* x_max, const float* mask, void* out, int B, int H,
                   int W, int C, int Ht, int Wt, cudaStream_t stream) {
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    max_blocks = (sms > 0 ? sms : 132) * 8;
  }
  const int64_t total = (int64_t)B * H * W * (C / VEC);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  const size_t smem = 2 * kNumBits * (size_t)C * sizeof(float);
  spatial_quant_kernel<T, VEC><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), bit_map, x_min, x_max, mask, static_cast<T*>(out),
      B, H, W, C, Ht, Wt);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each thread moves 16 bytes of channels
// (4 f32 / 8 bf16), so C must be a multiple of that group and x and out
// 16-byte aligned; anything else returns cudaErrorInvalidValue without a
// launch.  mask may be null.  Returns cudaGetLastError() after the launch
// (0 on success); launches on `stream`, does not synchronise.
extern "C" int mcaq_spatial_quant(const void* x, const void* bit_map, const void* x_min,
                                  const void* x_max, const void* mask, void* out,
                                  int dtype, int B, int H, int W, int C, int Ht, int Wt,
                                  void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Ht <= 0 || Wt <= 0 || C % vec != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* bm = static_cast<const float*>(bit_map);
  const float* lo = static_cast<const float*>(x_min);
  const float* hi = static_cast<const float*>(x_max);
  const float* mk = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float, 4>(x, bm, lo, hi, mk, out, B, H, W, C, Ht, Wt, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16, 8>(x, bm, lo, hi, mk, out, B, H, W, C, Ht, Wt, s);
  }
  return (int)cudaErrorInvalidValue;
}
