// Eval BatchNorm + SiLU after a convolution, in one pass over its output, in
// place, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this epilogue to XLA, which
// fuses it into the convolution.  In the port the convolution is cuDNN's, and
// without this kernel the epilogue was two full passes over every ConvBnSiLU
// output (ATen's channels-last BatchNorm transform, then the SiLU), each
// reading and writing every element.
//
// Per element of a map x, bf16 or f32, with the four per-channel f32
// vectors of the BatchNorm:
//   inv = rsqrt(running_var[c] + eps)             (the card's rsqrt.approx)
//   t   = fma(weight[c] * (x - running_mean[c]), inv, bias[c])
//   z   = t rounded to x's dtype                  (BatchNorm's output)
//   x   = z / (1 + exp(-z)), rounded to x's dtype (SiLU)
// Two roundings, as the unfused path and flax's ConvBnSiLU have: BatchNorm
// writes its output in x's dtype, and the SiLU reads that.
//
// Bitwise parity with the unfused path on the card (ops/bn_silu.py:
// bn_silu_torch, F.silu(F.batch_norm(x, ...))) where ATen normalizes with
// its own transform (batch_norm_transform_input_channels_last_kernel, or
// its NCHW twin, on every contiguous map under 2**31 elements; cuDNN's
// float32 kernel differs in the last bits): t is that kernel's expression
// `w * (x - mean) * inv_std + bias` as nvcc contracts it, one rounded
// multiply and a fused multiply-add, and inv its eval inverse deviation,
// rsqrtf(var + eps) as torch.rsqrt computes it on the card (so checked:
// PERF.md §6); the SiLU is ATen's, `z / (1 + exp(-z))` in f32.  Every f32 operation here
// is spelled with an __f*_rn intrinsic, so no other contraction happens (the
// build also passes --fmad=false); the stores round to nearest even.
//
// What bounds it on this card: bytes.  A bf16 element moves 4 bytes (2 read,
// 2 written), an f32 one 8; the per-channel vectors are noise.  YOLOv8n's 57
// ConvBnSiLU outputs at 640 px, bs 256, are 14.2 GB a forward, 4.24 ms at
// 3.35 TB/s.  But the arithmetic is not free: the exact SiLU (expf and an
// IEEE division), the affine and the rounding between them cost ~25
// instructions an element, ~200 a 16-byte group of 8 bf16 channels, most of
// what the card issues while it moves those bytes at full rate, so the
// design spends as few instructions as it can around them and keeps many
// blocks resident:
//   * each block owns one contiguous tile of kThreads * kUnroll 16-byte
//     groups (8 bf16 or 4 f32 channels of one pixel); a thread issues its
//     kUnroll coalesced, streaming (evict-first) 16-byte loads together, then
//     computes and stores each group; the grid covers the map once;
//   * each block first writes (mean, weight, inv, bias) of all C channels
//     into shared memory (no second launch, no tensor math on the host),
//     laid out so that a group's four parameters are 4 * VEC / 4 16-byte
//     loads and the threads of a warp, on consecutive channel groups, read
//     consecutive 16 bytes (a channel's four side by side put the threads
//     of a quarter warp 128 bytes apart, on the same banks: bf16 ran at
//     40% of the bound);
//   * a group's channel group g % G is kept by additions from the thread's
//     first one, no division in the loop.
// Channels-last maps are the port's (cuDNN writes them).  A width the
// 16-byte group does not fit (C % 8 for bf16, C % 4 for f32, as a head of 85
// classes has), or an NCHW map (PyTorch's own convolution writes one when
// cuDNN is off), runs element by element in a grid-stride loop: the same
// arithmetic, 2- or 4-byte accesses.
// Measured on the H100: PERF.md §6.  A grid of one resident wave striding
// over the map, a TMA ring of tiles a block, or several tiles a block each
// read 1-10 points lower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;                  // 16-byte groups a thread
constexpr int kTile = kThreads * kUnroll;   // 16-byte groups a block
constexpr int kMaxChannels = 3072;          // (mean, weight, inv, bias) of each in 48 KB
constexpr int kScalarBlocks = 4096;         // the element-wise grid's cap

struct F32 {
  using T = float;
  static __device__ __forceinline__ float load(T v) { return v; }
  static __device__ __forceinline__ T store(float v) { return v; }
};
struct BF16 {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float load(T v) { return __bfloat162float(v); }
  static __device__ __forceinline__ T store(float v) { return __float2bfloat16_rn(v); }
};

template <typename E>
__device__ __forceinline__ float bn_silu(float x, float mean, float weight, float inv, float bias) {
  const float t = __fmaf_rn(__fmul_rn(weight, __fsub_rn(x, mean)), inv, bias);
  const float z = E::load(E::store(t));
  return __fdiv_rn(z, __fadd_rn(1.0f, expf(-z)));
}

// (mean, weight, inv, bias) of channel c
__device__ __forceinline__ float4 params(const float* __restrict__ weight,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ mean,
                                         const float* __restrict__ var, float eps, int c) {
  return make_float4(mean[c], weight[c], rsqrtf(__fadd_rn(var[c], eps)), bias[c]);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// Shared memory of the vector kernel, Q = VEC / 4 16-byte quarters a group
// and G groups: the four channels of quarter j of group c of parameter p
// (0 mean, 1 weight, 2 inv, 3 bias) at float4 (p * Q + j) * G + c.
template <int VEC>
__device__ __forceinline__ void load_grouped(float* s, const float* __restrict__ weight,
                                             const float* __restrict__ bias,
                                             const float* __restrict__ mean,
                                             const float* __restrict__ var, float eps, int C) {
  constexpr int Q = VEC / 4;
  const int G = C / VEC;
  for (int ch = threadIdx.x; ch < C; ch += kThreads) {
    const float4 p = params(weight, bias, mean, var, eps, ch);
    float* at = s + (((ch % VEC) / 4) * G + ch / VEC) * 4 + ch % 4;
    const int next = Q * G * 4;  // floats from one parameter to the next
    at[0] = p.x;
    at[next] = p.y;
    at[2 * next] = p.z;
    at[3 * next] = p.w;
  }
  __syncthreads();
}

// one 16-byte group of VEC channels; sp: its first quarter's mean (shared),
// G float4s from one quarter to the next
template <typename E, int VEC>
__device__ __forceinline__ uint4 apply(const uint4& u, const float4* sp, int G) {
  constexpr int Q = VEC / 4;
  float v[VEC];
  unpack(u, v);
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const float4 m = sp[j * G], w = sp[(Q + j) * G], i = sp[(2 * Q + j) * G],
                 b = sp[(3 * Q + j) * G];
    v[4 * j] = bn_silu<E>(v[4 * j], m.x, w.x, i.x, b.x);
    v[4 * j + 1] = bn_silu<E>(v[4 * j + 1], m.y, w.y, i.y, b.y);
    v[4 * j + 2] = bn_silu<E>(v[4 * j + 2], m.z, w.z, i.z, b.z);
    v[4 * j + 3] = bn_silu<E>(v[4 * j + 3], m.w, w.w, i.w, b.w);
  }
  return pack(v);
}

// x as 16-byte groups: group g holds channels (g % G) * VEC .. + VEC of
// pixel g / G, G = C / VEC.  Block k owns groups k * kTile .. + kTile; its
// thread t the groups k * kTile + r * kThreads + t, r < kUnroll.
template <typename E>
__global__ void __launch_bounds__(kThreads)
bn_silu_kernel(uint4* __restrict__ x, const float* __restrict__ weight,
               const float* __restrict__ bias, const float* __restrict__ mean,
               const float* __restrict__ var, float eps, int C, int64_t groups) {
  constexpr int VEC = 16 / sizeof(typename E::T);
  extern __shared__ float4 s_p[];
  load_grouped<VEC>(reinterpret_cast<float*>(s_p), weight, bias, mean, var, eps, C);
  const unsigned G = C / VEC;
  const int64_t i0 = (int64_t)blockIdx.x * kTile + threadIdx.x;
  // (k * kTile + t) % G, then + kThreads % G a group
  int c = (int)(((blockIdx.x % G) * (kTile % G) + threadIdx.x % G) % G);
  const int step = kThreads % G;
  uint4 u[kUnroll];
#pragma unroll
  for (int r = 0; r < kUnroll; ++r) {
    if (i0 + r * kThreads < groups) u[r] = __ldcs(x + i0 + r * kThreads);
  }
#pragma unroll
  for (int r = 0; r < kUnroll; ++r) {
    if (i0 + r * kThreads < groups) {
      __stcs(x + i0 + r * kThreads, apply<E, VEC>(u[r], s_p + c, G));
    }
    c += step;
    if (c >= (int)G) c -= G;
  }
}

// the same, element by element: element i of channel (i / plane) % C
// (plane 1: channels-last; H * W: NCHW); a channel's four side by side
template <typename E>
__global__ void __launch_bounds__(kThreads)
bn_silu_scalar_kernel(typename E::T* __restrict__ x, const float* __restrict__ weight,
                      const float* __restrict__ bias, const float* __restrict__ mean,
                      const float* __restrict__ var, float eps, int C, int64_t plane,
                      int64_t n) {
  extern __shared__ float4 s_p[];
  for (int c = threadIdx.x; c < C; c += kThreads) s_p[c] = params(weight, bias, mean, var, eps, c);
  __syncthreads();
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const float4 p = s_p[(i / plane) % C];
    x[i] = E::store(bn_silu<E>(E::load(x[i]), p.x, p.y, p.z, p.w));
  }
}

template <typename E>
int launch(void* x, const float* w, const float* b, const float* m, const float* v, float eps,
           long long pixels, int C, long long plane, cudaStream_t s) {
  constexpr int vec = 16 / sizeof(typename E::T);
  const size_t smem = (size_t)C * sizeof(float4);
  if (plane == 1 && C % vec == 0) {
    if (reinterpret_cast<uintptr_t>(x) % 16 != 0) return (int)cudaErrorInvalidValue;
    const int64_t groups = (int64_t)pixels * (C / vec);
    const int64_t blocks = (groups + kTile - 1) / kTile;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    bn_silu_kernel<E><<<(int)blocks, kThreads, smem, s>>>(static_cast<uint4*>(x), w, b, m, v,
                                                         eps, C, groups);
  } else {
    const int64_t n = (int64_t)pixels * C;
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    bn_silu_scalar_kernel<E><<<(int)(blocks < kScalarBlocks ? blocks : kScalarBlocks), kThreads,
                               smem, s>>>(static_cast<typename E::T*>(x), w, b, m, v, eps, C,
                                          plane, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (pixels * C elements) <- silu(bn(x)), on `stream`; plane 1: channels
// contiguous (channels-last), else each channel's plane of `plane` elements
// contiguous (NCHW, plane = H * W).  dtype 0: float32, 1: bfloat16.  A
// channels-last map whose C is a multiple of the 16-byte group (4 / 8
// channels) runs the vector kernel and needs x 16-byte aligned; any other
// map runs element by element.  Refuses, with cudaErrorInvalidValue and
// without a launch: another dtype, C not in 1 .. kMaxChannels, no pixels, a
// plane below 1, a vector map not 16-byte aligned, or more blocks than a
// grid holds.  Returns the launch's CUDA error (0 on success) and does not
// synchronise.
extern "C" int mcaq_bn_silu(void* x, const void* weight, const void* bias, const void* mean,
                            const void* var, float eps, int dtype, long long pixels, int C,
                            long long plane, void* stream) {
  if ((dtype != 0 && dtype != 1) || C <= 0 || C > kMaxChannels || pixels <= 0 || plane < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mean);
  const float* v = static_cast<const float*>(var);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<F32>(x, w, b, m, v, eps, pixels, C, plane, s)
                    : launch<BF16>(x, w, b, m, v, eps, pixels, C, plane, s);
}
