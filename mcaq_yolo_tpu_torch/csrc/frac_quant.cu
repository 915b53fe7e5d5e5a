// The training quantize of the MCAQ transform, forward and backward, one
// pass each, for Hopper (sm_90a): the fractional-bit compose of two fake
// quantizations, its straight-through estimator and the soft-mask multiply.
//
// Replaces no TPU kernel: the JAX package runs this compose in XLA
// (mcaq_yolo_tpu/core/quantization.py:401-418), not in its Pallas kernel.
// In the port it was plain PyTorch with autograd (core/quantization.py:
// compose_fractional, which stays as the CPU path): seven full float32
// fake-quantized copies of the map, seven select-and-blend passes, ~60
// elementwise kernels a scale forward and as many backward, ~170 GB a
// train step of YOLOv8m at bs 64.
//
// Forward, per element of an NHWC map x (B, H, W, C), bf16 or f32, in the
// tile (th, tw) = (floor(h*Ht/H), floor(w*Wt/W)) of the bit map:
//   bl = floor(bit[tile]);  f = bit[tile] - bl;  k = bl, kh = min(bl + 1, 8)
//   Q_b(x) = x + ((clamp(rint(x / s_b + z_b), qmin_b, qmax_b) - z_b) * s_b - x)
//   out = ((1 - f) * Q_k(x) + f * Q_kh(x)) [* m(pixel)], rounded once to x's dtype
// and 0 where bl is not one of 2..8 (the plain version's one-hot sum of the
// seven blends).  Q_b is fake_quantize's straight-through value x + (deq -
// x), two roundings; s_b, z_b are row b - 2 of a 7 x C table that the
// table kernel writes from the range with compute_scale_zeropoint's
// arithmetic as ATen evaluates it on the card: x_range / d with d a Python
// number is x_range * (1 / d), 1 / d rounded to f32 (ATen's division by a
// CPU scalar), and the zero point's x_min / s a true division.
//
// Backward, per element, from the output's gradient g:
//   gm = g * m (g without the mask);  grad_x = (gm * (1 - f) + gm * f) rounded to x's dtype
//   grad_m[pixel] = sum_c g * ((1 - f) * Q_k(x) + f * Q_kh(x))
//   grad_frac[tile] = sum_{pixel in tile, c} gm * (Q_kh(x) - Q_k(x))
// grad_x is autograd's through the plain version bit for bit: of the 14
// straight-through terms only Q_k's and Q_kh's are nonzero.  The two sums
// are in another order than autograd's (sum over C per blend, then over
// the tile), so they agree to rounding; each is taken in one fixed order
// (below), so two runs give the same bits.
//
// Bitwise parity with the plain version on the card (forward, grad_x):
// every f32 operation is an __f*_rn intrinsic in the plain version's literal
// order, round-half-to-even rintf, clamps that pass NaN as torch.clamp does,
// and the build passes --fmad=false, so nothing is contracted into an FMA.
//
// What bounds it on this card.  Bytes would: the forward reads x (2 bytes a
// bf16 element) and writes the output (2), the backward reads x and g and
// writes grad_x (6); the mask, the bit map and the table are noise.  At
// YOLOv8m's bs-64 maps (132.7 M elements) that is 0.533 + 0.800 GB, 0.40 ms
// a train step at 3.35 TB/s.  But an element costs two correctly rounded
// divisions (x / s of the two bit widths) and ~20 other operations each
// way, ~50 instructions, about what the card issues while it moves an
// element's bytes, so the design keeps everything else off the element:
//   * a block owns one tile, so the bit width, the fraction and the two
//     table rows it reads are the block's constants, and the tile's sums
//     need no second pass and no atomics;
//   * L lanes take one pixel, L the largest power of two (at most 32) that
//     divides the pixel's G 16-byte groups (8 bf16 or 4 f32 channels), each
//     lane G / L groups strided by L (coalesced); the block's T / L lane
//     groups walk the tile's pixels in turn.  A pixel's sum over C is a
//     butterfly of shuffles inside its L lanes; the tile's, a butterfly a
//     warp and the warps in order through shared memory;
//   * a lane loads up to kChunk groups before it computes, so each thread
//     keeps several 16-byte loads in flight.
// A width that the 16-byte group does not fit (C % 8 bf16, C % 4 f32), or a
// pointer that is not 16-byte aligned, runs element by element: the same
// arithmetic and layout, one element a group.  The wrapper
// (ops/frac_quant.py:geometry) picks the group, L and T from C, the dtype
// and the tile; the C entries check them again.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMinBits = 2;
constexpr int kMaxBits = 8;
constexpr int kNumBits = kMaxBits - kMinBits + 1;
constexpr int kMaxThreads = 128;   // threads of a tile's block, at most
constexpr int kTableThreads = 256;
constexpr int kChunk = 3;          // groups a lane loads before it computes

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

// VEC elements of a map: one element (VEC 1) or one 16-byte group, streamed
template <typename E, int VEC>
__device__ __forceinline__ void load_group(const typename E::T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = E::load(p[0]);
  } else {
    unpack(__ldcs(reinterpret_cast<const uint4*>(p)), v);
  }
}
template <typename E, int VEC>
__device__ __forceinline__ void store_group(typename E::T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = E::store(v[0]);
  } else {
    __stcs(reinterpret_cast<uint4*>(p), pack(v));
  }
}
// VEC floats of a table row (16-byte aligned where VEC >= 4)
template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + k));
      v[k] = f.x;
      v[k + 1] = f.y;
      v[k + 2] = f.z;
      v[k + 3] = f.w;
    }
  }
}

// torch.clamp / clamp_min on the card: a NaN passes through
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// Q_b(x): fake_quantize's straight-through value x + (deq - x)
__device__ __forceinline__ float fake_quant(float x, float scale, float zp, float qmin,
                                            float qmax) {
  const float q = clamp_nan(rintf(__fadd_rn(__fdiv_rn(x, scale), zp)), qmin, qmax);
  const float deq = __fmul_rn(__fsub_rn(q, zp), scale);
  return __fadd_rn(x, __fsub_rn(deq, x));
}

// table[0][bi][c] = scale, table[1][bi][c] = zero point of bit width bi + 2
// (compute_scale_zeropoint), from the range x_min / x_max[bi * row_stride +
// c * col_stride]: (C,) ranges (0, 1), (7, C) rows (C, 1), (7, 1) rows (1, 0)
__global__ void __launch_bounds__(kTableThreads)
table_kernel(const float* __restrict__ x_min, const float* __restrict__ x_max,
             float* __restrict__ table, int C, int row_stride, int col_stride) {
  const int i = blockIdx.x * kTableThreads + threadIdx.x;
  if (i >= kNumBits * C) return;
  const int bi = i / C;
  const int c = i - bi * C;
  const float half = (float)(1 << (bi + kMinBits - 1));  // 2^(b-1), exact
  const float qmin = -half;
  const float qmax = __fsub_rn(half, 1.0f);
  const float d = __fsub_rn(qmax, qmin);                 // 2^b - 1, exact
  const int r = bi * row_stride + c * col_stride;
  const float lo = x_min[r];
  const float range = __fsub_rn(x_max[r], lo);
  const float scale = __fmul_rn(range != range ? range : fmaxf(range, 1e-8f),
                                __fdiv_rn(1.0f, d));
  table[i] = scale;
  table[kNumBits * C + i] = clamp_nan(__fsub_rn(qmin, __fdiv_rn(lo, scale)), qmin, qmax);
}

// What a block knows of its tile: blockIdx.x = (b * Ht + th) * Wt + tw
struct Tile {
  int64_t pix0;     // the tile's first pixel, (b * H + h0) * W + w0
  int nw, npix;     // its width and pixels: rows h with floor(h * Ht / H) == th, likewise w
  bool inside;      // floor(bit) is one of 2..8
  float frac, keep; // f and 1 - f
  const float *s_lo, *z_lo, *s_hi, *z_hi;  // the two bit widths' table rows
  float qmin_lo, qmax_lo, qmin_hi, qmax_hi;
};

__device__ __forceinline__ Tile tile_of(const float* __restrict__ bit_map,
                                        const float* __restrict__ table, int H, int W, int C,
                                        int Ht, int Wt) {
  Tile t;
  const int tw = blockIdx.x % Wt;
  const int th = (blockIdx.x / Wt) % Ht;
  const int b = blockIdx.x / (Wt * Ht);
  // geometry_ok keeps (H + 1) * Ht and (W + 1) * Wt below 2^31
  const int h0 = (th * H + Ht - 1) / Ht, h1 = ((th + 1) * H + Ht - 1) / Ht;
  const int w0 = (tw * W + Wt - 1) / Wt, w1 = ((tw + 1) * W + Wt - 1) / Wt;
  t.pix0 = ((int64_t)b * H + h0) * W + w0;
  t.nw = w1 - w0;
  t.npix = (h1 - h0) * t.nw;
  const float bit = bit_map[blockIdx.x];
  const float bl = floorf(bit);
  t.frac = __fsub_rn(bit, bl);
  t.keep = __fsub_rn(1.0f, t.frac);
  t.inside = bl >= (float)kMinBits && bl <= (float)kMaxBits;
  const int k = t.inside ? (int)bl : kMinBits;
  const int kh = min(k + 1, kMaxBits);
  t.s_lo = table + (k - kMinBits) * C;
  t.z_lo = t.s_lo + kNumBits * C;
  t.s_hi = table + (kh - kMinBits) * C;
  t.z_hi = t.s_hi + kNumBits * C;
  t.qmin_lo = -(float)(1 << (k - 1));
  t.qmax_lo = __fsub_rn(-t.qmin_lo, 1.0f);
  t.qmin_hi = -(float)(1 << (kh - 1));
  t.qmax_hi = __fsub_rn(-t.qmin_hi, 1.0f);
  return t;
}

// pixel p of the tile, row-major
__device__ __forceinline__ int64_t pixel(const Tile& t, int p, int W) {
  return t.pix0 + (int64_t)(p / t.nw) * W + p % t.nw;
}

// Q_k(x), Q_kh(x) of VEC channels from channel c0
template <int VEC>
__device__ __forceinline__ void both_quants(const Tile& t, int c0, const float (&v)[VEC],
                                            float (&qlo)[VEC], float (&qhi)[VEC]) {
  float s[VEC], z[VEC];
  load_row<VEC>(t.s_lo + c0, s);
  load_row<VEC>(t.z_lo + c0, z);
#pragma unroll
  for (int e = 0; e < VEC; ++e) qlo[e] = fake_quant(v[e], s[e], z[e], t.qmin_lo, t.qmax_lo);
  load_row<VEC>(t.s_hi + c0, s);
  load_row<VEC>(t.z_hi + c0, z);
#pragma unroll
  for (int e = 0; e < VEC; ++e) qhi[e] = fake_quant(v[e], s[e], z[e], t.qmin_hi, t.qmax_hi);
}

// (1 - f) * Q_k + f * Q_kh
__device__ __forceinline__ float blend(const Tile& t, float qlo, float qhi) {
  return __fadd_rn(__fmul_rn(t.keep, qlo), __fmul_rn(t.frac, qhi));
}

template <typename E, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
forward_kernel(const typename E::T* __restrict__ x, const float* __restrict__ bit_map,
               const float* __restrict__ table, const float* __restrict__ mask,
               typename E::T* __restrict__ out, int H, int W, int C, int Ht, int Wt,
               int lanes) {
  const Tile t = tile_of(bit_map, table, H, W, C, Ht, Wt);
  const int lane = threadIdx.x % lanes;
  const int slots = blockDim.x / lanes;
  const int per_lane = C / VEC / lanes;
  for (int p = threadIdx.x / lanes; p < t.npix; p += slots) {
    const int64_t pix = pixel(t, p, W);
    const float m = mask != nullptr ? mask[pix] : 1.0f;
    const typename E::T* xp = x + pix * C;
    typename E::T* op = out + pix * C;
    for (int j0 = 0; j0 < per_lane; j0 += kChunk) {
      float v[kChunk][VEC];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (j0 + u < per_lane) load_group<E, VEC>(xp + (lane + (j0 + u) * lanes) * VEC, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (j0 + u >= per_lane) continue;
        const int c0 = (lane + (j0 + u) * lanes) * VEC;
        float o[VEC];
        if (t.inside) {
          float qlo[VEC], qhi[VEC];
          both_quants<VEC>(t, c0, v[u], qlo, qhi);
          // the one-hot sum 0 + ... + 1 * blend + ... gives +0 for a -0 blend
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[e] = __fadd_rn(blend(t, qlo[e], qhi[e]), 0.0f);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[e] = 0.0f;
        }
        if (mask != nullptr) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[e] = __fmul_rn(o[e], m);
        }
        store_group<E, VEC>(op + c0, o);
      }
    }
  }
}

// Every loop bound here is the block's (or, inside, the warp's) own, so the
// whole warp reaches each shuffle; a lane past the tile's last pixel adds 0.
template <typename E, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
backward_kernel(const typename E::T* __restrict__ x, const typename E::T* __restrict__ g,
                const float* __restrict__ bit_map, const float* __restrict__ table,
                const float* __restrict__ mask, typename E::T* __restrict__ grad_x,
                float* __restrict__ grad_frac, float* __restrict__ grad_mask, int H, int W,
                int C, int Ht, int Wt, int lanes) {
  __shared__ float s_warp[kMaxThreads / 32];
  const Tile t = tile_of(bit_map, table, H, W, C, Ht, Wt);
  const int lane = threadIdx.x % lanes;
  const int slots = blockDim.x / lanes;
  const int per_lane = C / VEC / lanes;
  float acc_frac = 0.0f;
  for (int p0 = 0; p0 < t.npix; p0 += slots) {
    const int p = p0 + threadIdx.x / lanes;
    const bool valid = p < t.npix;
    float acc_m = 0.0f;
    if (valid) {
      const int64_t pix = pixel(t, p, W);
      const float m = mask != nullptr ? mask[pix] : 1.0f;
      const typename E::T* xp = x + pix * C;
      const typename E::T* gp = g + pix * C;
      typename E::T* dp = grad_x + pix * C;
      for (int j0 = 0; j0 < per_lane; j0 += kChunk) {
        float v[kChunk][VEC], gv[kChunk][VEC];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (j0 + u < per_lane) {
            const int at = (lane + (j0 + u) * lanes) * VEC;
            load_group<E, VEC>(xp + at, v[u]);
            load_group<E, VEC>(gp + at, gv[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (j0 + u >= per_lane) continue;
          const int c0 = (lane + (j0 + u) * lanes) * VEC;
          float d[VEC];
          if (t.inside) {
            float qlo[VEC], qhi[VEC];
            both_quants<VEC>(t, c0, v[u], qlo, qhi);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float gm = mask != nullptr ? __fmul_rn(gv[u][e], m) : gv[u][e];
              d[e] = __fadd_rn(__fmul_rn(gm, t.keep), __fmul_rn(gm, t.frac));
              acc_m = __fadd_rn(acc_m, __fmul_rn(gv[u][e], blend(t, qlo[e], qhi[e])));
              acc_frac = __fadd_rn(acc_frac, __fmul_rn(gm, __fsub_rn(qhi[e], qlo[e])));
            }
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) d[e] = 0.0f;
          }
          store_group<E, VEC>(dp + c0, d);
        }
      }
    }
    if (grad_mask != nullptr) {
      for (int off = lanes / 2; off > 0; off /= 2) {
        acc_m = __fadd_rn(acc_m, __shfl_xor_sync(0xffffffffu, acc_m, off));
      }
      if (valid && lane == 0) grad_mask[pixel(t, p, W)] = acc_m;
    }
  }
  if (grad_frac != nullptr) {
    for (int off = 16; off > 0; off /= 2) {
      acc_frac = __fadd_rn(acc_frac, __shfl_xor_sync(0xffffffffu, acc_frac, off));
    }
    if (threadIdx.x % 32 == 0) s_warp[threadIdx.x / 32] = acc_frac;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.0f;
      for (int w = 0; w < (int)blockDim.x / 32; ++w) s = __fadd_rn(s, s_warp[w]);
      grad_frac[blockIdx.x] = s;
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The shape and geometry checks shared by both entries; true when the
// launch may go ahead.
bool geometry_ok(int dtype, int B, int H, int W, int C, int Ht, int Wt, int vec, int lanes,
                 int threads) {
  const int group = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  if ((dtype != 0 && dtype != 1) || B < 1 || H < 1 || W < 1 || C < 1 || Ht < 1 || Wt < 1) {
    return false;
  }
  if ((vec != 1 && vec != group) || C % vec != 0) return false;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 || (C / vec) % lanes != 0) {
    return false;
  }
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return false;
  // tile_of's (th + 1) * H + Ht - 1, and its twin in w
  if ((int64_t)(H + 1) * Ht >= INT32_MAX || (int64_t)(W + 1) * Wt >= INT32_MAX) return false;
  return (int64_t)B * Ht * Wt <= INT32_MAX;
}

template <typename E, int VEC>
void forward_launch(const void* x, const float* bit_map, const float* table, const float* mask,
                    void* out, int tiles, int H, int W, int C, int Ht, int Wt, int lanes,
                    int threads, cudaStream_t s) {
  using T = typename E::T;
  forward_kernel<E, VEC><<<tiles, threads, 0, s>>>(static_cast<const T*>(x), bit_map, table,
                                                   mask, static_cast<T*>(out), H, W, C, Ht,
                                                   Wt, lanes);
}

template <typename E, int VEC>
void backward_launch(const void* x, const void* g, const float* bit_map, const float* table,
                     const float* mask, void* grad_x, float* grad_frac, float* grad_mask,
                     int tiles, int H, int W, int C, int Ht, int Wt, int lanes, int threads,
                     cudaStream_t s) {
  using T = typename E::T;
  backward_kernel<E, VEC><<<tiles, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), bit_map, table, mask,
      static_cast<T*>(grad_x), grad_frac, grad_mask, H, W, C, Ht, Wt, lanes);
}

}  // namespace

// Forward, on `stream`: the table (2 x 7 x C float32, kept for the backward)
// from x_min / x_max (row_stride, col_stride: see table_kernel), then out
// (x's shape and dtype) from x (B, H, W, C) NHWC-contiguous, the bit map
// (B, Ht, Wt) and the mask (B, H, W) or null.  dtype 0: float32, 1:
// bfloat16.  vec: 1 or the 16-byte group (4 / 8), which needs x and out
// 16-byte aligned; lanes: a power of two <= 32 dividing C / vec; threads: a
// multiple of 32 up to 128.  Refuses, with cudaErrorInvalidValue and
// without a launch, anything else.  Returns the launches' CUDA error (0 on
// success) and does not synchronise.
extern "C" int mcaq_frac_quant_forward(const void* x, const void* bit_map, const void* x_min,
                                       const void* x_max, int row_stride, int col_stride,
                                       const void* mask, void* table, void* out, int dtype,
                                       int B, int H, int W, int C, int Ht, int Wt, int vec,
                                       int lanes, int threads, void* stream) {
  if (!geometry_ok(dtype, B, H, W, C, Ht, Wt, vec, lanes, threads) ||
      (vec > 1 && !(aligned16(x) && aligned16(out))) || row_stride < 0 || col_stride < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tab = static_cast<float*>(table);
  const int entries = kNumBits * C;
  table_kernel<<<(entries + kTableThreads - 1) / kTableThreads, kTableThreads, 0, s>>>(
      static_cast<const float*>(x_min), static_cast<const float*>(x_max), tab, C, row_stride,
      col_stride);
  const float* bm = static_cast<const float*>(bit_map);
  const float* mk = static_cast<const float*>(mask);
  const int tiles = B * Ht * Wt;
  if (dtype == 0) {
    if (vec == 1) forward_launch<F32, 1>(x, bm, tab, mk, out, tiles, H, W, C, Ht, Wt, lanes, threads, s);
    else forward_launch<F32, 4>(x, bm, tab, mk, out, tiles, H, W, C, Ht, Wt, lanes, threads, s);
  } else {
    if (vec == 1) forward_launch<BF16, 1>(x, bm, tab, mk, out, tiles, H, W, C, Ht, Wt, lanes, threads, s);
    else forward_launch<BF16, 8>(x, bm, tab, mk, out, tiles, H, W, C, Ht, Wt, lanes, threads, s);
  }
  return (int)cudaGetLastError();
}

// Backward, on `stream`, from the forward's x, bit map, mask and table and
// the output's gradient g (x's shape, dtype and layout): grad_x (the
// same), grad_frac (B, Ht, Wt) float32 (null: not computed) and grad_mask
// (B, H, W) float32 (null: not computed; always null without a mask).  The
// same geometry as the forward's, with g and grad_x 16-byte aligned too.
extern "C" int mcaq_frac_quant_backward(const void* x, const void* g, const void* bit_map,
                                        const void* table, const void* mask, void* grad_x,
                                        void* grad_frac, void* grad_mask, int dtype, int B,
                                        int H, int W, int C, int Ht, int Wt, int vec,
                                        int lanes, int threads, void* stream) {
  if (!geometry_ok(dtype, B, H, W, C, Ht, Wt, vec, lanes, threads) ||
      (vec > 1 && !(aligned16(x) && aligned16(g) && aligned16(grad_x))) ||
      (mask == nullptr && grad_mask != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bm = static_cast<const float*>(bit_map);
  const float* tab = static_cast<const float*>(table);
  const float* mk = static_cast<const float*>(mask);
  float* gf = static_cast<float*>(grad_frac);
  float* gmk = static_cast<float*>(grad_mask);
  const int tiles = B * Ht * Wt;
  if (dtype == 0) {
    if (vec == 1) backward_launch<F32, 1>(x, g, bm, tab, mk, grad_x, gf, gmk, tiles, H, W, C, Ht, Wt, lanes, threads, s);
    else backward_launch<F32, 4>(x, g, bm, tab, mk, grad_x, gf, gmk, tiles, H, W, C, Ht, Wt, lanes, threads, s);
  } else {
    if (vec == 1) backward_launch<BF16, 1>(x, g, bm, tab, mk, grad_x, gf, gmk, tiles, H, W, C, Ht, Wt, lanes, threads, s);
    else backward_launch<BF16, 8>(x, g, bm, tab, mk, grad_x, gf, gmk, tiles, H, W, C, Ht, Wt, lanes, threads, s);
  }
  return (int)cudaGetLastError();
}
