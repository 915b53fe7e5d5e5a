// Per-tile morphology descriptors phi1-phi5 and the three interaction terms,
// every tile of one scale in one launch, for Hopper (sm_90a).
//
// Replaces the JAX package's default tile engine,
// mcaq_yolo_tpu/core/morphology_lanes.py:phi_metrics_tiled (an XLA lowering
// that packs tiles into the TPU's 128 vector lanes; not a Pallas kernel), and
// the few hundred small PyTorch launches per scale of its plain version,
// core/morphology_lanes.py:phi_tiles_torch in this package.
//
// Per tile of t x t pixels of the normalized gray map (B, ht*t, wt*t), with
// each operator's own border rule (edge = replicate, zero, one):
//   phi3  Sobel (edge) of the tile; Eq.(22) from the pairwise tile sums of
//         gx, gx^2, gy, gy^2;
//   edge  cv2compat: 5x5 sigma-1 Gaussian (edge), per-tile Otsu of the blur,
//         Sobel of blur*255 (edge), L1 magnitude, 4-direction NMS (atan2;
//         neighbours edge), hysteresis of 8 dilate3 passes (zero);
//         legacy: Gaussian and Sobel with zero borders, L2 magnitude, NMS,
//         Otsu of the tile's min-max normalized NMS, 2 passes;
//   mask  adaptive: 11-tap Gaussian of gray*255 (edge) minus 2; otsu: the
//         tile's own Otsu threshold;
//   phi1  dyadic box counts of the edges (scales 2 .. t), weighted log-log
//         slope; phi2 uniform-LBP (edge) 10-bin entropy; phi4 edge density;
//   phi5  erode3 (one) boundary, area, and optionally Gray's quad-pattern
//         Euler count over the (t+1)^2 windows of the zero-padded mask;
// out (B, ht, wt, 8) = phi1/2, phi2, phi3, phi4, phi5, phi1/2*phi2, phi3^2,
// sqrt(phi4*phi5 + 1e-12).  The options are template flags.
//
// Bitwise parity with the plain version.  Every elementwise step is the plain
// version's PyTorch op in its literal order, in float32, each rounded on its
// own: the build passes -fmad=false, so nothing is contracted into an FMA.
// The functions are the ones ATen's CUDA kernels call (atan2f, logf, log2f,
// expf, correctly rounded sqrtf and division); their arguments are never
// compile-time constants (`opaque`), so the compiler cannot fold a call with
// the host's libm.  The plain version writes its two float reductions in a
// fixed order (phi3's tile sums pairwise, first half plus second half;
// phi1's regression sums over the scales in order), which the kernel
// repeats.  Otsu: the plain version scores sigma_b at the last pixel of each
// run of its sorted bins from a cumsum; every partial sum there is a
// multiple of 2^-9 / t^2 below 1, exact in float32 for t <= 128 in any
// order, so the kernel scores each bin from integer counts and takes the
// largest sigma_b, the lowest bin on a tie, as argmax over the sorted bins
// does.  From 256 x 256 the sum of (2 bin + 1) can pass 2^24: the kernel's
// 64-bit scan stays exact and is rounded once to float32, the plain
// version's float cumsum rounds along the way in an order of ATen's, so the
// two can pick another bin where two sigma_b nearly tie; there the tile's
// phi differs, elsewhere it is bitwise equal (the checks trace each such
// tile to its Otsu bin).  The remaining reductions count {0, 1} maps or
// quarter-integers, exact in any order.  No tensor cores: nothing here is a product of
// matrices, and a TF32 or bf16 MMA would not round as the plain version's
// float32 ops do.
//
// Two paths, one launch either way (the C entry picks by the tile):
//
// Warp path, tiles up to 8 x 8 (every serving, training, calibration and
// evaluate launch: tile 4 at downsample 2, 8 at P3 with downsample 1, 1-2 on
// tiny maps).  A warp owns whole tiles: 32 / t^2 of them up to 4 x 4, one
// 8 x 8 tile at two pixels a lane (rows 0-3 in the first register, 4-7 in
// the second).  Pixel values live in registers; stencil neighbours come by
// __shfl_sync from the lane that holds them, with the operator's border rule
// applied to the source index.  Binary maps (edges, weak edges, the mask) are
// warp ballots, so hysteresis, erosion, Euler windows and box occupancy read
// bits of one 64-bit word; counts are popcounts under the tile's lane mask.
// phi3's pairwise sums are __shfl_down_sync at h = n/2 .. 1 (slot s adds slot
// s + h, the plain version's order; at 8 x 8 the h = 32 level adds the two
// registers first).  Otsu: each lane counts the pixels of its tile at or
// below its bin by shuffles, then a segment argmax of (sigma_b, bin).  The
// path has no __syncthreads and no shared memory; it is templated on the tile
// so every loop unrolls and every array stays in registers.  Blocks of 128
// threads, launch bounds for 32 resident warps per SM; a block's tiles are
// consecutive, so its reads are whole rows of neighbouring tiles.
//
// Block path, tiles 16 x 16 to 1024 x 1024 (Eq.(8) scoring at 128 px and up:
// tile 256 from 2048 px at grid 8; the global-size maps): one tile per block
// of 256 threads, thread j owning slots j + 256k.  The tile's planes (five
// float, five byte: 25 bytes a pixel) sit in shared memory up to 64 x 64
// (100 KB); from 128 x 128 (400 KB) they are a global scratch slice per
// block, the blocks then striding over the tiles.
// phi3's pairwise levels h >= 256 stay within a thread's own slots (no
// barrier), h = 128, 64 go through shared memory, h <= 32 by shuffles in warp
// 0: the same pairs in the same order.  Otsu is a 256-bin shared histogram,
// an exact integer scan of counts and of sum(2b + 1) over the bins, each
// thread scoring its own bin, and a block argmax with the same tie rule.
// Counters gather in registers and reach shared memory once per warp.
//
// What bounds it on this card.  The work is a few hundred float operations a
// pixel on a map of a few MB: the FP32 bound (~301 operations a pixel at
// 67 TFLOP/s) is 0.2-2 us a scale at the serving shapes, the byte bound
// smaller still.  The warp path is paced by instruction issue: ptxas gives it
// 31-64 registers (the 64 that 32 warps per SM allow), no stack, no shared
// memory; the tile-4 instance is ~1,600 SASS instructions a warp (of them
// ~116 shuffles, ~340 float arithmetic, the rest index arithmetic, bit
// logic, compares and the tile's tail), so ~1,600 issued a pixel against
// ~301 counted operations, which puts it near 8% of the FP32 bound at bs 256
// (0.021 ms a scale; the launch and one warp's chain at bs 32).  The block path
// (99-128 registers, no stack) keeps ~35 barriers a tile and, from
// 128 x 128, its planes in a global scratch (105 MB for 264 blocks at 128,
// 433 MB at 256: past the 50 MB L2) rather than shared memory.  It loads its
// tile with plain per-thread reads: TMA row loads, and a two-block cluster
// holding a 128 x 128 tile in distributed shared memory, were not tried and
// stay open (ROADMAP).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmallThreads = 128;  // warp path: threads per block (SMALL_THREADS)
constexpr int kSmallWarps = kSmallThreads / 32;
constexpr int kSmallMinBlocks = 8;  // 32 resident warps per SM
constexpr int kSmallMaxLt = 3;      // the warp path takes tiles up to 8 x 8
constexpr int kThreads = 256;       // block path: threads per block (LARGE_THREADS)
constexpr int kMaxLt = 10;          // the block path takes tiles up to 1024 x 1024 (MAX_TILE)
constexpr int kScales = kMaxLt;     // box-count scales 2 .. 2^lt
constexpr int kWarps = kThreads / 32;
constexpr int kCnt = 24;            // int counters of the tile
constexpr int kBins = 256;          // Otsu bins
constexpr int kHeader = 2048;       // block path: counters, histogram, reductions (HEADER_BYTES)
constexpr int kMaxSmem = 232448;
constexpr int kGlobalBlocks = 264;  // block path at 128 x 128 (GLOBAL_BLOCKS)

// the tile's int counters (block path)
enum { kEdge = 0, kArea = 1, kPerim = 2, kEuler4 = 3, kLbp = 4, kBox = 14 };
static_assert(kBox + kScales <= kCnt, "a counter for every box-count scale");

struct Taps {
  float g5[5];    // _gaussian_taps(5, 1.0)
  float g11[11];  // _gaussian_taps(11, 2.0000000000000004), adaptive_binarize's
};

// python float constants as torch casts them to float32
#define F32(x) ((float)(x))

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// the value unchanged, opaque to the compiler: a math function of it is
// computed on the card, as ATen computes it, never folded at compile time
__device__ __forceinline__ float opaque(float v) {
  asm("mov.b32 %0, %0;" : "+f"(v));
  return v;
}

__device__ __forceinline__ int otsu_bin(float v) {
  // clamp((x * 256).to(int32), 0, 255)
  return clampi((int)(v * 256.0f), kBins - 1);
}

// sigma_b at the last pixel of a bin's run: K pixels at or below the bin, S
// the sum of (2 bin + 1) over them, St over the tile (64-bit on the block
// path, where they can pass 2^31 at 1024 x 1024); p = 1 / n, q = p / 512
template <typename I>
__device__ __forceinline__ float otsu_sigma(int K, I S, I St, float p, float q) {
  const float omega = (float)K * p;
  const float mu = (float)S * q;
  const float mu_t = (float)St * q;
  const float d = mu_t * omega - mu;
  return (d * d) / (omega * (1.0f - omega) + F32(1e-12));
}

// argmax's rule over the sorted bins: the larger sigma_b, on a tie the lower
// bin (exact in any order: sigma_b is never NaN)
__device__ __forceinline__ void otsu_better(float& best, int& bin, float v, int b) {
  if (v > best || (v == best && b < bin)) {
    best = v;
    bin = b;
  }
}

__device__ __forceinline__ float otsu_threshold_of(int bin) {
  return ((float)bin + 0.5f) / 256.0f;
}

__device__ __forceinline__ int dir_bin(float gx, float gy) {
  float a = atan2f(gy, gx) * F32(180.0 / 3.141592653589793);
  a = a < 0.0f ? a + 180.0f : a;
  if (a < 22.5f || a >= 157.5f) return 0;
  if (a < 67.5f) return 1;
  if (a < 112.5f) return 2;
  return 3;
}

// the NMS neighbours of direction bin d are at (y + dy, x + dx) and
// (y - dy, x - dx)
__device__ __forceinline__ void nms_offset(int d, int& dy, int& dx) {
  dy = d == 0 ? 0 : -1;
  dx = d == 0 ? 1 : (d == 1 ? 1 : (d == 2 ? 0 : -1));
}

// Gray's quad pattern of a 2x2 window (tl, tr, bl, br): Q1 - Q3 - 2 QD
__device__ __forceinline__ int euler_window(int tl, int tr, int bl, int br) {
  const int idx = tl + 2 * tr + 4 * bl + 8 * br;
  const int q1 = idx == 1 || idx == 2 || idx == 4 || idx == 8;
  const int q3 = idx == 7 || idx == 11 || idx == 13 || idx == 14;
  const int qd = idx == 6 || idx == 9;
  return q1 - q3 - 2 * qd;
}

// phi1: the weighted log-log slope over the scales 2 .. 2^S (S >= 2) of
// xs = log(scale), ys = log(box count + 1), weights ws = exp(-0.1 k), the sums
// over the scales in order
__device__ __forceinline__ float phi1_fit(const float (&xs)[kScales],
                                          const float (&ys)[kScales],
                                          const float (&ws)[kScales], int S) {
  float w_sum = ws[0], wx = ws[0] * xs[0], wy = ws[0] * ys[0];
#pragma unroll
  for (int k = 1; k < kScales; ++k) {
    if (k < S) {
      w_sum = w_sum + ws[k];
      wx = wx + ws[k] * xs[k];
      wy = wy + ws[k] * ys[k];
    }
  }
  const float x_mean = wx / w_sum, y_mean = wy / w_sum;
  float cov = 0.0f, var = 0.0f;
#pragma unroll
  for (int k = 0; k < kScales; ++k) {
    if (k < S) {
      const float dx = xs[k] - x_mean;
      const float cv = ws[k] * dx * (ys[k] - y_mean);
      const float vv = ws[k] * (dx * dx);
      cov = k == 0 ? cv : cov + cv;
      var = k == 0 ? vv : var + vv;
    }
  }
  return fminf(fmaxf(-(cov / (var + F32(1e-12))), 1.0f), 2.0f);
}

// the three values of scale k: log(2^(k+1)), log(count + 1), exp(-0.1 k)
__device__ __forceinline__ void phi1_terms(int k, int count, float& x, float& y, float& w) {
  x = logf(opaque((float)(2 << k)));
  y = logf((float)count + 1.0f);
  w = expf(opaque((float)k * F32(-0.1)));
}

// phi1 from the box counts of the scales 2 .. 2^S (1 below two scales)
__device__ __forceinline__ float phi1_of(const int (&box)[kScales], int S) {
  if (S < 2) return 1.0f;
  float xs[kScales], ws[kScales], ys[kScales];
#pragma unroll
  for (int k = 0; k < kScales; ++k) {
    if (k < S) phi1_terms(k, box[k], xs[k], ys[k], ws[k]);
  }
  return phi1_fit(xs, ys, ws, S);
}

// phi2's term of one LBP label: p log2(p + 1e-10), p its share of the tile
__device__ __forceinline__ float entropy_term(int count, float inv_n) {
  const float p = (float)count * inv_n;
  return p * log2f(p + F32(1e-10));
}

// phi2: the 10-bin label entropy / log2(10), the terms subtracted in order
__device__ __forceinline__ float phi2_of(const int (&lbp)[10], float inv_n) {
  float ent = 0.0f;
#pragma unroll
  for (int v = 0; v < 10; ++v) {
    const float term = entropy_term(lbp[v], inv_n);
    ent = v == 0 ? -term : ent - term;
  }
  return ent * F32(1.0 / 3.321928094887362);
}

// the tile's counts
struct TileCounts {
  int edge, area, perim, euler4;
  int lbp[10];
  int box[kScales];
};

// the eight outputs of a tile
__device__ __forceinline__ void phi_outputs(const TileCounts& c, float phi1, float phi2,
                                            float phi3, float inv_n, bool contour,
                                            float (&o)[8]) {
  const float phi4 = (float)c.edge * inv_n;
  const float area = (float)c.area, perim = (float)c.perim;
  float ic = (perim * perim) / (F32(4.0 * 3.141592653589793) * area + F32(1e-6));
  if (contour) ic = ic / fmaxf(rintf((float)c.euler4 * 0.25f), 1.0f);
  float phi5 = 1.0f - 1.0f / fmaxf(ic, 1.0f);
  phi5 = area > 0.0f ? phi5 : 0.0f;
  const float phi1h = phi1 * 0.5f;
  o[0] = phi1h;
  o[1] = phi2;
  o[2] = phi3;
  o[3] = phi4;
  o[4] = phi5;
  o[5] = phi1h * phi2;
  o[6] = phi3 * phi3;
  o[7] = sqrtf(phi4 * phi5 + F32(1e-12));
}

// Eq.(22) from the tile sums of gx^2, gy^2, gx, gy
__device__ __forceinline__ float phi3_of(float s_gx2, float s_gy2, float s_gx, float s_gy,
                                         float inv_n) {
  const float mx = s_gx * inv_n, mx2 = s_gx2 * inv_n;
  const float my = s_gy * inv_n, my2 = s_gy2 * inv_n;
  float vx = mx2 - mx * mx;
  vx = vx < 0.0f ? 0.0f : vx;
  float vy = my2 - my * my;
  vy = vy < 0.0f ? 0.0f : vy;
  const float v = vx + vy;
  return v / (v + 1.0f);
}

// ---- warp path (tiles up to 8 x 8): no block barrier, no shared memory

template <int T>
struct Warp {
  static_assert(T == 1 || T == 2 || T == 4 || T == 8, "the warp path takes tiles 1-8");
  static constexpr int N = T * T;                   // pixels of a tile
  static constexpr int PPL = N > 32 ? 2 : 1;        // pixels a lane
  static constexpr int TPW = N >= 32 ? 1 : 32 / N;  // tiles a warp
  static constexpr int W = N >= 32 ? 32 : N;        // lanes of a tile
  static constexpr int LT = T == 1 ? 0 : (T == 2 ? 1 : (T == 4 ? 2 : 3));
};

// pixel q of the tile whose first lane is `base`, from the register plane v
template <int T>
__device__ __forceinline__ float pick(const float (&v)[Warp<T>::PPL], int base, int q) {
  if constexpr (Warp<T>::N == 1) {
    return v[0];
  } else if constexpr (Warp<T>::PPL == 1) {
    return __shfl_sync(kFull, v[0], base + q);
  } else {
    const float a = __shfl_sync(kFull, v[0], q & 31);
    const float b = __shfl_sync(kFull, v[1], q & 31);
    return q >= 32 ? b : a;
  }
}

// the same for a pixel in register r's row (it lies in register r)
template <int T>
__device__ __forceinline__ float pick_row(const float (&v)[Warp<T>::PPL], int r, int base,
                                          int q) {
  if constexpr (Warp<T>::N == 1) {
    return v[0];
  } else if constexpr (Warp<T>::PPL == 1) {
    return __shfl_sync(kFull, v[0], base + q);
  } else {
    return __shfl_sync(kFull, v[r], q & 31);
  }
}

// the plane at (yy, xx) of the tile: EDGE clamps into the tile, otherwise 0
// outside; ROW: yy is the row of register r
template <int T, bool EDGE, bool ROW>
__device__ __forceinline__ float wfetch(const float (&v)[Warp<T>::PPL], int r, int base, int yy,
                                        int xx) {
  if (EDGE) {
    yy = clampi(yy, T - 1);
    xx = clampi(xx, T - 1);
    return ROW ? pick_row<T>(v, r, base, yy * T + xx) : pick<T>(v, base, yy * T + xx);
  }
  const bool in = yy >= 0 && yy < T && xx >= 0 && xx < T;
  const int q = in ? yy * T + xx : 0;  // every lane takes part in the shuffle
  const float val = ROW ? pick_row<T>(v, r, base, q) : pick<T>(v, base, q);
  return in ? val : 0.0f;
}

// 1-D filter along y (VERT) or x of the plane at register r's pixel (y, x),
// taps in order, accumulated as out = s0 * w0; out = out + s_i * w_i (the
// plain version's _sep_filter / sobel pass1); S255 multiplies each read by
// 255 first (b255, g255)
template <int T, bool EDGE, bool VERT, bool S255, int K>
__device__ __forceinline__ float wfilt(const float (&v)[Warp<T>::PPL], int r, int base, int y,
                                       int x, const float (&w)[K]) {
  constexpr int R = K / 2;
  float out = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float a = VERT ? wfetch<T, EDGE, false>(v, r, base, y + i - R, x)
                   : wfetch<T, EDGE, true>(v, r, base, y, x + i - R);
    if (S255) a = a * 255.0f;
    const float s = a * w[i];
    out = i == 0 ? s : out + s;
  }
  return out;
}

// the warp's ballot of a per-pixel predicate: bit base + q is pixel q of the
// lane's tile (at 8 x 8 bit q, rows 4-7 in the high word)
template <int T>
__device__ __forceinline__ uint64_t ballot(const bool (&p)[Warp<T>::PPL]) {
  uint64_t w = __ballot_sync(kFull, p[0]);
  if constexpr (Warp<T>::PPL == 2) w |= (uint64_t)__ballot_sync(kFull, p[1]) << 32;
  return w;
}

template <int T>
__device__ __forceinline__ int wbit(uint64_t w, int base, int yy, int xx) {
  return (int)((w >> (base + yy * T + xx)) & 1u);
}

// bit of the map at (yy, xx), 0 outside the tile (zero padding)
template <int T>
__device__ __forceinline__ int wbit0(uint64_t w, int base, int yy, int xx) {
  return (yy >= 0 && yy < T && xx >= 0 && xx < T) ? wbit<T>(w, base, yy, xx) : 0;
}

// bit masks of a warp's ballot (bit base + y * T + x is pixel (y, x) of the
// tile at lane base; 32 bits up to 4 x 4 tiles, 64 at 8 x 8): the pixels of
// column x0 or row y0 of every tile
template <int T>
struct Masks {
  static constexpr uint64_t kSpan = Warp<T>::PPL == 2 ? ~0ull : 0xffffffffull;
  static __host__ __device__ constexpr uint64_t col(int x0) {
    uint64_t m = 0;
    for (int p = 0; p < 64; ++p) m |= (p % T == x0) ? (1ull << p) : 0ull;
    return m & kSpan;
  }
  static __host__ __device__ constexpr uint64_t row(int y0) {
    uint64_t m = 0;
    for (int p = 0; p < 64; ++p) m |= ((p % Warp<T>::N) / T == y0) ? (1ull << p) : 0ull;
    return m & kSpan;
  }
  // the top-left pixels of the 2^k x 2^k boxes
  static __host__ __device__ constexpr uint64_t corners(int k) {
    uint64_t m = 0;
    for (int p = 0; p < 64; ++p) {
      const int x = p % T, y = (p % Warp<T>::N) / T;
      m |= (x % (1 << k) == 0 && y % (1 << k) == 0) ? (1ull << p) : 0ull;
    }
    return m & kSpan;
  }
  static constexpr uint64_t kX0 = col(0), kX1 = col(T - 1), kY0 = row(0), kY1 = row(T - 1);
  static constexpr uint64_t kC1 = corners(1), kC2 = corners(2), kC3 = corners(3);
  static __device__ __forceinline__ uint64_t corner(int k) {
    return k == 1 ? kC1 : (k == 2 ? kC2 : kC3);
  }
};

// dilate3 of every tile's binary map at once, zero border (separable: the
// neighbours along x, then along y, never across a tile's edge)
template <int T>
__device__ __forceinline__ uint64_t wdilate(uint64_t w) {
  using M = Masks<T>;
  const uint64_t h = w | ((w << 1) & ~M::kX0) | ((w >> 1) & ~M::kX1);
  return (h | ((h << T) & ~M::kY0) | ((h >> T) & ~M::kY1)) & M::kSpan;
}

// erode3 of every tile's binary map at once, pad one (outside the tile never
// wins the min)
template <int T>
__device__ __forceinline__ uint64_t werode(uint64_t m) {
  using M = Masks<T>;
  const uint64_t h = m & ((m << 1) | M::kX0) & ((m >> 1) | M::kX1);
  return h & ((h << T) | M::kY0) & ((h >> T) | M::kY1) & M::kSpan;
}

// Otsu threshold of the lane's tile of src
template <int T>
__device__ __forceinline__ float wotsu(const float (&src)[Warp<T>::PPL], int base) {
  using G = Warp<T>;
  constexpr float p = 1.0f / (float)G::N;
  constexpr float q = p * (1.0f / 512.0f);
  int bin[G::PPL], K[G::PPL], S[G::PPL];
#pragma unroll
  for (int r = 0; r < G::PPL; ++r) {
    bin[r] = otsu_bin(src[r]);
    K[r] = 0;
    S[r] = 0;
  }
  int St = 0;
#pragma unroll
  for (int k = 0; k < G::N; ++k) {
    int b;
    if constexpr (G::N == 1) {
      b = bin[0];
    } else if constexpr (G::PPL == 1) {
      b = __shfl_sync(kFull, bin[0], base + k);
    } else {
      b = __shfl_sync(kFull, bin[k >> 5], k & 31);
    }
    const int w = 2 * b + 1;
    St += w;
#pragma unroll
    for (int r = 0; r < G::PPL; ++r) {
      if (b <= bin[r]) {
        K[r] += 1;
        S[r] += w;
      }
    }
  }
  float best = otsu_sigma(K[0], S[0], St, p, q);
  int bb = bin[0];
  if constexpr (G::PPL == 2) otsu_better(best, bb, otsu_sigma(K[1], S[1], St, p, q), bin[1]);
#pragma unroll
  for (int o = 1; o < G::W; o <<= 1) {
    const float ob = __shfl_xor_sync(kFull, best, o);
    const int obb = __shfl_xor_sync(kFull, bb, o);
    otsu_better(best, bb, ob, obb);
  }
  return otsu_threshold_of(bb);
}

// `iters` hysteresis passes on the ballots: edge = where(weak & dilate3(edge)
// > 0, 1, edge), i.e. edge | (weak & dilate3(edge))
template <int T>
__device__ __forceinline__ uint64_t whysteresis(const bool (&strong)[Warp<T>::PPL],
                                                const bool (&weak)[Warp<T>::PPL], int iters) {
  uint64_t e = ballot<T>(strong);
  const uint64_t w = ballot<T>(weak);
  for (int it = 0; it < iters; ++it) e = e | (w & wdilate<T>(e));
  return e;
}

template <int T, bool LEGACY, bool OTSU_BIN, bool CONTOUR>
__global__ void __launch_bounds__(kSmallThreads, kSmallMinBlocks)
phi_warp_kernel(const float* __restrict__ gray, float* __restrict__ phi, int ht, int wt,
                long long n_tiles, Taps taps) {
  using G = Warp<T>;
  constexpr int N = G::N, PPL = G::PPL, LT = G::LT;
  constexpr float inv_n = 1.0f / (float)N;
  const float sm[3] = {1.0f, 2.0f, 1.0f};
  const float df[3] = {-1.0f, 0.0f, 1.0f};
  const int lane = threadIdx.x & 31;
  const long long first =
      ((long long)blockIdx.x * kSmallWarps + (threadIdx.x >> 5)) * G::TPW;
  if (first >= n_tiles) return;  // the whole warp: no tile of its own
  const int tw = PPL == 1 ? lane / N : 0;  // the lane's tile in the warp
  const int base = tw * N;                 // its first lane
  const int pix = lane - base;             // register 0's pixel
  const long long tile = first + tw;
  const bool live = tile < n_tiles;
  // the lane's tile's bits in a ballot
  const uint64_t tbits = PPL == 2 ? ~0ull : (((1ull << N) - 1ull) << base);
  int y[PPL], x[PPL];
#pragma unroll
  for (int r = 0; r < PPL; ++r) {
    const int q = pix + 32 * r;
    y[r] = q >> LT;
    x[r] = q & (T - 1);
  }

  // ---- the tile's pixels
  float X[PPL];
  {
    long long b, ty, tx;
    const long long t = live ? tile : 0;
    if (n_tiles <= 0xffffffffLL) {  // 32-bit division: a few instructions, not a call
      const unsigned t32 = (unsigned)t, tpi = (unsigned)ht * (unsigned)wt;
      const unsigned b32 = t32 / tpi, rem = t32 - b32 * tpi, ty32 = rem / (unsigned)wt;
      b = b32;
      ty = ty32;
      tx = rem - ty32 * (unsigned)wt;
    } else {
      const long long tiles_per_image = (long long)ht * wt, rem = t % tiles_per_image;
      b = t / tiles_per_image;
      ty = rem / wt;
      tx = rem % wt;
    }
    const long long row = (long long)wt * T;  // gray row length
#pragma unroll
    for (int r = 0; r < PPL; ++r) {
      X[r] = live ? __ldg(&gray[(b * ht * T + ty * T + y[r]) * row + tx * T + x[r]]) : 0.0f;
    }
  }

  // ---- phi3: Sobel of the tile (edge), pairwise sums of gx^2, gy^2, gx, gy
  float phi3;
  {
    float sy[PPL], sx[PPL], a0[PPL], a1[PPL], a2[PPL], a3[PPL];
#pragma unroll
    for (int r = 0; r < PPL; ++r) {
      sy[r] = wfilt<T, true, true, false, 3>(X, r, base, y[r], x[r], sm);
      sx[r] = wfilt<T, true, false, false, 3>(X, r, base, y[r], x[r], sm);
    }
#pragma unroll
    for (int r = 0; r < PPL; ++r) {
      const float gx = wfilt<T, true, false, false, 3>(sy, r, base, y[r], x[r], df);
      const float gy = wfilt<T, true, true, false, 3>(sx, r, base, y[r], x[r], df);
      a0[r] = gx * gx;
      a1[r] = gy * gy;
      a2[r] = gx;
      a3[r] = gy;
    }
    float s0 = a0[0], s1 = a1[0], s2 = a2[0], s3 = a3[0];
    if constexpr (PPL == 2) {  // h = 32: slot s adds slot s + 32
      s0 = s0 + a0[1];
      s1 = s1 + a1[1];
      s2 = s2 + a2[1];
      s3 = s3 + a3[1];
    }
#pragma unroll
    for (int h = G::W / 2; h >= 1; h >>= 1) {
      s0 = s0 + __shfl_down_sync(kFull, s0, h);
      s1 = s1 + __shfl_down_sync(kFull, s1, h);
      s2 = s2 + __shfl_down_sync(kFull, s2, h);
      s3 = s3 + __shfl_down_sync(kFull, s3, h);
    }
    if constexpr (N > 1) {  // slot 0 holds the sums
      s0 = __shfl_sync(kFull, s0, base);
      s1 = __shfl_sync(kFull, s1, base);
      s2 = __shfl_sync(kFull, s2, base);
      s3 = __shfl_sync(kFull, s3, base);
    }
    phi3 = phi3_of(s0, s1, s2, s3, inv_n);
  }

  // ---- Canny: the edge ballot
  uint64_t ew;
  {
    float mag[PPL], nm[PPL];
    int d[PPL];
    float b1[PPL];  // the blurred tile
    {
      float b0[PPL];
#pragma unroll
      for (int r = 0; r < PPL; ++r) {
        b0[r] = wfilt<T, !LEGACY, true, false, 5>(X, r, base, y[r], x[r], taps.g5);
      }
#pragma unroll
      for (int r = 0; r < PPL; ++r) {
        b1[r] = wfilt<T, !LEGACY, false, false, 5>(b0, r, base, y[r], x[r], taps.g5);
      }
    }
    float thr255 = 0.0f;
    if (!LEGACY) thr255 = wotsu<T>(b1, base) * 255.0f;
    {
      float sy[PPL], sx[PPL];
#pragma unroll
      for (int r = 0; r < PPL; ++r) {  // cv2compat: of b255 = b01 * 255
        sy[r] = wfilt<T, !LEGACY, true, !LEGACY, 3>(b1, r, base, y[r], x[r], sm);
        sx[r] = wfilt<T, !LEGACY, false, !LEGACY, 3>(b1, r, base, y[r], x[r], sm);
      }
#pragma unroll
      for (int r = 0; r < PPL; ++r) {
        const float gx = wfilt<T, !LEGACY, false, false, 3>(sy, r, base, y[r], x[r], df);
        const float gy = wfilt<T, !LEGACY, true, false, 3>(sx, r, base, y[r], x[r], df);
        mag[r] = LEGACY ? sqrtf(gx * gx + gy * gy + F32(1e-12)) : fabsf(gx) + fabsf(gy);
        d[r] = dir_bin(gx, gy);
      }
    }
#pragma unroll
    for (int r = 0; r < PPL; ++r) {  // NMS, neighbours read with edge borders
      int dy, dx;
      nms_offset(d[r], dy, dx);
      const float n1 = wfetch<T, true, false>(mag, r, base, y[r] + dy, x[r] + dx);
      const float n2 = wfetch<T, true, false>(mag, r, base, y[r] - dy, x[r] - dx);
      nm[r] = (mag[r] >= n1 && mag[r] >= n2) ? mag[r] : 0.0f;
    }
    bool e[PPL], weak[PPL];
    if (!LEGACY) {
#pragma unroll
      for (int r = 0; r < PPL; ++r) {
        e[r] = nm[r] > thr255;
        weak[r] = nm[r] > 0.5f * thr255;
      }
      ew = whysteresis<T>(e, weak, 8);
    } else {
      float mn = nm[0], mx = nm[0];  // the tile's min and max (exact in any order)
      if constexpr (PPL == 2) {
        mn = fminf(mn, nm[1]);
        mx = fmaxf(mx, nm[1]);
      }
#pragma unroll
      for (int o = 1; o < G::W; o <<= 1) {
        mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      }
      float nn[PPL];
#pragma unroll
      for (int r = 0; r < PPL; ++r) nn[r] = (nm[r] - mn) / (mx - mn + F32(1e-8));  // nms_n
      const float thr = wotsu<T>(nn, base);
#pragma unroll
      for (int r = 0; r < PPL; ++r) {
        e[r] = nn[r] > thr;
        weak[r] = nn[r] > 0.5f * thr;
      }
      ew = whysteresis<T>(e, weak, 2);
    }
  }

  // ---- binarization: the mask ballot
  uint64_t mw;
  {
    bool m[PPL];
    if (!OTSU_BIN) {
      float g0[PPL];
#pragma unroll
      for (int r = 0; r < PPL; ++r) {
        g0[r] = wfilt<T, true, true, true, 11>(X, r, base, y[r], x[r], taps.g11);
      }
#pragma unroll
      for (int r = 0; r < PPL; ++r) {
        const float local_mean = wfilt<T, true, false, false, 11>(g0, r, base, y[r], x[r],
                                                                  taps.g11);
        m[r] = X[r] * 255.0f > local_mean - 2.0f;
      }
    } else {
      const float thr = wotsu<T>(X, base);
#pragma unroll
      for (int r = 0; r < PPL; ++r) m[r] = X[r] > thr;
    }
    mw = ballot<T>(m);
  }

  // ---- counts: edges, area, boundary, Euler windows, LBP labels, boxes
  TileCounts c;
  c.edge = __popcll(ew & tbits);
  c.area = __popcll(mw & tbits);
  c.perim = __popcll(mw & ~werode<T>(mw) & tbits);
  c.euler4 = 0;
  if (CONTOUR) {
    // Gray's quad patterns of every window at once: the windows whose
    // bottom-right pixel is in the tile (tl, tr, bl, br shifted in from the
    // zero-padded mask), then the windows past the last row (tl, tr only),
    // past the last column (tl, bl only) and the corner (tl only)
    using M = Masks<T>;
    const uint64_t br = mw, bl = (mw << 1) & ~M::kX0;
    const uint64_t tr = (mw << T) & ~M::kY0, tl = (bl << T) & ~M::kY0;
    const uint64_t odd = tl ^ tr ^ bl ^ br;
    const uint64_t two = (tl & tr) | (bl & br) | ((tl ^ tr) & (bl ^ br));  // at least two set
    const uint64_t q1 = odd & ~two, q3 = odd & two;
    const uint64_t qd = (tr & bl & ~tl & ~br) | (tl & br & ~tr & ~bl);
    c.euler4 = __popcll(q1 & tbits) - __popcll(q3 & tbits) - 2 * __popcll(qd & tbits) +
               __popcll((bl ^ br) & M::kY1 & tbits) + __popcll((tr ^ br) & M::kX1 & tbits) +
               __popcll(mw & M::kX1 & M::kY1 & tbits);
  }
  int lbp_mine = 0;  // the count of label pix (lanes 0-9 of a tile)
  {
    // uniform LBP (P = 8, R = 1) of the gray tile, neighbours edge
    const int oy[8] = {-1, -1, -1, 0, 1, 1, 1, 0};
    const int ox[8] = {-1, 0, 1, 1, 1, 0, -1, -1};
    int label[PPL];
#pragma unroll
    for (int r = 0; r < PPL; ++r) {
      int bits[8], ones = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        bits[k] = wfetch<T, true, false>(X, r, base, y[r] + oy[k], x[r] + ox[k]) >= X[r];
        ones += bits[k];
      }
      int trans = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) trans += bits[k] != bits[(k + 7) & 7];
      label[r] = trans <= 2 ? ones : 9;
    }
#pragma unroll
    for (int v = 0; v < 10; ++v) {
      bool is[PPL];
#pragma unroll
      for (int r = 0; r < PPL; ++r) is[r] = label[r] == v;
      c.lbp[v] = __popcll(ballot<T>(is) & tbits);
      lbp_mine = pix == v ? c.lbp[v] : lbp_mine;
    }
  }
#pragma unroll
  for (int k = 0; k < kScales; ++k) c.box[k] = 0;
  int box_mine = 0;  // the count of scale pix (lanes 0 .. LT-1 of a tile)
  {
    // the occupancy pyramid of the edges (max_pool2d of a {0, 1} map): a
    // level's box is the OR of four boxes of the level below, kept at its
    // top-left pixel
    uint64_t occ = ew;
#pragma unroll
    for (int k = 1; k <= LT; ++k) {
      const int s = 1 << (k - 1);
      occ = occ | (occ >> s) | (occ >> (s * T)) | (occ >> (s * T + s));
      c.box[k - 1] = __popcll(occ & Masks<T>::corner(k) & tbits);
      box_mine = pix == k - 1 ? c.box[k - 1] : box_mine;
    }
  }

  // ---- the outputs: every lane of the tile computes them, lanes write; from
  // 4 x 4 tiles up lane k of a tile computes the transcendental terms of scale
  // k and of LBP label k, the sums then run in order over shuffles
  float phi1 = 1.0f, phi2;
  if constexpr (N >= 16) {
    float xk, yk, wk;
    phi1_terms(pix < LT ? pix : 0, box_mine, xk, yk, wk);
    float xs[kScales], ys[kScales], ws[kScales];
#pragma unroll
    for (int k = 0; k < LT; ++k) {
      xs[k] = __shfl_sync(kFull, xk, base + k);
      ys[k] = __shfl_sync(kFull, yk, base + k);
      ws[k] = __shfl_sync(kFull, wk, base + k);
    }
    phi1 = phi1_fit(xs, ys, ws, LT);
    const float term = entropy_term(lbp_mine, inv_n);
    float ent = -__shfl_sync(kFull, term, base);
#pragma unroll
    for (int v = 1; v < 10; ++v) ent = ent - __shfl_sync(kFull, term, base + v);
    phi2 = ent * F32(1.0 / 3.321928094887362);
  } else {
    phi2 = phi2_of(c.lbp, inv_n);
  }
  float o[8];
  phi_outputs(c, phi1, phi2, phi3, inv_n, CONTOUR, o);
  if (live) {
    float* out = phi + tile * 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if ((N >= 8 ? k : (k & (N - 1))) == pix) out[k] = o[k];
    }
  }
}

// ---- block path (tiles 16 x 16 to 1024 x 1024): one tile per block

struct Planes {
  int lt, n;
  float *X, *P0, *P1, *P2, *P3;
  uint8_t *B0, *E, *E2, *W, *M;
};

// value of `plane` at (yy, xx): EDGE clamps into the tile, otherwise 0 outside
template <bool EDGE>
__device__ __forceinline__ float fetch(const float* plane, int yy, int xx, int lt) {
  const int t = 1 << lt;
  if (EDGE) {
    yy = clampi(yy, t - 1);
    xx = clampi(xx, t - 1);
  } else if (yy < 0 || yy >= t || xx < 0 || xx >= t) {
    return 0.0f;
  }
  return plane[(yy << lt) + xx];
}

// the block path's 1-D filter at (y, x), as wfilt
template <bool EDGE, bool VERT, bool S255, int K>
__device__ __forceinline__ float filt(const float* plane, int y, int x, int lt,
                                      const float (&w)[K]) {
  constexpr int r = K / 2;
  float out = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float v = VERT ? fetch<EDGE>(plane, y + i - r, x, lt) : fetch<EDGE>(plane, y, x + i - r, lt);
    if (S255) v = v * 255.0f;
    const float s = v * w[i];
    out = i == 0 ? s : out + s;
  }
  return out;
}

__device__ __forceinline__ int warp_sum(int v) { return __reduce_add_sync(kFull, v); }

// the block's shared scratch beside the planes
struct Header {
  int cnt[kCnt];
  float phi3;
  int hist[kBins];
  int scan_k[kWarps];
  long long scan_s[kWarps];
  float arg_sigma[kWarps];
  int arg_bin[kWarps];
  float mn[kWarps], mx[kWarps];
};
static_assert(sizeof(Header) <= kHeader, "the block path's header outgrew kHeader");

// the tile's Otsu threshold of `src` (every thread gets it): a 256-bin
// histogram, an exact integer scan over the bins, each thread scoring its own
// bin, a block argmax
__device__ float otsu_block(const Planes& g, const float* src, Header& h) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float p = 1.0f / (float)g.n;
  const float q = p * (1.0f / 512.0f);
  h.hist[tid] = 0;
  __syncthreads();
  for (int s = tid; s < g.n; s += kThreads) atomicAdd(&h.hist[otsu_bin(src[s])], 1);
  __syncthreads();
  const int c = h.hist[tid];
  int K = c;  // inclusive scan over the bins
  long long S = (long long)c * (2 * tid + 1);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int k2 = __shfl_up_sync(kFull, K, o);
    const long long s2 = __shfl_up_sync(kFull, S, o);
    if (lane >= o) {
      K += k2;
      S += s2;
    }
  }
  if (lane == 31) {
    h.scan_k[warp] = K;
    h.scan_s[warp] = S;
  }
  __syncthreads();
  long long St = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    St += h.scan_s[w];
    if (w < warp) {
      K += h.scan_k[w];
      S += h.scan_s[w];
    }
  }
  float best = c > 0 ? otsu_sigma(K, S, St, p, q) : -1.0f;  // empty bins are skipped
  int bin = tid;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float ob = __shfl_xor_sync(kFull, best, o);
    const int obb = __shfl_xor_sync(kFull, bin, o);
    otsu_better(best, bin, ob, obb);
  }
  if (lane == 0) {
    h.arg_sigma[warp] = best;
    h.arg_bin[warp] = bin;
  }
  __syncthreads();
  best = h.arg_sigma[0];
  bin = h.arg_bin[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) otsu_better(best, bin, h.arg_sigma[w], h.arg_bin[w]);
  return otsu_threshold_of(bin);
}

// `iters` hysteresis passes: edge = where(weak & dilate3(edge) > 0, 1, edge);
// returns the plane that holds the result (E or E2)
__device__ uint8_t* hysteresis(const Planes& g, int iters) {
  uint8_t* cur = g.E;
  uint8_t* nxt = g.E2;
  const int lt = g.lt, t = 1 << lt;
  for (int it = 0; it < iters; ++it) {
    for (int s = threadIdx.x; s < g.n; s += kThreads) {
      const int y = s >> lt, x = s & (t - 1);
      int grown = 0;
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          const int yy = y + dy, xx = x + dx;
          if (yy >= 0 && yy < t && xx >= 0 && xx < t) grown |= cur[(yy << lt) + xx];
        }
      nxt[s] = (g.W[s] && grown) ? 1 : cur[s];
    }
    __syncthreads();
    uint8_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

// Sobel of `src` (times 255 when S255): the smoothing passes into sy, sx
template <bool EDGE, bool S255>
__device__ void sobel_planes(const Planes& g, const float* src, float* sy, float* sx) {
  const float smooth[3] = {1.0f, 2.0f, 1.0f};
  const int lt = g.lt, t = 1 << lt;
  for (int s = threadIdx.x; s < g.n; s += kThreads) {
    const int y = s >> lt, x = s & (t - 1);
    sy[s] = filt<EDGE, true, S255, 3>(src, y, x, lt, smooth);
    sx[s] = filt<EDGE, false, S255, 3>(src, y, x, lt, smooth);
  }
  __syncthreads();
}

template <bool EDGE>
__device__ __forceinline__ void sobel_at(const Planes& g, const float* sy, const float* sx,
                                         int y, int x, float& gx, float& gy) {
  const float diff[3] = {-1.0f, 0.0f, 1.0f};
  gx = filt<EDGE, false, false, 3>(sy, y, x, g.lt, diff);
  gy = filt<EDGE, true, false, 3>(sx, y, x, g.lt, diff);
}

// NMS of the magnitude plane at (y, x): the pixel's magnitude if it is >= both
// neighbours along its direction bin (read with edge borders), else 0
__device__ __forceinline__ float nms_at(const float* mag, int y, int x, int lt, int d) {
  int dy, dx;
  nms_offset(d, dy, dx);
  const float m = mag[(y << lt) + x];
  const float n1 = fetch<true>(mag, y + dy, x + dx, lt);
  const float n2 = fetch<true>(mag, y - dy, x - dx, lt);
  return (m >= n1 && m >= n2) ? m : 0.0f;
}

template <bool LEGACY, bool OTSU_BIN, bool CONTOUR>
__global__ void __launch_bounds__(kThreads)
phi_block_kernel(const float* __restrict__ gray, float* __restrict__ phi,
                 unsigned char* scratch, int ht, int wt, int lt, long long n_tiles,
                 int ws_global, long long ws_bytes, Taps taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  Header& h = *reinterpret_cast<Header*>(smem);
  Planes g;
  g.lt = lt;
  g.n = 1 << (2 * lt);
  const int t = 1 << lt, n = g.n, tid = threadIdx.x;
  unsigned char* ws = ws_global ? scratch + (long long)blockIdx.x * ws_bytes : smem + kHeader;
  g.X = reinterpret_cast<float*>(ws);
  g.P0 = g.X + n;
  g.P1 = g.P0 + n;
  g.P2 = g.P1 + n;
  g.P3 = g.P2 + n;
  g.B0 = reinterpret_cast<uint8_t*>(g.P3 + n);
  g.E = g.B0 + n;
  g.E2 = g.E + n;
  g.W = g.E2 + n;
  g.M = g.W + n;
  const long long tiles_per_image = (long long)ht * wt;
  const long long row = (long long)wt << lt;  // gray row length
  const float inv_n = 1.0f / (float)n;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // ---- load the tile; zero the counters
    if (tid < kCnt) h.cnt[tid] = 0;
    {
      const long long b = tile / tiles_per_image, r = tile % tiles_per_image;
      const long long ty = r / wt, tx = r % wt;
      const float* src = gray + (b * ht * t + (ty << lt)) * row + (tx << lt);
      for (int s = tid; s < n; s += kThreads) g.X[s] = src[(s >> lt) * row + (s & (t - 1))];
    }
    __syncthreads();

    // ---- phi3: Sobel of the tile (edge), pairwise sums of gx^2, gy^2, gx, gy
    sobel_planes<true, false>(g, g.X, g.P0, g.P1);
    for (int s = tid; s < n; s += kThreads) {
      float gx, gy;
      sobel_at<true>(g, g.P0, g.P1, s >> lt, s & (t - 1), gx, gy);
      g.P2[s] = gx;
      g.P3[s] = gy;
    }
    __syncthreads();
    for (int s = tid; s < n; s += kThreads) {
      g.P0[s] = g.P2[s] * g.P2[s];
      g.P1[s] = g.P3[s] * g.P3[s];
    }
    // levels h >= 256: slot s and s + h are both this thread's (s = tid mod 256)
    for (int hh = n >> 1; hh >= kThreads; hh >>= 1) {
      for (int s = tid; s < hh; s += kThreads) {
        g.P0[s] = g.P0[s] + g.P0[s + hh];
        g.P1[s] = g.P1[s] + g.P1[s + hh];
        g.P2[s] = g.P2[s] + g.P2[s + hh];
        g.P3[s] = g.P3[s] + g.P3[s + hh];
      }
    }
    __syncthreads();
#pragma unroll
    for (int hh = kThreads / 2; hh >= 64; hh >>= 1) {  // h = 128, 64 through shared memory
      if (tid < hh) {
        g.P0[tid] = g.P0[tid] + g.P0[tid + hh];
        g.P1[tid] = g.P1[tid] + g.P1[tid + hh];
        g.P2[tid] = g.P2[tid] + g.P2[tid + hh];
        g.P3[tid] = g.P3[tid] + g.P3[tid + hh];
      }
      __syncthreads();
    }
    if (tid < 32) {  // h = 32 .. 1 in warp 0
      float s0 = g.P0[tid] + g.P0[tid + 32], s1 = g.P1[tid] + g.P1[tid + 32];
      float s2 = g.P2[tid] + g.P2[tid + 32], s3 = g.P3[tid] + g.P3[tid + 32];
#pragma unroll
      for (int hh = 16; hh >= 1; hh >>= 1) {
        s0 = s0 + __shfl_down_sync(kFull, s0, hh);
        s1 = s1 + __shfl_down_sync(kFull, s1, hh);
        s2 = s2 + __shfl_down_sync(kFull, s2, hh);
        s3 = s3 + __shfl_down_sync(kFull, s3, hh);
      }
      if (tid == 0) h.phi3 = phi3_of(s0, s1, s2, s3, inv_n);
    }
    __syncthreads();

    // ---- Canny: the edge map into E (or E2)
    uint8_t* edge;
    if (!LEGACY) {
      for (int s = tid; s < n; s += kThreads) {
        g.P0[s] = filt<true, true, false, 5>(g.X, s >> lt, s & (t - 1), lt, taps.g5);
      }
      __syncthreads();
      for (int s = tid; s < n; s += kThreads) {
        g.P1[s] = filt<true, false, false, 5>(g.P0, s >> lt, s & (t - 1), lt, taps.g5);  // b01
      }
      __syncthreads();
      const float thr255 = otsu_block(g, g.P1, h) * 255.0f;
      sobel_planes<true, true>(g, g.P1, g.P2, g.P3);  // of b255 = b01 * 255
      for (int s = tid; s < n; s += kThreads) {
        float gx, gy;
        sobel_at<true>(g, g.P2, g.P3, s >> lt, s & (t - 1), gx, gy);
        g.P0[s] = fabsf(gx) + fabsf(gy);
        g.B0[s] = (uint8_t)dir_bin(gx, gy);
      }
      __syncthreads();
      for (int s = tid; s < n; s += kThreads) {
        const float nm = nms_at(g.P0, s >> lt, s & (t - 1), lt, g.B0[s]);
        g.E[s] = nm > thr255;
        g.W[s] = nm > 0.5f * thr255;
      }
      __syncthreads();
      edge = hysteresis(g, 8);
    } else {
      for (int s = tid; s < n; s += kThreads) {
        g.P0[s] = filt<false, true, false, 5>(g.X, s >> lt, s & (t - 1), lt, taps.g5);
      }
      __syncthreads();
      for (int s = tid; s < n; s += kThreads) {
        g.P1[s] = filt<false, false, false, 5>(g.P0, s >> lt, s & (t - 1), lt, taps.g5);
      }
      __syncthreads();
      sobel_planes<false, false>(g, g.P1, g.P2, g.P3);
      for (int s = tid; s < n; s += kThreads) {
        float gx, gy;
        sobel_at<false>(g, g.P2, g.P3, s >> lt, s & (t - 1), gx, gy);
        g.P0[s] = sqrtf(gx * gx + gy * gy + F32(1e-12));
        g.B0[s] = (uint8_t)dir_bin(gx, gy);
      }
      __syncthreads();
      float mn = INFINITY, mx = -INFINITY;  // the tile's min and max (exact in any order)
      for (int s = tid; s < n; s += kThreads) {
        const float nm = nms_at(g.P0, s >> lt, s & (t - 1), lt, g.B0[s]);
        g.P1[s] = nm;
        mn = fminf(mn, nm);
        mx = fmaxf(mx, nm);
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      }
      if ((tid & 31) == 0) {
        h.mn[tid >> 5] = mn;
        h.mx[tid >> 5] = mx;
      }
      __syncthreads();
      mn = h.mn[0];
      mx = h.mx[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        mn = fminf(mn, h.mn[w]);
        mx = fmaxf(mx, h.mx[w]);
      }
      for (int s = tid; s < n; s += kThreads) {
        g.P0[s] = (g.P1[s] - mn) / (mx - mn + F32(1e-8));  // nms_n
      }
      __syncthreads();
      const float thr = otsu_block(g, g.P0, h);
      for (int s = tid; s < n; s += kThreads) {
        g.E[s] = g.P0[s] > thr;
        g.W[s] = g.P0[s] > 0.5f * thr;
      }
      __syncthreads();
      edge = hysteresis(g, 2);
    }

    // ---- binarization into M
    if (!OTSU_BIN) {
      for (int s = tid; s < n; s += kThreads) {
        g.P0[s] = filt<true, true, true, 11>(g.X, s >> lt, s & (t - 1), lt, taps.g11);
      }
      __syncthreads();
      for (int s = tid; s < n; s += kThreads) {
        const float local_mean = filt<true, false, false, 11>(g.P0, s >> lt, s & (t - 1), lt,
                                                              taps.g11);
        g.M[s] = g.X[s] * 255.0f > local_mean - 2.0f;
      }
    } else {
      const float thr = otsu_block(g, g.X, h);
      for (int s = tid; s < n; s += kThreads) g.M[s] = g.X[s] > thr;
    }
    __syncthreads();

    // ---- counts: edges, area, boundary, Euler windows, LBP labels, gathered
    // in registers and added once per warp
    {
      int c_edge = 0, c_area = 0, c_perim = 0, c_e4 = 0;
      int lbp[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
      const int oy[8] = {-1, -1, -1, 0, 1, 1, 1, 0};
      const int ox[8] = {-1, 0, 1, 1, 1, 0, -1, -1};
      for (int s = tid; s < n; s += kThreads) {
        const int y = s >> lt, x = s & (t - 1);
        const int m = g.M[s];
        int eroded = 1;
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx) {
            const int yy = y + dy, xx = x + dx;
            if (yy >= 0 && yy < t && xx >= 0 && xx < t) eroded &= g.M[(yy << lt) + xx];
          }
        c_edge += edge[s];
        c_area += m;
        c_perim += m & (eroded ^ 1);
        if (CONTOUR) {
          auto mask = [&](int yy, int xx) {
            return (yy >= 0 && yy < t && xx >= 0 && xx < t) ? (int)g.M[(yy << lt) + xx] : 0;
          };
          auto window = [&](int i, int j) {
            return euler_window(mask(i - 1, j - 1), mask(i - 1, j), mask(i, j - 1), mask(i, j));
          };
          c_e4 += window(y, x);
          if (y == t - 1) c_e4 += window(t, x);
          if (x == t - 1) c_e4 += window(y, t);
          if (y == t - 1 && x == t - 1) c_e4 += window(t, t);
        }
        // uniform LBP (P = 8, R = 1) of the gray tile, neighbours edge
        const float ctr = g.X[s];
        int bits[8], ones = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          bits[k] = fetch<true>(g.X, y + oy[k], x + ox[k], lt) >= ctr;
          ones += bits[k];
        }
        int trans = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) trans += bits[k] != bits[(k + 7) & 7];
        const int label = trans <= 2 ? ones : 9;
#pragma unroll
        for (int v = 0; v < 10; ++v) lbp[v] += label == v;
      }
      const int lane = tid & 31;
      c_edge = warp_sum(c_edge);
      c_area = warp_sum(c_area);
      c_perim = warp_sum(c_perim);
      if (CONTOUR) c_e4 = warp_sum(c_e4);
      if (lane == 0) {
        atomicAdd(&h.cnt[kEdge], c_edge);
        atomicAdd(&h.cnt[kArea], c_area);
        atomicAdd(&h.cnt[kPerim], c_perim);
        if (CONTOUR) atomicAdd(&h.cnt[kEuler4], c_e4);
      }
#pragma unroll
      for (int v = 0; v < 10; ++v) {
        const int cv = warp_sum(lbp[v]);
        if (lane == 0) atomicAdd(&h.cnt[kLbp + v], cv);
      }
    }
    __syncthreads();

    // ---- dyadic box counts of the edges: occupancy pyramid, 2x2 ORs per level
    {
      const uint8_t* src = edge;
      uint8_t* dst = edge == g.E ? g.E2 : g.E;
      uint8_t* other = g.W;
      for (int k = 1; k <= lt; ++k) {
        const int side = t >> k, lside = lt - k, up = 2 * side;
        int occ_n = 0;
        for (int s = tid; s < side * side; s += kThreads) {
          const int cy = s >> lside, cx = s & (side - 1);
          const uint8_t* o = src + (2 * cy) * up + 2 * cx;
          const int occ = o[0] | o[1] | o[up] | o[up + 1];
          dst[s] = (uint8_t)occ;
          occ_n += occ;
        }
        occ_n = warp_sum(occ_n);
        if ((tid & 31) == 0 && occ_n != 0) atomicAdd(&h.cnt[kBox + k - 1], occ_n);
        __syncthreads();
        src = dst;
        uint8_t* tmp = other;
        other = dst;
        dst = tmp;
      }
    }

    // ---- the outputs: threads 0-7 compute them, each writes one
    if (tid < 8) {
      TileCounts c;
      c.edge = h.cnt[kEdge];
      c.area = h.cnt[kArea];
      c.perim = h.cnt[kPerim];
      c.euler4 = h.cnt[kEuler4];
#pragma unroll
      for (int v = 0; v < 10; ++v) c.lbp[v] = h.cnt[kLbp + v];
#pragma unroll
      for (int k = 0; k < kScales; ++k) c.box[k] = k < lt ? h.cnt[kBox + k] : 0;
      float o[8];
      phi_outputs(c, phi1_of(c.box, lt), phi2_of(c.lbp, inv_n), h.phi3, inv_n, CONTOUR, o);
      float v = o[0];
#pragma unroll
      for (int k = 1; k < 8; ++k) v = tid == k ? o[k] : v;
      phi[tile * 8 + tid] = v;
    }
    __syncthreads();
  }
}

template <int T, bool L, bool O, bool C>
int launch_warp(const float* gray, float* phi, int ht, int wt, long long n_tiles, int grid,
                const Taps& taps, cudaStream_t stream) {
  phi_warp_kernel<T, L, O, C><<<grid, kSmallThreads, 0, stream>>>(gray, phi, ht, wt, n_tiles,
                                                                  taps);
  return (int)cudaGetLastError();
}

template <bool L, bool O, bool C>
int launch(const float* gray, float* phi, unsigned char* scratch, int ht, int wt, int lt,
           long long n_tiles, int grid, int ws_global, long long ws_bytes, int smem,
           const Taps& taps, cudaStream_t stream) {
  switch (lt) {
    case 0: return launch_warp<1, L, O, C>(gray, phi, ht, wt, n_tiles, grid, taps, stream);
    case 1: return launch_warp<2, L, O, C>(gray, phi, ht, wt, n_tiles, grid, taps, stream);
    case 2: return launch_warp<4, L, O, C>(gray, phi, ht, wt, n_tiles, grid, taps, stream);
    case 3: return launch_warp<8, L, O, C>(gray, phi, ht, wt, n_tiles, grid, taps, stream);
    default: break;
  }
  auto kernel = phi_block_kernel<L, O, C>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(gray, phi, scratch, ht, wt, lt, n_tiles, ws_global,
                                           ws_bytes, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch geometry is worked out by the wrapper
// (core/morphology_lanes.py:launch_geometry) and checked here again.
extern "C" int mcaq_phi_tiles(const void* gray, void* phi, void* scratch, int B, int ht,
                              int wt, int lt, int legacy, int otsu_bin, int contour,
                              int tiles_per_block, int grid, int ws_global, long long ws_bytes,
                              int smem, const float* taps5, const float* taps11, void* stream) {
  if (B <= 0 || ht <= 0 || wt <= 0 || lt < 0 || lt > kMaxLt || grid <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = 1 << (2 * lt);
  const long long n_tiles = (long long)B * ht * wt;
  const bool warp_path = lt <= kSmallMaxLt;
  int want_tpb, want_global;
  long long want_ws, want_smem, want_grid;
  if (warp_path) {
    want_tpb = kSmallWarps * (n >= 32 ? 1 : 32 / n);
    want_global = 0;
    want_ws = 0;
    want_smem = 0;
    want_grid = (n_tiles + want_tpb - 1) / want_tpb;
  } else {
    want_tpb = 1;
    want_ws = 25LL * n;  // five float and five byte planes
    want_global = kHeader + want_ws > kMaxSmem;
    want_smem = kHeader + (want_global ? 0 : want_ws);
    want_grid = want_global ? (n_tiles < kGlobalBlocks ? n_tiles : kGlobalBlocks) : n_tiles;
  }
  if (tiles_per_block != want_tpb || ws_global != want_global || ws_bytes != want_ws ||
      smem != want_smem || grid != want_grid || (ws_global && scratch == nullptr) ||
      reinterpret_cast<uintptr_t>(gray) % 4 != 0 || reinterpret_cast<uintptr_t>(phi) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Taps taps;
  for (int i = 0; i < 5; ++i) taps.g5[i] = taps5[i];
  for (int i = 0; i < 11; ++i) taps.g11[i] = taps11[i];
  const float* g = static_cast<const float*>(gray);
  float* o = static_cast<float*>(phi);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = (legacy ? 4 : 0) | (otsu_bin ? 2 : 0) | (contour ? 1 : 0);
#define MCAQ_PHI_CASE(K, L, O, C) \
  case K:                         \
    return launch<L, O, C>(g, o, sc, ht, wt, lt, n_tiles, grid, ws_global, ws_bytes, smem, taps, st);
  switch (key) {
    MCAQ_PHI_CASE(0, false, false, false)
    MCAQ_PHI_CASE(1, false, false, true)
    MCAQ_PHI_CASE(2, false, true, false)
    MCAQ_PHI_CASE(3, false, true, true)
    MCAQ_PHI_CASE(4, true, false, false)
    MCAQ_PHI_CASE(5, true, false, true)
    MCAQ_PHI_CASE(6, true, true, false)
    MCAQ_PHI_CASE(7, true, true, true)
  }
#undef MCAQ_PHI_CASE
  return (int)cudaErrorInvalidValue;
}
