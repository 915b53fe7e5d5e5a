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
// sqrt(phi4*phi5 + 1e-12).  The options are template flags (8 instances).
//
// Bitwise parity with the plain version.  Every elementwise step is the plain
// version's PyTorch op in its literal order, in float32, each rounded on its
// own: the build passes -fmad=false, so nothing is contracted into an FMA.
// The functions are the ones ATen's CUDA kernels call (atan2f, logf, log2f,
// expf, correctly rounded sqrtf and division).  The plain version writes its
// two float reductions in a fixed order (phi3's tile sums pairwise, first
// half plus second half; phi1's regression sums over the scales in order),
// which the kernel repeats.  Otsu: the plain version scores sigma_b at the
// last pixel of each run of its sorted bins from a cumsum; every partial sum
// there is a multiple of 2^-9 / t^2 below 1, exact in float32 for t <= 128 in
// any order, so the kernel scores each bin from integer counts (a pixel's
// count and bin sum over the pixels of its tile at or below its bin for tiles
// of <= 64 pixels, a 256-bin shared-memory histogram above) and takes the
// first maximum, as argmax does.  The remaining reductions count {0, 1}
// maps or quarter-integers, exact in any order.
//
// Layout.  A block takes a group of whole tiles: 256 pixel slots, so 256 / t^2
// tiles of up to 16 x 16 pixels, one tile above.  The group's planes (five
// float, five byte: 25 bytes a pixel) sit in shared memory up to t = 64
// (100 KB); t = 128 (400 KB) keeps them in a global scratch slice per block,
// the blocks then striding over the tiles.  Each stage is a loop over the
// slots between barriers; per-tile counters are summed over lane segments
// that lie in one tile, then added to shared memory.  A tile's result does
// not depend on the other tiles of its group, the batch size or its position.
//
// What bounds it on this card.  The work is a few hundred float operations
// and a few dozen shared-memory reads per pixel on a map of a few MB: both the
// byte bound (the gray map read once, phi written once) and the FP32 bound are
// a few microseconds at bs 256.  This first version is paced by its ~40
// barriers per group and the latency of each stage, with one tile's worth of
// Otsu work on one thread; making it fast is later work (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads per block (core/morphology_lanes.py THREADS)
constexpr int kSlots = 256;     // pixel slots per group of small tiles (SLOTS)
constexpr int kCnt = 24;        // int counters per tile (COUNTERS)
constexpr int kTf = 2;          // float scratch per tile: Otsu threshold, phi3
constexpr int kBins = 256;      // Otsu bins
constexpr int kMaxSmem = 232448;

// the per-tile int counters
enum { kEdge = 0, kArea = 1, kPerim = 2, kEuler4 = 3, kLbp = 4, kBox = 14 };

struct Taps {
  float g5[5];    // _gaussian_taps(5, 1.0)
  float g11[11];  // _gaussian_taps(11, 2.0000000000000004), adaptive_binarize's
};

// python float constants as torch casts them to float32
#define F32(x) ((float)(x))

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// value of `plane` at (yy, xx) of the tile at `base`: EDGE clamps into the
// tile, otherwise 0 outside
template <bool EDGE>
__device__ __forceinline__ float fetch(const float* plane, int base, int yy, int xx, int lt) {
  const int t = 1 << lt;
  if (EDGE) {
    yy = clampi(yy, t - 1);
    xx = clampi(xx, t - 1);
  } else if (yy < 0 || yy >= t || xx < 0 || xx >= t) {
    return 0.0f;
  }
  return plane[base + (yy << lt) + xx];
}

// 1-D filter along y (VERT) or x of the plane, taps in order, accumulated as
// out = s0 * w0; out = out + s_i * w_i (the plain version's _sep_filter /
// sobel pass1); S255 multiplies each read by 255 first (b255, g255)
template <bool EDGE, bool VERT, bool S255, int K>
__device__ __forceinline__ float filt(const float* plane, int base, int y, int x, int lt,
                                      const float* w) {
  constexpr int r = K / 2;
  float out = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float v = VERT ? fetch<EDGE>(plane, base, y + i - r, x, lt)
                   : fetch<EDGE>(plane, base, y, x + i - r, lt);
    if (S255) v = v * 255.0f;
    const float s = v * w[i];
    out = i == 0 ? s : out + s;
  }
  return out;
}

__device__ __forceinline__ int seg_sum(int v, int width) {
  // sum over aligned segments of `width` lanes (a power of two <= 32); every
  // lane of the warp takes part (the slot loops are warp-uniform)
  for (int o = 1; o < width; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void add_count(int* counter, int v, int width) {
  v = seg_sum(v, width);
  if ((threadIdx.x & (width - 1)) == 0 && v != 0) atomicAdd(counter, v);
}

__device__ __forceinline__ int otsu_bin(float v) {
  // clamp((x * 256).to(int32), 0, 255)
  return clampi((int)(v * 256.0f), kBins - 1);
}

// sigma_b at the last pixel of a bin's run: K pixels at or below the bin, S
// the sum of (2 bin + 1) over them, St over the tile; p = 1 / n, q = p / 512
__device__ __forceinline__ float otsu_sigma(int K, int S, int St, float p, float q) {
  const float omega = (float)K * p;
  const float mu = (float)S * q;
  const float mu_t = (float)St * q;
  const float d = mu_t * omega - mu;
  return (d * d) / (omega * (1.0f - omega) + F32(1e-12));
}

__device__ __forceinline__ int dir_bin(float gx, float gy) {
  float a = atan2f(gy, gx) * F32(180.0 / 3.141592653589793);
  a = a < 0.0f ? a + 180.0f : a;
  if (a < 22.5f || a >= 157.5f) return 0;
  if (a < 67.5f) return 1;
  if (a < 112.5f) return 2;
  return 3;
}

// NMS of the magnitude plane at slot (y, x) of the tile at `base`: the pixel's
// magnitude if it is >= both neighbours along its direction bin (read with
// edge borders), else 0
__device__ __forceinline__ float nms_at(const float* mag, int base, int y, int x, int lt, int d) {
  const int dy = d == 0 ? 0 : -1;
  const int dx = d == 0 ? 1 : (d == 1 ? 1 : (d == 2 ? 0 : -1));
  const float m = mag[base + (y << lt) + x];
  const float n1 = fetch<true>(mag, base, y + dy, x + dx, lt);
  const float n2 = fetch<true>(mag, base, y - dy, x - dx, lt);
  return (m >= n1 && m >= n2) ? m : 0.0f;
}

struct Group {
  int lt, ln, n, P, tpc;
  float *X, *P0, *P1, *P2, *P3;
  uint8_t *B0, *E, *E2, *W, *M;
  int* cnt;
  float* tf;
  int* hist;
};

// per-tile Otsu threshold of `src` into tf[tile * kTf]; uses B0 and `sig`
__device__ void otsu(const Group& g, const float* src, float* sig) {
  const int n = g.n, ln = g.ln;
  const float p = 1.0f / (float)n;
  const float q = p * (1.0f / 512.0f);
  if (n <= 64) {
    for (int s = threadIdx.x; s < g.P; s += kThreads) g.B0[s] = (uint8_t)otsu_bin(src[s]);
    __syncthreads();
    for (int s = threadIdx.x; s < g.P; s += kThreads) {
      const int base = (s >> ln) << ln;
      const int mine = g.B0[s];
      int K = 0, S = 0, St = 0;
      for (int k = 0; k < n; ++k) {
        const int b = g.B0[base + k];
        St += 2 * b + 1;
        if (b <= mine) {
          K += 1;
          S += 2 * b + 1;
        }
      }
      sig[s] = otsu_sigma(K, S, St, p, q);
    }
    __syncthreads();
    for (int tl = threadIdx.x; tl < g.tpc; tl += kThreads) {
      float best = -1.0f;
      int bin = kBins;
      for (int k = 0; k < n; ++k) {
        const float v = sig[(tl << ln) + k];
        const int b = g.B0[(tl << ln) + k];
        if (v > best || (v == best && b < bin)) {
          best = v;
          bin = b;
        }
      }
      g.tf[tl * kTf] = ((float)bin + 0.5f) / 256.0f;
    }
  } else {  // one tile per group
    for (int i = threadIdx.x; i < kBins; i += kThreads) g.hist[i] = 0;
    __syncthreads();
    for (int s = threadIdx.x; s < g.P; s += kThreads) atomicAdd(&g.hist[otsu_bin(src[s])], 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      int St = 0;
      for (int b = 0; b < kBins; ++b) St += g.hist[b] * (2 * b + 1);
      int K = 0, S = 0, bin = 0;
      float best = -1.0f;
      for (int b = 0; b < kBins; ++b) {
        const int c = g.hist[b];
        if (c == 0) continue;
        K += c;
        S += c * (2 * b + 1);
        const float v = otsu_sigma(K, S, St, p, q);
        if (v > best) {
          best = v;
          bin = b;
        }
      }
      g.tf[0] = ((float)bin + 0.5f) / 256.0f;
    }
  }
  __syncthreads();
}

// `iters` hysteresis passes: edge = where(weak & dilate3(edge) > 0, 1, edge);
// returns the plane that holds the result (E or E2)
__device__ uint8_t* hysteresis(const Group& g, int iters) {
  uint8_t* cur = g.E;
  uint8_t* nxt = g.E2;
  const int lt = g.lt, ln = g.ln, t = 1 << lt;
  for (int it = 0; it < iters; ++it) {
    for (int s = threadIdx.x; s < g.P; s += kThreads) {
      const int base = (s >> ln) << ln, pix = s & (g.n - 1), y = pix >> lt, x = pix & (t - 1);
      int grown = 0;
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          const int yy = y + dy, xx = x + dx;
          if (yy >= 0 && yy < t && xx >= 0 && xx < t) grown |= cur[base + (yy << lt) + xx];
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

// Sobel of `src` (times 255 when S255) into gx, gy: smoothing passes into
// P2 / P3 first
template <bool EDGE, bool S255>
__device__ void sobel_planes(const Group& g, const float* src, float* sy, float* sx) {
  const float smooth[3] = {1.0f, 2.0f, 1.0f};
  const int lt = g.lt, ln = g.ln, t = 1 << lt;
  for (int s = threadIdx.x; s < g.P; s += kThreads) {
    const int base = (s >> ln) << ln, pix = s & (g.n - 1), y = pix >> lt, x = pix & (t - 1);
    sy[s] = filt<EDGE, true, S255, 3>(src, base, y, x, lt, smooth);
    sx[s] = filt<EDGE, false, S255, 3>(src, base, y, x, lt, smooth);
  }
  __syncthreads();
}

template <bool EDGE>
__device__ __forceinline__ void sobel_at(const Group& g, const float* sy, const float* sx,
                                         int base, int y, int x, float& gx, float& gy) {
  const float diff[3] = {-1.0f, 0.0f, 1.0f};
  gx = filt<EDGE, false, false, 3>(sy, base, y, x, g.lt, diff);
  gy = filt<EDGE, true, false, 3>(sx, base, y, x, g.lt, diff);
}

template <bool LEGACY, bool OTSU_BIN, bool CONTOUR>
__global__ void __launch_bounds__(kThreads)
phi_tiles_kernel(const float* __restrict__ gray, float* __restrict__ phi,
                 unsigned char* scratch, int ht, int wt, int lt, int tpc, long long n_tiles,
                 long long n_groups, int ws_global, long long ws_bytes, Taps taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  Group g;
  g.lt = lt;
  g.ln = 2 * lt;
  g.n = 1 << g.ln;
  g.tpc = tpc;
  g.P = tpc << g.ln;
  const int t = 1 << lt, ln = g.ln, n = g.n, P = g.P;
  const int width = n < 32 ? n : 32;  // lanes of one tile in a warp
  g.cnt = reinterpret_cast<int*>(smem);
  g.tf = reinterpret_cast<float*>(g.cnt + tpc * kCnt);
  g.hist = reinterpret_cast<int*>(g.tf + tpc * kTf);
  unsigned char* ws = ws_global ? scratch + (long long)blockIdx.x * ws_bytes
                                : reinterpret_cast<unsigned char*>(g.hist + kBins);
  g.X = reinterpret_cast<float*>(ws);
  g.P0 = g.X + P;
  g.P1 = g.P0 + P;
  g.P2 = g.P1 + P;
  g.P3 = g.P2 + P;
  g.B0 = reinterpret_cast<uint8_t*>(g.P3 + P);
  g.E = g.B0 + P;
  g.E2 = g.E + P;
  g.W = g.E2 + P;
  g.M = g.W + P;
  const long long tiles_per_image = (long long)ht * wt;
  const long long row = (long long)wt << lt;  // gray row length
  const float inv_n = 1.0f / (float)n;

  for (long long grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    // ---- load the group's tiles; zero the counters
    for (int i = threadIdx.x; i < tpc * kCnt; i += kThreads) g.cnt[i] = 0;
    for (int s = threadIdx.x; s < P; s += kThreads) {
      const long long tile = grp * tpc + (s >> ln);
      const int pix = s & (n - 1), y = pix >> lt, x = pix & (t - 1);
      float v = 0.0f;
      if (tile < n_tiles) {
        const long long b = tile / tiles_per_image, r = tile % tiles_per_image;
        const long long ty = r / wt, tx = r % wt;
        v = gray[(b * ht * t + (ty << lt) + y) * row + (tx << lt) + x];
      }
      g.X[s] = v;
    }
    __syncthreads();

    // ---- phi3: Sobel of the tile (edge), pairwise sums of gx, gx^2, gy, gy^2
    sobel_planes<true, false>(g, g.X, g.P0, g.P1);
    for (int s = threadIdx.x; s < P; s += kThreads) {
      const int base = (s >> ln) << ln, pix = s & (n - 1), y = pix >> lt, x = pix & (t - 1);
      float gx, gy;
      sobel_at<true>(g, g.P0, g.P1, base, y, x, gx, gy);
      g.P2[s] = gx;
      g.P3[s] = gy;
    }
    __syncthreads();
    for (int s = threadIdx.x; s < P; s += kThreads) {
      g.P0[s] = g.P2[s] * g.P2[s];
      g.P1[s] = g.P3[s] * g.P3[s];
    }
    for (int h = n >> 1; h >= 1; h >>= 1) {
      __syncthreads();
      for (int s = threadIdx.x; s < P; s += kThreads) {
        if ((s & (n - 1)) < h) {
          g.P0[s] = g.P0[s] + g.P0[s + h];
          g.P1[s] = g.P1[s] + g.P1[s + h];
          g.P2[s] = g.P2[s] + g.P2[s + h];
          g.P3[s] = g.P3[s] + g.P3[s + h];
        }
      }
    }
    __syncthreads();
    for (int tl = threadIdx.x; tl < tpc; tl += kThreads) {
      const int base = tl << ln;
      const float mx = g.P2[base] * inv_n, mx2 = g.P0[base] * inv_n;
      const float my = g.P3[base] * inv_n, my2 = g.P1[base] * inv_n;
      float vx = mx2 - mx * mx;
      vx = vx < 0.0f ? 0.0f : vx;
      float vy = my2 - my * my;
      vy = vy < 0.0f ? 0.0f : vy;
      const float v = vx + vy;
      g.tf[tl * kTf + 1] = v / (v + 1.0f);
    }
    __syncthreads();

    // ---- Canny: the edge map into E (or E2)
    uint8_t* edge;
    if (!LEGACY) {
      for (int s = threadIdx.x; s < P; s += kThreads) {
        const int base = (s >> ln) << ln, pix = s & (n - 1), y = pix >> lt, x = pix & (t - 1);
        g.P0[s] = filt<true, true, false, 5>(g.X, base, y, x, lt, taps.g5);
      }
      __syncthreads();
      for (int s = threadIdx.x; s < P; s += kThreads) {
        const int base = (s >> ln) << ln, pix = s & (n - 1), y = pix >> lt, x = pix & (t - 1);
        g.P1[s] = filt<true, false, false, 5>(g.P0, base, y, x, lt, taps.g5);  // b01
      }
      __syncthreads();
      otsu(g, g.P1, g.P2);
      sobel_planes<true, true>(g, g.P1, g.P2, g.P3);  // of b255 = b01 * 255
      for (int s = threadIdx.x; s < P; s += kThreads) {
        const int base = (s >> ln) << ln, pix = s & (n - 1), y = pix >> lt, x = pix & (t - 1);
        float gx, gy;
        sobel_at<true>(g, g.P2, g.P3, base, y, x, gx, gy);
        g.P0[s] = fabsf(gx) + fabsf(gy);
        g.B0[s] = (uint8_t)dir_bin(gx, gy);
      }
      __syncthreads();
      for (int s = threadIdx.x; s < P; s += kThreads) {
        const int tl = s >> ln, base = tl << ln, pix = s & (n - 1), y = pix >> lt,
                  x = pix & (t - 1);
        const float thr255 = g.tf[tl * kTf] * 255.0f;
        const float nm = nms_at(g.P0, base, y, x, lt, g.B0[s]);
        g.E[s] = nm > thr255;
        g.W[s] = nm > 0.5f * thr255;
      }
      __syncthreads();
      edge = hysteresis(g, 8);
    } else {
      for (int s = threadIdx.x; s < P; s += kThreads) {
        const int base = (s >> ln) << ln, pix = s & (n - 1), y = pix >> lt, x = pix & (t - 1);
        g.P0[s] = filt<false, true, false, 5>(g.X, base, y, x, lt, taps.g5);
      }
      __syncthreads();
      for (int s = threadIdx.x; s < P; s += kThreads) {
        const int base = (s >> ln) << ln, pix = s & (n - 1), y = pix >> lt, x = pix & (t - 1);
        g.P1[s] = filt<false, false, false, 5>(g.P0, base, y, x, lt, taps.g5);
      }
      __syncthreads();
      sobel_planes<false, false>(g, g.P1, g.P2, g.P3);
      for (int s = threadIdx.x; s < P; s += kThreads) {
        const int base = (s >> ln) << ln, pix = s & (n - 1), y = pix >> lt, x = pix & (t - 1);
        float gx, gy;
        sobel_at<false>(g, g.P2, g.P3, base, y, x, gx, gy);
        g.P0[s] = sqrtf(gx * gx + gy * gy + F32(1e-12));
        g.B0[s] = (uint8_t)dir_bin(gx, gy);
      }
      __syncthreads();
      for (int s = threadIdx.x; s < P; s += kThreads) {
        const int base = (s >> ln) << ln, pix = s & (n - 1), y = pix >> lt, x = pix & (t - 1);
        const float nm = nms_at(g.P0, base, y, x, lt, g.B0[s]);
        g.P1[s] = nm;
        g.P2[s] = nm;
        g.P3[s] = nm;
      }
      for (int h = n >> 1; h >= 1; h >>= 1) {  // tile min into P2, max into P3
        __syncthreads();
        for (int s = threadIdx.x; s < P; s += kThreads) {
          if ((s & (n - 1)) < h) {
            g.P2[s] = fminf(g.P2[s], g.P2[s + h]);
            g.P3[s] = fmaxf(g.P3[s], g.P3[s + h]);
          }
        }
      }
      __syncthreads();
      for (int s = threadIdx.x; s < P; s += kThreads) {
        const int base = (s >> ln) << ln;
        const float mn = g.P2[base], mx = g.P3[base];
        g.P0[s] = (g.P1[s] - mn) / (mx - mn + F32(1e-8));  // nms_n
      }
      __syncthreads();
      otsu(g, g.P0, g.P2);
      for (int s = threadIdx.x; s < P; s += kThreads) {
        const float thr = g.tf[(s >> ln) * kTf];
        g.E[s] = g.P0[s] > thr;
        g.W[s] = g.P0[s] > 0.5f * thr;
      }
      __syncthreads();
      edge = hysteresis(g, 2);
    }

    // ---- binarization into M
    if (!OTSU_BIN) {
      for (int s = threadIdx.x; s < P; s += kThreads) {
        const int base = (s >> ln) << ln, pix = s & (n - 1), y = pix >> lt, x = pix & (t - 1);
        g.P0[s] = filt<true, true, true, 11>(g.X, base, y, x, lt, taps.g11);
      }
      __syncthreads();
      for (int s = threadIdx.x; s < P; s += kThreads) {
        const int base = (s >> ln) << ln, pix = s & (n - 1), y = pix >> lt, x = pix & (t - 1);
        const float local_mean = filt<true, false, false, 11>(g.P0, base, y, x, lt, taps.g11);
        g.M[s] = g.X[s] * 255.0f > local_mean - 2.0f;
      }
    } else {
      otsu(g, g.X, g.P0);
      for (int s = threadIdx.x; s < P; s += kThreads) g.M[s] = g.X[s] > g.tf[(s >> ln) * kTf];
    }
    __syncthreads();

    // ---- per-tile counts: edges, area, boundary, Euler windows, LBP labels
    for (int s = threadIdx.x; s < P; s += kThreads) {
      const int tl = s >> ln, base = tl << ln, pix = s & (n - 1), y = pix >> lt,
                x = pix & (t - 1);
      int* c = g.cnt + tl * kCnt;
      const int m = g.M[s];
      int eroded = 1;
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          const int yy = y + dy, xx = x + dx;
          if (yy >= 0 && yy < t && xx >= 0 && xx < t) eroded &= g.M[base + (yy << lt) + xx];
        }
      add_count(c + kEdge, edge[s], width);
      add_count(c + kArea, m, width);
      add_count(c + kPerim, m & (eroded ^ 1), width);
      if (CONTOUR) {
        // the windows whose bottom-right pixel is this one, and the ones past
        // the tile's last row / column that this pixel closes
        auto mask = [&](int yy, int xx) {
          return (yy >= 0 && yy < t && xx >= 0 && xx < t) ? (int)g.M[base + (yy << lt) + xx]
                                                          : 0;
        };
        auto window = [&](int i, int j) {
          const int idx = mask(i - 1, j - 1) + 2 * mask(i - 1, j) + 4 * mask(i, j - 1) +
                          8 * mask(i, j);
          const int q1 = idx == 1 || idx == 2 || idx == 4 || idx == 8;
          const int q3 = idx == 7 || idx == 11 || idx == 13 || idx == 14;
          const int qd = idx == 6 || idx == 9;
          return q1 - q3 - 2 * qd;
        };
        int e4 = window(y, x);
        if (y == t - 1) e4 += window(t, x);
        if (x == t - 1) e4 += window(y, t);
        if (y == t - 1 && x == t - 1) e4 += window(t, t);
        add_count(c + kEuler4, e4, width);
      }
      // uniform LBP (P = 8, R = 1) of the gray tile, neighbours edge
      const float ctr = g.X[s];
      const int oy[8] = {-1, -1, -1, 0, 1, 1, 1, 0};
      const int ox[8] = {-1, 0, 1, 1, 1, 0, -1, -1};
      int bits[8], ones = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        bits[k] = fetch<true>(g.X, base, y + oy[k], x + ox[k], lt) >= ctr;
        ones += bits[k];
      }
      int trans = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) trans += bits[k] != bits[(k + 7) & 7];
      const int label = trans <= 2 ? ones : 9;
#pragma unroll
      for (int v = 0; v < 10; ++v) add_count(c + kLbp + v, label == v, width);
    }
    __syncthreads();

    // ---- dyadic box counts of the edges: occupancy pyramid, 2x2 ORs per level
    {
      const uint8_t* src = edge;
      uint8_t* dst = edge == g.E ? g.E2 : g.E;
      uint8_t* other = g.W;
      for (int k = 1; k <= lt && lt >= 2; ++k) {
        const int side = t >> k, lside = lt - k;
        for (int s = threadIdx.x; s < P; s += kThreads) {
          const int tl = s >> ln, base = tl << ln, pix = s & (n - 1);
          int occ = 0;
          if (pix < side * side) {
            const int cy = pix >> lside, cx = pix & (side - 1), up = 2 * side;
            const uint8_t* o = src + base + (2 * cy) * up + 2 * cx;
            occ = o[0] | o[1] | o[up] | o[up + 1];
            dst[base + pix] = (uint8_t)occ;
          }
          add_count(g.cnt + tl * kCnt + kBox + k - 1, occ, width);
        }
        __syncthreads();
        src = dst;
        uint8_t* tmp = other;
        other = dst;
        dst = tmp;
      }
    }

    // ---- per tile: phi1-phi5 and the interaction terms
    for (int tl = threadIdx.x; tl < tpc; tl += kThreads) {
      const long long tile = grp * tpc + tl;
      if (tile >= n_tiles) continue;
      const int* c = g.cnt + tl * kCnt;
      float phi1 = 1.0f;
      if (lt >= 2) {  // the weighted log-log slope over the scales 2 .. t
        const int S = lt;
        float xs[7], ws[7], ys[7];
        for (int k = 0; k < S; ++k) {
          xs[k] = logf((float)(2 << k));
          ys[k] = logf((float)c[kBox + k] + 1.0f);
          ws[k] = expf((float)k * F32(-0.1));
        }
        float w_sum = ws[0], wx = ws[0] * xs[0], wy = ws[0] * ys[0];
        for (int k = 1; k < S; ++k) {
          w_sum = w_sum + ws[k];
          wx = wx + ws[k] * xs[k];
          wy = wy + ws[k] * ys[k];
        }
        const float x_mean = wx / w_sum, y_mean = wy / w_sum;
        float cov = 0.0f, var = 0.0f;
        for (int k = 0; k < S; ++k) {
          const float dx = xs[k] - x_mean;
          const float cv = ws[k] * dx * (ys[k] - y_mean);
          const float vv = ws[k] * (dx * dx);
          cov = k == 0 ? cv : cov + cv;
          var = k == 0 ? vv : var + vv;
        }
        phi1 = fminf(fmaxf(-(cov / (var + F32(1e-12))), 1.0f), 2.0f);
      }
      float ent = 0.0f;
      for (int v = 0; v < 10; ++v) {
        const float p = (float)c[kLbp + v] * inv_n;
        const float term = p * log2f(p + F32(1e-10));
        ent = v == 0 ? -term : ent - term;
      }
      const float phi2 = ent * F32(1.0 / 3.321928094887362);
      const float phi3 = g.tf[tl * kTf + 1];
      const float phi4 = (float)c[kEdge] * inv_n;
      const float area = (float)c[kArea], perim = (float)c[kPerim];
      float ic = (perim * perim) / (F32(4.0 * 3.141592653589793) * area + F32(1e-6));
      if (CONTOUR) ic = ic / fmaxf(rintf((float)c[kEuler4] * 0.25f), 1.0f);
      float phi5 = 1.0f - 1.0f / fmaxf(ic, 1.0f);
      phi5 = area > 0.0f ? phi5 : 0.0f;
      const float phi1h = phi1 * 0.5f;
      float* o = phi + tile * 8;
      o[0] = phi1h;
      o[1] = phi2;
      o[2] = phi3;
      o[3] = phi4;
      o[4] = phi5;
      o[5] = phi1h * phi2;
      o[6] = phi3 * phi3;
      o[7] = sqrtf(phi4 * phi5 + F32(1e-12));
    }
    __syncthreads();
  }
}

template <bool L, bool O, bool C>
int launch(const float* gray, float* phi, unsigned char* scratch, int ht, int wt, int lt,
           int tpc, long long n_tiles, long long n_groups, int grid, int ws_global,
           long long ws_bytes, int smem, const Taps& taps, cudaStream_t stream) {
  auto kernel = phi_tiles_kernel<L, O, C>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(gray, phi, scratch, ht, wt, lt, tpc, n_tiles,
                                           n_groups, ws_global, ws_bytes, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch geometry is worked out by the wrapper
// (core/morphology_lanes.py:launch_geometry) and checked here again.
extern "C" int mcaq_phi_tiles(const void* gray, void* phi, void* scratch, int B, int ht,
                              int wt, int lt, int legacy, int otsu_bin, int contour, int tpc,
                              int grid, int ws_global, long long ws_bytes, int smem,
                              const float* taps5, const float* taps11, void* stream) {
  if (B <= 0 || ht <= 0 || wt <= 0 || lt < 0 || lt > 7 || grid <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = 1 << (2 * lt);
  const int want_tpc = n >= kSlots ? 1 : kSlots / n;
  const long long P = (long long)want_tpc * n;
  const long long planes = 25 * P;  // five float and five byte planes
  const long long counters = (long long)want_tpc * (kCnt + kTf) * 4 + kBins * 4;
  const int want_global = counters + planes > kMaxSmem;
  const long long want_smem = counters + (want_global ? 0 : planes);
  const long long n_tiles = (long long)B * ht * wt;
  const long long n_groups = (n_tiles + want_tpc - 1) / want_tpc;
  if (tpc != want_tpc || ws_global != want_global || smem != want_smem ||
      grid > n_groups || (!ws_global && grid != n_groups) ||
      (ws_global && (scratch == nullptr || ws_bytes != planes)) ||
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
#define MCAQ_PHI_CASE(K, L, O, C)                                                          \
  case K:                                                                                  \
    return launch<L, O, C>(g, o, sc, ht, wt, lt, tpc, n_tiles, n_groups, grid, ws_global, \
                           ws_bytes, smem, taps, st);
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
