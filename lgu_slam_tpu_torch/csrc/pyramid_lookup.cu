// K2: fused deformable lookup over the 4-level correlation pyramid.
//
// Replaces the Pallas TPU kernel fused_pyramid_lookup (the JAX package's
// ops/pallas_lookup.py, body _fused_kernel).  Per edge e and source pixel p
// with base coordinates c = cflat[e,p] (level-0 pixels):
//   1. probe level 1 with a radius-1 window at c/2; gate = sigmoid of the
//      unbiased variance of the 9 taps;
//   2. for each level l, 49 taps (7x7, channel i*7+j with i along x) at
//      c/2^l + (i-3, j-3) + offset, where level 0 adds off0, level 1 adds
//      off1 * gate and levels 2-3 add nothing; the centre tap's offset is
//      zeroed and offsets are clipped to +-4;
//   3. bilinear taps with the reference CUDA boundary rule: a tap is 0
//      unless its floor corner is inside the level, and a +1 corner outside
//      the level reads 0.
// Output [E, P1, 196] fp32, level-major.
//
// What bounds it on the H100: it moves bytes, not operations.  At the
// tracking shapes (E = 48, P1 = 3072) it writes 115.6 MB of output, reads
// 115.6 MB of fp32 offsets and gathers at most (9 + 196) taps x 4 corners
// x 2 bytes of bf16 volume per pixel; the arithmetic is ~30 operations per
// tap.
//
// Design: one warp per (edge, source pixel).  The flat levels
// [E, P1, h_l * w_l] are read in place (no lane packing as on the TPU).
// Lanes 0-8 take the probe taps and two warp-shuffle reductions give the
// mean and the unbiased variance, so the gate never leaves registers.  The
// warp then strides over the 49 taps of each level: consecutive lanes write
// consecutive output channels and read consecutive offset pairs (coalesced),
// while the volume corners of one pixel's window fall in a few rows of its
// level and are served by L1/L2.  The bilinear tap is shared with K3/K4
// (bilinear.cuh), and the per-level tap loop (level_taps) with the K6 probe
// k2_one_level below, through template parameters that K2's instantiation
// folds away (its code and registers are those of the loop written inline).

#include "bilinear.cuh"

namespace {

using lgu::bilinear;

constexpr int RADIUS = 3;
constexpr int RD = 2 * RADIUS + 1;      // 7
constexpr int TAPS = RD * RD;           // 49
constexpr int LEVELS = 4;
constexpr int OUT_C = LEVELS * TAPS;    // 196
constexpr int CENTER = RADIUS * RD + RADIUS;
constexpr int WARPS = 8;                // warps (pixels) per block
constexpr int ONE_LEVEL_TAPS = 64;      // K6 one_level's lanes per pixel

struct Levels {
  const void* v[LEVELS];
  int h[LEVELS];
  int w[LEVELS];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The taps k = lane, lane + 32, ... < N of level L for one pixel at c / 2^L,
// written to dst[k]: for k < 49 the window tap (k / 7 - 3, k % 7 - 3), plus
// with OFFSETS the level's offset (level 0: o0, level 1: o1 * gate; the
// centre's zeroed; clipped to +-4); for k >= 49 (K6's N = 64) the centre tap.
template <typename T, int L, int N, bool OFFSETS>
__device__ __forceinline__ void level_taps(const T* vol, int H2, int W2,
                                           float cx, float cy, const float* o0,
                                           const float* o1, float gate,
                                           float* dst, int lane) {
  const float scale = 1.f / (float)(1 << L);
  for (int k = lane; k < N; k += 32) {
    const int kk = (N > TAPS && k >= TAPS) ? CENTER : k;
    float ox = 0.f;
    float oy = 0.f;
    if (OFFSETS && L < 2 && kk != CENTER) {
      if (L == 0) {
        ox = o0[2 * kk];
        oy = o0[2 * kk + 1];
      } else {
        ox = o1[2 * kk] * gate;
        oy = o1[2 * kk + 1] * gate;
      }
      ox = fminf(fmaxf(ox, -4.f), 4.f);
      oy = fminf(fmaxf(oy, -4.f), 4.f);
    }
    const float px = cx * scale + ox + (float)(kk / RD - RADIUS);
    const float py = cy * scale + oy + (float)(kk % RD - RADIUS);
    dst[k] = bilinear(vol, H2, W2, px, py);
  }
}

template <typename T, int L>
__device__ __forceinline__ void pyramid_level(const Levels& lv, int pix,
                                              float cx, float cy,
                                              const float* o0,
                                              const float* o1, float gate,
                                              float* dst, int lane) {
  const T* vol = static_cast<const T*>(lv.v[L]) +
                 (size_t)pix * lv.h[L] * lv.w[L];
  level_taps<T, L, TAPS, true>(vol, lv.h[L], lv.w[L], cx, cy, o0, o1, gate,
                               dst + L * TAPS, lane);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
pyramid_lookup_kernel(Levels lv, const float* __restrict__ cflat,
                      const float* __restrict__ off0,
                      const float* __restrict__ off1,
                      float* __restrict__ out, int n_pix) {
  const int pix = blockIdx.x * WARPS + threadIdx.x / 32;  // e * P1 + p
  const int lane = threadIdx.x % 32;
  if (pix >= n_pix) return;  // uniform per warp: the shuffles stay full

  const float cx = cflat[2 * (size_t)pix];
  const float cy = cflat[2 * (size_t)pix + 1];

  // level-1 variance probe -> gate
  const T* vol1 = static_cast<const T*>(lv.v[1]) +
                  (size_t)pix * lv.h[1] * lv.w[1];
  float pv = 0.f;
  if (lane < 9) {
    pv = bilinear(vol1, lv.h[1], lv.w[1], cx * 0.5f + (float)(lane / 3 - 1),
                  cy * 0.5f + (float)(lane % 3 - 1));
  }
  const float m = warp_sum(pv) / 9.f;
  const float d = lane < 9 ? pv - m : 0.f;
  const float var = warp_sum(d * d) / 8.f;
  const float gate = 1.f / (1.f + expf(-var));

  const float* o0 = off0 + (size_t)pix * TAPS * 2;
  const float* o1 = off1 + (size_t)pix * TAPS * 2;
  float* dst = out + (size_t)pix * OUT_C;

  pyramid_level<T, 0>(lv, pix, cx, cy, o0, o1, gate, dst, lane);
  pyramid_level<T, 1>(lv, pix, cx, cy, o0, o1, gate, dst, lane);
  pyramid_level<T, 2>(lv, pix, cx, cy, o0, o1, gate, dst, lane);
  pyramid_level<T, 3>(lv, pix, cx, cy, o0, o1, gate, dst, lane);
}

// K6 (one_level): K2's taps on level L alone, 64 per pixel (the 49 window
// taps at cflat / 2^L, then the centre tap 15 times), no offsets, no gate.
template <typename T, int L>
__global__ void __launch_bounds__(WARPS * 32)
one_level_kernel(const T* __restrict__ level, int H2, int W2,
                 const float* __restrict__ cflat, float* __restrict__ out,
                 int n_pix) {
  const int pix = blockIdx.x * WARPS + threadIdx.x / 32;  // e * P1 + p
  const int lane = threadIdx.x % 32;
  if (pix >= n_pix) return;
  level_taps<T, L, ONE_LEVEL_TAPS, false>(
      level + (size_t)pix * H2 * W2, H2, W2, cflat[2 * (size_t)pix],
      cflat[2 * (size_t)pix + 1], nullptr, nullptr, 1.f,
      out + (size_t)pix * ONE_LEVEL_TAPS, lane);
}

template <typename T>
int launch_one_level(const void* level, const float* cflat, float* out,
                     int n_pix, int H2, int W2, int lvl,
                     cudaStream_t stream) {
  const int blocks = (n_pix + WARPS - 1) / WARPS;
  const T* v = static_cast<const T*>(level);
  switch (lvl) {
    case 0:
      one_level_kernel<T, 0><<<blocks, WARPS * 32, 0, stream>>>(
          v, H2, W2, cflat, out, n_pix);
      break;
    case 1:
      one_level_kernel<T, 1><<<blocks, WARPS * 32, 0, stream>>>(
          v, H2, W2, cflat, out, n_pix);
      break;
    case 2:
      one_level_kernel<T, 2><<<blocks, WARPS * 32, 0, stream>>>(
          v, H2, W2, cflat, out, n_pix);
      break;
    case 3:
      one_level_kernel<T, 3><<<blocks, WARPS * 32, 0, stream>>>(
          v, H2, W2, cflat, out, n_pix);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// v0..v3: flat levels [E, P1, h_l * w_l] (bf16 when vol_bf16 != 0, else
// fp32) with h_l = H >> l, w_l = W >> l; cflat [E, P1, 2]; off0/off1
// [E, P1, 7, 7, 2]; out [E, P1, 196], all fp32 except the levels.
// Returns cudaGetLastError() after launch.
extern "C" int fused_pyramid_lookup(const void* v0, const void* v1,
                                    const void* v2, const void* v3,
                                    const float* cflat, const float* off0,
                                    const float* off1, float* out, int E,
                                    int H, int W, int vol_bf16,
                                    cudaStream_t stream) {
  Levels lv;
  const void* vs[LEVELS] = {v0, v1, v2, v3};
  int h = H;
  int w = W;
  for (int l = 0; l < LEVELS; ++l) {
    lv.v[l] = vs[l];
    lv.h[l] = h;
    lv.w[l] = w;
    h /= 2;
    w /= 2;
  }
  const int n_pix = E * H * W;
  const int blocks = (n_pix + WARPS - 1) / WARPS;
  if (vol_bf16) {
    pyramid_lookup_kernel<__nv_bfloat16><<<blocks, WARPS * 32, 0, stream>>>(
        lv, cflat, off0, off1, out, n_pix);
  } else {
    pyramid_lookup_kernel<float><<<blocks, WARPS * 32, 0, stream>>>(
        lv, cflat, off0, off1, out, n_pix);
  }
  return (int)cudaGetLastError();
}

// K6 one_level: level [E, P1, H2 * W2] (bf16 when vol_bf16 != 0, else fp32),
// cflat [E, P1, 2] in level-0 pixels, out [E, P1, 64] fp32; lvl (0-3) scales
// the coordinates by 2^-lvl.  Returns cudaGetLastError() after launch.
extern "C" int k2_one_level(const void* level, const float* cflat, float* out,
                            int n_pix, int H2, int W2, int lvl, int vol_bf16,
                            cudaStream_t stream) {
  return vol_bf16 ? launch_one_level<__nv_bfloat16>(level, cflat, out, n_pix,
                                                    H2, W2, lvl, stream)
                  : launch_one_level<float>(level, cflat, out, n_pix, H2, W2,
                                            lvl, stream);
}
