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
// What bounds it on the H100: at the tracking shapes (E = 48, P1 = 3072) it
// writes 115.6 MB of output, reads 115.6 MB of fp32 offsets and gathers
// (9 + 196) taps x 4 corners of bf16 volume per pixel; the arithmetic is
// ~30 operations per tap.  Its byte bound counts the distinct corners, its
// sector bound the distinct 32-byte sectors that hold them.  Timed on the
// device alone, its time grows in proportion to E from the backend's
// E = 8 to 48: what holds it is how many scattered loads are in flight on
// each SM, that is how many warps are resident, not the chain of round
// trips of one pixel.  Designs that put more loads in flight per thread
// (every tap of a pixel before the first use, level 0 before the gate,
// paired 8-byte corner loads, or a block's offsets and output staged
// through shared memory) need more registers (60-110; held to 32, they
// spill), fit fewer warps on an SM, and ran 1.3-1.8 x slower than the
// earlier kernel at E >= 8 (PERF.md, scripts/ab_k2_torch.py --variant).
//
// Design: one warp per (edge, source pixel), 4 per block; the kernel is held
// to 32 registers so that 16 blocks (the SM's 64 warps) are resident.  Each
// lane takes taps k = lane and lane + 32 (the second for lanes 0-16) of a
// level, both unrolled so that their loads issue together; the offsets of
// levels 0 and 1 are read once, at the start, as 8-byte pairs.  Lanes 0-8
// take the probe taps and two warp-shuffle reductions give the mean and the
// unbiased variance, so the gate never leaves registers; the levels follow
// in turn.  Consecutive lanes write consecutive output channels and read
// consecutive offset pairs (coalesced), while the volume corners of one
// pixel's window fall in a few rows of its level and are served by L1/L2.
// The flat levels [E, P1, h_l * w_l] are read in place.  The bilinear rule
// is bilinear.cuh's, written out with predicated loads (tap_load /
// tap_value); its arithmetic is unchanged, though the compiler may contract
// it differently (results within 2e-5 of the earlier kernel's).  K6's
// k2_one_level keeps the earlier kernel's per-level loop (level_taps) so
// that its numbers still describe what they measured.

#include "bilinear.cuh"

namespace {

using lgu::bilinear;

constexpr int RADIUS = 3;
constexpr int RD = 2 * RADIUS + 1;      // 7
constexpr int TAPS = RD * RD;           // 49
constexpr int LEVELS = 4;
constexpr int OUT_C = LEVELS * TAPS;    // 196
constexpr int CENTER = RADIUS * RD + RADIUS;
constexpr int K2W = 4;                  // K2: warps (pixels) per block
constexpr int K2_BLOCKS_PER_SM = 16;    // 64 warps: at most 32 registers
constexpr int WARPS = 8;                // K6 one_level: warps (pixels) per block
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

// A bilinear tap with its corners loaded: bilinear.cuh's rule, the corner
// loads predicated instead of behind an early return, so that a lane's two
// taps of a level issue their loads together.
struct Tap {
  float v11, v21, v12, v22, dx, dy;
  bool ok;
};

template <typename T>
__device__ __forceinline__ Tap tap_load(const T* __restrict__ vol, int H2,
                                        int W2, float px, float py,
                                        bool live) {
  Tap t;
  const float x1 = floorf(px);
  const float y1 = floorf(py);
  t.ok = live && x1 >= 0.f && x1 < (float)W2 && y1 >= 0.f && y1 < (float)H2;
  t.dx = px - x1;
  t.dy = py - y1;
  const int xi = t.ok ? (int)x1 : 0;
  const int yi = t.ok ? (int)y1 : 0;
  const bool xo = t.ok && xi + 1 < W2;
  const bool yo = t.ok && yi + 1 < H2;
  const T* r0 = vol + (yi * W2 + xi);
  t.v11 = t.ok ? lgu::load(r0, 0) : 0.f;
  t.v21 = xo ? lgu::load(r0, 1) : 0.f;
  t.v12 = yo ? lgu::load(r0, W2) : 0.f;
  t.v22 = (xo && yo) ? lgu::load(r0, W2 + 1) : 0.f;
  return t;
}

__device__ __forceinline__ float tap_value(const Tap& t) {
  const float v = t.v11 * (1.f - t.dy) * (1.f - t.dx) +
                  t.v21 * (1.f - t.dy) * t.dx + t.v12 * t.dy * (1.f - t.dx) +
                  t.v22 * t.dy * t.dx;
  return t.ok ? v : 0.f;
}

__device__ __forceinline__ float clip4(float o) {
  return fminf(fmaxf(o, -4.f), 4.f);
}

// the lane's two taps k = lane, lane + 32 (the second for lanes 0-16) of
// level L at c / 2^L plus the offsets o (already gated, not yet clipped)
template <typename T, int L>
__device__ __forceinline__ void level_load(const Levels& lv, int pix,
                                           float cx, float cy,
                                           const float2 (&o)[2], int lane,
                                           Tap (&t)[2]) {
  const T* vol = static_cast<const T*>(lv.v[L]) +
                 (size_t)pix * lv.h[L] * lv.w[L];
  const float scale = 1.f / (float)(1 << L);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int k = lane + 32 * s;
    const bool offs = L < 2 && k != CENTER;
    const float ox = offs ? clip4(o[s].x) : 0.f;
    const float oy = offs ? clip4(o[s].y) : 0.f;
    const float px = cx * scale + ox + (float)(k / RD - RADIUS);
    const float py = cy * scale + oy + (float)(k % RD - RADIUS);
    t[s] = tap_load(vol, lv.h[L], lv.w[L], px, py, s == 0 || k < TAPS);
  }
}

__device__ __forceinline__ void level_store(float* __restrict__ dst,
                                            const Tap (&t)[2], int lane) {
  dst[lane] = tap_value(t[0]);
  if (lane + 32 < TAPS) dst[lane + 32] = tap_value(t[1]);
}

template <typename T>
__global__ void __launch_bounds__(K2W * 32, K2_BLOCKS_PER_SM)
pyramid_lookup_kernel(Levels lv, const float* __restrict__ cflat,
                      const float2* __restrict__ off0,
                      const float2* __restrict__ off1,
                      float* __restrict__ out, int n_pix) {
  const int pix = blockIdx.x * K2W + threadIdx.x / 32;  // e * P1 + p
  const int lane = threadIdx.x % 32;
  if (pix >= n_pix) return;  // uniform per warp: the shuffles stay full
  const bool two = lane + 32 < TAPS;

  // the coordinates and both levels' offsets: independent loads
  const float cx = cflat[2 * (size_t)pix];
  const float cy = cflat[2 * (size_t)pix + 1];
  const float2* p0 = off0 + (size_t)pix * TAPS;
  const float2* p1 = off1 + (size_t)pix * TAPS;
  const float2 zero = make_float2(0.f, 0.f);
  float2 o0[2] = {p0[lane], two ? p0[lane + 32] : zero};
  float2 o1[2] = {p1[lane], two ? p1[lane + 32] : zero};
  float* dst = out + (size_t)pix * OUT_C;

  // level-1 variance probe
  const T* vol1 = static_cast<const T*>(lv.v[1]) +
                  (size_t)pix * lv.h[1] * lv.w[1];
  const Tap probe = tap_load(vol1, lv.h[1], lv.w[1],
                             cx * 0.5f + (float)(lane / 3 - 1),
                             cy * 0.5f + (float)(lane % 3 - 1), lane < 9);
  const float pv = lane < 9 ? tap_value(probe) : 0.f;
  const float m = warp_sum(pv) / 9.f;
  const float d = lane < 9 ? pv - m : 0.f;
  const float var = warp_sum(d * d) / 8.f;
  const float gate = 1.f / (1.f + expf(-var));
  o1[0].x *= gate;
  o1[0].y *= gate;
  o1[1].x *= gate;
  o1[1].y *= gate;

  Tap t[2];
  level_load<T, 0>(lv, pix, cx, cy, o0, lane, t);
  level_store(dst, t, lane);
  level_load<T, 1>(lv, pix, cx, cy, o1, lane, t);
  level_store(dst + TAPS, t, lane);
  level_load<T, 2>(lv, pix, cx, cy, o0, lane, t);
  level_store(dst + 2 * TAPS, t, lane);
  level_load<T, 3>(lv, pix, cx, cy, o0, lane, t);
  level_store(dst + 3 * TAPS, t, lane);
}

// K6 one_level: the earlier K2 kernel's per-level loop, one warp per pixel:
// the taps k = lane, lane + 32, ... < N of level L at c / 2^L, written to
// dst[k]: for k < 49 the window tap (k / 7 - 3, k % 7 - 3), for k >= 49
// (N = 64) the centre tap.
template <typename T, int L, int N>
__device__ __forceinline__ void level_taps(const T* vol, int H2, int W2,
                                           float cx, float cy, float* dst,
                                           int lane) {
  const float scale = 1.f / (float)(1 << L);
  for (int k = lane; k < N; k += 32) {
    const int kk = (N > TAPS && k >= TAPS) ? CENTER : k;
    const float px = cx * scale + (float)(kk / RD - RADIUS);
    const float py = cy * scale + (float)(kk % RD - RADIUS);
    dst[k] = bilinear(vol, H2, W2, px, py);
  }
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
  level_taps<T, L, ONE_LEVEL_TAPS>(
      level + (size_t)pix * H2 * W2, H2, W2, cflat[2 * (size_t)pix],
      cflat[2 * (size_t)pix + 1], out + (size_t)pix * ONE_LEVEL_TAPS, lane);
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
  const int blocks = (n_pix + K2W - 1) / K2W;
  const float2* o0 = reinterpret_cast<const float2*>(off0);
  const float2* o1 = reinterpret_cast<const float2*>(off1);
  if (vol_bf16) {
    pyramid_lookup_kernel<__nv_bfloat16><<<blocks, K2W * 32, 0, stream>>>(
        lv, cflat, o0, o1, out, n_pix);
  } else {
    pyramid_lookup_kernel<float><<<blocks, K2W * 32, 0, stream>>>(
        lv, cflat, o0, o1, out, n_pix);
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
