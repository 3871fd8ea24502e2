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
// k2_one_level, below, is a kernel of its own: it no longer runs K2's
// per-level code, so its times do not describe K2's levels.

#include "bilinear.cuh"

namespace {

constexpr int RADIUS = 3;
constexpr int RD = 2 * RADIUS + 1;      // 7
constexpr int TAPS = RD * RD;           // 49
constexpr int LEVELS = 4;
constexpr int OUT_C = LEVELS * TAPS;    // 196
constexpr int CENTER = RADIUS * RD + RADIUS;
constexpr int K2W = 4;                  // K2: warps (pixels) per block
constexpr int K2_BLOCKS_PER_SM = 16;    // 64 warps: at most 32 registers
constexpr int ONE_LEVEL_TAPS = 64;      // K6 one_level's taps per pixel

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

__device__ __forceinline__ float clip4(float o) {
  return fminf(fmaxf(o, -4.f), 4.f);
}

// the lane's two taps k = lane, lane + 32 (the second for lanes 0-16) of
// level L at c / 2^L plus the offsets o (already gated, not yet clipped)
template <typename T, int L>
__device__ __forceinline__ void level_load(const Levels& lv, int pix,
                                           float cx, float cy,
                                           const float2 (&o)[2], int lane,
                                           lgu::Tap (&t)[2]) {
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
    t[s] = lgu::tap_load(vol, lv.h[L], lv.w[L], px, py, s == 0 || k < TAPS);
  }
}

__device__ __forceinline__ void level_store(float* __restrict__ dst,
                                            const lgu::Tap (&t)[2],
                                            int lane) {
  dst[lane] = lgu::tap_value(t[0]);
  if (lane + 32 < TAPS) dst[lane + 32] = lgu::tap_value(t[1]);
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
  const lgu::Tap probe = lgu::tap_load(vol1, lv.h[1], lv.w[1],
                                       cx * 0.5f + (float)(lane / 3 - 1),
                                       cy * 0.5f + (float)(lane % 3 - 1),
                                       lane < 9);
  const float pv = lane < 9 ? lgu::tap_value(probe) : 0.f;
  const float m = warp_sum(pv) / 9.f;
  const float d = lane < 9 ? pv - m : 0.f;
  const float var = warp_sum(d * d) / 8.f;
  const float gate = 1.f / (1.f + expf(-var));
  o1[0].x *= gate;
  o1[0].y *= gate;
  o1[1].x *= gate;
  o1[1].y *= gate;

  lgu::Tap t[2];
  level_load<T, 0>(lv, pix, cx, cy, o0, lane, t);
  level_store(dst, t, lane);
  level_load<T, 1>(lv, pix, cx, cy, o1, lane, t);
  level_store(dst + TAPS, t, lane);
  level_load<T, 2>(lv, pix, cx, cy, o0, lane, t);
  level_store(dst + 2 * TAPS, t, lane);
  level_load<T, 3>(lv, pix, cx, cy, o0, lane, t);
  level_store(dst + 3 * TAPS, t, lane);
}

// K6 one_level: replaces the Pallas probe one_level of the JAX package's
// _prof_kparts.py (K2's taps on one level, no offsets, no gate).  What
// bounds it on the H100: bytes; at the probe's shapes (E = 48, 48 x 64) its
// 37.7 MB of fp32 output, written once, and the 32-byte sectors of the
// level that the taps touch (up to 16 per pixel on level 0, the whole
// 96-byte plane on level 3).  Timed alone it is held back by latency and
// instructions more than by bytes: the earlier design (a warp per pixel,
// each tap's four corners loaded from device memory, K2's per-level code)
// reached 44-57 % of the sector bound, its time falling by a quarter from
// level 0 to level 3 while the bytes fell by 40 %.
//
// Design: a warp takes OL_PIX = 4 pixels, 8 lanes each.  Per pixel the 64
// outputs are the 49 taps of the 7 x 7 window at c / 2^L + (i - 3, j - 3)
// (output i * 7 + j) and the centre tap 15 times.  With f = floor(c / 2^L)
// the taps' floors lie in f - 3 .. f + 3 on each axis, or f + 4 where an
// integer added to c / 2^L rounds up across the next integer; their
// corners in f - 3 .. f + 4, or f + 5 then.  The pixel's 8 lanes load the
// 8 x 8 patch from f - 3 (moved inside the plane where it would leave it;
// a level of 8 x 8 or less is loaded whole), lane c column c, every load
// of the warp in flight at once, into shared memory as fp32 with a ninth
// row and column of zeros: the +1 corners that leave the plane, which the
// boundary rule reads as 0.  Then lane i < 7 computes the window's column
// i: the x position cx + (i - 3), its floor and fraction once, and for
// each j the y position cy + (j - 3), its own floor and fraction (every
// tap's floor and weights come from its own fp32 position, as in
// bilinear.cuh, never from a shared fraction), the four corners from the
// patch without masks, and bilinear.cuh's weights.  A tap whose corners
// the patch does not hold (a floor at f + 4 whose +1 row or column lies
// inside the plane) is read from global memory by bilinear().  The taps go
// through shared memory so that the warp writes its 4 x 256 bytes of
// output as coalesced 16-byte stores.
constexpr int OL_WARPS = 8;             // warps per block
constexpr int OL_PIX = 4;               // pixels per warp, 8 lanes each
constexpr int PL = 8;                   // patch side loaded
constexpr int PS = PL + 1;              // patch side with the zero edge
constexpr int PSTRIDE = 88;             // floats per patch: 4 pixels' patches
                                        // start on disjoint banks

// the patch origin on one axis of n elements: floor(c) - 3, moved inside
// the plane; the floor clamped so that huge or NaN coordinates give an int
__device__ __forceinline__ int patch_origin(float c, int n) {
  const int f = (int)fminf(fmaxf(floorf(c), -16.f), (float)(n + 16));
  return max(min(f - RADIUS, n - PL), 0);
}

// whether a tap at patch index a (floor - origin) has both corners on the
// axis in the patch: loaded, or the +1 corner outside the plane (zero)
__device__ __forceinline__ bool in_patch(int a, int floor, int n) {
  return (unsigned)a < PL - 1 || (a == PL - 1 && floor + 1 >= n);
}

template <typename T, int L>
__global__ void __launch_bounds__(OL_WARPS * 32)
one_level_kernel(const T* __restrict__ level, int H2, int W2,
                 const float2* __restrict__ cflat, float* __restrict__ out,
                 int n_pix) {
  __shared__ float patch[OL_WARPS][OL_PIX * PSTRIDE];
  __shared__ float taps[OL_WARPS][OL_PIX][TAPS];
  const int wib = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pix0 = (blockIdx.x * OL_WARPS + wib) * OL_PIX;
  if (pix0 >= n_pix) return;  // uniform per warp
  const int p = lane / 8;     // this lane's pixel
  const int l8 = lane % 8;
  const int pix = pix0 + p;
  const bool live = pix < n_pix;
  const float scale = 1.f / (float)(1 << L);

  const float2 c = lane < OL_PIX && pix0 + lane < n_pix
                       ? cflat[pix0 + lane]
                       : make_float2(0.f, 0.f);
  const float cx = __shfl_sync(0xffffffffu, c.x, p) * scale;
  const float cy = __shfl_sync(0xffffffffu, c.y, p) * scale;
  const int ox = patch_origin(cx, W2);
  const int oy = patch_origin(cy, H2);
  const T* vol = level + (size_t)pix * H2 * W2;
  float* P = patch[wib] + p * PSTRIDE;

  // column l8 of the patch, 0 outside the plane; the zero edge
  const bool col = live && ox + l8 < W2;
  float v[PL];
#pragma unroll
  for (int r = 0; r < PL; ++r) {
    v[r] = col && oy + r < H2
               ? lgu::load(vol, (size_t)(oy + r) * W2 + ox + l8)
               : 0.f;
  }
#pragma unroll
  for (int r = 0; r < PL; ++r) P[r * PS + l8] = v[r];
  P[PL * PS + l8] = 0.f;
  P[l8 * PS + PL] = 0.f;
  if (l8 == 0) P[PL * PS + PL] = 0.f;
  __syncwarp();

  if (live && l8 < RD) {
    const float px = cx + (float)(l8 - RADIUS);
    const float x1 = floorf(px);
    const float dx = px - x1;
    const bool xin = x1 >= 0.f && x1 < (float)W2;
    const int xi = (int)x1;
    const bool xp = in_patch(xi - ox, xi, W2);
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const float py = cy + (float)(j - RADIUS);
      const float y1 = floorf(py);
      const float dy = py - y1;
      const int yi = (int)y1;
      float val = 0.f;
      if (xin && y1 >= 0.f && y1 < (float)H2) {
        if (xp && in_patch(yi - oy, yi, H2)) {
          const float* q = P + (yi - oy) * PS + (xi - ox);
          val = q[0] * (1.f - dy) * (1.f - dx) + q[1] * (1.f - dy) * dx +
                q[PS] * dy * (1.f - dx) + q[PS + 1] * dy * dx;
        } else {
          val = lgu::bilinear(vol, H2, W2, px, py);
        }
      }
      taps[wib][p][l8 * RD + j] = val;
    }
  }
  __syncwarp();

  // float4 q = lane + 32 s: pixel q / 16, outputs 4 (q % 16) .. + 3
#pragma unroll
  for (int s = 0; s < OL_PIX / 2; ++s) {
    const int q = lane + 32 * s;
    const int i = q / 16;
    if (pix0 + i >= n_pix) continue;
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * (q % 16) + e;
      r[e] = taps[wib][i][k < TAPS ? k : CENTER];
    }
    reinterpret_cast<float4*>(out + (size_t)(pix0 + i) * ONE_LEVEL_TAPS)
        [q % 16] = make_float4(r[0], r[1], r[2], r[3]);
  }
}

template <typename T, int L>
int launch_level(const T* v, int H2, int W2, const float2* cflat, float* out,
                 int n_pix, cudaStream_t stream) {
  const int per_block = OL_WARPS * OL_PIX;
  const int blocks = (n_pix + per_block - 1) / per_block;
  one_level_kernel<T, L><<<blocks, OL_WARPS * 32, 0, stream>>>(
      v, H2, W2, cflat, out, n_pix);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_one_level(const void* level, const float* cflat, float* out,
                     int n_pix, int H2, int W2, int lvl,
                     cudaStream_t stream) {
  const T* v = static_cast<const T*>(level);
  const float2* c = reinterpret_cast<const float2*>(cflat);
  switch (lvl) {
    case 0:
      return launch_level<T, 0>(v, H2, W2, c, out, n_pix, stream);
    case 1:
      return launch_level<T, 1>(v, H2, W2, c, out, n_pix, stream);
    case 2:
      return launch_level<T, 2>(v, H2, W2, c, out, n_pix, stream);
    case 3:
      return launch_level<T, 3>(v, H2, W2, c, out, n_pix, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
