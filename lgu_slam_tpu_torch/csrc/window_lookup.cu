// K3/K4: bilinear taps at arbitrary positions on one flat correlation level.
//
// Replaces the Pallas TPU kernels window_lookup_packed (body _window_kernel)
// and dense_lookup_packed (body _dense_kernel) of the JAX package's
// ops/pallas_lookup.py.  Both compute one function: for each edge e, source
// pixel p and tap k,
//   out[e, p, k] = bilinear(vol[e, p, :, :], px[e, p, k], py[e, p, k])
// on the level plane [H2, W2] with the reference CUDA boundary rule
// (bilinear.cuh).  On the TPU the dense variant evaluated the bilinear
// weights as a tent over the whole tiny plane because Mosaic has no fast
// data-dependent gather; on Hopper a gather is a load, so one kernel serves
// both shapes.
//
// What bounds it on the H100: bytes.  Per tap it reads two fp32 positions
// and writes one fp32 value (12 bytes); each (edge, pixel) reads the
// 32-byte sectors of its own plane that hold its taps' corners (a window
// of r = 3 with offsets of +-4 spans at most 16 x 16 elements).  Its sector
// bound counts those sectors once per plane.
//
// Timed alone, on the device, it is bound by latency more than by bytes: a
// tap costs two dependent round trips (its position, then its corners),
// so its time follows the taps in flight on each SM and the instructions
// each costs.  Staging each pixel's bounding box of corners in shared
// memory first (tried: 16-byte cp.async chunks, or fp32 rows; PERF.md)
// was 1.15-1.8 x slower: the box holds more sectors than the taps touch
// (12.7 against 10.9 per pixel for r = 3 with offsets of +-4 on 48 x 64),
// and the box's shuffles, loads and barrier lengthen each pixel's chain.
//
// Design: for 16 < K <= 64 (the windows of r = 3) a warp per (edge, pixel),
// lanes holding taps k = lane and lane + 32: a lane reads its taps'
// positions (coalesced across the warp), then issues every corner load of
// both taps together (bilinear.cuh's tap_load: the boundary rule with
// predicated loads, not an early return), then writes them (one
// contiguous run per pixel); a thread per tap there was 1.4-5.2 % slower
// at every 49-tap shape, in the same turns (PERF.md).  For other K (the
// 9-tap probe, or windows above 64 taps) a thread per tap, its pixel from
// a 32-bit division (a quarter warp per 9-tap pixel, two taps per lane,
// was slower: 7 of its 16 tap slots idle).  Indices are 32-bit within a
// plane; held to 32 registers, 64 warps are resident on each SM.  The flat
// levels are read in place (no lane packing as on the TPU).

#include "bilinear.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// a warp per (edge, pixel), taps k = lane and lane + 32 (K <= 64)
template <typename T>
__global__ void __launch_bounds__(THREADS, 8)
warp_kernel(const T* __restrict__ vol, const float* __restrict__ px,
            const float* __restrict__ py, float* __restrict__ out,
            int n_pix, int K, int H2, int W2) {
  const int pix = blockIdx.x * WARPS + threadIdx.x / 32;  // e * P1 + p
  const int lane = threadIdx.x % 32;
  if (pix >= n_pix) return;
  const size_t first = (size_t)pix * K;
  const T* plane = vol + (size_t)pix * H2 * W2;
  lgu::Tap t[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = lane + 32 * j;
    const bool on = k < K;
    t[j] = lgu::tap_load(plane, H2, W2, on ? __ldg(px + first + k) : 0.f,
                         on ? __ldg(py + first + k) : 0.f, on);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = lane + 32 * j;
    if (k < K) out[first + k] = lgu::tap_value(t[j]);
  }
}

// a thread per tap i = (e * P1 + p) * K + k
template <typename T>
__global__ void __launch_bounds__(THREADS, 8)
tap_kernel(const T* __restrict__ vol, const float* __restrict__ px,
           const float* __restrict__ py, float* __restrict__ out,
           int n_taps, int K, int H2, int W2) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_taps) return;
  const unsigned pix = (unsigned)i / (unsigned)K;
  const T* plane = vol + (size_t)pix * H2 * W2;
  out[i] = lgu::tap_value(
      lgu::tap_load(plane, H2, W2, __ldg(px + i), __ldg(py + i), true));
}

template <typename T>
void launch(const T* vol, const float* px, const float* py, float* out,
            int n_pix, int K, int H2, int W2, cudaStream_t stream) {
  if (K > 16 && K <= 64) {
    warp_kernel<T><<<(n_pix + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
        vol, px, py, out, n_pix, K, H2, W2);
  } else {
    const int n_taps = n_pix * K;
    tap_kernel<T><<<(n_taps + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        vol, px, py, out, n_taps, K, H2, W2);
  }
}

}  // namespace

// vol: flat level [E, P1, H2 * W2] (bf16 when vol_bf16 != 0, else fp32);
// px/py/out: [E, P1, K] fp32, E * P1 * K < 2^31.  Returns
// cudaGetLastError() after launch.
extern "C" int window_lookup(const void* vol, const float* px,
                             const float* py, float* out, int E, int P1,
                             int K, int H2, int W2, int vol_bf16,
                             cudaStream_t stream) {
  if (vol_bf16) {
    launch(static_cast<const __nv_bfloat16*>(vol), px, py, out, E * P1, K,
           H2, W2, stream);
  } else {
    launch(static_cast<const float*>(vol), px, py, out, E * P1, K, H2, W2,
           stream);
  }
  return (int)cudaGetLastError();
}
