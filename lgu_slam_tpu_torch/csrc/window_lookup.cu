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
// and writes one fp32 value (12 bytes) and reads at most four 2- or 4-byte
// plane corners; the arithmetic is ~20 operations per tap.
//
// Design: one thread per output tap, threads in (e, p, k) order, so the
// position reads and the output writes are coalesced; the corners of the
// taps of one pixel fall in a few rows of its plane and are served by
// L1/L2.  The flat levels are read in place (no lane packing as on the TPU).

#include "bilinear.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
window_lookup_kernel(const T* __restrict__ vol, const float* __restrict__ px,
                     const float* __restrict__ py, float* __restrict__ out,
                     size_t n_taps, int K, int H2, int W2) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_taps) return;
  const size_t pix = i / (size_t)K;  // e * P1 + p
  const T* plane = vol + pix * (size_t)H2 * W2;
  out[i] = lgu::bilinear(plane, H2, W2, __ldg(px + i), __ldg(py + i));
}

}  // namespace

// vol: flat level [E, P1, H2 * W2] (bf16 when vol_bf16 != 0, else fp32);
// px/py/out: [E, P1, K] fp32.  Returns cudaGetLastError() after launch.
extern "C" int window_lookup(const void* vol, const float* px,
                             const float* py, float* out, int E, int P1,
                             int K, int H2, int W2, int vol_bf16,
                             cudaStream_t stream) {
  const size_t n_taps = (size_t)E * P1 * K;
  const unsigned blocks = (unsigned)((n_taps + THREADS - 1) / THREADS);
  if (vol_bf16) {
    window_lookup_kernel<__nv_bfloat16><<<blocks, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(vol), px, py, out, n_taps, K, H2,
        W2);
  } else {
    window_lookup_kernel<float><<<blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(vol), px, py, out, n_taps, K, H2, W2);
  }
  return (int)cudaGetLastError();
}
