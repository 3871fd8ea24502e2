// K5: per-lane row gather.
//
// Replaces the Pallas TPU probe run of the JAX package's _prof_sublane.py
// (bodies chain_kernel and sublane_kernel, which compute one function):
//   out[e, p, l] = V[e, p, s[e, p, l], l]
// with V bf16 [E, P, S, L], s int32 [E, P, L], out fp32 [E, P, L].  On the
// TPU the probe asked whether Mosaic lowers a sublane gather or needs an
// S-step select chain; on Hopper a gather is a load, so one kernel computes
// the function.  It is the access pattern of K2's corner reads: 2-byte
// values gathered from a few rows of a plane, one per lane.  An index
// outside [0, S) reads 0.
//
// What bounds it on the H100: bytes.  The byte bound counts s and out once
// and 2 bytes of V per element (189 MB at the probe's E = 48, P = 3072,
// S = 24, L = 128); the memory system moves whole 32-byte sectors, so the
// sector bound counts every distinct sector of V that the run's s touches
// (about half of V for uniform s).
//
// Design: one thread per output element in (e, p, l) order, so the reads
// of s and the writes of out are coalesced; a warp's V reads fall in the
// S rows of one (e, p) block, 64 bytes of lanes per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const __nv_bfloat16* __restrict__ V,
                  const int* __restrict__ s, float* __restrict__ out,
                  size_t n, int S, int L) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t row = i / (size_t)L;  // e * P + p
  const size_t l = i - row * (size_t)L;
  const int r = __ldg(s + i);
  float v = 0.f;
  if (r >= 0 && r < S) v = __bfloat162float(V[(row * S + r) * L + l]);
  out[i] = v;
}

}  // namespace

// V [rows, S, L] bf16, s [rows, L] int32, out [rows, L] fp32 with
// rows = E * P.  Returns cudaGetLastError() after launch.
extern "C" int row_gather(const void* V, const int* s, float* out, int rows,
                          int S, int L, cudaStream_t stream) {
  const size_t n = (size_t)rows * L;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  row_gather_kernel<<<blocks, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(V), s, out, n, S, L);
  return (int)cudaGetLastError();
}
