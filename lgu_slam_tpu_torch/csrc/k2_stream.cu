// K6 (dma_only): K2's memory floor, every byte of K2's inputs streamed once.
//
// Replaces the Pallas TPU probe dma_only of the JAX package's _prof_kparts.py
// (body dma_kernel).  There the BlockSpec DMA moves every byte of K2's
// inputs into VMEM whatever the body does, and the body only sums the first
// 64 lanes of row 0 of each block.  A GPU kernel reads only what its
// threads load, so computing that sum would read 64 elements per row and
// measure nothing; this kernel computes a function that needs every byte:
// for each (edge e, pixel p),
//   out[e, p, k] = sum, over every input row of (e, p) -- the four flat
//                  bf16 levels [E, P1, h_l * w_l], cflat [E, P1, 2], off0
//                  and off1 [E, P1, 98] fp32 -- of the elements whose index
//                  in their own row is k modulo 64,
// out fp32 [E, P1, 64].
//
// What bounds it on the H100: bytes (1.358 GB at E = 48 on 48 x 64: 1.203 GB
// of levels, 115.6 MB of offsets, 1.2 MB of coordinates, 37.7 MB of output)
// at one add per element.  The time against K2's is how far K2's gathers beat
// streaming the planes.
//
// Design: one warp per (e, p).  A bf16 row whose length is a multiple of 8
// (and 16-byte aligned) is read as 16-byte vectors: vector v holds elements
// 8v .. 8v + 7, which fold into k = 8 (v mod 8) .. + 7, and lane t reads
// vectors t, t + 32, ..., all with v mod 8 = t mod 8, so each lane keeps 8
// sums.  Other rows (the fp32 offsets and coordinates) are read one element
// per lane, coalesced.  The lanes' sums meet in 64 floats of shared memory
// per warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;   // warps (pixels) per block
constexpr int FOLD = 64;   // output lanes per pixel

template <typename T>
__device__ __forceinline__ float to_float(T x) {
  return static_cast<float>(x);
}
template <>
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// row [n], one element per lane: element j folds into j mod 64
template <typename T>
__device__ __forceinline__ void fold_scalar(const T* __restrict__ row, int n,
                                            int lane, float* sm) {
  float a = 0.f;
  float b = 0.f;
  for (int j = lane; j < n; j += FOLD) a += to_float(row[j]);
  for (int j = lane + 32; j < n; j += FOLD) b += to_float(row[j]);
  atomicAdd(sm + lane, a);
  atomicAdd(sm + lane + 32, b);
}

__device__ __forceinline__ void fold_level(const __nv_bfloat16* __restrict__ row,
                                           int n, int lane, float* sm) {
  if ((n & 7) != 0 || (reinterpret_cast<uintptr_t>(row) & 15) != 0) {
    fold_scalar(row, n, lane, sm);
    return;
  }
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const uint4* vec = reinterpret_cast<const uint4*>(row);
  for (int v = lane; v < n / 8; v += 32) {
    const uint4 q = __ldg(vec + v);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
  const int k0 = 8 * (lane & 7);
#pragma unroll
  for (int i = 0; i < 8; ++i) atomicAdd(sm + k0 + i, acc[i]);
}

struct Levels {
  const __nv_bfloat16* v[4];
  int n[4];  // h_l * w_l
};

__global__ void __launch_bounds__(WARPS * 32)
k2_stream_kernel(Levels lv, const float* __restrict__ cflat,
                 const float* __restrict__ off0,
                 const float* __restrict__ off1, float* __restrict__ out,
                 int n_pix, int n_off) {
  __shared__ float sums[WARPS][FOLD];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pix = blockIdx.x * WARPS + warp;  // e * P1 + p
  if (pix >= n_pix) return;  // uniform per warp
  float* sm = sums[warp];
  sm[lane] = 0.f;
  sm[lane + 32] = 0.f;
  __syncwarp();
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    fold_level(lv.v[l] + (size_t)pix * lv.n[l], lv.n[l], lane, sm);
  }
  fold_scalar(cflat + (size_t)pix * 2, 2, lane, sm);
  fold_scalar(off0 + (size_t)pix * n_off, n_off, lane, sm);
  fold_scalar(off1 + (size_t)pix * n_off, n_off, lane, sm);
  __syncwarp();
  out[(size_t)pix * FOLD + lane] = sm[lane];
  out[(size_t)pix * FOLD + lane + 32] = sm[lane + 32];
}

}  // namespace

// v0..v3: flat bf16 levels [E, P1, n_l]; cflat [E, P1, 2]; off0/off1
// [E, P1, n_off] fp32; out [E, P1, 64] fp32; n_pix = E * P1.  Returns
// cudaGetLastError() after launch.
extern "C" int k2_stream_floor(const void* v0, const void* v1, const void* v2,
                               const void* v3, int n0, int n1, int n2, int n3,
                               const float* cflat, const float* off0,
                               const float* off1, float* out, int n_pix,
                               int n_off, cudaStream_t stream) {
  Levels lv;
  const void* vs[4] = {v0, v1, v2, v3};
  const int ns[4] = {n0, n1, n2, n3};
  for (int l = 0; l < 4; ++l) {
    lv.v[l] = static_cast<const __nv_bfloat16*>(vs[l]);
    lv.n[l] = ns[l];
  }
  const int blocks = (n_pix + WARPS - 1) / WARPS;
  k2_stream_kernel<<<blocks, WARPS * 32, 0, stream>>>(lv, cflat, off0, off1,
                                                      out, n_pix, n_off);
  return (int)cudaGetLastError();
}
