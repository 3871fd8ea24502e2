// K1: level 0 of the correlation pyramid -- all-pairs feature correlation
// with the Gaussian-uncertainty re-weighting fused into the epilogue.
//
// Replaces the Pallas TPU kernel masked_corr_level0 (the JAX package's
// ops/pallas_corr.py, body _kernel).  Per edge e, source pixel p and target
// pixel q:
//   corr = <f1[e,p,:], f2[e,q,:]> / 16
//   out  = corr * (1 + 3 exp(-(dx^2/c1 + dy^2/c2)/2) / (6.28 sqrt(c1 c2)))
// inside the (2r+1)^2 window around floor(mean[e,p]) (dx, dy measured from
// the unfloored mean), out = corr elsewhere.  Output [E, P, P] in fp32 or
// bf16 (the pyramid's volume dtype).
//
// What bounds it on the H100: at the tracking shapes (E = 48, P = 3072,
// C = 128) the product is 2 E P^2 C = 116 GFLOP of fp32 arithmetic against
// ~1.06 GB of traffic (151 MB of fp32 features in, 906 MB of bf16 volume
// out), so it is bound by fp32 operations (67 TFLOP/s outside the tensor
// cores), not by the 3.35 TB/s of HBM.
//
// Design: a classic tiled SGEMM -- one block per (edge, 64 source pixels x
// 64 target pixels), 16-channel slices of f1 and f2 staged in shared memory,
// a 4x4 register tile per thread with fp32 FMA accumulation.  The Gaussian
// epilogue is computed in registers from the (mean, cov) of the tile's
// source pixels and the result is written straight in the volume dtype, so
// no fp32 [E, P, P] volume ever reaches device memory.  Ragged tiles (any P,
// e.g. TUM's 30 x 40 = 1200) are masked on load and store.
//
// The inputs are fp32, as in the JAX kernel.  On the frontend the features
// come from the bf16 keyframe store, so a later version can feed bf16 to the
// tensor cores (wgmma, TMA) without losing information; that is the path to
// the 989 TFLOP/s bf16 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;  // source pixels per block
constexpr int BN = 64;  // target pixels per block
constexpr int BK = 16;  // feature channels per shared-memory stage
constexpr int TM = 4;   // register tile rows per thread
constexpr int TN = 4;   // register tile columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;  // keeps rows 16-byte aligned for float4 reads

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
masked_corr_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   const float* __restrict__ mean,
                   const float* __restrict__ cov, OutT* __restrict__ out,
                   int P, int W, int C, int radius) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const float* A = f1 + (size_t)e * P * C;
  const float* B = f2 + (size_t)e * P * C;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int i = tid + r * THREADS;
      const int row = i / BK;
      const int k = i % BK;
      const int gk = k0 + k;
      const int gm = m0 + row;
      const int gn = n0 + row;
      As[k][row] = (gm < P && gk < C) ? A[(size_t)gm * C + gk] : 0.f;
      Bs[k][row] = (gn < P && gk < C) ? B[(size_t)gn * C + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // fused Gaussian epilogue, straight to the volume dtype
  const float rad = (float)radius;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = m0 + ty * TM + i;
    if (p >= P) continue;
    const size_t ep = (size_t)e * P + p;
    const float mx = mean[2 * ep];
    const float my = mean[2 * ep + 1];
    const float c1 = cov[2 * ep];
    const float c2 = cov[2 * ep + 1];
    const float fx = floorf(mx);
    const float fy = floorf(my);
    const float denom = 6.28f * sqrtf(c1 * c2);
    OutT* row = out + ep * P;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int q = n0 + tx * TN + j;
      if (q >= P) continue;
      const float qx = (float)(q % W);
      const float qy = (float)(q / W);
      float v = acc[i][j] * (1.0f / 16.0f);
      if (fabsf(qx - fx) <= rad && fabsf(qy - fy) <= rad) {
        const float dx = qx - mx;
        const float dy = qy - my;
        const float g = 3.0f * expf(-0.5f * (dx * dx / c1 + dy * dy / c2));
        v = v * (1.0f + g / denom);
      }
      store(row + q, v);
    }
  }
}

}  // namespace

// f1, f2: [E, H*W, C] fp32; mean, cov: [E, H*W, 2] fp32; out: [E, P, P] in
// bf16 (out_bf16 != 0) or fp32.  Returns cudaGetLastError() after launch.
extern "C" int masked_corr_level0(const float* f1, const float* f2,
                                  const float* mean, const float* cov,
                                  void* out, int E, int H, int W, int C,
                                  int radius, int out_bf16,
                                  cudaStream_t stream) {
  const int P = H * W;
  const dim3 grid((P + BN - 1) / BN, (P + BM - 1) / BM, E);
  if (out_bf16) {
    masked_corr_kernel<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        f1, f2, mean, cov, static_cast<__nv_bfloat16*>(out), P, W, C,
        radius);
  } else {
    masked_corr_kernel<float><<<grid, THREADS, 0, stream>>>(
        f1, f2, mean, cov, static_cast<float*>(out), P, W, C, radius);
  }
  return (int)cudaGetLastError();
}
