// Hopper building blocks shared by K1's tensor-core kernels
// (masked_corr_tc.cu: bf16 operands, masked_corr_tf32.cu: fp32 operands):
// mbarriers, 3D TMA loads, wgmma shared-memory descriptors and fences, the
// epilogue's 16-byte stores, and the TMA map encoder looked up at run time.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lgu {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// 3D TMA load of one box {channels, rows, 1 edge} into swizzled smem
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c, int row,
                                         int e) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(row), "r"(e),
      "r"(smem_addr(bar))
      : "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// a barrier of one warpgroup (128 threads), ids from 1 (0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float to_out(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16*) {
  return __float2bfloat16(v);
}

// 16 output bytes from fp32 staging: 4 floats, or 8 floats as bf16
__device__ __forceinline__ void store16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  __nv_bfloat162 v[4] = {__floats2bfloat162_rn(a.x, a.y),
                         __floats2bfloat162_rn(a.z, a.w),
                         __floats2bfloat162_rn(b.x, b.y),
                         __floats2bfloat162_rn(b.z, b.w)};
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up at run time through the CUDA runtime, so
// the library needs no -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// features [E, P, C] as a 3D map {channel, pixel, edge} of elements of
// `esize` bytes, read in boxes of {box_c channels (128 bytes), box_rows
// pixels, 1 edge} in the 128-byte swizzle; boxes past P are zero-filled
inline CUresult feature_map(EncodeTiled enc, CUtensorMap* map, const void* f,
                            CUtensorMapDataType type, int esize, int E, int P,
                            int C, int box_c, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)P, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)C * esize,
                                 (cuuint64_t)P * C * esize};
  const cuuint32_t box[3] = {(cuuint32_t)box_c, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(f), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace lgu
