// K1 for fp32 operands: level 0 of the correlation pyramid on the tensor
// cores as three TF32 products -- all-pairs feature correlation with the
// Gaussian-uncertainty re-weighting fused into the epilogue.
//
// Replaces the Pallas TPU kernel masked_corr_level0 (the JAX package's
// ops/pallas_corr.py, body _kernel) where the features are fp32 (the fp32
// configurations); masked_corr_tc.cu takes bf16 operands.  Per edge e,
// source pixel p and target pixel q:
//   corr = <f1[e,p,:], f2[e,q,:]> / 16
//   out  = corr * (1 + 3 exp(-(dx^2/c1 + dy^2/c2)/2) / (6.28 sqrt(c1 c2)))
// inside the (2r+1)^2 window around floor(mean[e,p]) (dx, dy measured from
// the unfloored mean), out = corr elsewhere.  Output [E, P, P] in fp32 or
// bf16.
//
// 3xTF32: each operand x is split into hi = x with its low 13 mantissa bits
// cleared (a TF32 value, exact in the tensor cores) and lo = x - hi (exact
// in fp32), and each product is a_hi b_hi + a_hi b_lo + a_lo b_hi, three
// wgmma .tf32 products accumulated in fp32.  The dropped a_lo b_lo and the
// TF32 truncation of lo leave ~2^-21 of each product: the JAX kernel's fp32
// dot up to rounding (one TF32 product alone leaves 2^-11, outside the fp32
// tolerance).  hi is written back as a TF32 value, so the result does not
// depend on whether the tensor cores truncate or round the low bits.
//
// What bounds it on the H100: at the tracking shapes (E = 48, P = 3072,
// C = 128) the three products are 348 GFLOP, 0.70 ms at the 494.7 TFLOP/s
// dense TF32 rate, against 151 MB of fp32 features and 906 MB of bf16
// volume (0.32 ms at 3.35 TB/s; 0.59 ms for an fp32 volume): it is bound
// by its operations.
//
// Design: masked_corr_tc.cu's pipeline in fp32.  An fp32 128 x 128 tile is
// 64 KB and needs a lo twin, so the tiles are 64 x 64 (64 source pixels per
// block, 64 target pixels per tile, all 128 channels): the A block's hi and
// lo (32 KB each) stay resident while the block walks its target tiles; a
// 2-deep ring of B tiles (hi and lo, 64 KB a stage) and the fp32 staging
// bring shared memory to 211 KB, one block per SM.  One thread of the
// producer warpgroup issues the TMA loads (3D maps, 128-byte swizzle, boxes
// of 32 channels x 64 pixels, zero-filled past P); its other three warps
// split each tile in shared memory once it has landed (hi in place, lo
// beside it) -- no pre-pass and no extra device memory -- so that the split
// of the next tile overlaps this tile's products and epilogue.  The
// consumer warpgroup issues 3 x 16 wgmma.m64n64k8 per tile, then the epilogue
// of masked_corr_tc.cu: scale by 1/16, stage in fp32, the Gaussian on the
// window's elements only, 16-byte stores.  The grid (row blocks x runs of
// target tiles x edges) comes from the wrapper, which splits the runs when
// E is small so that the card stays full.

#include "hopper.cuh"

namespace {

using namespace lgu;

constexpr int C = 128;       // feature channels
constexpr int BM = 64;       // source pixels per block (one warpgroup)
constexpr int BN = 64;       // target pixels per tile
constexpr int KA = 32;       // fp32 channels per 128-byte swizzle atom
constexpr int ATOMS = C / KA;             // 4
constexpr int ATOM_BYTES = 64 * 128;      // 64 rows x 32 channels
constexpr int TILE_BYTES = ATOMS * ATOM_BYTES;  // 32 KB: 64 rows x 128 ch
constexpr int STAGES = 2;    // B tiles in flight
constexpr int THREADS = 256;  // producer/splitter + consumer warpgroups
constexpr int SPLITTERS = 96;  // warps 1-3 of the producer warpgroup
constexpr int SROW = BN + 8;  // fp32 staging row stride (no conflicts)

constexpr int SMEM_BYTES = 1024 /* alignment slack */
                           + 2 * TILE_BYTES * (1 + STAGES)  // hi, lo: A, B
                           + BM * SROW * 4                  // fp32 staging
                           + 8 * (2 + 3 * STAGES);          // mbarriers

// d[64 x 64] (+)= A[64 x 8] B[64 x 8]^T, TF32 operands K-major in smem
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// split one landed tile: hi in place, lo = x - hi beside it; then make the
// writes visible to the tensor cores (the async proxy)
__device__ __forceinline__ void split_tile(uint8_t* hi, uint8_t* lo, int t) {
  float4* h = reinterpret_cast<float4*>(hi);
  float4* l = reinterpret_cast<float4*>(lo);
  for (int i = t; i < TILE_BYTES / 16; i += SPLITTERS) {
    const float4 x = h[i];
    const float4 a = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z),
                                 tf32_hi(x.w));
    h[i] = a;
    l[i] = make_float4(x.x - a.x, x.y - a.y, x.z - a.z, x.w - a.w);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
masked_corr_tf32_kernel(const __grid_constant__ CUtensorMap map1,
                        const __grid_constant__ CUtensorMap map2,
                        const float* __restrict__ mean,
                        const float* __restrict__ cov,
                        OutT* __restrict__ out, int P, int W, int radius,
                        int tiles_per_block) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* a_hi = smem;                     // [4 atoms][64 rows][32 ch]
  uint8_t* a_lo = smem + TILE_BYTES;
  uint8_t* b_hi = smem + 2 * TILE_BYTES;    // STAGES x [4][64][32]
  uint8_t* b_lo = b_hi + STAGES * TILE_BYTES;
  float* st = reinterpret_cast<float*>(b_lo + STAGES * TILE_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(st + BM * SROW);
  uint64_t* full_a = bars;                     // TMA -> splitters
  uint64_t* ready_a = bars + 1;                // splitters -> consumer
  uint64_t* full_b = bars + 2;                 // [STAGES]
  uint64_t* ready_b = bars + 2 + STAGES;       // [STAGES]
  uint64_t* empty_b = bars + 2 + 2 * STAGES;   // [STAGES]: consumer -> TMA

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n_tiles = (P + BN - 1) / BN;
  const int t_lo = blockIdx.y * tiles_per_block;
  const int t_hi = min(n_tiles, t_lo + tiles_per_block);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_a, 1);
    mbar_init(ready_a, SPLITTERS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_b[s], 1);
      mbar_init(&ready_b[s], SPLITTERS);
      mbar_init(&empty_b[s], 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // producer: one thread issues every TMA load
    if (lane != 0) return;
    mbar_expect_tx(full_a, TILE_BYTES);
    for (int k = 0; k < ATOMS; ++k)
      tma_load(a_hi + k * ATOM_BYTES, &map1, full_a, k * KA, m0, e);
    for (int t = t_lo; t < t_hi; ++t) {
      const int i = t - t_lo;
      const int s = i % STAGES;
      mbar_wait(&empty_b[s], ((i / STAGES) & 1) ^ 1);
      uint8_t* dst = b_hi + s * TILE_BYTES;
      mbar_expect_tx(&full_b[s], TILE_BYTES);
      for (int k = 0; k < ATOMS; ++k)
        tma_load(dst + k * ATOM_BYTES, &map2, &full_b[s], k * KA, t * BN, e);
    }
    return;
  }
  if (warp < 4) {
    // splitters: each landed tile into hi and lo
    const int t = threadIdx.x - 32;
    mbar_wait(full_a, 0);
    split_tile(a_hi, a_lo, t);
    mbar_arrive(ready_a);
    for (int tile = t_lo; tile < t_hi; ++tile) {
      const int i = tile - t_lo;
      const int s = i % STAGES;
      mbar_wait(&full_b[s], (i / STAGES) & 1);
      split_tile(b_hi + s * TILE_BYTES, b_lo + s * TILE_BYTES, t);
      mbar_arrive(&ready_b[s]);
    }
    return;
  }

  // consumer warpgroup: the block's 64 source rows
  const int tid = threadIdx.x - 128;  // 0..127
  const int cw = tid / 32;            // consumer warp
  const float rad = (float)radius;

  // the window pass: two threads per source row, alternate window rows
  const int w_row = tid >> 1;
  const int w_par = tid & 1;
  const int w_p = m0 + w_row;
  float mx = 0.f, my = 0.f, ax = 0.f, ay = 0.f, k = 0.f;
  float fx = nanf(""), fy = nanf("");  // past P: no window
  if (w_p < P) {
    const size_t ep = (size_t)e * P + w_p;
    mx = mean[2 * ep];
    my = mean[2 * ep + 1];
    const float c1 = cov[2 * ep];
    const float c2 = cov[2 * ep + 1];
    fx = floorf(mx);
    fy = floorf(my);
    ax = -0.72134752f / c1;  // -log2(e) / 2
    ay = -0.72134752f / c2;
    k = 3.0f / (6.28f * sqrtf(c1 * c2));
  }
  // the window's columns; NaN or far means make the test false: no window,
  // as in the JAX kernel
  const bool x_hit = fx - rad <= (float)(W - 1) && fx + rad >= 0.f;
  const int x_lo = x_hit ? max((int)(fx - rad), 0) : 0;
  const int x_hi = x_hit ? min((int)(fx + rad), W - 1) : -1;

  mbar_wait(ready_a, 0);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int t = t_lo; t < t_hi; ++t) {
    const int i = t - t_lo;
    const int s = i % STAGES;
    const int n0 = t * BN;
    const uint8_t* bh = b_hi + s * TILE_BYTES;
    const uint8_t* bl = b_lo + s * TILE_BYTES;
    mbar_wait(&ready_b[s], (i / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 8; ++kk) {
      // k8 steps: 32 bytes within a 128-byte swizzle row, 4 per atom
      const int off = (kk / 4) * ATOM_BYTES + (kk % 4) * 32;
      wgmma_m64n64k8(acc, desc(a_lo + off), desc(bh + off), kk > 0);
      wgmma_m64n64k8(acc, desc(a_hi + off), desc(bl + off), 1);
      wgmma_m64n64k8(acc, desc(a_hi + off), desc(bh + off), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    if (lane == 0) mbar_arrive(&empty_b[s]);

    // the accumulator fragment: register i of this thread holds row
    // cw*16 + lane/4 + 8*((i>>1)&1), column (i>>2)*8 + (lane%4)*2 + (i&1)
    named_sync(1);  // the previous tile's staging has been read
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = cw * 16 + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = j * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(st + lr * SROW + col) =
            make_float2(acc[4 * j + 2 * h] * (1.0f / 16.0f),
                        acc[4 * j + 2 * h + 1] * (1.0f / 16.0f));
      }
    }
    named_sync(1);  // the tile is staged

    // the Gaussian on the window's elements that lie in this tile
    const int q_last = min(n0 + BN, P) - 1;
    const int ty_lo = n0 / W;
    const int ty_hi = q_last / W;
    if (x_hit && fy - rad <= (float)ty_hi && fy + rad >= (float)ty_lo) {
      const int y_lo = max((int)(fy - rad), ty_lo);
      const int y_hi = min((int)(fy + rad), ty_hi);
      float* row = st + w_row * SROW;
      for (int y = y_lo + w_par; y <= y_hi; y += 2) {
        const float dy = (float)y - my;
        const float ey = dy * dy * ay;
        for (int x = x_lo; x <= x_hi; ++x) {
          const int q = y * W + x;
          if (q < n0 || q > q_last) continue;
          const float dx = (float)x - mx;
          row[q - n0] *= 1.0f + k * exp2f(dx * dx * ax + ey);
        }
      }
    }
    named_sync(1);  // the window is applied

    // 64 rows x BN columns out of staging, row by row, 16 bytes a thread
    constexpr int EPV = 16 / sizeof(OutT);  // elements per 16-byte vector
    constexpr int VPR = BN / EPV;           // vectors per row
    const bool vec = (P * (int)sizeof(OutT)) % 16 == 0;
    for (int idx = tid; idx < BM * VPR; idx += 128) {
      const int lr = idx / VPR;
      const int q0 = n0 + (idx % VPR) * EPV;
      const int p = m0 + lr;
      if (p >= P || q0 >= P) continue;
      const float* src = st + lr * SROW + (idx % VPR) * EPV;
      OutT* dst = out + ((size_t)e * P + p) * P + q0;
      if (vec) {
        store16(dst, src);
      } else {
#pragma unroll
        for (int u = 0; u < EPV; ++u)
          if (q0 + u < P) dst[u] = to_out(src[u], dst);
      }
    }
  }
}

template <typename OutT>
int launch(const CUtensorMap& m1, const CUtensorMap& m2, const float* mean,
           const float* cov, void* out, int E, int P, int W, int radius,
           int splits, int tiles_per_block, cudaStream_t stream) {
  const int bytes = SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      masked_corr_tf32_kernel<OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + BM - 1) / BM, splits, E);
  masked_corr_tf32_kernel<OutT><<<grid, THREADS, bytes, stream>>>(
      m1, m2, mean, cov, static_cast<OutT*>(out), P, W, radius,
      tiles_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// f1, f2: [E, H*W, 128] fp32; mean, cov: [E, H*W, 2] fp32; out: [E, P, P]
// in bf16 (out_bf16 != 0) or fp32.  The grid is (ceil(P / 64), splits, E);
// block (r, y, e) computes rows 64r.. of edge e against the target tiles
// y * tiles_per_block .. (64-pixel tiles).  Returns 0, cudaGetLastError()
// after the launch, or -1 when cuTensorMapEncodeTiled is unavailable,
// -2 when it refuses a map.
extern "C" int masked_corr_level0_tf32(const float* f1, const float* f2,
                                       const float* mean, const float* cov,
                                       void* out, int E, int H, int W,
                                       int radius, int splits,
                                       int tiles_per_block, int out_bf16,
                                       cudaStream_t stream) {
  const int P = H * W;
  lgu::EncodeTiled enc = lgu::encode_tiled();
  if (enc == nullptr) return -1;
  CUtensorMap m1, m2;
  // boxes of 32 channels x 64 pixels
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (lgu::feature_map(enc, &m1, f1, f32, 4, E, P, C, KA, BM) != 0
      || lgu::feature_map(enc, &m2, f2, f32, 4, E, P, C, KA, BN) != 0)
    return -2;
  return out_bf16
             ? launch<__nv_bfloat16>(m1, m2, mean, cov, out, E, P, W, radius,
                                     splits, tiles_per_block, stream)
             : launch<float>(m1, m2, mean, cov, out, E, P, W, radius, splits,
                             tiles_per_block, stream);
}
