// K1 for bf16 operands: level 0 of the correlation pyramid on the tensor
// cores -- all-pairs feature correlation with the Gaussian-uncertainty
// re-weighting fused into the epilogue.
//
// Replaces the Pallas TPU kernel masked_corr_level0 (the JAX package's
// ops/pallas_corr.py, body _kernel) where the features are bf16 values (the
// bf16 keyframe store, a bf16 encoder's output); masked_corr_tf32.cu takes
// fp32 operands.  Per edge e, source pixel p and target pixel q:
//   corr = <f1[e,p,:], f2[e,q,:]> / 16
//   out  = corr * (1 + 3 exp(-(dx^2/c1 + dy^2/c2)/2) / (6.28 sqrt(c1 c2)))
// inside the (2r+1)^2 window around floor(mean[e,p]) (dx, dy measured from
// the unfloored mean), out = corr elsewhere.  Output [E, P, P] in fp32 or
// bf16.  The product of two bf16 values is exact in fp32, so bf16 tensor
// cores accumulating in fp32 compute the JAX kernel's fp32 dot up to the
// order of summation.
//
// What bounds it on the H100: at the tracking shapes (E = 48, P = 3072,
// C = 128) the product is 116 GFLOP (0.117 ms at the 989 TFLOP/s bf16
// rate) against 984 MB of traffic (75.5 MB of bf16 features, 2.4 MB of
// mean and cov, 906 MB of bf16 volume written): 0.294 ms at 3.35 TB/s.  It
// is bound by its output stores.
//
// Design: one block per (edge, 128 source pixels, run of 128-pixel target
// tiles).  The A block (128 x 128 bf16, 32 KB) is loaded once by TMA and
// stays resident while the block walks its target tiles; a producer thread
// keeps a ring of 3 B tiles (128 x 128 bf16) in flight with TMA in the
// 128-byte swizzle that the wgmma shared-memory descriptors read, signalled
// through mbarriers.  C = 128 fits in one stage, so there is no K loop to
// pipeline: the pipeline runs across output tiles.  Two consumer
// warpgroups each own 64 source rows and issue 8 wgmma.m64n128k16 (bf16 in,
// fp32 accumulators in registers) per tile, then the epilogue: scale by
// 1/16 and stage the tile in fp32 in padded shared memory; then two threads
// per source row apply the Gaussian to the row's window elements that lie
// in the tile (at most 81 per row, none for most tiles: tested once per row
// and tile, before any exp); then convert and write each row with 16-byte
// vector stores (element stores where P * sizeof(out) is no multiple of 16,
// e.g. 7 x 9).  The window pass replaced a per-element Gaussian in
// registers: the lanes of a warp hold eight different rows, so a branch per
// element ran for nearly all of them and doubled the kernel's time.  The
// stores are posted, so they drain while the next tile's wgmma runs.  TMA
// zero-fills the rows past P (3D maps, one plane per edge), and the stores
// are masked.  The grid splits the target tiles of a row block over
// several blocks when E is small (the motion filter's 1-edge probe), so
// that the card stays full.

#include "hopper.cuh"

namespace {

using namespace lgu;

constexpr int C = 128;       // feature channels
constexpr int BM = 128;      // source pixels per block (2 warpgroups x 64)
constexpr int BN = 128;      // target pixels per tile
constexpr int KH = 64;       // channels per 128-byte swizzle atom
constexpr int STAGES = 3;    // B tiles in flight
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int HALF_BYTES = 128 * KH * 2;       // one 128-row x 64 half tile
constexpr int TILE_BYTES = 2 * HALF_BYTES;     // 32 KB: 128 rows x 128 ch
constexpr int SROW = BN + 8;  // fp32 staging row stride (no conflicts)
constexpr int SPLIT_TARGET = 264;  // blocks to aim for: 2 per SM

constexpr int SMEM_BYTES = 1024 /* alignment slack */
                           + TILE_BYTES * (1 + STAGES)    // A and the B ring
                           + 2 * 64 * SROW * 4            // fp32 staging
                           + 8 * (1 + 2 * STAGES);        // mbarriers

// d[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, both K-major in smem
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
masked_corr_tc_kernel(const __grid_constant__ CUtensorMap map1,
                      const __grid_constant__ CUtensorMap map2,
                      const float* __restrict__ mean,
                      const float* __restrict__ cov, OutT* __restrict__ out,
                      int P, int W, int radius, int tiles_per_block) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* sA = smem;                 // [2 halves][128 rows][64 ch]
  uint8_t* sB = smem + TILE_BYTES;    // STAGES x [2 halves][128][64]
  float* stage = reinterpret_cast<float*>(smem + TILE_BYTES * (1 + STAGES));
  uint64_t* bars = reinterpret_cast<uint64_t*>(stage + 2 * 64 * SROW);
  uint64_t* full_a = bars;
  uint64_t* full_b = bars + 1;            // [STAGES]
  uint64_t* empty_b = bars + 1 + STAGES;  // [STAGES]

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n_tiles = (P + BN - 1) / BN;
  const int t_lo = blockIdx.y * tiles_per_block;
  const int t_hi = min(n_tiles, t_lo + tiles_per_block);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_a, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_b[s], 1);
      mbar_init(&empty_b[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every TMA load
    if (threadIdx.x != 0) return;
    mbar_expect_tx(full_a, TILE_BYTES);
    tma_load(sA, &map1, full_a, 0, m0, e);
    tma_load(sA + HALF_BYTES, &map1, full_a, KH, m0, e);
    for (int t = t_lo; t < t_hi; ++t) {
      const int i = t - t_lo;
      const int s = i % STAGES;
      mbar_wait(&empty_b[s], ((i / STAGES) & 1) ^ 1);
      uint8_t* dst = sB + s * TILE_BYTES;
      mbar_expect_tx(&full_b[s], TILE_BYTES);
      tma_load(dst, &map2, &full_b[s], 0, t * BN, e);
      tma_load(dst + HALF_BYTES, &map2, &full_b[s], KH, t * BN, e);
    }
    return;
  }

  // consumers: warpgroup c owns source rows m0 + 64c .. m0 + 64c + 63
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;  // 0..127
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* st = stage + c * 64 * SROW;
  const float rad = (float)radius;

  // the window pass: two threads per source row, alternate window rows
  const int w_row = tid >> 1;
  const int w_par = tid & 1;
  const int w_p = m0 + 64 * c + w_row;
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

  const uint8_t* a_base = sA + c * 64 * 128;  // 64 rows of 128 bytes
  mbar_wait(full_a, 0);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int t = t_lo; t < t_hi; ++t) {
    const int i = t - t_lo;
    const int s = i % STAGES;
    const int n0 = t * BN;
    const uint8_t* b_base = sB + s * TILE_BYTES;
    mbar_wait(&full_b[s], (i / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      const int off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
      wgmma_m64n128k16(acc, desc(a_base + off), desc(b_base + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    if (lane == 0) mbar_arrive(&empty_b[s]);

    // the accumulator fragment: register i of this thread holds row
    // warp*16 + lane/4 + 8*((i>>1)&1), column (i>>2)*8 + (lane%4)*2 + (i&1)
    named_sync(1 + c);  // the previous tile's staging has been read
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = warp * 16 + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = j * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(st + lr * SROW + col) =
            make_float2(acc[4 * j + 2 * h] * (1.0f / 16.0f),
                        acc[4 * j + 2 * h + 1] * (1.0f / 16.0f));
      }
    }
    named_sync(1 + c);  // the tile is staged

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
    named_sync(1 + c);  // the window is applied

    // 64 rows x BN columns out of staging, row by row, 16 bytes a thread
    constexpr int EPV = 16 / sizeof(OutT);  // elements per 16-byte vector
    constexpr int VPR = BN / EPV;           // vectors per row
    const bool vec = (P * (int)sizeof(OutT)) % 16 == 0;
    for (int idx = tid; idx < 64 * VPR; idx += 128) {
      const int lr = idx / VPR;
      const int q0 = n0 + (idx % VPR) * EPV;
      const int p = m0 + 64 * c + lr;
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
           cudaStream_t stream) {
  const int bytes = SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      masked_corr_tc_kernel<OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int m_tiles = (P + BM - 1) / BM;
  const int n_tiles = (P + BN - 1) / BN;
  // split each row block's target tiles when E * m_tiles leaves SMs idle
  int split = (SPLIT_TARGET + E * m_tiles - 1) / (E * m_tiles);
  split = split < 1 ? 1 : (split > n_tiles ? n_tiles : split);
  const int per_block = (n_tiles + split - 1) / split;
  split = (n_tiles + per_block - 1) / per_block;
  const dim3 grid(m_tiles, split, E);
  masked_corr_tc_kernel<OutT><<<grid, THREADS, bytes, stream>>>(
      m1, m2, mean, cov, static_cast<OutT*>(out), P, W, radius, per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// f1, f2: [E, H*W, 128] bf16; mean, cov: [E, H*W, 2] fp32; out: [E, P, P]
// in bf16 (out_bf16 != 0) or fp32.  Returns 0, cudaGetLastError() after
// the launch, or -1 when cuTensorMapEncodeTiled is unavailable,
// -2 when it refuses a map.
extern "C" int masked_corr_level0_tc(const void* f1, const void* f2,
                                     const float* mean, const float* cov,
                                     void* out, int E, int H, int W,
                                     int radius, int out_bf16,
                                     cudaStream_t stream) {
  const int P = H * W;
  lgu::EncodeTiled enc = lgu::encode_tiled();
  if (enc == nullptr) return -1;
  CUtensorMap m1, m2;
  // boxes of 64 channels x 128 pixels
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (lgu::feature_map(enc, &m1, f1, bf16, 2, E, P, C, KH, BM) != 0
      || lgu::feature_map(enc, &m2, f2, bf16, 2, E, P, C, KH, BN) != 0)
    return -2;
  return out_bf16 ? launch<__nv_bfloat16>(m1, m2, mean, cov, out, E, P, W,
                                          radius, stream)
                  : launch<float>(m1, m2, mean, cov, out, E, P, W, radius,
                                  stream);
}
