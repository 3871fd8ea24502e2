// Bilinear tap of one flat correlation plane with the reference CUDA
// boundary rule, shared by K2 and K6 one_level (pyramid_lookup.cu) and
// K3/K4 (window_lookup.cu): a tap is 0 unless its floor corner is inside
// the plane (NaN positions included), and a +1 corner outside the plane
// reads 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lgu {

__device__ __forceinline__ float load(const float* p, size_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// bilinear tap of one pixel's plane vol [H2 * W2] at (px, py)
template <typename T>
__device__ __forceinline__ float bilinear(const T* __restrict__ vol, int H2,
                                          int W2, float px, float py) {
  const float x1 = floorf(px);
  const float y1 = floorf(py);
  if (!(x1 >= 0.f && x1 < (float)W2 && y1 >= 0.f && y1 < (float)H2)) {
    return 0.f;
  }
  const float dx = px - x1;
  const float dy = py - y1;
  const int xi = (int)x1;
  const int yi = (int)y1;
  const bool xo = xi + 1 < W2;
  const bool yo = yi + 1 < H2;
  const size_t r0 = (size_t)yi * W2 + xi;
  const float v11 = load(vol, r0);
  const float v21 = xo ? load(vol, r0 + 1) : 0.f;
  const float v12 = yo ? load(vol, r0 + W2) : 0.f;
  const float v22 = (xo && yo) ? load(vol, r0 + W2 + 1) : 0.f;
  return v11 * (1.f - dy) * (1.f - dx) + v21 * (1.f - dy) * dx +
         v12 * dy * (1.f - dx) + v22 * dy * dx;
}

// A bilinear tap with its corners loaded: bilinear()'s rule and arithmetic,
// the corner loads predicated instead of behind an early return, so that a
// thread's taps issue their loads together (K2, K3/K4).
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
  t.v11 = t.ok ? load(r0, 0) : 0.f;
  t.v21 = xo ? load(r0, 1) : 0.f;
  t.v12 = yo ? load(r0, W2) : 0.f;
  t.v22 = (xo && yo) ? load(r0, W2 + 1) : 0.f;
  return t;
}

__device__ __forceinline__ float tap_value(const Tap& t) {
  const float v = t.v11 * (1.f - t.dy) * (1.f - t.dx) +
                  t.v21 * (1.f - t.dy) * t.dx + t.v12 * t.dy * (1.f - t.dx) +
                  t.v22 * t.dy * t.dx;
  return t.ok ? v : 0.f;
}

}  // namespace lgu
