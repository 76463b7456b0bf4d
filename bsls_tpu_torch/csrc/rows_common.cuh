// Shared pieces of the per-row kernels (proj_simplex_rows.cu, pava_rows.cu).
//
// Both kernels have the same shape: an (R, w) row-major fp32 array whose
// rows are independent, R = S * Bk (the S scenarios of a (S, Bk, w) bucket
// folded into the row axis by a reshape), and per-block parameters
// widths[Bk] / radius[Bk] that row r reads at r % Bk, so the S-fold
// broadcast of the parameters never exists in memory.  One thread owns one
// row and keeps it in registers.
#pragma once

#include <cuda_runtime.h>

namespace bsls {

// Finite stand-in for -inf on masked slots: inf - inf would be NaN.
constexpr float kBig = 3.0e38f;
constexpr int kThreads = 128;
constexpr int kMaxWidth = 128;

// Load row `row` of an (R, W) array into registers; 16-byte loads where the
// row is a whole number of float4 (rows then start 16-byte aligned, because
// torch allocations are and W * 4 is a multiple of 16).
template <int W>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         long long row, float (&x)[W]) {
  if constexpr (W % 4 == 0) {
    const float4* p = reinterpret_cast<const float4*>(src + row * W);
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 t = p[q];
      x[4 * q + 0] = t.x;
      x[4 * q + 1] = t.y;
      x[4 * q + 2] = t.z;
      x[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) x[i] = src[row * W + i];
  }
}

template <int W>
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          long long row, const float (&x)[W]) {
  if constexpr (W % 4 == 0) {
    float4* p = reinterpret_cast<float4*>(dst + row * W);
#pragma unroll
    for (int q = 0; q < W / 4; ++q)
      p[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) dst[row * W + i] = x[i];
  }
}

inline unsigned int grid_for(long long rows) {
  return static_cast<unsigned int>((rows + kThreads - 1) / kThreads);
}

}  // namespace bsls
