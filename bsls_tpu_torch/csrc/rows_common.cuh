// Shared pieces of the per-row kernels (proj_simplex_rows.cu, pava_rows.cu).
//
// Both kernels have the same shape: an (R, w) row-major fp32 array whose
// rows are independent, R = S * Bk (the S scenarios of a (S, Bk, w) bucket
// folded into the row axis by a reshape), and per-block parameters
// widths[Bk] / radius[Bk] that row r = s * Bk + b reads at b, so the S-fold
// broadcast of the parameters never exists in memory.  Both take every
// bucket of a call in one launch: a block covers consecutive rows of one
// bucket, and finds the block index of its first row with the bucket's magic
// number.
#pragma once

#include <cuda_runtime.h>

namespace bsls {

// Finite stand-in for -inf on masked slots: inf - inf would be NaN.
constexpr float kBig = 3.0e38f;
constexpr int kThreads = 128;
constexpr int kMaxWidth = 128;
// Buckets one launch takes (the wrappers launch again beyond them).
constexpr int kMaxBuckets = 8;
// Rows a bucket may hold (S * Bk): the row index of a block's last row fits
// 32 bits.
constexpr long long kMaxRows = (1LL << 32) - (1LL << 12);

// Row-contiguous loads of a thread form (K == w): 16- or 8-byte vectors where
// the bucket's pointers are aligned, through the read-only path (__ldg: the
// input never aliases an output of the launch).
template <int K>
__device__ __forceinline__ void load_thread_row(const float* __restrict__ src, bool vec,
                                                float (&x)[K]) {
  if constexpr (K % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(src) + q);
        x[4 * q] = t.x;
        x[4 * q + 1] = t.y;
        x[4 * q + 2] = t.z;
        x[4 * q + 3] = t.w;
      }
      return;
    }
  } else if constexpr (K % 2 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < K / 2; ++q) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(src) + q);
        x[2 * q] = t.x;
        x[2 * q + 1] = t.y;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = __ldg(src + k);
}

template <int K>
__device__ __forceinline__ void store_thread_row(float* __restrict__ dst, bool vec,
                                                 const float (&x)[K]) {
  if constexpr (K % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < K / 4; ++q)
        reinterpret_cast<float4*>(dst)[q] =
            make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
      return;
    }
  } else if constexpr (K % 2 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < K / 2; ++q)
        reinterpret_cast<float2*>(dst)[q] = make_float2(x[2 * q], x[2 * q + 1]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) dst[k] = x[k];
}

// The magic number of a divisor Bk for the round-up method:
// r / Bk = (t + ((r - t) >> shift1)) >> shift2, t = umulhi(r, magic).
struct Magic {
  unsigned int magic;
  int shift1, shift2;
};

inline Magic magic_of(unsigned int Bk) {
  // l = ceil(log2 Bk), m = 2^32 (2^l - Bk) / Bk + 1
  int l = 0;
  while ((1ULL << l) < Bk) ++l;
  const unsigned int m = static_cast<unsigned int>(
      (((1ULL << 32) * ((1ULL << l) - static_cast<unsigned long long>(Bk))) /
       static_cast<unsigned long long>(Bk)) + 1);
  return Magic{m, l < 1 ? l : 1, l > 1 ? l - 1 : 0};
}

// A bucket's rows are its scenarios' Bk rows end to end.  The block index of
// a block's first row r0: r0 - Bk * (r0 / Bk), the quotient by the bucket's
// magic number (no division on the card).  Bucket: a descriptor with the
// fields Bk, magic, shift1 and shift2.
template <class Bucket>
__device__ __forceinline__ unsigned int first_block_index(const Bucket& bk, unsigned int r0) {
  const unsigned int t = __umulhi(r0, bk.magic);
  return r0 - bk.Bk * ((t + ((r0 - t) >> bk.shift1)) >> bk.shift2);
}

// Block index of row `off` of a block whose first row has block index b0: one
// subtraction, or a 32-bit remainder where the bucket has fewer rows a
// scenario than a block.
__device__ __forceinline__ unsigned int block_of(unsigned int b0, unsigned int off,
                                                 unsigned int Bk, unsigned int span) {
  const unsigned int b = b0 + off;
  return b < Bk ? b : (Bk >= span ? b - Bk : b % Bk);
}

}  // namespace bsls
