// band_zmv / band_grmv: the two per-page contractions of the banded layout.
//
//   band_zmv :  Z[s, g, :] = X[s, g, :] @ band[g]      (S,C) @ (C,W) per page g
//   band_grmv:  G[s, g, :] = R[s, g, :] @ band[g]^T    (S,W) @ (W,C) per page g
//
// band is (Mp, C, W) fp32, contiguous; fp32 in, fp32 accumulation (plain FMA,
// no tensor-core pass).  Replace the TPU kernels band_zmv_pallas and
// band_grmv_pallas (bsls_tpu/ops/pallas/banded_kernels.py:63 and :86).
//
// Bound on this card: memory.  The band tensors are read once per product
// (hundreds of MB at 100k rows) against S * 2 operations per band element; at
// the S < 16 for which the layout is chosen that is at most 8 operations per
// byte, far below what the fp32 units need to keep up with device memory.  So
// the design streams band[g] exactly once with coalesced loads and keeps the
// small operand (X[., g, :] or R[., g, :]) in shared memory and the S partial
// sums in registers:
//
//  * band_zmv: a block owns one page and 128 neighbouring w columns, a thread
//    one column.  It walks c, reads band[g, c, w] (a warp reads 128
//    contiguous bytes) and feeds NS accumulators from X in shared memory (all
//    threads read the same address: a broadcast).  C is walked in tiles of
//    kCTile so that shared memory does not grow with C.
//  * band_grmv: a block owns one page and kRowsPerBlock rows c, a warp one
//    row at a time: its lanes stride over the W contiguous floats of
//    band[g, c, :], each with NS accumulators against R in shared memory
//    (conflict-free: neighbouring lanes, neighbouring words), and a butterfly
//    of shuffles sums the lanes.  W is walked in tiles of kWTile.
//
// The scenario axis is handled in chunks of NS <= 16 accumulators (template
// parameter, the smallest power of two that holds S); more than 16 scenarios
// re-read the band once per chunk (grid.z).  S = 1 runs the same loop as
// S > 1.  Every sum is taken in a fixed order: results repeat from run to run.
//
// X and R are addressed through (scenario, page) strides with a unit stride
// along the contracted axis, so the caller can pass a view: the segment of a
// PF-flat (S, n_pf) vector, or the sliding page windows of the front-padded
// residual (R[s, g, :] = rp[s, g*128 : g*128 + W]) without materialising them.
#include <cuda_runtime.h>

namespace bsls {

constexpr int kZmvThreads = 128;  // = w columns per block
constexpr int kCTile = 256;
constexpr int kGrmvThreads = 256;
constexpr int kGrmvWarps = kGrmvThreads / 32;
constexpr int kRowsPerBlock = 32;
constexpr int kWTile = 512;

template <int NS>
__global__ void __launch_bounds__(kZmvThreads)
band_zmv_kernel(const float* __restrict__ band, const float* __restrict__ x,
                float* __restrict__ z, int S, int Mp, int C, int W,
                long long x_stride_s, long long x_stride_g) {
  __shared__ float xs[NS * kCTile];
  const int g = blockIdx.x;
  const int w = blockIdx.y * kZmvThreads + threadIdx.x;
  const int s0 = blockIdx.z * NS;
  const bool live = w < W;
  const float* bp = band + static_cast<long long>(g) * C * W + (live ? w : 0);

  float acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kCTile) {
    const int ct = min(kCTile, C - c0);
    __syncthreads();  // the previous tile has been consumed
    for (int e = threadIdx.x; e < NS * ct; e += kZmvThreads) {
      const int s = e / ct, c = e - s * ct;
      xs[s * kCTile + c] = (s0 + s < S)
          ? x[(s0 + s) * x_stride_s + g * x_stride_g + c0 + c] : 0.0f;
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int c = 0; c < ct; ++c) {
        const float b = bp[static_cast<long long>(c0 + c) * W];
#pragma unroll
        for (int s = 0; s < NS; ++s) acc[s] = fmaf(xs[s * kCTile + c], b, acc[s]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
      if (s0 + s < S) z[(static_cast<long long>(s0 + s) * Mp + g) * W + w] = acc[s];
  }
}

template <int NS>
__global__ void __launch_bounds__(kGrmvThreads)
band_grmv_kernel(const float* __restrict__ band, const float* __restrict__ r,
                 float* __restrict__ out, int S, int Mp, int C, int W,
                 long long r_stride_s, long long r_stride_g) {
  __shared__ float rs[NS * kWTile];
  const int g = blockIdx.x;
  const int c_lo = blockIdx.y * kRowsPerBlock;
  const int c_hi = min(c_lo + kRowsPerBlock, C);
  const int s0 = blockIdx.z * NS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kRowsPerWarp = kRowsPerBlock / kGrmvWarps;

  // row c_lo + warp + kGrmvWarps * q is held in acc[q]
  float acc[kRowsPerWarp][NS];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q)
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[q][s] = 0.0f;

  for (int w0 = 0; w0 < W; w0 += kWTile) {
    const int wt = min(kWTile, W - w0);
    __syncthreads();
    for (int e = threadIdx.x; e < NS * wt; e += kGrmvThreads) {
      const int s = e / wt, w = e - s * wt;
      rs[s * kWTile + w] = (s0 + s < S)
          ? r[(s0 + s) * r_stride_s + g * r_stride_g + w0 + w] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int c = c_lo + warp + kGrmvWarps * q;
      if (c < c_hi) {
        const float* bp = band + (static_cast<long long>(g) * C + c) * W + w0;
#pragma unroll 4
        for (int w = lane; w < wt; w += 32) {
          const float b = bp[w];
#pragma unroll
          for (int s = 0; s < NS; ++s) acc[q][s] = fmaf(rs[s * kWTile + w], b, acc[q][s]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int c = c_lo + warp + kGrmvWarps * q;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float v = acc[q][s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && c < c_hi && s0 + s < S)
        out[(static_cast<long long>(s0 + s) * Mp + g) * C + c] = v;
    }
  }
}

inline int chunk_width(int S) {
  int ns = 1;
  while (ns < S && ns < 16) ns *= 2;
  return ns;
}

}  // namespace bsls

#define BSLS_DISPATCH_NS(ns, CALL) \
  switch (ns) {                    \
    case 1: CALL(1); break;        \
    case 2: CALL(2); break;        \
    case 4: CALL(4); break;        \
    case 8: CALL(8); break;        \
    default: CALL(16); break;      \
  }

// band: (Mp, C, W) contiguous; x: element (s, g, c) at x[s*x_stride_s +
// g*x_stride_g + c]; z: (S, Mp, W) contiguous.  Launches on `stream`, does not
// synchronise.  Returns the cudaError_t of the launch; -1 for a bad shape.
extern "C" int bsls_band_zmv(const void* band, const void* x, void* z, int S, int Mp,
                             int C, int W, long long x_stride_s, long long x_stride_g,
                             void* stream) {
  using namespace bsls;
  if (S < 1 || Mp < 1 || C < 1 || W < 1) return -1;
  const int ns = chunk_width(S);
  const dim3 grid(Mp, (W + kZmvThreads - 1) / kZmvThreads, (S + ns - 1) / ns);
  if (grid.y > 65535u || grid.z > 65535u) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BSLS_CALL(NS)                                                          \
  band_zmv_kernel<NS><<<grid, kZmvThreads, 0, st>>>(                           \
      static_cast<const float*>(band), static_cast<const float*>(x),           \
      static_cast<float*>(z), S, Mp, C, W, x_stride_s, x_stride_g)
  BSLS_DISPATCH_NS(ns, BSLS_CALL)
#undef BSLS_CALL
  return static_cast<int>(cudaGetLastError());
}

// band: (Mp, C, W) contiguous; r: element (s, g, w) at r[s*r_stride_s +
// g*r_stride_g + w]; out: (S, Mp, C) contiguous.
extern "C" int bsls_band_grmv(const void* band, const void* r, void* out, int S, int Mp,
                              int C, int W, long long r_stride_s, long long r_stride_g,
                              void* stream) {
  using namespace bsls;
  if (S < 1 || Mp < 1 || C < 1 || W < 1) return -1;
  const int ns = chunk_width(S);
  const dim3 grid(Mp, (C + kRowsPerBlock - 1) / kRowsPerBlock, (S + ns - 1) / ns);
  if (grid.y > 65535u || grid.z > 65535u) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BSLS_CALL(NS)                                                          \
  band_grmv_kernel<NS><<<grid, kGrmvThreads, 0, st>>>(                         \
      static_cast<const float*>(band), static_cast<const float*>(r),           \
      static_cast<float*>(out), S, Mp, C, W, r_stride_s, r_stride_g)
  BSLS_DISPATCH_NS(ns, BSLS_CALL)
#undef BSLS_CALL
  return static_cast<int>(cudaGetLastError());
}
