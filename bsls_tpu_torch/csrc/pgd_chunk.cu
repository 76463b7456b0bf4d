// pgd_chunk: `steps` whole projected-gradient iterations with the exact
// quadratic line search in ONE launch, for a single right-hand side, a dense
// A of (m, n = B*w) and one bucket of B blocks of padded width w:
//
//   r0 = A x0 - b
//   repeat `steps` times:
//     g    = A^T r
//     xhat = P(x - t0 g)            per block, onto {x >= 0, sum x = radius[b]}
//     d    = xhat - x
//     Ad   = A d
//     t    = clip(-(g.d) / max(||Ad||^2, 1e-30), 0, 1)
//     x   += t d ;  r += t Ad ;  f[i] = 0.5 ||r||^2
//
// Replaces the TPU kernel pgd_chunk_fused
// (bsls_tpu/ops/pallas/megastep_kernel.py:152, body _mega_kernel).
//
// Bound on this card: a step reads A twice (2 * 4 * m * n bytes) for
// 4 * m * n operations, so it is bound by bytes; A of a few MB stays in the
// 50 MB L2 from step to step and only the first read comes from device
// memory.  What the eager step pays instead is some forty launches per
// iteration; this kernel pays one launch per chunk and three grid-wide
// barriers per step.
//
// Design.  One cooperative launch of at most one block per SM; the phases of
// a step are separated by cooperative-groups grid.sync().  Work is owned, not
// scheduled: block k owns the contiguous rows [m*k/nb, m*(k+1)/nb) in every
// phase that touches r or Ad, and global warp q owns the simplex blocks
// q, q + nwarps, ... in every phase that touches x or d, so r and x never
// cross blocks and need no barrier of their own.
//
//   A  (rows)   : gpart[k, :] = sum over own rows of A[i, :] * r[i]
//   -- grid.sync --
//   B  (blocks) : g = sum_k gpart[k, :] on the own columns (lanes stride k,
//                 butterfly), projection by the exact sort-based threshold
//                 (proj_device.cuh, one lane), d, and the block's share of g.d
//   -- grid.sync --
//   C  (rows)   : Ad[i] = A[i, :] . d, a warp per row, and the share of ||Ad||^2
//   -- grid.sync --
//   D  (both)   : every block sums the nb shares in the same order, so all
//                 hold the same t; x += t d on own blocks, r += t Ad on own
//                 rows, share of ||r||^2 (summed into f[i] by block 0 after
//                 the next barrier)
//
// Every reduction is a fixed tree or a fixed-order loop, no float atomics: the
// trace repeats bit for bit from run to run on the same card.  Values another
// block wrote are read with __ldcg (L2), never through the read-only path.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "proj_device.cuh"
#include "rows_common.cuh"

namespace cg = cooperative_groups;

namespace bsls {

constexpr int kChunkThreads = 256;
constexpr int kChunkWarps = kChunkThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of `v` over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red may still be read from the previous use
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0)
    for (int q = 0; q < kChunkWarps; ++q) total += red[q];
  return total;
}

// Sum of the nb per-block shares at `part`, the same value in every lane of
// the calling warp.
__device__ __forceinline__ float sum_shares(const float* part, int nb, int lane) {
  float v = 0.0f;
  for (int k = lane; k < nb; k += 32) v += __ldcg(part + k);
  return warp_sum(v);
}

// out[i] = A[i, :] . vec (- sub[i]) on the rows [lo, hi), a warp per row.
// Returns this thread's share of sum out[i]^2 (non-zero in lane 0 only).
__device__ __forceinline__ float rows_dot(const float* __restrict__ A, const float* vec,
                                          const float* sub, float* out, int lo, int hi,
                                          int n, int warp, int lane) {
  float sq = 0.0f;
  for (int i = lo + warp; i < hi; i += kChunkWarps) {
    const float* a = A + static_cast<long long>(i) * n;
    float acc = 0.0f;
#pragma unroll 4
    for (int j = lane; j < n; j += 32) acc = fmaf(a[j], __ldcg(vec + j), acc);
    acc = warp_sum(acc);
    if (sub != nullptr) acc -= sub[i];
    if (lane == 0) {
      out[i] = acc;
      sq = fmaf(acc, acc, sq);
    }
  }
  return sq;
}

__global__ void __launch_bounds__(kChunkThreads)
pgd_chunk_kernel(const float* __restrict__ A, const float* __restrict__ b,
                 const float* __restrict__ x0, const int* __restrict__ widths,
                 const float* __restrict__ radius, float t0, int m, int B, int w,
                 int steps, float* x, float* f, float* scratch) {
  cg::grid_group grid = cg::this_grid();
  const int nb = gridDim.x, k = blockIdx.x;
  const int n = B * w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gwarp = k * kChunkWarps + warp, nwarps = nb * kChunkWarps;
  const int lo = static_cast<int>(static_cast<long long>(m) * k / nb);
  const int hi = static_cast<int>(static_cast<long long>(m) * (k + 1) / nb);

  float* gpart = scratch;                              // (nb, n)
  float* d = gpart + static_cast<long long>(nb) * n;   // (n,)
  float* r = d + n;                                    // (m,)
  float* Ad = r + m;                                   // (m,)
  float* gd_part = Ad + m;                             // (nb,)
  float* ad_part = gd_part + nb;                       // (nb,)
  float* f_part = ad_part + nb;                        // (nb,)

  __shared__ float red[kChunkWarps];
  __shared__ float t_shared;
  __shared__ float gs[kChunkWarps][kMaxWidth];  // gradient of the block in hand
  __shared__ float vs[kChunkWarps][kMaxWidth];  // candidate, then its projection
  __shared__ float us[kChunkWarps][kMaxWidth];  // sort scratch

  // x <- x0 on the own blocks; everyone needs all of x for r0
  for (int bi = gwarp; bi < B; bi += nwarps)
    for (int j = lane; j < w; j += 32) x[bi * w + j] = x0[bi * w + j];
  grid.sync();
  rows_dot(A, x, b, r, lo, hi, n, warp, lane);
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    // ---- A: partial gradient over the own rows
    for (int j = threadIdx.x; j < n; j += kChunkThreads) {
      float acc = 0.0f;
#pragma unroll 4
      for (int i = lo; i < hi; ++i) acc = fmaf(A[static_cast<long long>(i) * n + j], r[i], acc);
      gpart[static_cast<long long>(k) * n + j] = acc;
    }
    grid.sync();
    if (k == 0 && warp == 0 && step > 0) {
      const float s = sum_shares(f_part, nb, lane);
      if (lane == 0) f[step - 1] = 0.5f * s;
    }

    // ---- B: gradient, projection and direction on the own simplex blocks
    float gd = 0.0f;
    for (int bi = gwarp; bi < B; bi += nwarps) {
      const int col0 = bi * w;
      for (int j = 0; j < w; ++j) {
        float acc = 0.0f;
        for (int kk = lane; kk < nb; kk += 32)
          acc += __ldcg(gpart + static_cast<long long>(kk) * n + col0 + j);
        acc = warp_sum(acc);
        if (lane == 0) gs[warp][j] = acc;
      }
      if (lane == 0) {
        const int nv = min(widths[bi], w);
        for (int j = 0; j < w; ++j) vs[warp][j] = fmaf(-t0, gs[warp][j], x[col0 + j]);
        proj_simplex_row(vs[warp], nv, w, radius[bi], us[warp], vs[warp]);
        for (int j = 0; j < w; ++j) {
          const float dj = vs[warp][j] - x[col0 + j];
          d[col0 + j] = dj;
          gd = fmaf(gs[warp][j], dj, gd);
        }
      }
      __syncwarp();
    }
    gd = block_sum(gd, red);
    if (threadIdx.x == 0) gd_part[k] = gd;
    grid.sync();

    // ---- C: Ad on the own rows
    float sq = rows_dot(A, d, nullptr, Ad, lo, hi, n, warp, lane);
    sq = block_sum(sq, red);
    if (threadIdx.x == 0) ad_part[k] = sq;
    grid.sync();

    // ---- D: the step length (the same in every block), then x and r
    if (warp == 0) {
      const float g_dot_d = sum_shares(gd_part, nb, lane);
      const float den = sum_shares(ad_part, nb, lane);
      if (lane == 0) t_shared = fminf(fmaxf(-g_dot_d / fmaxf(den, 1e-30f), 0.0f), 1.0f);
    }
    __syncthreads();
    const float t = t_shared;
    for (int bi = gwarp; bi < B; bi += nwarps)
      for (int j = lane; j < w; j += 32) x[bi * w + j] = fmaf(t, __ldcg(d + bi * w + j), x[bi * w + j]);
    float rr = 0.0f;
    for (int i = lo + threadIdx.x; i < hi; i += kChunkThreads) {
      const float rn = fmaf(t, Ad[i], r[i]);
      r[i] = rn;
      rr = fmaf(rn, rn, rr);
    }
    rr = block_sum(rr, red);
    if (threadIdx.x == 0) f_part[k] = rr;
    __syncthreads();  // r and x of this block are complete before phase A reads them
  }
  grid.sync();
  if (k == 0 && warp == 0 && steps > 0) {
    const float s = sum_shares(f_part, nb, lane);
    if (lane == 0) f[steps - 1] = 0.5f * s;
  }
}

// Blocks of the cooperative launch: one per SM, fewer if fewer can be
// co-resident.  0 if the kernel cannot be launched cooperatively.
static int chunk_blocks() {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pgd_chunk_kernel, kChunkThreads, 0);
  if (!coop || per_sm < 1) return 0;
  return sms;
}

}  // namespace bsls

// Number of blocks bsls_pgd_chunk launches on the current device (0: the
// device cannot launch it), so that the caller can size `scratch`:
// blocks * (n + 3) + n + 2 * m floats.
extern "C" int bsls_pgd_chunk_blocks() { return bsls::chunk_blocks(); }

// A: (m, B*w) row-major; b: (m,); x0, x: (B, w); widths: (B,) int32; radius:
// (B,); f: (steps,); scratch: blocks * (B*w + 3) + B*w + 2*m floats, where
// blocks is what bsls_pgd_chunk_blocks() returned and is passed back in.  x0
// and x must not overlap.  Launches on `stream`, does not synchronise.
// Returns the cudaError_t of the launch; -1 for a bad shape.
extern "C" int bsls_pgd_chunk(const void* A, const void* b, const void* x0,
                              const void* widths, const void* radius, float t0, int m,
                              int B, int w, int steps, void* x, void* f, void* scratch,
                              int blocks, void* stream) {
  using namespace bsls;
  if (m < 1 || B < 1 || w < 1 || w > kMaxWidth || steps < 1 || blocks < 1) return -1;
  void* args[] = {&A, &b, &x0, &widths, &radius, &t0, &m, &B, &w, &steps, &x, &f, &scratch};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(pgd_chunk_kernel), dim3(blocks), dim3(kChunkThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}
