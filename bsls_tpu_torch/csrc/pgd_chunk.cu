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
// Bound on this card.  By the count of bytes and operations a step is two
// passes over A, a few hundredths of a microsecond for an A of a few MB.  What
// a step really costs is latency: it has global dependencies (g needs all of
// r, Ad all of d, t two global sums), and each one is a grid-wide barrier
// (1.1 us for 132 blocks) plus a trip through the L2 for the values that cross
// it.  So the design removes trips and barriers, not bytes:
//
//  * A stays where it is used.  Block k owns the contiguous rows
//    [m*k/nb, m*(k+1)/nb) in every phase; when they fit (chunk_plan below)
//    they are copied into shared memory once per launch and both passes of
//    every step read them there (the resident form).  Otherwise the same code
//    reads them from global memory, i.e. from the L2 (the streaming form).  One
//    pointer chosen at the start; no other difference.
//  * So does the block's state: r and Ad on its rows, x, g and d on its
//    columns live in shared memory (in scratch only when they do not fit).
//  * Two barriers a step instead of three, by carrying the gradient: after
//    Ad on its rows a block also forms hpart[k, :] = A_own^T Ad_own, and once
//    t is known the owner of a column updates g += t * sum_k hpart[k, :]
//    (g_new = A^T (r + t Ad)).  The pass A_own^T r and its barrier are needed
//    only once per launch, which starts from the exact r0 and A^T r0, so the
//    drift of the carried g is bounded by one chunk.
//  * Columns are owned too: block k owns the simplex blocks
//    [B*k/nb, B*(k+1)/nb) and with them a contiguous run of columns, whose x
//    and g never leave it.  The sum over the nb partial rows is taken by the
//    whole thread block (warp q adds the rows q, q+16, ..., lanes take
//    neighbouring columns, so all loads of a gather are in flight at once),
//    then one thread per column adds the 16 warp sums in a fixed order.
//  * The projection uses the whole warp for w <= 32: one element a lane, rank
//    and prefix sum by counting over w shuffles, the pivot by a warp vote,
//    and the same Newton correction as proj_device.cuh; wider blocks take the
//    one-lane routine of that header.
//  * 512 threads a block: the row sums and the column sums are spread over
//    threads (a thread per column, eight rows at a time), so that d crosses
//    from the L2 once per block and step.
//
// A step (`|` is a barrier):
//   B  project the own blocks from the own g -> d, share of g.d            |
//   C  Ad on the own rows, share of ||Ad||^2, hpart[k, :]                  |
//   D  t from the shares (every block, the same order, so the same t);
//      x += t d, g += t * gather(hpart) on the own columns; r += t Ad on the
//      own rows, share of ||r||^2 (a warp of block 0 sums the shares of the
//      step before into f[i - 1] meanwhile)
//
// The barrier is cooperative groups' grid.sync().  For measurements only the
// file also builds the kernel with clock64() sums per phase, lets the caller
// force the streaming form (bsls_pgd_chunk_variant), and has a kernel of
// nothing but barriers (bsls_grid_barriers).  Forms that were tried on the
// H100, found slower and removed (PERF.md has their times): the gradient
// recomputed from r every step with a third barrier, a barrier on one arrival
// counter, a barrier on per-block flags, and a copy of hpart per reader.
//
// Every reduction is a fixed tree or a fixed-order loop over a fixed
// ownership, no float atomics: the trace repeats bit for bit from run to run
// on the same card.  Values another block wrote are read with __ldcg (L2),
// never through the read-only path; what a block reads of its own writes is
// ordered by __syncthreads.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "proj_device.cuh"
#include "rows_common.cuh"

namespace cg = cooperative_groups;

namespace bsls {

constexpr int kChunkThreads = 512;
constexpr int kChunkWarps = kChunkThreads / 32;
constexpr int kRowGroup = 8;      // rows whose dot products a thread carries at once
constexpr int kGatherCols = 256;  // columns a gather sums at once
// Dynamic shared memory that the resident form may take: what a block may
// have on this architecture (232,448 bytes) less 42 KB for the static buffers
// of the kernel.  ops/chunkkernel.py::RESIDENT_MAX_BYTES states the same.
constexpr int kResidentMaxBytes = 232448 - 43008;
// The block's own vectors (2 * ceil(m/nb) + 3 * ceil(B/nb) * w floats) live in
// shared memory up to this many bytes, else in scratch (STATE_MAX_BYTES there).
constexpr int kStateMaxBytes = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Sum of `v` over the block in a fixed order; the result is valid in warp 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red may still be read from the previous use
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x < 32)
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

// The sums of two arrays of shares at once (their loads overlap), into a and b.
__device__ __forceinline__ void sum_shares2(const float* pa, const float* pb, int nb, int lane,
                                            float& a, float& b) {
  float va = 0.0f, vb = 0.0f;
#pragma unroll 4
  for (int k = lane; k < nb; k += 32) {
    va += __ldcg(pa + k);
    vb += __ldcg(pb + k);
  }
  a = warp_sum(va);
  b = warp_sum(vb);
}

// ---- the two passes over the own rows

// out[i - lo] = Aown[i - lo, :] . vec (- sub[i]) on the rows [lo, hi): a thread
// per column, kRowGroup rows at a time, a butterfly over the lanes and a fixed
// loop over the warps.  vec may have been written by other blocks.  Returns
// this thread's share of sum out[.]^2, non-zero in the first kRowGroup
// threads only (all of warp 0).  Ends with a __syncthreads where there are rows.
__device__ __forceinline__ float rows_dot(const float* Aown, const float* vec,
                                          const float* __restrict__ sub, float* out, int lo,
                                          int hi, int n, float (*stage)[kRowGroup]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float sq = 0.0f;
  for (int i0 = lo; i0 < hi; i0 += kRowGroup) {
    const int rows = min(kRowGroup, hi - i0);
    const float* a = Aown + static_cast<long long>(i0 - lo) * n;
    float acc[kRowGroup];
#pragma unroll
    for (int q = 0; q < kRowGroup; ++q) acc[q] = 0.0f;
    for (int j = threadIdx.x; j < n; j += kChunkThreads) {
      const float vj = __ldcg(vec + j);
#pragma unroll
      for (int q = 0; q < kRowGroup; ++q)
        if (q < rows) acc[q] = fmaf(a[static_cast<long long>(q) * n + j], vj, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < kRowGroup; ++q) {
      const float v = warp_sum(acc[q]);
      if (lane == 0) stage[warp][q] = v;
    }
    __syncthreads();
    if (threadIdx.x < rows) {
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < kChunkWarps; ++q) v += stage[q][threadIdx.x];
      if (sub != nullptr) v -= sub[i0 + threadIdx.x];
      out[i0 - lo + threadIdx.x] = v;
      sq = fmaf(v, v, sq);
    }
    __syncthreads();
  }
  return sq;
}

// part[j] = sum over the own rows of Aown[i, j] * vec[i], all columns j; vec
// is the block's own (r or Ad on its rows), indexed from its first row.
__device__ __forceinline__ void cols_dot(const float* Aown, const float* vec, float* part,
                                         int rows, int n) {
  for (int j = threadIdx.x; j < n; j += kChunkThreads) {
    float acc = 0.0f;
#pragma unroll 4
    for (int i = 0; i < rows; ++i)
      acc = fmaf(Aown[static_cast<long long>(i) * n + j], vec[i], acc);
    part[j] = acc;
  }
}

// apply(c - c0, sum over the nb rows of part[., c]) for the own columns [c0, c1).
// Always passes at least two __syncthreads, the first before any apply.
template <class F>
__device__ __forceinline__ void gather_own(const float* part, int nb, int n, int c0, int c1,
                                           float (*wsum)[kGatherCols], F apply) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int cb = c0;
  do {
    const int cn = min(kGatherCols, c1 - cb);
    for (int c = lane; c < cn; c += 32) {
      float acc = 0.0f;
#pragma unroll 4
      for (int kk = warp; kk < nb; kk += kChunkWarps)
        acc += __ldcg(part + static_cast<long long>(kk) * n + cb + c);
      wsum[warp][c] = acc;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < cn; c += kChunkThreads) {
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < kChunkWarps; ++q) v += wsum[q][c];
      apply(cb - c0 + c, v);
    }
    __syncthreads();
    cb += kGatherCols;
  } while (cb < c1);
}

// ---- the projection of one block of width w <= 32 by a whole warp

// Lane j holds v_j (valid for j < nv); returns the lane's entry of the
// projection onto {x >= 0, sum x = rad}, 0 for j >= nv.  The sorted order is
// never formed: lane i counts the entries that come before it in the
// descending order (ties by index), which is its 1-based rank k_i, and adds
// them up, which is the prefix sum at that rank.  Pivot, threshold and the
// Newton correction are those of proj_simplex_row.
__device__ __forceinline__ float proj_simplex_warp(float v, int nv, int w, float rad,
                                                   int lane) {
  if (nv <= 0) return 0.0f;
  const bool valid = lane < nv;
  int rank = 0;
  float css = 0.0f;
  for (int j = 0; j < w; ++j) {
    const float vj = __shfl_sync(kFull, v, j);
    if (j < nv && (vj > v || (vj == v && j <= lane))) {
      css += vj;
      rank += 1;
    }
  }
  const bool cond = valid && v * static_cast<float>(rank) > css - rad;
  int rho = __reduce_max_sync(kFull, cond ? rank : 0);
  unsigned who = __ballot_sync(kFull, cond && rank == rho);
  if (who == 0u) {  // no pivot passed: the largest entry alone, as the row routine
    rho = 1;
    who = __ballot_sync(kFull, valid && rank == 1);
  }
  const float css_rho = __shfl_sync(kFull, css, __ffs(who) - 1);
  float tau = (css_rho - rad) / static_cast<float>(rho);
  const float o = valid ? fmaxf(v - tau, 0.0f) : 0.0f;
  const float ssum = warp_sum(o);
  const float nsup = warp_sum(o > 0.0f ? 1.0f : 0.0f);
  tau += (ssum - rad) / fmaxf(nsup, 1.0f);
  return valid ? fmaxf(v - tau, 0.0f) : 0.0f;
}

// ---- the kernel

// clock64() sums of thread 0 of block 0, by what the time was spent on
enum ClockSlot {
  kClkBarrier = 0, kClkGradient, kClkProject, kClkRows, kClkCols, kClkShares, kClkGather,
  kClkUpdate, kClkSlots
};

template <bool CLOCKS>
__global__ void __launch_bounds__(kChunkThreads, 1)
pgd_chunk_kernel(const float* __restrict__ A, const float* __restrict__ b,
                 const float* __restrict__ x0, const int* __restrict__ widths,
                 const float* __restrict__ radius, float t0, int m, int B, int w, int steps,
                 int resident, int local_state, float* x, float* f, float* scratch,
                 long long* clocks) {
  cg::grid_group grid = cg::this_grid();
  const int nb = gridDim.x, k = blockIdx.x;
  const int n = B * w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = static_cast<int>(static_cast<long long>(m) * k / nb);
  const int hi = static_cast<int>(static_cast<long long>(m) * (k + 1) / nb);
  const int b0 = static_cast<int>(static_cast<long long>(B) * k / nb);
  const int b1 = static_cast<int>(static_cast<long long>(B) * (k + 1) / nb);
  const int c0 = b0 * w, c1 = b1 * w;

  // scratch (chunk_plan below has the sizes): what crosses blocks, then
  // (global form only) what a block keeps of its own
  float* part = scratch;                              // (nb, n): gpart, then hpart
  float* d = part + static_cast<long long>(nb) * n;   // (n,)
  float* shares = d + n;                              // (5, nb)
  float* own = shares + 5 * nb;                       // n + 2 * m, see below
  // the five kinds of share: g.d and ||r||^2 by the step's parity, ||Ad||^2
  enum { kGd = 0, kF = 2, kAd = 4 };

  extern __shared__ __align__(16) float dyn_shared[];
  __shared__ float red[kChunkWarps];
  __shared__ float t_shared;
  __shared__ float stage[kChunkWarps][kRowGroup];
  __shared__ float wsum[kChunkWarps][kGatherCols];
  __shared__ float gs[kChunkWarps][kMaxWidth];  // w > 32: gradient of the block in hand
  __shared__ float vs[kChunkWarps][kMaxWidth];  //         candidate, then its projection
  __shared__ float us[kChunkWarps][kMaxWidth];  //         sort scratch

  long long clk[kClkSlots] = {0, 0, 0, 0, 0, 0, 0, 0};
  long long clk_prev = 0;
  const bool timing = CLOCKS && k == 0 && threadIdx.x == 0;
  if (timing) clk_prev = clock64();
#define BSLS_TICK(slot)                 \
  if (timing) {                         \
    const long long now = clock64();    \
    clk[slot] += now - clk_prev;        \
    clk_prev = now;                     \
  }

  // What the block owns, indexed from its first row or column: r and Ad on
  // its rows; x, g and its own copy of d on its columns.  In shared memory
  // when it fits (chunk_plan below), else in scratch.
  const int rows_max = (m + nb - 1) / nb, cols_max = (B + nb - 1) / nb * w;
  float *ro, *Ado, *xo, *go, *dn;
  float* a_shared = dyn_shared;
  if (local_state) {
    ro = dyn_shared;
    Ado = ro + rows_max;
    xo = Ado + rows_max;
    go = xo + cols_max;
    dn = go + cols_max;
    a_shared = dn + cols_max;
  } else {
    ro = own + lo;
    Ado = own + m + lo;
    go = own + 2 * m + c0;
    xo = x + c0;
    dn = d + c0;
  }
  auto shares_of = [&](int slot) -> const float* { return shares + slot * nb; };
  // warp 0 hands the block's share of kind `slot` to the others
  auto give_share = [&](int slot, float v) {
    if (lane == 0) shares[slot * nb + k] = v;
  };
  // the own rows of A: in shared memory for the whole launch, or where they are
  const float* Aown = A + static_cast<long long>(lo) * n;
  if (resident) {
    const long long count = static_cast<long long>(hi - lo) * n;
    for (long long e = threadIdx.x; e < count; e += kChunkThreads) a_shared[e] = Aown[e];
    Aown = a_shared;
  }
  for (int c = threadIdx.x; c < c1 - c0; c += kChunkThreads) xo[c] = x0[c0 + c];
  __syncthreads();
  rows_dot(Aown, x0, b, ro, lo, hi, n, stage);

  // f[i] from the shares of step i, by a warp of block 0
  auto emit_f = [&](int i) {
    const float s = sum_shares(shares_of(kF + (i & 1)), nb, lane);
    if (lane == 0) f[i] = 0.5f * s;
  };

  // ---- once: the partial gradient over the own rows, and its sum on the own
  // columns; from here on g is carried
  cols_dot(Aown, ro, part + static_cast<long long>(k) * n, hi - lo, n);
  BSLS_TICK(kClkGradient)
  grid.sync();
  BSLS_TICK(kClkBarrier)
  gather_own(part, nb, n, c0, c1, wsum, [&](int c, float v) { go[c] = v; });
  BSLS_TICK(kClkGradient)

  for (int step = 0; step < steps; ++step) {
    // ---- B: projection and direction on the own simplex blocks
    float gd = 0.0f;
    for (int bi = b0 + warp; bi < b1; bi += kChunkWarps) {
      const int col0 = bi * w - c0;
      const int nv = min(widths[bi], w);
      const float rad = radius[bi];
      if (w <= 32) {
        const bool in = lane < w;
        const float xj = in ? xo[col0 + lane] : 0.0f;
        const float gj = in ? go[col0 + lane] : 0.0f;
        const float pj = proj_simplex_warp(fmaf(-t0, gj, xj), nv, w, rad, lane);
        const float dj = pj - xj;
        if (in) {
          dn[col0 + lane] = dj;
          gd = fmaf(gj, dj, gd);
        }
      } else {
        for (int j = lane; j < w; j += 32) {
          gs[warp][j] = go[col0 + j];
          vs[warp][j] = fmaf(-t0, go[col0 + j], xo[col0 + j]);
        }
        __syncwarp();
        if (lane == 0) {
          proj_simplex_row(vs[warp], nv, w, rad, us[warp], vs[warp]);
          for (int j = 0; j < w; ++j) {
            const float dj = vs[warp][j] - xo[col0 + j];
            dn[col0 + j] = dj;
            gd = fmaf(gs[warp][j], dj, gd);
          }
        }
        __syncwarp();
      }
    }
    gd = block_sum(gd, red);  // its __syncthreads also put dn in place
    if (warp == 0) give_share(kGd + (step & 1), gd);
    // d of the own columns to where the others read it
    if (local_state)
      for (int c = threadIdx.x; c < c1 - c0; c += kChunkThreads) d[c0 + c] = dn[c];
    BSLS_TICK(kClkProject)
    grid.sync();
    BSLS_TICK(kClkBarrier)

    // ---- C: Ad on the own rows (and what it adds to the gradient)
    float sq = rows_dot(Aown, d, nullptr, Ado, lo, hi, n, stage);
    if (warp == 0) give_share(kAd, warp_sum(sq));
    BSLS_TICK(kClkRows)
    cols_dot(Aown, Ado, part + static_cast<long long>(k) * n, hi - lo, n);
    BSLS_TICK(kClkCols)
    grid.sync();
    BSLS_TICK(kClkBarrier)

    // ---- D: the step length (the same in every block), then x, g and r
    if (warp == 0) {
      float g_dot_d, den;
      sum_shares2(shares_of(kGd + (step & 1)), shares_of(kAd), nb, lane, g_dot_d, den);
      if (lane == 0) t_shared = fminf(fmaxf(-g_dot_d / fmaxf(den, 1e-30f), 0.0f), 1.0f);
    } else if (warp == 1 && k == 0 && step > 0) {
      emit_f(step - 1);
    }
    BSLS_TICK(kClkShares)
    gather_own(part, nb, n, c0, c1, wsum,
               [&](int c, float v) { go[c] = fmaf(t_shared, v, go[c]); });
    BSLS_TICK(kClkGather)
    const float t = t_shared;
    for (int c = threadIdx.x; c < c1 - c0; c += kChunkThreads) xo[c] = fmaf(t, dn[c], xo[c]);
    float rr = 0.0f;
    for (int i = threadIdx.x; i < hi - lo; i += kChunkThreads) {
      const float rn = fmaf(t, Ado[i], ro[i]);
      ro[i] = rn;
      rr = fmaf(rn, rn, rr);
    }
    // the two __syncthreads in here also put x, g and r of this block in
    // place before the next step reads them
    rr = block_sum(rr, red);
    if (warp == 0) give_share(kF + (step & 1), rr);
    BSLS_TICK(kClkUpdate)
  }
  if (local_state)
    for (int c = threadIdx.x; c < c1 - c0; c += kChunkThreads) x[c0 + c] = xo[c];
  grid.sync();
  if (k == 0 && warp == 0 && steps > 0) emit_f(steps - 1);
  if (timing)
    for (int i = 0; i < kClkSlots; ++i) clocks[i] = clk[i];
#undef BSLS_TICK
}

// Nothing but `count` barriers, at the grid and block size of the chunk kernel.
__global__ void __launch_bounds__(kChunkThreads, 1) barrier_only_kernel(int count) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < count; ++i) grid.sync();
}

// ---- the plan: blocks, where the state and A live, shared memory, scratch.
// ops/chunkkernel.py::chunk_plan states the same rules; keep the two alike.

struct ChunkPlan {
  bool local_state;  // r, Ad, x, g, d of the block in shared memory
  bool resident;     // and its rows of A
  int smem;          // dynamic shared memory of the launch, bytes
};

inline ChunkPlan chunk_plan(int m, int B, int w, int blocks) {
  const long long rows = (m + blocks - 1) / blocks;
  const long long cols = static_cast<long long>((B + blocks - 1) / blocks) * w;
  const long long state = (2 * rows + 3 * cols) * 4;
  const long long a_rows = rows * B * w * 4;
  ChunkPlan p;
  p.local_state = state <= kStateMaxBytes;
  const long long base = p.local_state ? state : 0;
  p.resident = base + a_rows <= kResidentMaxBytes;
  p.smem = static_cast<int>(base + (p.resident ? a_rows : 0));
  return p;
}

using ChunkKernel = void (*)(const float*, const float*, const float*, const int*, const float*,
                             float, int, int, int, int, int, int, float*, float*, float*,
                             long long*);

static ChunkKernel chunk_kernel(bool clocks) {
  return clocks ? pgd_chunk_kernel<true> : pgd_chunk_kernel<false>;
}

// Blocks of the cooperative launch: one per SM.  0 if the device cannot
// launch the kernel cooperatively with `smem` bytes of dynamic shared memory.
static int chunk_blocks(int smem) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!coop || sms < 1) return 0;
  const ChunkKernel fn = chunk_kernel(false);
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kChunkThreads, smem) !=
          cudaSuccess || per_sm < 1)
    return 0;
  return sms;
}

// form: -1 what the plan says; 1 asks for the resident form (-2 if it does
// not fit), 0 for the streaming one.
static int launch_chunk(const void* A, const void* b, const void* x0, const void* widths,
                        const void* radius, float t0, int m, int B, int w, int steps, void* x,
                        void* f, void* scratch, int blocks, int form, void* clocks,
                        void* stream) {
  if (m < 1 || B < 1 || w < 1 || w > kMaxWidth || steps < 1 || steps > (1 << 22) || blocks < 1)
    return -1;
  ChunkPlan plan = chunk_plan(m, B, w, blocks);
  if (form >= 0) {
    if (form == 1 && !plan.resident) return -2;
    if (form == 0 && plan.resident) {
      plan.smem -= static_cast<int>(static_cast<long long>((m + blocks - 1) / blocks) * B * w * 4);
      plan.resident = false;
    }
  }
  const ChunkKernel fn = chunk_kernel(clocks != nullptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int res = plan.resident ? 1 : 0, loc = plan.local_state ? 1 : 0;
  void* args[] = {&A, &b, &x0, &widths, &radius, &t0, &m, &B, &w, &steps, &res, &loc, &x, &f,
                  &scratch, &clocks};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fn), dim3(blocks), dim3(kChunkThreads), args, plan.smem, st));
}

}  // namespace bsls

// Number of blocks bsls_pgd_chunk launches for an (m, B*w) problem on the
// current device (0: the device cannot launch it), so that the caller can
// size `scratch`.  Today one per SM whatever the shape; the shape decides
// what they hold in shared memory.
extern "C" int bsls_pgd_chunk_blocks(int m, int B, int w) {
  using namespace bsls;
  int dev = 0, sms = 0;
  if (m < 1 || B < 1 || w < 1 || cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms < 1) return 0;
  return chunk_blocks(chunk_plan(m, B, w, sms).smem);
}

// A: (m, B*w) row-major; b: (m,); x0, x: (B, w); widths: (B,) int32; radius:
// (B,); f: (steps,); scratch: blocks * (B*w + 5) + 2 * B*w + 2 * m
// floats, where blocks is what bsls_pgd_chunk_blocks(m, B, w) returned and is
// passed back in.  x0 and x must not overlap.  Takes the resident form when
// chunk_plan says it fits, else the streaming form; the gradient carried, two
// grid.sync() a step.  Launches on `stream`, does not synchronise.  Returns
// the cudaError_t of the launch (720: more blocks than can be resident
// together); -1 for a bad shape.
extern "C" int bsls_pgd_chunk(const void* A, const void* b, const void* x0,
                              const void* widths, const void* radius, float t0, int m,
                              int B, int w, int steps, void* x, void* f, void* scratch,
                              int blocks, void* stream) {
  return bsls::launch_chunk(A, b, x0, widths, radius, t0, m, B, w, steps, x, f, scratch,
                            blocks, -1, nullptr, stream);
}

// For measurements only (the solver never calls it): the same chunk with the
// form chosen by the caller.  resident: 1 the resident form (-2 where it does
// not fit), 0 the streaming form.  `clocks`, if not null, receives eight
// clock64() sums of thread 0 of block 0: barriers, the gradient from r
// (partials and gather, once a launch), projection, A d, A^T (A d), the shares
// and t, the gather of the carried gradient, the update.
extern "C" int bsls_pgd_chunk_variant(const void* A, const void* b, const void* x0,
                                      const void* widths, const void* radius, float t0, int m,
                                      int B, int w, int steps, void* x, void* f, void* scratch,
                                      int blocks, int resident, void* clocks, void* stream) {
  return bsls::launch_chunk(A, b, x0, widths, radius, t0, m, B, w, steps, x, f, scratch,
                            blocks, resident ? 1 : 0, clocks, stream);
}

// For measurements only: `count` grid.sync() and nothing else, with `blocks`
// blocks of the chunk kernel's size.
extern "C" int bsls_grid_barriers(int count, int blocks, void* stream) {
  using namespace bsls;
  if (count < 0 || blocks < 1) return -1;
  void* args[] = {&count};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(barrier_only_kernel), dim3(blocks), dim3(kChunkThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}
