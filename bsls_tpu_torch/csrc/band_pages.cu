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
// both kernels stream band[g] exactly once and keep the small operand
// (X[., g, :] or R[., g, :]) in shared memory and the S partial sums in
// registers; what differs is how the stream is kept full.
//
//  * band_zmv: a block owns one page and 128 neighbouring w columns, a thread
//    one column.  It walks c, reads band[g, c, w] (a warp reads 128
//    contiguous bytes) and feeds NS accumulators from X in shared memory (all
//    threads read the same address: a broadcast).  C is walked in tiles of
//    kCTile so that shared memory does not grow with C.
//
//  * band_grmv contracts along the contiguous axis, so a band row is one run
//    of W floats and rows c_lo..c_hi of a page are one run of rows * W * 4
//    bytes.  Two kernels compute it, the launcher picks one from the
//    pointers, the strides and the shape, and reports which:
//
//    - ring (path 1): persistent.  One block per SM walks a contiguous share
//      of the Mp * C band rows (shares differ by one row at most, so there is
//      no tail wave and no partly filled row block) as tiles of up to 32 rows
//      of one page.  A ring of 2-4 tile stages in dynamic shared memory is
//      filled by one producer thread with 1-D bulk asynchronous copies
//      (cp.async.bulk, no tensor map), one copy per tile, reported to the
//      stage's `full` mbarrier by byte count; the R windows of a page come the
//      same way into a ring of two slots of their own, once per page, because
//      every bulk copy costs the block about a quarter of a microsecond
//      whatever its size.  Eight consumer warps read tile and window from
//      shared memory as float4, hold up to 4 rows x NS sums in registers, and
//      give stage and slot back through their `empty` mbarriers.  The copies
//      of the next stages are in flight while a stage is consumed: 128 KB per
//      SM at W = 512 against the ~25 KB that the memory's latency asks for
//      (more stages were no faster).
//    - scalar (path 0): one block per (page, 32 rows), 4-byte loads.  It
//      takes any W and any base address: W no multiple of 4, an operand that
//      is not 16-byte aligned, or a W so large that two stages of 8 rows do
//      not fit the ring.
//
//    In both a row's sum is: each lane adds its elements in ascending w,
//    then a butterfly of shuffles adds the lanes.  Which block, stage or warp
//    handled the row does not enter: results repeat from run to run.
//
// The scenario axis is handled in chunks of NS <= 16 accumulators (template
// parameter, the smallest power of two that holds S); more than 16 scenarios
// re-read the band once per chunk (grid.z, grid.y in the persistent kernel).
// S = 1 runs the same loop as S > 1.
//
// X and R are addressed through (scenario, page) strides with a unit stride
// along the contracted axis, so the caller can pass a view: the segment of a
// PF-flat (S, n_pf) vector, or the sliding page windows of the front-padded
// residual (R[s, g, :] = rp[s, g*128 : g*128 + W]) without materialising them.
#include <cuda_runtime.h>

#include <cstdint>

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

// ---------------------------------------------------------------- band_grmv

// path 0: any W, any alignment
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

// ---- the persistent kernel (path 1): W % 4 == 0, 16-byte aligned

constexpr int kMaxTileRows = 32;                           // rows of a (page, tile) item
constexpr int kMaxRowsPerWarp = kMaxTileRows / kGrmvWarps; // 4
constexpr int kMaxStages = 4;
constexpr int kRingThreads = kGrmvThreads + 32;  // consumers + the producer's warp
constexpr int kWindowSlots = 2;                  // R windows (pages) the ring holds
constexpr int kRingBarrierBytes = 128;           // 2 * (kMaxStages + kWindowSlots) * 8, rounded up
constexpr int kRingBudget = 200 * 1024;                    // bytes of the ring
constexpr int kRingInFlight = 96 * 1024;  // bytes of tiles wanted in flight; more was no faster

// The static work list.  The Mp * C band rows are one sequence; block b owns
// the rows [rows*b/nb, rows*(b+1)/nb), so the shares differ by at most one row,
// and walks them in order as tiles: up to tile_rows rows that lie in one page
// and in the share.  The divisions are made once per block, the walk only
// counts.
struct Item {
  int g, c_lo, rows;  // page, first row and number of rows of the tile
  long long left;     // rows left in the block's share, this tile included
};

__device__ __forceinline__ int tile_size(const Item& it, int C, int tile_rows) {
  const long long most = min(static_cast<long long>(min(tile_rows, C - it.c_lo)), it.left);
  return static_cast<int>(most);
}

__device__ __forceinline__ Item first_item(int Mp, int C, int tile_rows) {
  const long long total = static_cast<long long>(Mp) * C;
  const long long first = total * blockIdx.x / gridDim.x;
  Item it;
  it.g = static_cast<int>(first / C);
  it.c_lo = static_cast<int>(first % C);
  it.left = total * (blockIdx.x + 1) / gridDim.x - first;
  it.rows = tile_size(it, C, tile_rows);
  return it;
}

__device__ __forceinline__ void next_item(Item& it, int C, int tile_rows) {
  it.left -= it.rows;
  it.c_lo += it.rows;
  if (it.c_lo == C) {
    it.c_lo = 0;
    ++it.g;
  }
  it.rows = tile_size(it, C, tile_rows);
}

// The rows of one tile against the R window, both in shared memory as float4:
// warp `warp` takes local rows warp, warp + 8, ...; writes out[s, g, c_lo + row].
template <int NS>
__device__ __forceinline__ void grmv_tile(const float4* tile4,
                                          const float4* r4, float* __restrict__ out,
                                          int nrows, int W4, int S, int s0, int Mp, int C,
                                          int g, int c_lo, int warp, int lane) {
  float acc[kMaxRowsPerWarp][NS];
#pragma unroll
  for (int q = 0; q < kMaxRowsPerWarp; ++q)
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[q][s] = 0.0f;

#pragma unroll 2
  for (int j = lane; j < W4; j += 32) {
    float4 b[kMaxRowsPerWarp];
#pragma unroll
    for (int q = 0; q < kMaxRowsPerWarp; ++q) {
      const int row = warp + kGrmvWarps * q;
      b[q] = row < nrows ? tile4[static_cast<long long>(row) * W4 + j]
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float4 rv = r4[s * W4 + j];
#pragma unroll
      for (int q = 0; q < kMaxRowsPerWarp; ++q) {
        acc[q][s] = fmaf(rv.x, b[q].x, acc[q][s]);
        acc[q][s] = fmaf(rv.y, b[q].y, acc[q][s]);
        acc[q][s] = fmaf(rv.z, b[q].z, acc[q][s]);
        acc[q][s] = fmaf(rv.w, b[q].w, acc[q][s]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kMaxRowsPerWarp; ++q) {
    const int row = warp + kGrmvWarps * q;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float v = acc[q][s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && row < nrows && s0 + s < S)
        out[(static_cast<long long>(s0 + s) * Mp + g) * C + c_lo + row] = v;
    }
  }
}

// ---- mbarrier and bulk-copy primitives (PTX)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase differs from `parity`.  A barrier that never
// completes is a fault of this file; a build with -DBSLS_DEBUG_HANG traps
// after 2^31 clocks (about a second) instead of hanging the device.  The
// guard is off otherwise: the clock runs on while the context is switched
// out, so a slow but correct run on a shared card would trap too.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
#ifdef BSLS_DEBUG_HANG
  long long start = 0;
#endif
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
#ifdef BSLS_DEBUG_HANG
    if (!done) {
      if (start == 0) start = clock64();
      if (clock64() - start > (1LL << 31)) __trap();
    }
#endif
  }
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// path 1: the ring.  Dynamic shared memory: `stages` tile stages of
// tile_rows * W floats, then kWindowSlots R windows of NS * W floats, then the
// barriers.  A bulk copy costs the block about a quarter of a microsecond
// whatever its size, so there is one per tile and one per scenario and page
// (not per tile): the windows have a small ring of their own, refilled when the
// walk enters a new page and released when it has left it.
template <int NS>
__global__ void __launch_bounds__(kRingThreads, 1)
band_grmv_ring_kernel(const float* __restrict__ band, const float* __restrict__ r,
                      float* __restrict__ out, int S, int Mp, int C, int W, int tile_rows,
                      int stages, long long r_stride_s, long long r_stride_g) {
  extern __shared__ __align__(128) unsigned char grmv_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int W4 = W / 4;
  const int s0 = blockIdx.y * NS;
  const int ns_live = min(NS, S - s0);
  const long long stage_floats = static_cast<long long>(tile_rows) * W;
  const long long window_floats = static_cast<long long>(NS) * W;
  float* ring = reinterpret_cast<float*>(grmv_smem);
  float* windows = ring + stages * stage_floats;
  uint64_t* bars = reinterpret_cast<uint64_t*>(windows + kWindowSlots * window_floats);
  uint64_t* full = bars;                      // [kMaxStages]  a tile has arrived
  uint64_t* empty = full + kMaxStages;        // [kMaxStages]  the consumers are done with it
  uint64_t* wfull = empty + kMaxStages;       // [kWindowSlots]  a page's windows have arrived
  uint64_t* wempty = wfull + kWindowSlots;    // [kWindowSlots]  the consumers have left the page

  if (threadIdx.x == 0) {
    for (int i = 0; i < kMaxStages; ++i) {
      mbar_init(smem_addr(full + i), 1);
      mbar_init(smem_addr(empty + i), kGrmvWarps);
    }
    for (int i = 0; i < kWindowSlots; ++i) {
      mbar_init(smem_addr(wfull + i), 1);
      mbar_init(smem_addr(wempty + i), kGrmvWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kGrmvWarps) {
    // ---- producer: one thread keeps both rings full
    if (lane == 0) {
      int stage = 0, slot = 0, g_held = -1;
      uint32_t parity = 1, wparity = 1;  // the first pass finds every stage and slot empty
      const uint32_t row_bytes = static_cast<uint32_t>(W) * 4u;
      for (Item it = first_item(Mp, C, tile_rows); it.left > 0; next_item(it, C, tile_rows)) {
        if (it.g != g_held) {
          const uint32_t wf = smem_addr(wfull + slot);
          mbar_wait(smem_addr(wempty + slot), wparity);
          mbar_expect_tx(wf, static_cast<uint32_t>(ns_live) * row_bytes);
          for (int s = 0; s < ns_live; ++s)
            bulk_copy(smem_addr(windows + slot * window_floats + static_cast<long long>(s) * W),
                      r + (s0 + s) * r_stride_s + it.g * r_stride_g, row_bytes, wf);
          g_held = it.g;
          if (++slot == kWindowSlots) {
            slot = 0;
            wparity ^= 1u;
          }
        }
        const uint32_t tile_bytes = static_cast<uint32_t>(it.rows) * row_bytes;
        const uint32_t tf = smem_addr(full + stage);
        mbar_wait(smem_addr(empty + stage), parity);
        mbar_expect_tx(tf, tile_bytes);
        bulk_copy(smem_addr(ring + stage * stage_floats),
                  band + (static_cast<long long>(it.g) * C + it.c_lo) * W, tile_bytes, tf);
        if (++stage == stages) {
          stage = 0;
          parity ^= 1u;
        }
      }
    }
    return;
  }

  // ---- consumers
  int stage = 0, slot = 0, g_held = -1;
  uint32_t parity = 0, wparity = 0;
  for (Item it = first_item(Mp, C, tile_rows); it.left > 0; next_item(it, C, tile_rows)) {
    if (it.g != g_held) {
      if (g_held >= 0) {  // the page that was in hand is done: give its slot back
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_addr(wempty + slot));
        if (++slot == kWindowSlots) {
          slot = 0;
          wparity ^= 1u;
        }
      }
      mbar_wait(smem_addr(wfull + slot), wparity);
      g_held = it.g;
    }
    mbar_wait(smem_addr(full + stage), parity);
    grmv_tile<NS>(reinterpret_cast<const float4*>(ring + stage * stage_floats),
                         reinterpret_cast<const float4*>(windows + slot * window_floats), out,
                         it.rows, W4, S, s0, Mp, C, it.g, it.c_lo, warp, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(empty + stage));
    if (++stage == stages) {
      stage = 0;
      parity ^= 1u;
    }
  }
}

inline int chunk_width(int S) {
  int ns = 1;
  while (ns < S && ns < 16) ns *= 2;
  return ns;
}

// How band_grmv runs a shape: which kernel, and the ring's geometry.  The
// same rule is stated in ops/pagekernels.py::grmv_path (which the CPU tests
// hold against the cases of chip_smoke.py); keep the two alike.
struct GrmvPlan {
  int path;       // 0 scalar, 1 ring
  int tile_rows;  // of the ring
  int stages;     // of the ring
  int smem;       // dynamic shared memory of the launch
};

inline GrmvPlan grmv_plan(const void* band, const void* r, int S, int Mp, int W,
                          long long r_stride_s, long long r_stride_g) {
  GrmvPlan p = {0, kRowsPerBlock, 0, 0};
  const bool aligned = W % 4 == 0 && reinterpret_cast<uintptr_t>(band) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
                       (S == 1 || r_stride_s % 4 == 0) && (Mp == 1 || r_stride_g % 4 == 0);
  if (!aligned) return p;
  const int ns = chunk_width(S);
  const long long windows = static_cast<long long>(kWindowSlots) * ns * W * 4;
  for (int rows = kMaxTileRows; rows >= kGrmvWarps; rows /= 2) {
    const long long stage = static_cast<long long>(rows) * W * 4;
    if (windows + 2 * stage <= kRingBudget) {
      // enough stages for kRingInFlight bytes of tiles, at least two, and what fits
      const long long fit = (kRingBudget - windows) / stage;
      long long want = (kRingInFlight + stage - 1) / stage;
      want = want < 2 ? 2 : want > kMaxStages ? kMaxStages : want;
      p.path = 1;
      p.tile_rows = rows;
      p.stages = static_cast<int>(fit < want ? fit : want);
      p.smem = static_cast<int>(p.stages * stage + windows) + kRingBarrierBytes;
      return p;
    }
  }
  return p;  // W too large for a ring of two stages
}

static int g_grmv_last_path = -1;

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
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

namespace bsls {

// Launches path `path` (which the caller has found admissible).
static int launch_grmv(const GrmvPlan& plan, const float* band, const float* r, float* out,
                       int S, int Mp, int C, int W, long long r_stride_s,
                       long long r_stride_g, cudaStream_t st) {
  const int ns = chunk_width(S);
  const unsigned s_chunks = (S + ns - 1) / ns;
  if (s_chunks > 65535u) return -1;
  (void)cudaGetLastError();  // an error another library left behind is not this launch's
  if (plan.path == 0) {
    const dim3 grid(Mp, (C + kRowsPerBlock - 1) / kRowsPerBlock, s_chunks);
    if (grid.y > 65535u) return -1;
#define BSLS_CALL(NS)                                        \
  band_grmv_kernel<NS><<<grid, kGrmvThreads, 0, st>>>(       \
      band, r, out, S, Mp, C, W, r_stride_s, r_stride_g)
    BSLS_DISPATCH_NS(ns, BSLS_CALL)
#undef BSLS_CALL
    return static_cast<int>(cudaGetLastError());
  }
  const long long rows = static_cast<long long>(Mp) * C;
  cudaError_t err = cudaSuccess;
  const long long want = sm_count();
  const dim3 grid(static_cast<unsigned>(rows < want ? rows : want), s_chunks);
#define BSLS_CALL(NS)                                                                    \
  {                                                                                      \
    static int attr_set = 0;                                                             \
    if (attr_set < plan.smem) {                                                          \
      err = cudaFuncSetAttribute(band_grmv_ring_kernel<NS>,                              \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem); \
      if (err != cudaSuccess) return 1000 + static_cast<int>(err);                       \
      attr_set = plan.smem;                                                              \
    }                                                                                    \
    band_grmv_ring_kernel<NS><<<grid, kRingThreads, plan.smem, st>>>(                    \
        band, r, out, S, Mp, C, W, plan.tile_rows, plan.stages, r_stride_s, r_stride_g); \
  }
  BSLS_DISPATCH_NS(ns, BSLS_CALL)
#undef BSLS_CALL
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bsls

// band: (Mp, C, W) contiguous; r: element (s, g, w) at r[s*r_stride_s +
// g*r_stride_g + w]; out: (S, Mp, C) contiguous.  Picks its kernel from the
// pointers, the strides and the shape (grmv_plan above).
extern "C" int bsls_band_grmv(const void* band, const void* r, void* out, int S, int Mp,
                              int C, int W, long long r_stride_s, long long r_stride_g,
                              void* stream) {
  using namespace bsls;
  if (S < 1 || Mp < 1 || C < 1 || W < 1) return -1;
  const GrmvPlan plan = grmv_plan(band, r, S, Mp, W, r_stride_s, r_stride_g);
  g_grmv_last_path = plan.path;
  return launch_grmv(plan, static_cast<const float*>(band), static_cast<const float*>(r),
                     static_cast<float*>(out), S, Mp, C, W, r_stride_s, r_stride_g,
                     static_cast<cudaStream_t>(stream));
}

// The kernel the last bsls_band_grmv of this process took: 0 scalar, 1 ring;
// -1 before the first call.
extern "C" int bsls_band_grmv_last_path() { return bsls::g_grmv_last_path; }

// For measurements only (the solver never calls it): the same product through
// the kernel `path`, where the shape admits it (the scalar kernel takes every
// shape); -2 where it does not.
extern "C" int bsls_band_grmv_on_path(const void* band, const void* r, void* out, int S,
                                      int Mp, int C, int W, long long r_stride_s,
                                      long long r_stride_g, int path, void* stream) {
  using namespace bsls;
  if (S < 1 || Mp < 1 || C < 1 || W < 1) return -1;
  GrmvPlan plan = grmv_plan(band, r, S, Mp, W, r_stride_s, r_stride_g);
  if (path < 0 || path > plan.path) return -2;
  if (path == 0) plan = {0, kRowsPerBlock, 0, 0};
  return launch_grmv(plan, static_cast<const float*>(band), static_cast<const float*>(r),
                     static_cast<float*>(out), S, Mp, C, W, r_stride_s, r_stride_g,
                     static_cast<cudaStream_t>(stream));
}
