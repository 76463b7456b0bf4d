// ell_products: the two sparse products of the gather layout (ops/layout.py
// matvec and rmatvec on a DeviceEll), every width group of one product in one
// launch, the result written in the (S, rows) layout the solver keeps.
//
//   out[s, p] = sum_k vals_g[r, k] * vt[idx_g[r, k], s]       (S, rows_out) fp32
//
// Output row p reads sorted row q = rank[p] (q = p without a rank map).  A
// sorted row q < zeros is 0 (a column without nonzeros); any other lies in
// the group g whose first sorted row start_g is the last at or below q, as
// its row r = q - start_g.  vt is the (n, S) contiguous operand, so each
// index pulls S contiguous floats.  Groups: the row-nnz groups of A x
// (mv_cols/mv_vals, no rank map), the column-nnz groups of A^T r
// (rt_rows/rt_vals after rt_zeros zero columns, the rank map rt_inv folded
// in), or one group (the unbucketed (1, m, kr) row copy, the plain (n, k)
// column copy).
//
// Replaces no TPU kernel: the reference computes these products with XLA
// gathers (bsls_tpu/ops/layout.py:902, gather_dot).  Its plain PyTorch
// counterpart, ops/layout.py::_gather_dot_t and the chain around it (an
// (nnz, S) index_select buffer, a broadcast multiply, a sum over k, a cat of
// the groups, a transpose back to (S, rows)), moved about 1 GB a product at
// S = 128 on the medium instance.
//
// Bound on this card: bytes.  A's indices and values once, the operand once
// and the result once (4.9 MB of slots, padding included, 28 MB and 51 MB
// for A x at S = 128 on medium: 27 us at 3.35 TB/s).  The gathered rows,
// nnz x S x 4 bytes (225 MB there), come from L2 as long as the operand fits
// in its 50 MB, and L2's rate is what the kernel meets first (71 us there,
// PERF.md); two flops a gathered float are far below the fp32 rate.  What
// the design does about it:
//
// * Nothing of (rows, k, S) exists: each output row's sums stay in fp32
//   registers, one row's indices and values are read once per chunk of
//   scenarios, and each index loads the S contiguous floats of its operand
//   row as float4 lanes where S and the operand's address allow, so that a
//   warp's load of one index is whole 32-byte sectors.
// * The thread mapping follows S (ops/ellkernels.py::ell_plan states it):
//   F floats a lane (4, 2 or 1: the widest that divides S and the operand's
//   alignment), L lanes a row (the power of two that covers S / F, at most
//   32), 32 / L rows a warp; a grid row (blockIdx.y) per chunk of L * F
//   scenarios.  S = 128: a warp a row, 512 B a gathered row; S = 32: 8 lanes
//   a row, 4 rows a warp; S = 1: a lane a row.
// * The result goes straight into (S, rows_out): with one lane a row,
//   neighbouring lanes hold neighbouring rows and store coalesced; with more,
//   a block stages a tile of max(32, 256 / L) rows x one chunk in shared
//   memory (a row's vectors padded by one, so that both the row-wise writes
//   and the column-wise reads are free of bank conflicts) and stores it
//   along rows, 128 B or more a scenario.  No cat, no transpose.
// * Every group of a product in one launch: the descriptors travel by value
//   in a __grid_constant__ parameter (up to kEllMaxGroups; the wrapper
//   launches again beyond them, each launch computing its window [lo, hi) of
//   sorted rows).  The kernel is instantiated for 1, 2, 4 and 8 descriptors.
// * Enough blocks to fill 132 SMs: at m = 100k rows, S = 128, 3,125 blocks of
//   256 threads; at S = 1, 391.
//
// Indices are trusted: prepare() builds them in range, as the plain
// index_select's would be.
#include <cstdint>

#include <cuda_runtime.h>

namespace bsls {

constexpr int kEllThreads = 256;
constexpr int kEllWarps = kEllThreads / 32;
// Groups one launch takes (the wrapper launches again beyond them).
constexpr int kEllMaxGroups = 8;
constexpr int kEllMaxLanes = 32;
// The staging tile in vectors of F floats: tile rows x (L + 1) at its
// largest, L = 32 (32 rows x 33); L = 2, 4, 8, 16 take 384, 320, 288, 544.
constexpr int kEllTileVectors = 32 * (kEllMaxLanes + 1);

struct EllGroup {
  const int* idx;     // (rows, w) int32
  const float* vals;  // (rows, w) fp32
  long long start;    // sorted row of its first row
  int w;
};

template <int NB>
struct EllLaunch {
  EllGroup g[NB];
  const float* vt;    // (n, S) operand
  float* out;         // (S, rows_out) result
  const int* rank;    // (rows_out,) sorted row of each output row, or null
  long long rows_out;
  long long first, end;  // the output rows the grid covers
  long long lo, hi;      // the sorted rows this launch computes
  long long zeros;       // sorted rows below this are 0
  int nb, S, log_lanes, log_tile;
};

template <int F>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[F]) {
  if constexpr (F == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else if constexpr (F == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int F, int NB>
__global__ void __launch_bounds__(kEllThreads)
ell_gather_dot_kernel(const __grid_constant__ EllLaunch<NB> L) {
  __shared__ __align__(16) float tile[kEllTileVectors * F];
  const int lanes = 1 << L.log_lanes;
  const int tile_rows = 1 << L.log_tile;
  const int lane = threadIdx.x & 31;
  const int v = lane & (lanes - 1);            // the lane's vector of the chunk
  const int rows_warp = 32 >> L.log_lanes;
  const int stride = (lanes + 1) * F;          // a staged row, in floats
  const int c0 = blockIdx.y * lanes * F;       // the block's first scenario
  const int c = c0 + v * F;                    // the lane's first scenario
  const long long S = L.S;
  const long long p0 = L.first + static_cast<long long>(blockIdx.x) * tile_rows;

  for (int t = (threadIdx.x >> 5) * rows_warp + (lane >> L.log_lanes); t < tile_rows;
       t += kEllWarps * rows_warp) {
    const long long p = p0 + t;
    if (p >= L.end) break;
    const long long q = L.rank ? static_cast<long long>(__ldg(L.rank + p)) : p;
    if (q < L.lo || q >= L.hi || c >= L.S) continue;
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
    if (q >= L.zeros) {
      // the row's group: the last whose first sorted row it has passed
      int i = 0;
#pragma unroll
      for (int j = 1; j < NB; ++j) i += (j < L.nb && q >= L.g[j].start);
      const EllGroup& g = L.g[i];
      const long long at = (q - g.start) * g.w;
      const int* __restrict__ ip = g.idx + at;
      const float* __restrict__ vp = g.vals + at;
      const float* xs = L.vt + c;
#pragma unroll 4
      for (int k = 0; k < g.w; ++k) {
        const long long j = __ldg(ip + k);
        const float a = __ldg(vp + k);
        float x[F];
        load_vec<F>(xs + j * S, x);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = fmaf(a, x[f], acc[f]);
      }
    }
    if (lanes == 1) {
#pragma unroll
      for (int f = 0; f < F; ++f) L.out[(c + f) * L.rows_out + p] = acc[f];
    } else {
      float* dst = tile + t * stride + v * F;
      if constexpr (F == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else if constexpr (F == 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
      } else {
        dst[0] = acc[0];
      }
    }
  }
  if (lanes == 1) return;
  __syncthreads();
  // the tile along rows: consecutive threads take consecutive rows of one
  // vector, so each scenario's tile_rows floats go out as one run
  for (int e = threadIdx.x; e < (tile_rows << L.log_lanes); e += kEllThreads) {
    const int t = e & (tile_rows - 1);
    const int vq = e >> L.log_tile;
    const long long p = p0 + t;
    const int cq = c0 + vq * F;
    if (p >= L.end || cq >= L.S) continue;
    if (L.rank) {
      const long long q = __ldg(L.rank + p);
      if (q < L.lo || q >= L.hi) continue;
    }
    const float* src = tile + t * stride + vq * F;
    float x[F];
    if constexpr (F == 4) {
      const float4 u = *reinterpret_cast<const float4*>(src);
      x[0] = u.x;
      x[1] = u.y;
      x[2] = u.z;
      x[3] = u.w;
    } else if constexpr (F == 2) {
      const float2 u = *reinterpret_cast<const float2*>(src);
      x[0] = u.x;
      x[1] = u.y;
    } else {
      x[0] = src[0];
    }
#pragma unroll
    for (int f = 0; f < F; ++f) L.out[(cq + f) * L.rows_out + p] = x[f];
  }
}

// The thread mapping of S scenarios over an operand at address `addr`
// (ops/ellkernels.py::ell_plan states the same rule): F floats a lane, the
// widest of 4, 2, 1 that divides S and the address's alignment; 2^log_lanes
// lanes a row, the power of two that covers S / F, at most kEllMaxLanes; a
// tile of max(32, kEllThreads / lanes) rows.
inline void ell_form(int S, std::uintptr_t addr, int& F, int& log_lanes, int& log_tile) {
  F = (S % 4 == 0 && addr % 16 == 0) ? 4 : (S % 2 == 0 && addr % 8 == 0) ? 2 : 1;
  const int vecs = (S + F - 1) / F;
  log_lanes = 0;
  while ((1 << log_lanes) < vecs && (1 << log_lanes) < kEllMaxLanes) ++log_lanes;
  log_tile = 5;
  while ((1 << log_tile) < (kEllThreads >> log_lanes)) ++log_tile;
}

template <int NB>
int launch_groups(const void* const* idx, const void* const* vals, const long long* start,
                  const int* w, int nb, const void* vt, int S, void* out,
                  long long rows_out, const void* rank, long long lo, long long hi,
                  long long zeros, cudaStream_t stream) {
  if (S < 1 || rows_out < 1 || rows_out >= (1LL << 31) || lo < 0 || hi <= lo ||
      hi > rows_out || zeros < 0 || nb < 0 || nb > NB)
    return -1;
  EllLaunch<NB> L{};
  for (int i = 0; i < nb; ++i) {
    if (w[i] < 1 || start[i] < zeros || start[i] < lo || start[i] >= hi) return -1;
    L.g[i] = EllGroup{static_cast<const int*>(idx[i]), static_cast<const float*>(vals[i]),
                      start[i], w[i]};
  }
  const std::uintptr_t addr = reinterpret_cast<std::uintptr_t>(vt);
  int F = 1, log_lanes = 0, log_tile = 5;
  ell_form(S, addr, F, log_lanes, log_tile);
  L.vt = static_cast<const float*>(vt);
  L.out = static_cast<float*>(out);
  L.rank = static_cast<const int*>(rank);
  L.rows_out = rows_out;
  L.first = rank ? 0 : lo;
  L.end = rank ? rows_out : hi;
  L.lo = lo;
  L.hi = hi;
  L.zeros = zeros;
  L.nb = nb;
  L.S = S;
  L.log_lanes = log_lanes;
  L.log_tile = log_tile;
  const long long tiles = (L.end - L.first + (1LL << log_tile) - 1) >> log_tile;
  const long long chunks = (S + (static_cast<long long>(F) << log_lanes) - 1) /
                           (static_cast<long long>(F) << log_lanes);
  if (tiles >= (1LL << 31) || chunks > 65535) return -1;
  const dim3 grid(static_cast<unsigned int>(tiles), static_cast<unsigned int>(chunks));
  if (F == 4) {
    ell_gather_dot_kernel<4, NB><<<grid, kEllThreads, 0, stream>>>(L);
  } else if (F == 2) {
    ell_gather_dot_kernel<2, NB><<<grid, kEllThreads, 0, stream>>>(L);
  } else {
    ell_gather_dot_kernel<1, NB><<<grid, kEllThreads, 0, stream>>>(L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bsls

// Group i: idx[i], vals[i] (rows_i, w[i]) int32 / fp32 row-major, its first
// sorted row start[i]; 0 <= nb <= 8, starts ascending.  vt: the (n, S) fp32
// operand, contiguous.  out: (S, rows_out) fp32, contiguous.  rank: null, or
// (rows_out,) int32, the sorted row of each output row.  This launch
// computes the sorted rows [lo, hi) (those below `zeros` as 0) and writes
// the output rows that hold them.  One launch on `stream`, no
// synchronisation.  Returns the cudaError_t of the launch (0 = success); -1
// for bad arguments.
extern "C" int bsls_ell_gather_dot(const void* const* idx, const void* const* vals,
                                   const long long* start, const int* w, int nb,
                                   const void* vt, int S, void* out, long long rows_out,
                                   const void* rank, long long lo, long long hi,
                                   long long zeros, void* stream) {
  using namespace bsls;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nb <= 1)
    return launch_groups<1>(idx, vals, start, w, nb, vt, S, out, rows_out, rank, lo, hi,
                            zeros, st);
  if (nb == 2)
    return launch_groups<2>(idx, vals, start, w, nb, vt, S, out, rows_out, rank, lo, hi,
                            zeros, st);
  if (nb <= 4)
    return launch_groups<4>(idx, vals, start, w, nb, vt, S, out, rows_out, rank, lo, hi,
                            zeros, st);
  return launch_groups<kEllMaxGroups>(idx, vals, start, w, nb, vt, S, out, rows_out, rank,
                                      lo, hi, zeros, st);
}
