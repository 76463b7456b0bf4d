// pgd_step: the passes of one exact-line-search PGD step in x-space around
// its two products and its projection (solvers/pgd.py::step), as three
// kernels, every bucket of the step in one launch.
//
//   step_prep    cand = x - t0 g into the buckets the projection reads, the
//                flat copy of x (the state's x_prev), and each block's part
//                of the Frank-Wolfe gap: g.x and radius * min over the
//                block's valid slots of g (dummy rows: nothing).
//                t0 = 1 / L from L's float64 device buffer (or the fixed step).
//   step_dir     d = xhat - x into a flat (S, n) buffer, in the same pass its
//                (n, S) copy (the operand the ELL product gathers from, where
//                the operator has one), and each block's part of g.d.
//   step_update  two launches: "dots" sums each block's part of Ad.Ad (and
//                finishes the gap from step_prep's parts); "apply" forms
//                t = clamp(-g.d / max(Ad.Ad, 1e-30), 0, 1) per scenario,
//                writes x + t d and r + t Ad, each block's part of r.r, and
//                its last block finishes f = 0.5 r.r.
//
// Replaces no TPU kernel: the reference's step is XLA's fusion of the same
// elementwise passes (bsls_tpu/solvers/pgd.py::step).  Their plain PyTorch
// counterpart, ops/stepkernels.py's plain versions (the chain of
// padded_to_flat's cat, fw_gap's block_min / any / where, the candidate, the
// products' input transposes, xdot, rdot, exact_step's clamps and the
// in-place updates), is some 50 launches a step, each a full pass or a few
// microseconds of launch, and each a node that a graph replay walks.
//
// Bound on this card: bytes.  Every pass reads and writes each element
// once; the sums are a few flops an element.
//
// Sums.  Every cross-block sum is a fixed-order two-stage sum, with no
// float atomics, so that a step repeats itself bit for bit: a block's
// threads accumulate their elements in order (element e + 256 i of each
// tile, tiles in order), the block folds its 256 values in a fixed tree
// (block_sum), and a consumer folds the blocks' parts in a fixed order
// (block_sum over the parts, or lane groups in apply's last block).  Every
// product and sum is rounded on its own (__fmul_rn, __fadd_rn: no fused
// multiply-add), as the plain version's passes round them.
// ops/stepkernels.py states the plans (blocks a launch, tiles), and
// tests/test_torch_stepkernels.py restates the order of every sum.  The
// only atomic is an integer count of apply's finished blocks, which "dots"
// sets to 0.
//
// Work a block.  A launch has a fixed number of blocks per scenario (per
// group of scenarios in step_dir), at most kStepBlocks / S (and at most the
// scenario's tiles), each walking the tiles c, c + C, c + 2C, ... of its
// scenario, so that the parts a consumer folds stay few at any S.  A tile is
// kStepTile floats of one bucket (step_prep: whole rows; step_dir: TS
// scenarios by TP columns) or of r.
#include <cstdint>

#include <cuda_runtime.h>

namespace bsls {
namespace pgdstep {

constexpr int kStepThreads = 256;
constexpr int kStepWarps = kStepThreads / 32;
// floats a tile: step_prep's rows, step_dir's TS x TP, a tile of r or Ad
constexpr int kStepTile = 2048;
// blocks a launch aims at: the parts a scenario's sums are folded from
constexpr int kStepBlocks = 1024;
// buckets one launch takes (a step with more takes the plain chain)
constexpr int kStepMaxBuckets = 8;
// widest scenario group of step_dir's tiles
constexpr int kStepMaxGroup = 32;
constexpr unsigned int kFull = 0xffffffffu;
static_assert(kStepTile == 1 << 11, "step_dir splits a tile as 2^log_ts x 2^(11 - log_ts)");

// ---------------------------------------------------------------- sums

// lane 0 gets the sum of the warp's 32 values: v[l] += v[l + h], h = 16 .. 1
__device__ __forceinline__ float warp_fold(float v) {
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) v = __fadd_rn(v, __shfl_down_sync(kFull, v, h));
  return v;
}

// thread 0 gets the sum of the block's 256 values: each warp folds its own,
// then warp 0 folds the eight warps' sums (v[w] += v[w + h], h = 4, 2, 1).
// `red` is kStepWarps floats of shared memory.
__device__ float block_sum(float v, float* red) {
  v = warp_fold(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = 0.0f;
  if (warp == 0) {
    r = lane < kStepWarps ? red[lane] : 0.0f;
#pragma unroll
    for (int h = kStepWarps / 2; h >= 1; h >>= 1) r = __fadd_rn(r, __shfl_down_sync(kFull, r, h));
  }
  return r;
}

// thread 0 gets the sum of p[0 .. C): thread i sums p[i], p[i + 256], ... in
// order, then block_sum
__device__ float block_sum_of(const float* p, int C, float* red) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < C; i += kStepThreads) acc = __fadd_rn(acc, p[i]);
  return block_sum(acc, red);
}

// ---------------------------------------------------------------- step_prep

struct PrepBucket {
  const float* x;        // (S, Bk, w)
  float* cand;           // (S, Bk, w)
  const int* sizes;      // (Bk,)
  const float* radius;   // (Bk,)
  long long seg;         // Bk * w: floats a scenario
  long long off;         // the bucket's first column of the flat vector
  int Bk, w;
  int rows_tile;         // rows a tile: max(1, kStepTile / w)
  int first_tile;        // tiles of the buckets before it
};

template <int NB>
struct PrepLaunch {
  PrepBucket b[NB];
  const float* g;        // (S, n)
  float* xflat;          // (S, n)
  float* parts;          // (2, S, C): g.x, then radius * min
  const double* L;       // 0-d float64
  double step;           // > 0: the fixed step in place of 1 / L
  long long n;
  int S, C, T, nb;
};

template <int NB>
__global__ void __launch_bounds__(kStepThreads)
step_prep_kernel(const __grid_constant__ PrepLaunch<NB> P) {
  __shared__ float sg[kStepTile];
  __shared__ float red[kStepWarps];
  const int s = blockIdx.x / P.C, c = blockIdx.x % P.C;
  // as quadratic.inv_lipschitz makes it: 1 / L in float64, rounded once
  const float t0 = P.step > 0.0 ? static_cast<float>(P.step) : static_cast<float>(1.0 / *P.L);
  float gx = 0.0f, mins = 0.0f;
  for (int j = c; j < P.T; j += P.C) {
    int i = 0;
#pragma unroll
    for (int q = 1; q < NB; ++q) i += (q < P.nb && j >= P.b[q].first_tile);
    const PrepBucket& bk = P.b[i];
    const long long b0 = static_cast<long long>(j - bk.first_tile) * bk.rows_tile;
    const int rows = static_cast<int>(min(static_cast<long long>(bk.rows_tile), bk.Bk - b0));
    const int E = rows * bk.w;
    const long long xb = s * bk.seg + b0 * bk.w;
    const long long fb = s * P.n + bk.off + b0 * bk.w;
    for (int e = threadIdx.x; e < E; e += kStepThreads) {
      const float xv = bk.x[xb + e];
      const float gv = P.g[fb + e];
      bk.cand[xb + e] = __fsub_rn(xv, __fmul_rn(t0, gv));
      P.xflat[fb + e] = xv;
      gx = __fadd_rn(gx, __fmul_rn(gv, xv));
      sg[e] = gv;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += kStepThreads) {
      const long long b = b0 + r;
      const int nv = min(bk.sizes[b], bk.w);
      if (nv > 0) {
        const float* row = sg + r * bk.w;
        float mn = row[0];
        for (int q = 1; q < nv; ++q) mn = fminf(mn, row[q]);
        mins = __fadd_rn(mins, __fmul_rn(bk.radius[b], mn));
      }
    }
    __syncthreads();
  }
  gx = block_sum(gx, red);
  mins = block_sum(mins, red);
  if (threadIdx.x == 0) {
    P.parts[static_cast<long long>(s) * P.C + c] = gx;
    P.parts[static_cast<long long>(P.S + s) * P.C + c] = mins;
  }
}

// ---------------------------------------------------------------- step_dir

struct DirBucket {
  const float* xhat;     // (S, Bk, w)
  long long seg, off;
  int first_tile;        // column tiles of the buckets before it
};

template <int NB>
struct DirLaunch {
  DirBucket b[NB];
  const float* xflat;    // (S, n)
  const float* g;        // (S, n)
  float* dflat;          // (S, n)
  float* dt;             // (n, S) or null
  float* parts;          // (S, C): g.d
  long long n;
  int S, C, T, nb, log_ts, log_tp;
  int quads;             // dt takes 16-byte stores of four scenarios
};

// eight blocks an SM: the launch's ~kStepBlocks blocks in one wave
template <int NB>
__global__ void __launch_bounds__(kStepThreads, 8)
step_dir_kernel(const __grid_constant__ DirLaunch<NB> P) {
  // a tile of TS scenarios x TP columns, a row padded by one: the row-wise
  // writes and the transposed reads are free of most bank conflicts
  __shared__ float sd[kStepTile + kStepMaxGroup];
  __shared__ float sp[kStepTile + kStepMaxGroup];
  __shared__ float racc[kStepMaxGroup];
  const int TS = 1 << P.log_ts, TP = 1 << P.log_tp;
  const int sgrp = blockIdx.x / P.C, c = blockIdx.x % P.C;
  const int s0 = sgrp * TS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < kStepMaxGroup) racc[threadIdx.x] = 0.0f;
  for (int j = c; j < P.T; j += P.C) {
    int i = 0;
#pragma unroll
    for (int q = 1; q < NB; ++q) i += (q < P.nb && j >= P.b[q].first_tile);
    const DirBucket& bk = P.b[i];
    const long long q0 = static_cast<long long>(j - bk.first_tile) << P.log_tp;
    for (int e = threadIdx.x; e < (TS << P.log_tp); e += kStepThreads) {
      const int sl = e >> P.log_tp, pl = e & (TP - 1);
      const int s = s0 + sl;
      const long long q = q0 + pl;
      float d = 0.0f, p = 0.0f;
      if (s < P.S && q < bk.seg) {
        const long long fi = s * P.n + bk.off + q;
        d = __fsub_rn(bk.xhat[s * bk.seg + q], P.xflat[fi]);
        P.dflat[fi] = d;
        p = __fmul_rn(P.g[fi], d);
      }
      sd[sl * (TP + 1) + pl] = d;
      sp[sl * (TP + 1) + pl] = p;
    }
    __syncthreads();
    if (P.dt != nullptr && P.quads) {
      // (n, S): TS contiguous scenarios of each column, four to a 16-byte
      // store (S a multiple of 4: a quad lies wholly below S or above it)
      const int log_q = P.log_ts - 2;
      for (int e = threadIdx.x; e < (TS << P.log_tp) >> 2; e += kStepThreads) {
        const int pl = e >> log_q, sl = (e & ((1 << log_q) - 1)) << 2;
        const long long q = q0 + pl;
        if (s0 + sl < P.S && q < bk.seg) {
          const float* col = sd + sl * (TP + 1) + pl;
          *reinterpret_cast<float4*>(P.dt + (bk.off + q) * P.S + s0 + sl) =
              make_float4(col[0], col[TP + 1], col[2 * (TP + 1)], col[3 * (TP + 1)]);
        }
      }
    } else if (P.dt != nullptr) {
      for (int e = threadIdx.x; e < (TS << P.log_tp); e += kStepThreads) {
        const int pl = e >> P.log_ts, sl = e & (TS - 1);
        const int s = s0 + sl;
        const long long q = q0 + pl;
        if (s < P.S && q < bk.seg) P.dt[(bk.off + q) * P.S + s] = sd[sl * (TP + 1) + pl];
      }
    }
    // each scenario's part of g.d over the tile: a warp a row, lane l sums
    // columns l, l + 32, ... in order, then the warp folds
    for (int sl = warp; sl < TS; sl += kStepWarps) {
      float acc = 0.0f;
      for (int pl = lane; pl < TP; pl += 32) acc = __fadd_rn(acc, sp[sl * (TP + 1) + pl]);
      acc = warp_fold(acc);
      if (lane == 0) racc[sl] = __fadd_rn(racc[sl], acc);
    }
    __syncthreads();
  }
  if (threadIdx.x < TS && s0 + static_cast<int>(threadIdx.x) < P.S)
    P.parts[static_cast<long long>(s0 + threadIdx.x) * P.C + c] = racc[threadIdx.x];
}

// ---------------------------------------------------------------- step_update

struct DotsLaunch {
  const float* Ad;       // (S, m)
  float* aparts;         // (S, C): Ad.Ad
  const float* gparts;   // step_prep's (2, S, C1)
  float* gap;            // (S,)
  int* done;             // apply's count of finished blocks
  long long m;
  int S, C, T, C1;
};

__global__ void __launch_bounds__(kStepThreads) step_dots_kernel(const __grid_constant__ DotsLaunch P) {
  __shared__ float red[kStepWarps];
  const int s = blockIdx.x / P.C, c = blockIdx.x % P.C;
  float acc = 0.0f;
  for (int j = c; j < P.T; j += P.C) {
    const long long i0 = static_cast<long long>(j) * kStepTile;
    const int E = static_cast<int>(min(static_cast<long long>(kStepTile), P.m - i0));
    const float* a = P.Ad + s * P.m + i0;
    for (int e = threadIdx.x; e < E; e += kStepThreads) acc = __fadd_rn(acc, __fmul_rn(a[e], a[e]));
  }
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) P.aparts[static_cast<long long>(s) * P.C + c] = acc;
  if (c == 0) {
    // the gap: g.x - sum of radius * min, each from step_prep's parts
    const float gx = block_sum_of(P.gparts + static_cast<long long>(s) * P.C1, P.C1, red);
    const float mn = block_sum_of(P.gparts + static_cast<long long>(P.S + s) * P.C1, P.C1, red);
    if (threadIdx.x == 0) P.gap[s] = __fsub_rn(gx, mn);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *P.done = 0;
}

struct ApplyBucket {
  float* xnew;           // (S, Bk, w); may be the xhat buffer step_dir read
  long long seg, off;
  int first_tile;        // tiles of the buckets before it
};

template <int NB>
struct ApplyLaunch {
  ApplyBucket b[NB];
  const float* xflat;    // (S, n)
  const float* dflat;    // (S, n)
  const float* r;        // (S, m)
  const float* Ad;       // (S, m)
  float* rnew;           // (S, m); may be Ad's buffer
  const float* dparts;   // step_dir's (S, C2)
  const float* aparts;   // dots' (S, C3)
  float* rparts;         // (S, C): r.r of the new r
  float* f;              // (S,)
  int* done;
  long long n, m;
  int S, C, T, Tx, C2, C3, nb, G;
};

template <int NB>
__global__ void __launch_bounds__(kStepThreads)
step_apply_kernel(const __grid_constant__ ApplyLaunch<NB> P) {
  __shared__ float red[kStepWarps];
  __shared__ float tsh;
  __shared__ int last;
  const int s = blockIdx.x / P.C, c = blockIdx.x % P.C;
  // every block of the scenario folds the same parts in the same order
  const float gd = block_sum_of(P.dparts + static_cast<long long>(s) * P.C2, P.C2, red);
  const float den = block_sum_of(P.aparts + static_cast<long long>(s) * P.C3, P.C3, red);
  if (threadIdx.x == 0) {
    // quadratic.exact_step on [0, 1]: comparisons keep a NaN, as torch.clamp
    const float dd = den < 1e-30f ? 1e-30f : den;
    float t = -gd / dd;
    t = t < 0.0f ? 0.0f : (t > 1.0f ? 1.0f : t);
    tsh = t;
  }
  __syncthreads();
  const float t = tsh;
  float rr = 0.0f;
  for (int j = c; j < P.T; j += P.C) {
    if (j < P.Tx) {
      int i = 0;
#pragma unroll
      for (int q = 1; q < NB; ++q) i += (q < P.nb && j >= P.b[q].first_tile);
      const ApplyBucket& bk = P.b[i];
      const long long q0 = static_cast<long long>(j - bk.first_tile) * kStepTile;
      const int E = static_cast<int>(min(static_cast<long long>(kStepTile), bk.seg - q0));
      const long long fb = s * P.n + bk.off + q0;
      float* out = bk.xnew + s * bk.seg + q0;
      for (int e = threadIdx.x; e < E; e += kStepThreads)
        out[e] = __fadd_rn(__fmul_rn(P.dflat[fb + e], t), P.xflat[fb + e]);
    } else {
      const long long i0 = static_cast<long long>(j - P.Tx) * kStepTile;
      const int E = static_cast<int>(min(static_cast<long long>(kStepTile), P.m - i0));
      const long long base = s * P.m + i0;
      for (int e = threadIdx.x; e < E; e += kStepThreads) {
        const float rn = __fadd_rn(__fmul_rn(P.Ad[base + e], t), P.r[base + e]);
        P.rnew[base + e] = rn;
        rr = __fadd_rn(rr, __fmul_rn(rn, rn));
      }
    }
  }
  rr = block_sum(rr, red);
  if (threadIdx.x == 0) {
    P.rparts[static_cast<long long>(s) * P.C + c] = rr;
    __threadfence();
    last = atomicAdd(P.done, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block finishes f: G lanes a scenario, lane l of a group sums
  // parts l, l + G, ... in order, then the group folds (v[l] += v[l + h])
  const int per = kStepThreads / P.G, gi = threadIdx.x / P.G, gl = threadIdx.x % P.G;
  for (int base = 0; base < P.S; base += per) {
    const int s2 = base + gi;
    float acc = 0.0f;
    if (s2 < P.S)
      for (int i = gl; i < P.C; i += P.G)
        acc = __fadd_rn(acc, __ldcg(P.rparts + static_cast<long long>(s2) * P.C + i));
    for (int h = P.G / 2; h >= 1; h >>= 1) acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, h, P.G));
    if (gl == 0 && s2 < P.S) P.f[s2] = __fmul_rn(0.5f, acc);
  }
}

// ---------------------------------------------------------------- launchers

inline bool grid_ok(long long blocks) { return blocks >= 1 && blocks < (1LL << 31); }

template <int NB>
int launch_prep(const void* const* x, void* const* cand, const void* const* sizes,
                const void* const* radius, const int* Bk, const int* w, int nb, const void* g,
                void* xflat, void* parts, const void* L, double step, int S, long long n,
                int C, cudaStream_t stream) {
  PrepLaunch<NB> P{};
  long long off = 0, tiles = 0;
  for (int i = 0; i < nb; ++i) {
    if (Bk[i] < 1 || w[i] < 1 || w[i] > kStepTile) return -1;
    const int rows_tile = max(1, kStepTile / w[i]);
    P.b[i] = PrepBucket{static_cast<const float*>(x[i]), static_cast<float*>(cand[i]),
                        static_cast<const int*>(sizes[i]), static_cast<const float*>(radius[i]),
                        static_cast<long long>(Bk[i]) * w[i], off, Bk[i], w[i], rows_tile,
                        static_cast<int>(tiles)};
    off += static_cast<long long>(Bk[i]) * w[i];
    tiles += (Bk[i] + rows_tile - 1) / rows_tile;
  }
  if (off != n || tiles >= (1LL << 31) || C < 1 || C > tiles || !grid_ok(1LL * S * C)) return -1;
  P.g = static_cast<const float*>(g);
  P.xflat = static_cast<float*>(xflat);
  P.parts = static_cast<float*>(parts);
  P.L = static_cast<const double*>(L);
  P.step = step;
  P.n = n;
  P.S = S;
  P.C = C;
  P.T = static_cast<int>(tiles);
  P.nb = nb;
  step_prep_kernel<NB><<<static_cast<unsigned int>(S * C), kStepThreads, 0, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_dir(const void* const* xhat, const int* Bk, const int* w, int nb, const void* xflat,
               const void* g, void* dflat, void* dt, void* parts, int S, long long n, int C,
               int log_ts, cudaStream_t stream) {
  if (log_ts < 0 || (1 << log_ts) > kStepMaxGroup) return -1;
  const int log_tp = 11 - log_ts;  // TS * TP = kStepTile = 2^11
  DirLaunch<NB> P{};
  long long off = 0, tiles = 0;
  for (int i = 0; i < nb; ++i) {
    if (Bk[i] < 1 || w[i] < 1) return -1;
    const long long seg = static_cast<long long>(Bk[i]) * w[i];
    P.b[i] = DirBucket{static_cast<const float*>(xhat[i]), seg, off, static_cast<int>(tiles)};
    off += seg;
    tiles += (seg + (1LL << log_tp) - 1) >> log_tp;
  }
  const long long groups = (S + (1LL << log_ts) - 1) >> log_ts;
  if (off != n || tiles >= (1LL << 31) || C < 1 || C > tiles || !grid_ok(groups * C)) return -1;
  P.xflat = static_cast<const float*>(xflat);
  P.g = static_cast<const float*>(g);
  P.dflat = static_cast<float*>(dflat);
  P.dt = static_cast<float*>(dt);
  P.parts = static_cast<float*>(parts);
  P.n = n;
  P.S = S;
  P.C = C;
  P.T = static_cast<int>(tiles);
  P.nb = nb;
  P.log_ts = log_ts;
  P.log_tp = log_tp;
  P.quads = dt != nullptr && S % 4 == 0 && reinterpret_cast<std::uintptr_t>(dt) % 16 == 0;
  step_dir_kernel<NB><<<static_cast<unsigned int>(groups * C), kStepThreads, 0, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_apply(void* const* xnew, const int* Bk, const int* w, int nb, const void* xflat,
                 const void* dflat, const void* r, const void* Ad, void* rnew,
                 const void* dparts, const void* aparts, void* rparts, void* f, void* done,
                 int S, long long n, long long m, int C, int C2, int C3, int G,
                 cudaStream_t stream) {
  ApplyLaunch<NB> P{};
  long long off = 0, tiles = 0;
  for (int i = 0; i < nb; ++i) {
    if (Bk[i] < 1 || w[i] < 1) return -1;
    const long long seg = static_cast<long long>(Bk[i]) * w[i];
    P.b[i] = ApplyBucket{static_cast<float*>(xnew[i]), seg, off, static_cast<int>(tiles)};
    off += seg;
    tiles += (seg + kStepTile - 1) / kStepTile;
  }
  const long long all = tiles + (m + kStepTile - 1) / kStepTile;
  if (off != n || m < 1 || all >= (1LL << 31) || C < 1 || C > all || C2 < 1 || C3 < 1 ||
      G < 1 || G > 32 || (G & (G - 1)) != 0 || !grid_ok(1LL * S * C))
    return -1;
  P.xflat = static_cast<const float*>(xflat);
  P.dflat = static_cast<const float*>(dflat);
  P.r = static_cast<const float*>(r);
  P.Ad = static_cast<const float*>(Ad);
  P.rnew = static_cast<float*>(rnew);
  P.dparts = static_cast<const float*>(dparts);
  P.aparts = static_cast<const float*>(aparts);
  P.rparts = static_cast<float*>(rparts);
  P.f = static_cast<float*>(f);
  P.done = static_cast<int*>(done);
  P.n = n;
  P.m = m;
  P.S = S;
  P.C = C;
  P.T = static_cast<int>(all);
  P.Tx = static_cast<int>(tiles);
  P.C2 = C2;
  P.C3 = C3;
  P.nb = nb;
  P.G = G;
  step_apply_kernel<NB><<<static_cast<unsigned int>(S * C), kStepThreads, 0, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pgdstep
}  // namespace bsls

// The entry points.  Bucket i: (S, Bk[i], w[i]) fp32 contiguous tensors,
// sizes[i] (Bk[i],) int32, radius[i] (Bk[i],) fp32; the buckets lie one
// after another in the flat vector of n = sum Bk[i] w[i] columns; 1 <= nb <=
// 8.  Flat vectors (S, n), r and Ad (S, m), fp32 contiguous.  C: the blocks
// a scenario (a scenario group in step_dir), as ops/stepkernels.py plans
// them; parts are sized by it.  Each call is one launch on `stream`, no
// synchronisation; it returns the cudaError_t of the launch (0 = success),
// -1 for bad arguments.
#define BSLS_STEP_DISPATCH(fn, ...)                                         \
  using namespace bsls::pgdstep;                                            \
  if (nb < 1 || nb > kStepMaxBuckets || S < 1) return -1;                   \
  cudaStream_t st = static_cast<cudaStream_t>(stream);                      \
  if (nb == 1) return fn<1>(__VA_ARGS__, st);                               \
  if (nb == 2) return fn<2>(__VA_ARGS__, st);                               \
  if (nb <= 4) return fn<4>(__VA_ARGS__, st);                               \
  return fn<kStepMaxBuckets>(__VA_ARGS__, st)

// cand[i] = x[i] - t0 g, xflat = x, parts (2, S, C) of g.x and of the
// radius-scaled block minima; t0 = step if step > 0, else 1 / *L (L: a 0-d
// float64 device tensor).
extern "C" int bsls_step_prep(const void* const* x, void* const* cand, const void* const* sizes,
                              const void* const* radius, const int* Bk, const int* w, int nb,
                              const void* g, void* xflat, void* parts, const void* L,
                              double step, int S, long long n, int C, void* stream) {
  BSLS_STEP_DISPATCH(launch_prep, x, cand, sizes, radius, Bk, w, nb, g, xflat, parts, L, step, S,
                     n, C);
}

// dflat = xhat - xflat, dt (n, S) its transpose unless null, parts (S, C) of
// g.d; tiles of 2^log_ts scenarios.
extern "C" int bsls_step_dir(const void* const* xhat, const int* Bk, const int* w, int nb,
                             const void* xflat, const void* g, void* dflat, void* dt,
                             void* parts, int S, long long n, int C, int log_ts, void* stream) {
  BSLS_STEP_DISPATCH(launch_dir, xhat, Bk, w, nb, xflat, g, dflat, dt, parts, S, n, C, log_ts);
}

// aparts (S, C) of Ad.Ad; gap (S,) from step_prep's parts (2, S, C1); sets
// *done to 0 for step_apply.
extern "C" int bsls_step_dots(const void* Ad, void* aparts, const void* gparts, void* gap,
                              void* done, int S, long long m, int C, int C1, void* stream) {
  using namespace bsls::pgdstep;
  const long long tiles = (m + kStepTile - 1) / kStepTile;
  if (S < 1 || m < 1 || C < 1 || C > tiles || C1 < 1 || !grid_ok(1LL * S * C)) return -1;
  DotsLaunch P{static_cast<const float*>(Ad), static_cast<float*>(aparts),
               static_cast<const float*>(gparts), static_cast<float*>(gap),
               static_cast<int*>(done), m, S, C, static_cast<int>(tiles), C1};
  step_dots_kernel<<<static_cast<unsigned int>(S * C), kStepThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// t = clamp(-g.d / max(Ad.Ad, 1e-30), 0, 1) from step_dir's (S, C2) and
// dots' (S, C3) parts; xnew[i] = xflat + t dflat, rnew = r + t Ad, f (S,)
// = 0.5 r.r from the parts (S, C); G lanes a scenario in the last block.
extern "C" int bsls_step_apply(void* const* xnew, const int* Bk, const int* w, int nb,
                               const void* xflat, const void* dflat, const void* r,
                               const void* Ad, void* rnew, const void* dparts,
                               const void* aparts, void* rparts, void* f, void* done, int S,
                               long long n, long long m, int C, int C2, int C3, int G,
                               void* stream) {
  BSLS_STEP_DISPATCH(launch_apply, xnew, Bk, w, nb, xflat, dflat, r, Ad, rnew, dparts, aparts,
                     rparts, f, done, S, n, m, C, C2, C3, G);
}
