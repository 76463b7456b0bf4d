// proj_simplex_rows: batched Euclidean projection onto radius-scaled simplices,
// every bucket of one projection in one launch.
//
//   out[r, :n] = argmin_x ||x - v[r, :n]||  s.t.  x >= 0, sum x = radius[b]
//   out[r, n:] = 0,   n = widths[b],  r = s * Bk + b   (n = 0: the row is 0)
//
// for each bucket (S, Bk, w) of the projection.  Replaces the TPU kernels
// proj_simplex_pallas_tw and proj_simplex_pallas
// (bsls_tpu/ops/pallas/projection_kernel.py:132 and :187, the same function
// in two layouts; cores _proj_tile_kernel_t and _proj_tile_kernel).
//
// Bound on this card: bytes.  Each row is read once and written once,
// 2 * 4 * w bytes a row plus 8 * Bk bytes of parameters.  The thread forms'
// arithmetic (a sorting network, a scan) stays under the fp32 rate that the
// memory rate feeds; the group forms' (w^2 compare-and-adds a row) binds from
// w of about 32 on.
//
// Threshold.  Both forms find exactly the threshold tau of arXiv:1101.6081,
// then apply one Newton correction of tau on the support it selects, which
// takes the cancellation error of the sums out of the row sum, as the TPU
// kernel does after its bisection.
// * Thread forms (w <= 16, one thread a row): the row is sorted descending by
//   Batcher's odd-even merge network, pruned to w slots; then
//   rho = max{k : u_k * k > cumsum_k - r}, tau = (cumsum_rho - r) / rho.
// * Group forms (w > 16, a row on G lanes): sort-free.  With u the row's
//   first n values and r its radius,
//       tau = max_{i < n} (sum_{j < n, u_j >= u_i} u_j - r) / #{j < n : u_j >= u_i},
//   the same threshold, ties included: each i names the top set that ends
//   with u_i's whole tie group, every such set gives a lower bound on tau,
//   and the support of the projection is one of them.  The pairwise sums
//   take the row's values lane by lane through __shfl_sync broadcasts; tau is
//   a max-reduction over the group of (numerator, count) pairs compared by
//   cross-multiplication in a total order, so every lane picks the same pair.
//
// What held the first form of this kernel (PR 1) back, and what this one does
// about each:
//
// * Widths other than 1, 2, 4, 8, 16 and 32 ran a generic form: one thread a
//   row, the row and its sorted copy in local memory, an insertion sort
//   (13% of the bound at w = 12).  Here every width 1..128 has a compile-time
//   form (BSLS_PROJ_FORMS below, ops/rowkernels.py::PROJ_PLAN), and nothing is
//   indexed at run time, so nothing leaves the registers (chip_smoke.py
//   --ptxas checks it).  Up to w = 16 a thread holds its row, read with 16- or
//   8-byte loads where the bucket is aligned; past w = 8 it reads the row a
//   second time (an L1 hit) after the threshold rather than hold the row
//   beside its sorted copy.  Wider rows take a group of G = 8, 16 or 32 lanes
//   with K = 3 or 4 values a lane, slot l + k * G on lane l, so that
//   neighbouring lanes read neighbouring addresses whatever the row stride;
//   slots past the width are masked at run time.
// * Every thread found its block by a 64-bit remainder, row % Bk.  Here a
//   block covers consecutive rows of one bucket; the block index of its first
//   row comes from a multiply by the bucket's magic number, and a thread's
//   from one subtraction (a 32-bit remainder only in a bucket with fewer rows
//   a scenario than a block).
// * Each bucket was one launch.  Here one launch covers every bucket (up to
//   kMaxBuckets; the wrapper launches again beyond them).  The descriptors of
//   the buckets travel by value as a __grid_constant__ kernel parameter, so
//   nothing is copied to the card for a call; a block finds its bucket from
//   the descriptors' first blocks and switches on that bucket's form.  The
//   kernel is instantiated for 1, 2, 4 and 8 descriptors, since the size of
//   the parameter block is paid at every launch.
//
// The price of one kernel for every form: its register count is its largest
// form's, so the narrowest rows, which have the fewest bytes in flight a
// thread, run at lower occupancy than a kernel of their own would give them
// (PERF.md, PR 10).
#include <cstdint>

#include "rows_common.cuh"

namespace bsls {

constexpr unsigned int kFull = 0xffffffffu;
// Thread forms up to this width keep the row's first read in registers
// beside its sorted copy; wider ones read the row again after the threshold.
constexpr int kKeepRow = 8;

// width range -> (lanes a row G, values a lane K): X(lo, hi, G, K).
// ops/rowkernels.py::PROJ_PLAN states the same table.
#define BSLS_PROJ_FORMS(X)                                                      \
  X(1, 1, 1, 1) X(2, 2, 1, 2) X(3, 3, 1, 3) X(4, 4, 1, 4) X(5, 5, 1, 5)       \
  X(6, 6, 1, 6) X(7, 7, 1, 7) X(8, 8, 1, 8) X(9, 9, 1, 9) X(10, 10, 1, 10)    \
  X(11, 11, 1, 11) X(12, 12, 1, 12) X(13, 13, 1, 13) X(14, 14, 1, 14)         \
  X(15, 15, 1, 15) X(16, 16, 1, 16) X(17, 24, 8, 3) X(25, 32, 8, 4)           \
  X(33, 48, 16, 3) X(49, 64, 16, 4) X(65, 96, 32, 3) X(97, 128, 32, 4)

struct ProjBucket {
  const float* v;
  float* out;
  const int* widths;
  const float* radius;
  unsigned int rows;       // S * Bk, the rows of the (S, Bk, w) bucket
  unsigned int Bk;
  unsigned int magic;      // r / Bk = (t + ((r - t) >> shift1)) >> shift2,
  int shift1, shift2;      //   t = umulhi(r, magic) (round-up method)
  int w;
  int form;                // G * 256 + K of the width's entry in BSLS_PROJ_FORMS
  int vec;                 // v and out 16-byte aligned
  unsigned int first_block;
};

// NB descriptors: the kernel is instantiated for 1, 2, 4 and kMaxBuckets,
// and a projection takes the smallest that holds its buckets, since the size
// of the parameter block is paid at every launch (PERF.md, PR 10).
template <int NB>
struct ProjLaunch {
  ProjBucket b[NB];
  int nb;
};

// Sort u descending with Batcher's odd-even merge network for the next power
// of two, pruned to the first K slots: every comparator sends the larger
// value to the lower slot, so slots past K (as if -inf) never move and their
// comparators are dropped.  Every index is a compile-time constant.
template <int K>
__device__ __forceinline__ void sort_desc(float (&u)[K]) {
  constexpr int P = K <= 1 ? 1 : K <= 2 ? 2 : K <= 4 ? 4 : K <= 8 ? 8 : 16;
#pragma unroll
  for (int p = 1; p < P; p *= 2) {
#pragma unroll
    for (int k = p; k >= 1; k /= 2) {
      // comparators (lo, lo + k) with lo = j + i, j = k % p + 2k * m, i < k,
      // both in one run of 2p; a constant trip count, so that it unrolls
#pragma unroll
      for (int lo = 0; lo < P; ++lo) {
        const int hi = lo + k, r = k % p;
        if (lo >= r && (lo - r) % (2 * k) < k && hi < K && lo / (2 * p) == hi / (2 * p)) {
          const float a = u[lo], c = u[hi];
          u[lo] = fmaxf(a, c);
          u[hi] = fminf(a, c);
        }
      }
    }
  }
}

// The row of a thread form read a second time, after its threshold: an L1 hit
// (the first read brought the lines in).  The asm is volatile so that the
// compiler cannot keep the first read's values live through the sort
// instead, which would hold two K-arrays at once and cut the occupancy of
// every form of the kernel.
template <int K>
__device__ __forceinline__ void reload_thread_row(const float* src, bool vec, float (&x)[K]) {
  if constexpr (K % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < K / 4; ++q)
        asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(x[4 * q]), "=f"(x[4 * q + 1]), "=f"(x[4 * q + 2]), "=f"(x[4 * q + 3])
                     : "l"(src + 4 * q));
      return;
    }
  } else if constexpr (K % 2 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < K / 2; ++q)
        asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];"
                     : "=f"(x[2 * q]), "=f"(x[2 * q + 1]) : "l"(src + 2 * q));
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(x[k]) : "l"(src + k));
}

// Thread form: one row a thread, K = w values in its registers.  The row's
// load is issued first (it needs the row index only); its block's width and
// radius are found while it is in flight.  The row is sorted in a masked
// copy u; past kKeepRow the row itself is read again after the threshold
// instead of kept, so that only one K-array is live at a time.
template <int K>
__device__ __forceinline__ void project_rows_thread(const ProjBucket& bk, unsigned int lb) {
  const unsigned int r0 = lb * kThreads, row = r0 + threadIdx.x;
  if (row >= bk.rows) return;
  const long long base = static_cast<long long>(row) * K;
  const bool vec = bk.vec != 0;
  float x[K];
  load_thread_row<K>(bk.v + base, vec, x);
  const unsigned int b = block_of(first_block_index(bk, r0), threadIdx.x, bk.Bk, kThreads);
  const int n = min(bk.widths[b], K);
  const float rad = bk.radius[b];

  float u[K];
#pragma unroll
  for (int k = 0; k < K; ++k) u[k] = (k < n) ? x[k] : -kBig;
  sort_desc<K>(u);
  float css = 0.0f, css_rho = u[0];
  int rho = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < n) {
      css += u[k];
      if (u[k] * static_cast<float>(k + 1) > css - rad) {
        rho = k;
        css_rho = css;
      }
    }
  }
  float tau = (css_rho - rad) / static_cast<float>(rho + 1);
  if constexpr (K > kKeepRow) reload_thread_row<K>(bk.v + base, vec, x);
  float ssum = 0.0f, nsup = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float o = (k < n) ? fmaxf(x[k] - tau, 0.0f) : 0.0f;
    ssum += o;
    nsup += (o > 0.0f) ? 1.0f : 0.0f;
  }
  tau += (ssum - rad) / fmaxf(nsup, 1.0f);
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = (k < n) ? fmaxf(x[k] - tau, 0.0f) : 0.0f;
  store_thread_row<K>(bk.out + base, vec, x);
}

// (a, c) before (ba, bc) in the order the threshold maximises: the larger
// a / c, then the larger c, then the larger a; c == 0 is no candidate.
__device__ __forceinline__ bool better(float a, float c, float ba, float bc) {
  if (c == 0.0f) return false;
  if (bc == 0.0f) return true;
  const float l = a * bc, r = ba * c;
  return l > r || (l == r && (c > bc || (c == bc && a > ba)));
}

// Group form: one row on G lanes, K values a lane.  Every lane of the block
// runs every shuffle: rows past Bk are masked, not skipped.
template <int G, int K>
__device__ __forceinline__ void project_rows_group(const ProjBucket& bk, unsigned int lb) {
  constexpr unsigned int kSpan = kThreads / G;  // rows a block
  const unsigned int r0 = lb * kSpan;
  const unsigned int off = threadIdx.x / G;
  const int lane = static_cast<int>(threadIdx.x) % G;
  const bool live = r0 + off < bk.rows;
  const int w = bk.w;
  const long long base = static_cast<long long>(r0 + off) * w;
  float x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + k * G;
    x[k] = (live && j < w) ? __ldg(bk.v + base + j) : 0.0f;
  }
  // the row's block, while its loads are in flight
  const unsigned int b = live ? block_of(first_block_index(bk, r0), off, bk.Bk, kSpan) : 0;
  const int n = live ? min(bk.widths[b], w) : 0;
  const float rad = live ? bk.radius[b] : 0.0f;
  // u: the valid values, -kBig elsewhere (never >= a valid value)
  float u[K], sum[K], cnt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    u[k] = (lane + k * G < n) ? x[k] : -kBig;
    sum[k] = 0.0f;
    cnt[k] = 0.0f;
  }
#pragma unroll 8
  for (int src = 0; src < G; ++src) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const float val = __shfl_sync(kFull, u[kk], src, G);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (val >= u[k]) {
          sum[k] += val;
          cnt[k] += 1.0f;
        }
      }
    }
  }

  float ba = 0.0f, bc = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float a = sum[k] - rad;
    const float c = (lane + k * G < n) ? cnt[k] : 0.0f;
    if (better(a, c, ba, bc)) {
      ba = a;
      bc = c;
    }
  }
#pragma unroll
  for (int m = G / 2; m >= 1; m /= 2) {
    const float oa = __shfl_xor_sync(kFull, ba, m, G);
    const float oc = __shfl_xor_sync(kFull, bc, m, G);
    if (better(oa, oc, ba, bc)) {
      ba = oa;
      bc = oc;
    }
  }
  float tau = (bc > 0.0f) ? ba / bc : 0.0f;

  // Newton correction on the support that tau selects; the butterfly sums
  // are the same bits on every lane (each step adds a pair in both orders)
  float ssum = 0.0f, nsup = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float o = (lane + k * G < n) ? fmaxf(x[k] - tau, 0.0f) : 0.0f;
    ssum += o;
    nsup += (o > 0.0f) ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int m = G / 2; m >= 1; m /= 2) {
    ssum += __shfl_xor_sync(kFull, ssum, m, G);
    nsup += __shfl_xor_sync(kFull, nsup, m, G);
  }
  tau += (ssum - rad) / fmaxf(nsup, 1.0f);

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + k * G;
    if (live && j < w) bk.out[base + j] = (j < n) ? fmaxf(x[k] - tau, 0.0f) : 0.0f;
  }
}

template <int G, int K>
__device__ __forceinline__ void project_rows(const ProjBucket& bk, unsigned int lb) {
  if constexpr (G == 1) {
    project_rows_thread<K>(bk, lb);
  } else {
    project_rows_group<G, K>(bk, lb);
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
proj_buckets_kernel(const __grid_constant__ ProjLaunch<NB> L) {
  // the block's bucket: the last whose first block it has passed (with one
  // bucket a constant, and every field a direct operand)
  int i = 0;
#pragma unroll
  for (int j = 1; j < NB; ++j) i += (j < L.nb && blockIdx.x >= L.b[j].first_block);
  const ProjBucket& bk = L.b[i];
  const unsigned int lb = blockIdx.x - bk.first_block;
  switch (bk.form) {
#define BSLS_FORM_CASE(lo, hi, G, K) \
  case (G) * 256 + (K): project_rows<G, K>(bk, lb); break;
    BSLS_PROJ_FORMS(BSLS_FORM_CASE)
#undef BSLS_FORM_CASE
    default: break;
  }
}

// The form of width w (G * 256 + K, -1 for none) and the rows a block of it
// covers.
inline int proj_form(int w, int& rows_per_block) {
#define BSLS_FORM_CODE(lo, hi, G, K) \
  if (w >= (lo) && w <= (hi)) {      \
    rows_per_block = kThreads / (G); \
    return (G) * 256 + (K);          \
  }
  BSLS_PROJ_FORMS(BSLS_FORM_CODE)
#undef BSLS_FORM_CODE
  return -1;
}

template <int NB>
int launch_buckets(const void* const* v, void* const* out, const void* const* widths,
                   const void* const* radius, const long long* S, const int* Bk,
                   const int* w, int nb, cudaStream_t stream) {
  ProjLaunch<NB> L{};
  L.nb = nb;
  long long blocks = 0;
  for (int i = 0; i < nb; ++i) {
    int span = 0;
    const int form = (w[i] >= 1 && w[i] <= kMaxWidth) ? proj_form(w[i], span) : -1;
    if (form < 0 || Bk[i] < 1 || S[i] < 1 || S[i] > kMaxRows / Bk[i]) return -1;
    const long long rows = S[i] * Bk[i];
    const std::uintptr_t addr = reinterpret_cast<std::uintptr_t>(v[i]) |
                                reinterpret_cast<std::uintptr_t>(out[i]);
    const Magic m = magic_of(static_cast<unsigned int>(Bk[i]));
    L.b[i] = ProjBucket{static_cast<const float*>(v[i]), static_cast<float*>(out[i]),
                        static_cast<const int*>(widths[i]),
                        static_cast<const float*>(radius[i]), static_cast<unsigned int>(rows),
                        static_cast<unsigned int>(Bk[i]), m.magic, m.shift1, m.shift2, w[i],
                        form, addr % 16 == 0 ? 1 : 0, static_cast<unsigned int>(blocks)};
    blocks += (rows + span - 1) / span;
    if (blocks >= (1LL << 31)) return -1;  // one 1-D grid
  }
  proj_buckets_kernel<NB><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bsls

// Bucket i: v[i], out[i] (S[i] * Bk[i], w[i]) fp32 row-major; widths[i]
// (Bk[i],) int32; radius[i] (Bk[i],) fp32; S[i], Bk[i] >= 1,
// S[i] * Bk[i] <= kMaxRows; 1 <= w[i] <= 128; 1 <= nb <= 8.  One launch on
// `stream`, no synchronisation.  Returns the cudaError_t of the launch
// (0 = success); -1 for bad arguments.
extern "C" int bsls_proj_simplex_buckets(const void* const* v, void* const* out,
                                         const void* const* widths,
                                         const void* const* radius, const long long* S,
                                         const int* Bk, const int* w, int nb, void* stream) {
  using namespace bsls;
  if (nb < 1 || nb > kMaxBuckets) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nb == 1) return launch_buckets<1>(v, out, widths, radius, S, Bk, w, nb, st);
  if (nb == 2) return launch_buckets<2>(v, out, widths, radius, S, Bk, w, nb, st);
  if (nb <= 4) return launch_buckets<4>(v, out, widths, radius, S, Bk, w, nb, st);
  return launch_buckets<kMaxBuckets>(v, out, widths, radius, S, Bk, w, nb, st);
}
