// pava_rows: batched [0, radius]-bounded nondecreasing isotonic regression,
// every bucket of one call in one launch.
//
//   out[r, :n] = clip(argmin_{x_1 <= ... <= x_n} ||x - y[r, :n]||, 0, radius[b])
//   out[r, n:] = 0,   n = widths[b],  r = s * Bk + b   (n = 0: the row is 0)
//
// for each bucket (S, Bk, w) of the call, 1 <= w <= 128.  Replaces the TPU
// kernels pava_pallas_tw and pava_pallas (bsls_tpu/ops/pallas/pava_kernel.py:132
// and :181, the same function in two layouts; cores _pava_tile_kernel_t and
// _pava_tile_kernel).
//
// Bound on this card: bytes.  Each row is read once and written once,
// 2 * 4 * w bytes a row plus 8 * Bk bytes of parameters; pool-adjacent-
// violators does about 14 operations a slot, under one a byte.
//
// Every width has a form that keeps its row out of local and device memory
// (BSLS_PAVA_FORMS below, ops/rowkernels.py::PAVA_PLAN):
//
// * Thread forms (w <= 16): one row a thread, the row in registers, the fit
//   by the "minimax" formula with compile-time indices only,
//       yhat_i = min_{i <= k < n} max_{j <= i} mean(y[j..k]),
//   k outermost; for each start j a running sum over k >= j (taken directly,
//   not as a difference of prefix sums, which loses digits when |y| is large
//   beside the fit), times the compile-time reciprocal of k - j + 1, folded
//   with fmaxf over j and fminf over k.  Slots k >= n enter as +inf, so every
//   segment that reaches them has mean +inf and never wins the min: no branch,
//   the same work whatever the data.  Its w(w+1)/2 segments cost about 2 w^2
//   operations, and its registers (about 2 w live values) grow with w, so it
//   stops where a wider form would raise the register count of the whole
//   kernel.
// * Stack forms (w > 16): pool adjacent violators on a stack in shared
//   memory.  A block stages its R rows there with coalesced loads (slot s of
//   row q at s * (R + 1) + q: consecutive slots of a row and one slot of
//   consecutive rows fall in distinct banks); then each of R threads fits one
//   row in place: the level that starts at slot p keeps its sum at slot p
//   (p is at most the slot being read), its start is a bit of a 128-bit mask
//   in registers, its count the distance to the next start, and the top level
//   stays in registers.  A level's mean is its sum over its count by the fast
//   division, computed the same way wherever it is needed.  The fit is expanded
//   from the last slot down (a level's slots are written after its sum is
//   read), and the block stores its rows with coalesced writes.  R * w is at
//   most 4096 values, about 17 KB of shared memory a block, so that a launch
//   that mixes forms keeps at least 13 blocks a multiprocessor.
//
// Either way every mean is computed once and reused, so the fit is exactly
// nondecreasing in fp32; uniform box bounds commute with the monotone-cone
// projection, so the clip to [0, radius] comes last; a NaN among a row's first
// n slots makes all n NaN, as in the plain version (the comparisons and
// fmaxf/fminf alone would drop it); a NaN in a padding slot is never read.
//
// What held the earlier generic form (every width outside 1, 2, 4, 8, 16
// and 32) to 11.7% of the bound at w = 12: its stack lived in local memory,
// indexed by a run-time depth that differs from lane to lane, so every push
// and pop was a scattered local access; the row and the output went through
// scalar strided accesses; every bucket was one launch.  Here the stack
// forms' scattered accesses are shared-memory ones, and the thread forms have
// none.  The stack forms stay latency-bound: a warp's rows pool in different
// places, so a step costs the longest merge chain among its 32 rows, and
// shared memory holds about 400 rows a multiprocessor at w = 128.
//
// One launch takes every bucket (up to kMaxBuckets; the wrapper launches
// again beyond them), as the projection's (proj_simplex_rows.cu): the
// descriptors travel by value as a __grid_constant__ parameter, a block finds
// its bucket from their first blocks and switches on that bucket's form, and
// the kernel is instantiated for 1, 2, 4 and 8 descriptors, since the size of
// the parameter block is paid at every launch.  The shared memory of a launch
// is that of its widest stack form, none where every bucket takes a thread
// form.
#include <cstdint>

#include "rows_common.cuh"

namespace bsls {

// width range -> form: X(lo, hi, R).  R = 0: the thread form of width
// lo == hi, kThreads rows a block; R > 0: the stack form, R rows a block.
// ops/rowkernels.py::PAVA_PLAN states the same table.
#define BSLS_PAVA_FORMS(X)                                                     \
  X(1, 1, 0) X(2, 2, 0) X(3, 3, 0) X(4, 4, 0) X(5, 5, 0) X(6, 6, 0) X(7, 7, 0) \
  X(8, 8, 0) X(9, 9, 0) X(10, 10, 0) X(11, 11, 0) X(12, 12, 0) X(13, 13, 0)    \
  X(14, 14, 0) X(15, 15, 0) X(16, 16, 0)                                       \
  X(17, 32, 128) X(33, 64, 64) X(65, 128, 32)

struct PavaBucket {
  const float* y;
  float* out;
  const int* widths;
  const float* radius;
  unsigned int rows;       // S * Bk, the rows of the (S, Bk, w) bucket
  unsigned int Bk;
  unsigned int magic;      // r / Bk by the round-up method (rows_common.cuh)
  int shift1, shift2;
  int w;
  int form;                // w for a thread form, 1000 + R for a stack form
  int vec;                 // y and out 16-byte aligned
  unsigned int first_block;
};

template <int NB>
struct PavaLaunch {
  PavaBucket b[NB];
  int nb;
};

template <int W>
__device__ __forceinline__ void fit_minimax(float (&x)[W], int n) {
  const float inf = __int_as_float(0x7f800000);
  float sum[W], fit[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    x[i] = (i < n) ? x[i] : inf;
    fit[i] = inf;
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    float run = 0.0f;  // max over j' <= j of mean(x[j'..k])
#pragma unroll
    for (int j = 0; j <= k; ++j) {
      sum[j] = (j == k) ? x[k] : sum[j] + x[k];  // x[j] + ... + x[k], in order
      const float mean = sum[j] * (1.0f / static_cast<float>(k - j + 1));
      run = (j == 0) ? mean : fmaxf(run, mean);
      fit[j] = fminf(fit[j], run);
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = fit[i];
}

// Thread form: one row a thread, W = w values in its registers.
template <int W>
__device__ __forceinline__ void fit_rows_thread(const PavaBucket& bk, unsigned int lb) {
  const unsigned int r0 = lb * kThreads, row = r0 + threadIdx.x;
  if (row >= bk.rows) return;
  const long long base = static_cast<long long>(row) * W;
  const bool vec = bk.vec != 0;
  float x[W];
  load_thread_row<W>(bk.y + base, vec, x);
  const unsigned int b = block_of(first_block_index(bk, r0), threadIdx.x, bk.Bk, kThreads);
  const int n = min(bk.widths[b], W);
  const float rad = bk.radius[b];
  const float nan = __int_as_float(0x7fffffff);
  bool bad = false;
#pragma unroll
  for (int i = 0; i < W; ++i) bad |= (i < n) && isnan(x[i]);
  fit_minimax<W>(x, n);
#pragma unroll
  for (int i = 0; i < W; ++i)
    x[i] = (i < n) ? (bad ? nan : fminf(fmaxf(x[i], 0.0f), rad)) : 0.0f;
  store_thread_row<W>(bk.out + base, vec, x);
}

// The level starts of a row of the stack form: bit p of (hi:lo) is set where
// a level starts at slot p.
__device__ __forceinline__ void set_start(unsigned long long& lo, unsigned long long& hi,
                                          int p) {
  if (p < 64) lo |= 1ULL << p;
  else hi |= 1ULL << (p - 64);
}

__device__ __forceinline__ void clear_start(unsigned long long& lo, unsigned long long& hi,
                                            int p) {
  if (p < 64) lo &= ~(1ULL << p);
  else hi &= ~(1ULL << (p - 64));
}

// The last level start before slot p, 1 <= p <= 128 (slot 0 always starts one).
__device__ __forceinline__ int start_below(unsigned long long lo, unsigned long long hi, int p) {
  if (p > 64) {
    const unsigned long long m = (p >= 128) ? hi : (hi & ((1ULL << (p - 64)) - 1ULL));
    if (m) return 127 - __clzll(static_cast<long long>(m));
  }
  const unsigned long long m = (p >= 64) ? lo : (lo & ((1ULL << p) - 1ULL));
  return 63 - __clzll(static_cast<long long>(m));
}

// A level's mean: the fast division (within 2 ulp), the same instructions
// for the same (sum, count) wherever the mean is needed.
__device__ __forceinline__ float level_mean(float sum, int count) {
  return __fdividef(sum, static_cast<float>(count));
}

// The block's rows between device memory and shared memory, coalesced:
// element e of the block's nrows * w values is slot e % w of row e / w, at
// s * P + q in shared memory.  Each thread reads kBatch values before it
// writes any, so that kBatch loads from device memory are in flight at once
// rather than one (a thread moves at most R * w / kThreads = 32 values).
constexpr int kBatch = 8;

template <int P, bool kLoad, class T>
__device__ __forceinline__ void stage_rows(T* __restrict__ g, float* sm, int w, int total) {
  const int tid = static_cast<int>(threadIdx.x);
  const int dq = kThreads / w, ds = kThreads - dq * w;
  int q = tid / w, s = tid - q * w;
  const auto advance = [&]() {
    q += dq;
    s += ds;
    if (s >= w) {
      s -= w;
      ++q;
    }
  };
  for (int e0 = tid; e0 < total; e0 += kBatch * kThreads) {
    float buf[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = e0 + k * kThreads;
      if constexpr (kLoad) {
        buf[k] = (e < total) ? __ldg(g + e) : 0.0f;
      } else {
        buf[k] = (e < total) ? sm[s * P + q] : 0.0f;
        advance();
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = e0 + k * kThreads;
      if constexpr (kLoad) {
        if (e < total) sm[s * P + q] = buf[k];
        advance();
      } else {
        if (e < total) g[e] = buf[k];
      }
    }
  }
}

// Stack form: R rows a block in shared memory, one row a thread.
template <int R>
__device__ __forceinline__ void fit_rows_stack(const PavaBucket& bk, unsigned int lb,
                                               float* sm) {
  constexpr int P = R + 1;
  const int w = bk.w;
  const unsigned int r0 = lb * R;
  const int nrows = static_cast<int>(min(static_cast<unsigned int>(R), bk.rows - r0));
  const long long base = static_cast<long long>(r0) * w;
  stage_rows<P, true>(bk.y + base, sm, w, nrows * w);
  __syncthreads();
  const int t = static_cast<int>(threadIdx.x);
  if (t < nrows) {
    const unsigned int b = block_of(first_block_index(bk, r0), t, bk.Bk, R);
    const int n = min(bk.widths[b], w);
    const float rad = bk.radius[b];
    float* col = sm + t;  // slot i of this row at col[i * P]
    unsigned long long lo = 0, hi = 0;
    bool bad = false;
    // the top level: its start, sum and mean
    int ts = 0;
    float tsum = 0.0f, tmean = 0.0f;
    // the next slot is read one step ahead: its load overlaps this step's
    // pooling (which writes slots up to i only)
    float next = (n > 0) ? col[0] : 0.0f;
    for (int i = 0; i < n; ++i) {
      const float v = next;
      if (i + 1 < n) next = col[(i + 1) * P];
      bad |= isnan(v);
      // the new level [cs, i]; pool it into the top while the top's mean is larger
      int cs = i;
      float csum = v, cmean = v;
      while (cs > 0 && tmean > cmean) {
        clear_start(lo, hi, cs);
        csum += tsum;
        cs = ts;
        cmean = level_mean(csum, i + 1 - cs);
        if (cs > 0) {
          ts = start_below(lo, hi, cs);
          tsum = col[ts * P];
          tmean = level_mean(tsum, cs - ts);
        }
      }
      set_start(lo, hi, cs);
      col[cs * P] = csum;
      ts = cs;
      tsum = csum;
      tmean = cmean;
    }
    // expand from the last slot down: a level's sum is read before its slots
    // are written
    const float nan = __int_as_float(0x7fffffff);
    int st = n;
    float o = 0.0f;
    for (int i = n - 1; i >= 0; --i) {
      if (i < st) {
        const int end = st;
        st = start_below(lo, hi, end);
        o = bad ? nan : fminf(fmaxf(level_mean(col[st * P], end - st), 0.0f), rad);
      }
      col[i * P] = o;
    }
    for (int i = max(n, 0); i < w; ++i) col[i * P] = 0.0f;
  }
  __syncthreads();
  stage_rows<P, false>(bk.out + base, sm, w, nrows * w);
}

template <int LO, int R>
__device__ __forceinline__ void fit_rows(const PavaBucket& bk, unsigned int lb, float* sm) {
  if constexpr (R == 0) {
    fit_rows_thread<LO>(bk, lb);
  } else {
    fit_rows_stack<R>(bk, lb, sm);
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
pava_buckets_kernel(const __grid_constant__ PavaLaunch<NB> L) {
  extern __shared__ float sm[];
  // the block's bucket: the last whose first block it has passed
  int i = 0;
#pragma unroll
  for (int j = 1; j < NB; ++j) i += (j < L.nb && blockIdx.x >= L.b[j].first_block);
  const PavaBucket& bk = L.b[i];
  const unsigned int lb = blockIdx.x - bk.first_block;
  switch (bk.form) {
#define BSLS_FORM_CASE(lo, hi, R) \
  case (R) ? 1000 + (R) : (lo): fit_rows<lo, R>(bk, lb, sm); break;
    BSLS_PAVA_FORMS(BSLS_FORM_CASE)
#undef BSLS_FORM_CASE
    default: break;
  }
}

// The form of width w (-1 for none), the rows a block of it covers and the
// shared memory it needs.
inline int pava_form(int w, int& rows_per_block, int& smem) {
#define BSLS_FORM_CODE(lo, hi, R)                                  \
  if (w >= (lo) && w <= (hi)) {                                    \
    rows_per_block = (R) ? (R) : kThreads;                         \
    smem = (R) ? w * ((R) + 1) * static_cast<int>(sizeof(float)) : 0; \
    return (R) ? 1000 + (R) : (lo);                                \
  }
  BSLS_PAVA_FORMS(BSLS_FORM_CODE)
#undef BSLS_FORM_CODE
  return -1;
}

template <int NB>
int launch_pava(const void* const* y, void* const* out, const void* const* widths,
                const void* const* radius, const long long* S, const int* Bk, const int* w,
                int nb, cudaStream_t stream) {
  PavaLaunch<NB> L{};
  L.nb = nb;
  long long blocks = 0;
  int smem = 0;
  for (int i = 0; i < nb; ++i) {
    int span = 0, bytes = 0;
    const int form = (w[i] >= 1 && w[i] <= kMaxWidth) ? pava_form(w[i], span, bytes) : -1;
    if (form < 0 || Bk[i] < 1 || S[i] < 1 || S[i] > kMaxRows / Bk[i]) return -1;
    const long long rows = S[i] * Bk[i];
    const std::uintptr_t addr = reinterpret_cast<std::uintptr_t>(y[i]) |
                                reinterpret_cast<std::uintptr_t>(out[i]);
    const Magic m = magic_of(static_cast<unsigned int>(Bk[i]));
    L.b[i] = PavaBucket{static_cast<const float*>(y[i]), static_cast<float*>(out[i]),
                        static_cast<const int*>(widths[i]),
                        static_cast<const float*>(radius[i]), static_cast<unsigned int>(rows),
                        static_cast<unsigned int>(Bk[i]), m.magic, m.shift1, m.shift2, w[i],
                        form, addr % 16 == 0 ? 1 : 0, static_cast<unsigned int>(blocks)};
    blocks += (rows + span - 1) / span;
    smem = bytes > smem ? bytes : smem;
    if (blocks >= (1LL << 31)) return -1;  // one 1-D grid
  }
  pava_buckets_kernel<NB><<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bsls

// Bucket i: y[i], out[i] (S[i] * Bk[i], w[i]) fp32 row-major; widths[i]
// (Bk[i],) int32; radius[i] (Bk[i],) fp32; S[i], Bk[i] >= 1,
// S[i] * Bk[i] <= kMaxRows; 1 <= w[i] <= 128; 1 <= nb <= 8.  One launch on
// `stream`, no synchronisation.  Returns the cudaError_t of the launch
// (0 = success); -1 for bad arguments.
extern "C" int bsls_pava_buckets(const void* const* y, void* const* out,
                                 const void* const* widths, const void* const* radius,
                                 const long long* S, const int* Bk, const int* w, int nb,
                                 void* stream) {
  using namespace bsls;
  if (nb < 1 || nb > kMaxBuckets) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nb == 1) return launch_pava<1>(y, out, widths, radius, S, Bk, w, nb, st);
  if (nb == 2) return launch_pava<2>(y, out, widths, radius, S, Bk, w, nb, st);
  if (nb <= 4) return launch_pava<4>(y, out, widths, radius, S, Bk, w, nb, st);
  return launch_pava<kMaxBuckets>(y, out, widths, radius, S, Bk, w, nb, st);
}
