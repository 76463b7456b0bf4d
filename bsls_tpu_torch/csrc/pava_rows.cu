// pava_rows: batched [0, radius]-bounded nondecreasing isotonic regression.
//
//   out[r, :n] = clip(argmin_{x_1 <= ... <= x_n} ||x - y[r, :n]||, 0, radius[r % Bk])
//   out[r, n:] = 0,   n = widths[r % Bk]   (n = 0: the whole row is 0)
//
// Replaces the TPU kernels pava_pallas_tw and pava_pallas
// (bsls_tpu/ops/pallas/pava_kernel.py:132 and :181, the same function in two
// layouts; cores _pava_tile_kernel_t and _pava_tile_kernel).
//
// Bound on this card: bytes.  Each row is read once and written once,
// 2 * 4 * w bytes a row plus 8 * Bk bytes of parameters; the fit of the
// minimax form below is w(w+1)/2 segments of at most 4 operations, 2.5
// operations a byte at w = 8 against the 20 that the card's fp32 rate allows
// per byte of its memory rate.
//
// Design.  One thread per row, the row in registers, 16-byte loads and stores
// where w % 4 == 0 (rows_common.cuh), w a template parameter for 1, 2, 4, 8,
// 16 and 32.  What held the first form of this kernel (a pool-adjacent-
// violators stack) at a third of the bound, and what the design does about it:
//
// * The stack was indexed by a run-time depth, so it lived in local memory:
//   every push and pop a dependent local access.  The "minimax" form evaluates
//   the fit with compile-time indices only, so nothing leaves the registers:
//       yhat_i = min_{i <= k < n} max_{j <= i} mean(y[j..k]),
//   k outermost; for each start j a running sum over k >= j (taken directly,
//   not as a difference of prefix sums, which loses digits when |y| is large
//   beside the fit), times the compile-time reciprocal of k - j + 1, folded
//   with fmaxf over j and fminf over k.  Slots k >= n enter as +inf, so every
//   segment that reaches them has mean +inf and never wins the min: no branch.
//   Every mean is computed once and reused, so the output is exactly
//   nondecreasing in fp32.
// * The pooling loop ran a data-dependent number of times, so the lanes of a
//   warp waited for the one with most merges.  The minimax form does the same
//   work whatever the data.
// * The expansion read the stack at a run-time index and divided once per
//   slot.  The minimax form has no expansion and no division.
// * The row was found with a 64-bit remainder (row % Bk).  The grid is 2-D:
//   x covers the Bk rows of one scenario, y the scenarios (in strides of
//   gridDim.y above 65,535), so the block's width and radius sit at the
//   thread's own x index and no division is left.
//
// Uniform box bounds commute with the monotone-cone projection, so the clip to
// [0, radius] comes last.  A NaN among a row's first n slots makes all n NaN,
// as in the plain version (fmaxf and fminf alone would drop it).  The minimax
// form costs w(w+1)/2 segments against the stack's at most 2w pushes and pops,
// yet it was the faster one at every templated width up to 32, on random rows
// and on the inputs a pava solve hands the kernel (PERF.md has the times of
// the stack in local memory and of a stack in registers), so every templated
// width takes it (ops/rowkernels.py::PAVA_FORMS says the same).  Rows of any
// other width up to 128 go through a generic kernel that runs the stack on the
// row in device memory.
#include "rows_common.cuh"

namespace bsls {

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

// Push y_i onto the (sum, count) stack and pool while the order is violated.
__device__ __forceinline__ void pava_push(float val, float* s, int* c, int& top) {
  float sum = val;
  int cnt = 1;
  while (top > 0 &&
         s[top - 1] * static_cast<float>(cnt) > sum * static_cast<float>(c[top - 1])) {
    sum += s[top - 1];
    cnt += c[top - 1];
    --top;
  }
  s[top] = sum;
  c[top] = cnt;
  ++top;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
pava_rows_fixed(const float* __restrict__ y, const int* __restrict__ widths,
                const float* __restrict__ radius, float* __restrict__ out,
                int Bk, long long S) {
  const unsigned int b = blockIdx.x * kThreads + threadIdx.x;  // < 2^31 + 2^7
  if (b >= static_cast<unsigned int>(Bk)) return;
  const int n = min(widths[b], W);
  const float rad = radius[b];
  const float nan = __int_as_float(0x7fffffff);
  for (long long s = blockIdx.y; s < S; s += gridDim.y) {
    const long long row = s * Bk + b;
    float x[W];
    load_row<W>(y, row, x);
    bool bad = false;
#pragma unroll
    for (int i = 0; i < W; ++i) bad |= (i < n) && isnan(x[i]);
    fit_minimax<W>(x, n);
#pragma unroll
    for (int i = 0; i < W; ++i)
      x[i] = (i < n) ? (bad ? nan : fminf(fmaxf(x[i], 0.0f), rad)) : 0.0f;
    store_row<W>(out, row, x);
  }
}

__global__ void __launch_bounds__(kThreads)
pava_rows_generic(const float* __restrict__ y, const int* __restrict__ widths,
                  const float* __restrict__ radius, float* __restrict__ out,
                  int w, int Bk, long long S) {
  const unsigned int b = blockIdx.x * kThreads + threadIdx.x;  // < 2^31 + 2^7
  if (b >= static_cast<unsigned int>(Bk)) return;
  const int n = min(widths[b], w);
  const float rad = radius[b];
  for (long long r = blockIdx.y; r < S; r += gridDim.y) {
    const long long row = r * Bk + b;
    const float* src = y + row * w;
    float* dst = out + row * w;

    float s[kMaxWidth];
    int c[kMaxWidth];
    int top = 0;
    for (int i = 0; i < n; ++i) pava_push(src[i], s, c, top);

    int lev = 0, end = (n > 0) ? c[0] : 0;
    for (int i = 0; i < w; ++i) {
      if (i < n) {
        if (i >= end) {
          ++lev;
          end += c[lev];
        }
        dst[i] = fminf(fmaxf(s[lev] / static_cast<float>(c[lev]), 0.0f), rad);
      } else {
        dst[i] = 0.0f;
      }
    }
  }
}

}  // namespace bsls

// y, out: (R, w) fp32 row-major; widths: (Bk,) int32; radius: (Bk,) fp32;
// R % Bk == 0; 1 <= w <= 128.  Launches on `stream`, does not synchronise.
// Returns the cudaError_t of the launch (0 = success); -1 for bad arguments.
extern "C" int bsls_pava_rows(const void* y, const void* widths, const void* radius,
                              void* out, long long R, int w, int Bk, void* stream) {
  using namespace bsls;
  if (w < 1 || w > kMaxWidth || Bk < 1 || R < 0 || R % Bk != 0) return -1;
  if (R == 0) return 0;
  const float* yp = static_cast<const float*>(y);
  const int* wp = static_cast<const int*>(widths);
  const float* rp = static_cast<const float*>(radius);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // x: the Bk rows of one scenario; y: the scenarios, at most 65,535 blocks
  // (the kernels stride over the rest)
  const long long S = R / Bk;
  const dim3 grid(grid_for(Bk), static_cast<unsigned int>(S < 65535 ? S : 65535));
  // every templated width takes the minimax fit (ops/rowkernels.py::PAVA_FORMS)
  switch (w) {
#define BSLS_CASE(W) \
  case W: pava_rows_fixed<W><<<grid, kThreads, 0, st>>>(yp, wp, rp, op, Bk, S); break;
    BSLS_CASE(1)
    BSLS_CASE(2)
    BSLS_CASE(4)
    BSLS_CASE(8)
    BSLS_CASE(16)
    BSLS_CASE(32)
#undef BSLS_CASE
    default:
      pava_rows_generic<<<grid, kThreads, 0, st>>>(yp, wp, rp, op, w, Bk, S);
  }
  return static_cast<int>(cudaGetLastError());
}
