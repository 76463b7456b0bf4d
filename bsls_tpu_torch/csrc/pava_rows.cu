// pava_rows: batched [0, radius]-bounded nondecreasing isotonic regression.
//
//   out[r, :n] = clip(argmin_{x_1 <= ... <= x_n} ||x - y[r, :n]||, 0, radius[r % Bk])
//   out[r, n:] = 0,   n = widths[r % Bk]   (n = 0: the whole row is 0)
//
// Replaces the TPU kernel pava_pallas_tw
// (bsls_tpu/ops/pallas/pava_kernel.py:132, core _pava_tile_kernel_t).
//
// Bound on this card: memory.  Each row is read once and written once,
// 2 * 4 * R * w bytes plus 8 * Bk bytes of parameters; pool-adjacent-violators
// does at most 2n pushes and pops per row.
//
// Design.  One thread per row running the classical pool-adjacent-violators
// stack: each new value opens a level (sum, count); while the level below has
// a larger mean the two merge.  That is O(n) per row.  The TPU kernel
// evaluated the O(w^2) minimax form min_{k>=i} max_{j<=i} mean(y[j..k])
// because its compiler offered neither a scan nor data-dependent loops; a
// CUDA thread has both.  Level means are compared by cross-multiplication
// (sum_a * cnt_b > sum_b * cnt_a), which needs no division inside the loop.
// Uniform box bounds commute with the monotone-cone projection, so the clip
// to [0, radius] comes last.  The row is in registers (w a template parameter
// for 1, 2, 4, 8, 16, 32, with 16-byte loads and stores where w % 4 == 0);
// the stack is indexed by a run-time depth and so lives in local memory,
// which the L1 cache serves.  Rows of any other width up to 128 go through a
// generic kernel that reads the row from global memory.
#include "rows_common.cuh"

namespace bsls {

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
                long long R, int Bk) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= R) return;
  const int b = static_cast<int>(row % Bk);
  const int n = min(widths[b], W);
  const float rad = radius[b];

  float x[W];
  load_row<W>(y, row, x);

  float s[W];
  int c[W];
  int top = 0;
#pragma unroll
  for (int i = 0; i < W; ++i)
    if (i < n) pava_push(x[i], s, c, top);

  // expand the levels back over their slots
  int lev = 0, end = (n > 0) ? c[0] : 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (i < n) {
      if (i >= end) {
        ++lev;
        end += c[lev];
      }
      x[i] = fminf(fmaxf(s[lev] / static_cast<float>(c[lev]), 0.0f), rad);
    } else {
      x[i] = 0.0f;
    }
  }
  store_row<W>(out, row, x);
}

__global__ void __launch_bounds__(kThreads)
pava_rows_generic(const float* __restrict__ y, const int* __restrict__ widths,
                  const float* __restrict__ radius, float* __restrict__ out,
                  long long R, int w, int Bk) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= R) return;
  const int b = static_cast<int>(row % Bk);
  const int n = min(widths[b], w);
  const float rad = radius[b];
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

}  // namespace bsls

// y, out: (R, w) fp32 row-major; widths: (Bk,) int32; radius: (Bk,) fp32;
// R % Bk == 0; 1 <= w <= 128.  Launches on `stream`, does not synchronise.
// Returns the cudaError_t of the launch (0 = success); -1 for a bad width.
extern "C" int bsls_pava_rows(const void* y, const void* widths,
                              const void* radius, void* out, long long R,
                              int w, int Bk, void* stream) {
  using namespace bsls;
  if (w < 1 || w > kMaxWidth || Bk < 1) return -1;
  if (R == 0) return 0;
  const float* yp = static_cast<const float*>(y);
  const int* wp = static_cast<const int*>(widths);
  const float* rp = static_cast<const float*>(radius);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_for(R)), block(kThreads);
  switch (w) {
#define BSLS_CASE(W) \
  case W: pava_rows_fixed<W><<<grid, block, 0, st>>>(yp, wp, rp, op, R, Bk); break;
    BSLS_CASE(1)
    BSLS_CASE(2)
    BSLS_CASE(4)
    BSLS_CASE(8)
    BSLS_CASE(16)
    BSLS_CASE(32)
#undef BSLS_CASE
    default:
      pava_rows_generic<<<grid, block, 0, st>>>(yp, wp, rp, op, R, w, Bk);
  }
  return static_cast<int>(cudaGetLastError());
}
