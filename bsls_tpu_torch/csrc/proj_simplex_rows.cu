// proj_simplex_rows: batched Euclidean projection onto radius-scaled simplices.
//
//   out[r, :n] = argmin_x ||x - v[r, :n]||  s.t.  x >= 0, sum x = radius[r % Bk]
//   out[r, n:] = 0,   n = widths[r % Bk]   (n = 0: the whole row is 0)
//
// Replaces the TPU kernel proj_simplex_pallas_tw
// (bsls_tpu/ops/pallas/projection_kernel.py:132, core _proj_tile_kernel_t).
//
// Bound on this card: memory.  Each row is read once and written once,
// 2 * 4 * R * w bytes plus the 8 * Bk bytes of parameters, against some
// w^2 / 2 compare-exchanges per row; at w <= 32 the arithmetic is far below
// the fp32 rate that the memory rate would have to feed.
//
// Design.  One thread per row, the row in registers, w a template parameter
// for the bucket widths that occur (1, 2, 4, 8, 16, 32); 16-byte loads and
// stores where w % 4 == 0.  The threshold is found EXACTLY, by the sort-based
// algorithm of arXiv:1101.6081 (sort descending, pivot
// rho = max{k : u_k * k > cumsum_k - radius}, tau = (cumsum_rho - radius)/rho)
// on an odd-even transposition network that the compiler unrolls into
// register-to-register min/max.  The TPU kernel bisected (40 halvings of a
// bracket on s(t) = sum max(v - t, 0)) only because sort networks would not
// lower there; on registers the sort costs w^2/2 min/max pairs against
// 40 * w for the bisection, so it is cheaper for every templated width, and it
// mirrors the plain version (ops/projection.py::proj_simplex_padded) step by
// step.  One Newton correction of tau on the found support takes the
// cancellation error of cumsum - radius out of the row sum, as the TPU kernel
// does.  Rows of any other width up to 128 go through a generic kernel with
// the row in local memory and an insertion sort (proj_device.cuh, shared with
// the fused-chunk kernel).
#include "proj_device.cuh"
#include "rows_common.cuh"

namespace bsls {

template <int W>
__global__ void __launch_bounds__(kThreads)
proj_rows_fixed(const float* __restrict__ v, const int* __restrict__ widths,
                const float* __restrict__ radius, float* __restrict__ out,
                long long R, int Bk) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= R) return;
  const int b = static_cast<int>(row % Bk);
  const int n = min(widths[b], W);
  const float rad = radius[b];

  float x[W], u[W];
  load_row<W>(v, row, x);
#pragma unroll
  for (int i = 0; i < W; ++i) u[i] = (i < n) ? x[i] : -kBig;

  // odd-even transposition sort, descending; all indices are compile-time
  // constants after unrolling, so u stays in registers
#pragma unroll
  for (int p = 0; p < W; ++p) {
#pragma unroll
    for (int i = (p & 1); i + 1 < W; i += 2) {
      const float a = u[i], c = u[i + 1];
      u[i] = fmaxf(a, c);
      u[i + 1] = fminf(a, c);
    }
  }

  float css = 0.0f, css_rho = u[0];
  int rho = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k < n) {
      css += u[k];
      if (u[k] * static_cast<float>(k + 1) > css - rad) {
        rho = k;
        css_rho = css;
      }
    }
  }
  float tau = (css_rho - rad) / static_cast<float>(rho + 1);

  // Newton correction on the support that tau selects
  float ssum = 0.0f, nsup = 0.0f;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float o = (i < n) ? fmaxf(x[i] - tau, 0.0f) : 0.0f;
    ssum += o;
    nsup += (o > 0.0f) ? 1.0f : 0.0f;
  }
  tau += (ssum - rad) / fmaxf(nsup, 1.0f);

#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = (i < n) ? fmaxf(x[i] - tau, 0.0f) : 0.0f;
  store_row<W>(out, row, x);
}

// Any width up to kMaxWidth: the row and its sorted copy live in local memory.
__global__ void __launch_bounds__(kThreads)
proj_rows_generic(const float* __restrict__ v, const int* __restrict__ widths,
                  const float* __restrict__ radius, float* __restrict__ out,
                  long long R, int w, int Bk) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= R) return;
  const int b = static_cast<int>(row % Bk);
  const int n = min(widths[b], w);
  const float rad = radius[b];
  float u[kMaxWidth];
  proj_simplex_row(v + row * w, n, w, rad, u, out + row * w);
}

}  // namespace bsls

// v, out: (R, w) fp32 row-major; widths: (Bk,) int32; radius: (Bk,) fp32;
// R % Bk == 0; 1 <= w <= 128.  Launches on `stream`, does not synchronise.
// Returns the cudaError_t of the launch (0 = success); -1 for a bad width.
extern "C" int bsls_proj_simplex_rows(const void* v, const void* widths,
                                      const void* radius, void* out,
                                      long long R, int w, int Bk, void* stream) {
  using namespace bsls;
  if (w < 1 || w > kMaxWidth || Bk < 1) return -1;
  if (R == 0) return 0;
  const float* vp = static_cast<const float*>(v);
  const int* wp = static_cast<const int*>(widths);
  const float* rp = static_cast<const float*>(radius);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_for(R)), block(kThreads);
  switch (w) {
#define BSLS_CASE(W) \
  case W: proj_rows_fixed<W><<<grid, block, 0, st>>>(vp, wp, rp, op, R, Bk); break;
    BSLS_CASE(1)
    BSLS_CASE(2)
    BSLS_CASE(4)
    BSLS_CASE(8)
    BSLS_CASE(16)
    BSLS_CASE(32)
#undef BSLS_CASE
    default:
      proj_rows_generic<<<grid, block, 0, st>>>(vp, wp, rp, op, R, w, Bk);
  }
  return static_cast<int>(cudaGetLastError());
}
