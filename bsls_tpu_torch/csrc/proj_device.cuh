// The exact sort-based simplex projection of one row, as a device function
// of the fused chunk (pgd_chunk.cu).
#pragma once

#include <cuda_runtime.h>

namespace bsls {

// dst[:n] = argmin_x ||x - src[:n]||  s.t.  x >= 0, sum x = rad;  dst[n:w] = 0.
// `u` is scratch for n floats (the valid prefix sorted descending).  src and
// dst may be the same array: every slot is read before it is written.
// Threshold by arXiv:1101.6081 (pivot rho = max{k : u_k * k > cumsum_k - rad},
// tau = (cumsum_rho - rad) / rho), then one Newton correction of tau on the
// support it selects, which takes the cancellation error of cumsum - rad out
// of the row sum.
__device__ __forceinline__ void proj_simplex_row(const float* src, int n, int w,
                                                 float rad, float* u, float* dst) {
  // insertion sort of the valid prefix, descending
  for (int i = 0; i < n; ++i) {
    const float val = src[i];
    int j = i;
    while (j > 0 && u[j - 1] < val) {
      u[j] = u[j - 1];
      --j;
    }
    u[j] = val;
  }
  float tau = 0.0f;
  if (n > 0) {
    float css = 0.0f, css_rho = u[0];
    int rho = 0;
    for (int k = 0; k < n; ++k) {
      css += u[k];
      if (u[k] * static_cast<float>(k + 1) > css - rad) {
        rho = k;
        css_rho = css;
      }
    }
    tau = (css_rho - rad) / static_cast<float>(rho + 1);
    float ssum = 0.0f, nsup = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float o = fmaxf(src[i] - tau, 0.0f);
      ssum += o;
      nsup += (o > 0.0f) ? 1.0f : 0.0f;
    }
    tau += (ssum - rad) / fmaxf(nsup, 1.0f);
  }
  for (int i = 0; i < w; ++i) dst[i] = (i < n) ? fmaxf(src[i] - tau, 0.0f) : 0.0f;
}

}  // namespace bsls
