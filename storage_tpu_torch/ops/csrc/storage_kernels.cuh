// Shared device math of the LSMC kernels (backward_update.cu, forward_sim.cu).
//
// Every function here is the float32 arithmetic of a torch function of the
// package, statement for statement, so that a kernel and its plain PyTorch
// version differ only by rounding (nvcc contracts a*b+c into FMA by default;
// that, and expf, are the expected sources of last-bit differences):
//
//   spot_of                  engines/lsmc.py::spot_from_factors
//   design_row               ops/regression.py::design_columns
//   frac_index               ops/interp.py::fractional_index
//   interp_rates             ops/ratchets.py::interp_rates (LINEAR / STEP)
//   clipped_decision_bounds  ops/decisions.py::clipped_decision_bounds
//
// Index arithmetic over sims uses 64-bit offsets: at 1M paths x 341 steps x
// 3 factors the path array holds 1.02e9 floats, half of the int32 range.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace storage_kernels {

constexpr int kMaxBasis = 16;    // B: basis functions of the regression
constexpr int kMaxFactors = 4;   // F: Markov factors of the price model
constexpr int kWarp = 32;

constexpr int kInterpLinear = 0;
constexpr int kInterpStep = 1;

// Monomial basis: column b = spot^spot_pow[b] * prod_f x_f^fac_pow[b][f].
struct BasisDesc {
  int num_basis;
  int num_factors;
  int spot_pow[kMaxBasis];
  int fac_pow[kMaxBasis * kMaxFactors];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// x**p for a small positive integer p as the multiply chain x*x*...*x.
__device__ __forceinline__ float ipow(float x, int p) {
  float r = x;
  for (int i = 1; i < p; ++i) r = r * x;
  return r;
}

// exp(drift + sum_f vol_f * x_f); coef = [drift, vol_0, ..., vol_{F-1}].
__device__ __forceinline__ float spot_of(const float* coef, const float* x, int num_factors) {
  float log_spot = coef[0];
#pragma unroll
  for (int f = 0; f < kMaxFactors; ++f) {
    if (f < num_factors) log_spot = log_spot + coef[1 + f] * x[f];
  }
  return expf(log_spot);
}

// Raw (unstandardized) design-matrix columns for one sim.
__device__ __forceinline__ void design_row(const BasisDesc& bd, float spot, const float* x,
                                           float* cols) {
#pragma unroll
  for (int b = 0; b < kMaxBasis; ++b) {
    if (b < bd.num_basis) {
      float col = 1.0f;
      if (bd.spot_pow[b]) col = col * ipow(spot, bd.spot_pow[b]);
#pragma unroll
      for (int f = 0; f < kMaxFactors; ++f) {
        const int p = bd.fac_pow[b * kMaxFactors + f];
        if (f < bd.num_factors && p) col = col * ipow(x[f], p);
      }
      cols[b] = col;
    }
  }
}

// Lower index j in [0, G-2] and upper weight w of x on linspace(lo, hi, G).
__device__ __forceinline__ void frac_index(float x, float lo, float hi, int num_grid, int* j,
                                           float* w) {
  const float span = hi - lo;
  const float step = span / (float)(num_grid - 1);
  const float t = span > 0.0f ? (x - lo) / step : 0.0f;
  const float jf = fminf(fmaxf(floorf(t), 0.0f), (float)(num_grid - 2));
  *j = (int)jf;
  *w = fminf(fmaxf(t - jf, 0.0f), 1.0f);
}

// Min/max rates at inventory inv from pillars [P][3] = (inventory, min, max).
__device__ __forceinline__ void interp_rates(const float* pil, int num_pillars, int interp_kind,
                                             float inv, float* min_rate, float* max_rate) {
  int idx = -1;
  for (int p = 0; p < num_pillars; ++p) idx += (pil[3 * p] <= inv) ? 1 : 0;
  if (interp_kind == kInterpStep) {
    idx = min(max(idx, 0), num_pillars - 1);
    *min_rate = pil[3 * idx + 1];
    *max_rate = pil[3 * idx + 2];
    return;
  }
  const int lo = min(max(idx, 0), max(num_pillars - 2, 0));
  const int hi = min(lo + 1, num_pillars - 1);
  const float inv_lo = pil[3 * lo];
  const float seg = pil[3 * hi] - inv_lo;
  float w = seg > 0.0f ? (inv - inv_lo) / seg : 0.0f;
  w = fminf(fmaxf(w, 0.0f), 1.0f);
  *min_rate = pil[3 * lo + 1] + (pil[3 * hi + 1] - pil[3 * lo + 1]) * w;
  *max_rate = pil[3 * lo + 2] + (pil[3 * hi + 2] - pil[3 * lo + 2]) * w;
}

// Feasible (withdraw, inject) rates clipped to the next step's inventory space.
__device__ __forceinline__ void clipped_decision_bounds(float min_rate, float max_rate, float inv,
                                                        float inv_loss, float next_min,
                                                        float next_max, float* yielded_withdraw,
                                                        float* yielded_inject) {
  const float inv_after_loss = inv - inv_loss;
  const float after_max_withdraw = min_rate + inv_after_loss;
  *yielded_withdraw = after_max_withdraw > next_max   ? next_max - inv_after_loss
                      : after_max_withdraw > next_min ? min_rate
                                                      : next_min - inv_after_loss;
  const float after_max_inject = max_rate + inv_after_loss;
  *yielded_inject = after_max_inject < next_min   ? next_min - inv_after_loss
                    : after_max_inject < next_max ? max_rate
                                                  : next_max - inv_after_loss;
}

// Builds the BasisDesc a launcher receives as host arrays.
inline BasisDesc make_basis_desc(int num_basis, int num_factors, const int* spot_pow,
                                 const int* fac_pow) {
  BasisDesc bd = {};
  bd.num_basis = num_basis;
  bd.num_factors = num_factors;
  for (int b = 0; b < num_basis; ++b) {
    bd.spot_pow[b] = spot_pow[b];
    for (int f = 0; f < num_factors; ++f) bd.fac_pow[b * kMaxFactors + f] = fac_pow[b * num_factors + f];
  }
  return bd;
}

}  // namespace storage_kernels
