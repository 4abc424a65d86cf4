// Shared device math of the float64 LSMC kernels (backward_update_f64.cu,
// forward_sim_f64.cu).
//
// Each function is the float64 arithmetic of a torch function of the
// package, statement for statement, with every product, sum and quotient
// rounded on its own (__dmul_rn / __dadd_rn / __dsub_rn, IEEE division):
// torch's CUDA ops round each elementwise op separately, so a kernel that
// may not contract a*b+c into an FMA takes the plain version's values bit
// for bit, and exp is the function torch's CUDA exp calls.
//
//   spot_of_f64          ops/regression.py::spot_from_factors
//   design_row_f64       ops/regression.py::design_columns
//   frac_index_f64       ops/interp.py::fractional_index
//   interp_rates_f64     ops/ratchets.py::interp_rates (LINEAR / STEP / POLY)
//   clipped_bounds_f64   ops/decisions.py::clipped_decision_bounds
//
// The float32 kernels' helpers (storage_kernels.cuh) are not touched.
#pragma once

#include "storage_kernels.cuh"

namespace storage_kernels {

// exp(drift + sum_f vol_f * x_f); coef = [drift, vol_0, ..., vol_{F-1}].
__device__ __forceinline__ double spot_of_f64(const double* coef, const double* x,
                                              int num_factors) {
  double log_spot = coef[0];
#pragma unroll
  for (int f = 0; f < kMaxFactors; ++f) {
    if (f < num_factors) log_spot = __dadd_rn(log_spot, __dmul_rn(coef[1 + f], x[f]));
  }
  return exp(log_spot);
}

__device__ __forceinline__ double ipow_f64(double x, int p) {
  double r = x;
  for (int i = 1; i < p; ++i) r = __dmul_rn(r, x);
  return r;
}

// Raw (unstandardized) design-matrix columns for one sim.
__device__ __forceinline__ void design_row_f64(const BasisDesc& bd, double spot, const double* x,
                                               double* cols) {
#pragma unroll
  for (int b = 0; b < kMaxBasis; ++b) {
    if (b < bd.num_basis) {
      double col = 1.0;
      if (bd.spot_pow[b]) col = __dmul_rn(col, ipow_f64(spot, bd.spot_pow[b]));
#pragma unroll
      for (int f = 0; f < kMaxFactors; ++f) {
        const int p = bd.fac_pow[b * kMaxFactors + f];
        if (f < bd.num_factors && p) col = __dmul_rn(col, ipow_f64(x[f], p));
      }
      cols[b] = col;
    }
  }
}

// Lower index j in [0, G-2] and upper weight w of x on linspace(lo, hi, G),
// given step = (hi - lo) / (G - 1) and whether hi - lo is positive.
__device__ __forceinline__ void frac_index_f64(double x, double lo, double step, bool positive,
                                               int num_grid, int* j, double* w) {
  const double t = positive ? __ddiv_rn(__dsub_rn(x, lo), step) : 0.0;
  const double jf = fmin(fmax(floor(t), 0.0), (double)(num_grid - 2));
  *j = (int)jf;
  *w = fmin(fmax(__dsub_rn(t, jf), 0.0), 1.0);
}

// Min/max rates at inventory inv from pillars [P][C] = (inventory, min, max
// [, min_poly_coef, max_poly_coef]); C = 5 for POLY (Horner over the padded
// coefficient columns, highest power first).
__device__ __forceinline__ void interp_rates_f64(const double* pil, int num_pillars, int num_cols,
                                                 int interp_kind, double inv, double* min_rate,
                                                 double* max_rate) {
  if (interp_kind == kInterpPoly) {
    double mn = 0.0, mx = 0.0;
    for (int p = 0; p < num_pillars; ++p) {
      mn = __dadd_rn(__dmul_rn(mn, inv), pil[num_cols * p + 3]);
      mx = __dadd_rn(__dmul_rn(mx, inv), pil[num_cols * p + 4]);
    }
    *min_rate = mn;
    *max_rate = mx;
    return;
  }
  int idx = -1;
  for (int p = 0; p < num_pillars; ++p) idx += (pil[num_cols * p] <= inv) ? 1 : 0;
  if (interp_kind == kInterpStep) {
    idx = min(max(idx, 0), num_pillars - 1);
    *min_rate = pil[num_cols * idx + 1];
    *max_rate = pil[num_cols * idx + 2];
    return;
  }
  const int lo = min(max(idx, 0), max(num_pillars - 2, 0));
  const int hi = min(lo + 1, num_pillars - 1);
  const double* p_lo = pil + num_cols * lo;
  const double* p_hi = pil + num_cols * hi;
  const double seg = __dsub_rn(p_hi[0], p_lo[0]);
  double w = seg > 0.0 ? __ddiv_rn(__dsub_rn(inv, p_lo[0]), seg) : 0.0;
  w = fmin(fmax(w, 0.0), 1.0);
  *min_rate = __dadd_rn(p_lo[1], __dmul_rn(__dsub_rn(p_hi[1], p_lo[1]), w));
  *max_rate = __dadd_rn(p_lo[2], __dmul_rn(__dsub_rn(p_hi[2], p_lo[2]), w));
}

// Feasible (withdraw, inject) rates clipped to the next step's inventory space.
__device__ __forceinline__ void clipped_bounds_f64(double min_rate, double max_rate, double inv,
                                                   double inv_loss, double next_min,
                                                   double next_max, double* yielded_withdraw,
                                                   double* yielded_inject) {
  const double inv_after_loss = __dsub_rn(inv, inv_loss);
  const double after_max_withdraw = __dadd_rn(min_rate, inv_after_loss);
  *yielded_withdraw = after_max_withdraw > next_max   ? __dsub_rn(next_max, inv_after_loss)
                      : after_max_withdraw > next_min ? min_rate
                                                      : __dsub_rn(next_min, inv_after_loss);
  const double after_max_inject = __dadd_rn(max_rate, inv_after_loss);
  *yielded_inject = after_max_inject < next_min   ? __dsub_rn(next_min, inv_after_loss)
                    : after_max_inject < next_max ? max_rate
                                                  : __dsub_rn(next_max, inv_after_loss);
}

// Blocks per SM from the occupancy calculator x SMs, at most one per tile:
// the persistent grid of a kernel with `threads` threads and `smem` bytes
// of dynamic shared memory (set as the kernel's maximum first).
inline cudaError_t persistent_grid_f64(const void* fn, int threads, size_t smem, long long tiles,
                                       int* num_blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  const long long grid = (long long)per_sm * sms;
  *num_blocks = (int)(tiles < grid ? tiles : grid);
  return cudaSuccess;
}

}  // namespace storage_kernels
