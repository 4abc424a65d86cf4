// Shared device math of the LSMC kernels (backward_update.cu, forward_sim.cu;
// path_sim.cu takes the constants and the rounded operations), templated on
// the element type T: each kernel's float32 and float64 instantiations come
// from one source.
//
// Every function here is the arithmetic of a torch function of the package,
// statement for statement, so that a kernel and its plain PyTorch version
// differ only by rounding:
//
//   spot_of                  engines/lsmc.py::spot_from_factors
//   design_row               ops/regression.py::design_columns
//   frac_index               ops/interp.py::fractional_index
//   interp_rates             ops/ratchets.py::interp_rates (LINEAR / STEP / POLY)
//   clipped_decision_bounds  ops/decisions.py::clipped_decision_bounds
//
// Where a function multiplies and adds, its rounding policy R says how:
// Contract writes the operations as they stand, and nvcc contracts a*b+c
// into an FMA (the float32 kernels' choice where last-bit differences from
// torch are bounded by chip_smoke); TorchRounding rounds every product, sum
// and difference on its own (__fmul_rn / __dadd_rn ...), as torch's CUDA
// ops round each elementwise op, so the kernel takes the plain version's
// values bit for bit wherever the library functions (exp) agree.
//
// Index arithmetic over sims uses 64-bit offsets: at 1M paths x 341 steps x
// 3 factors the path array holds 1.02e9 elements, half of the int32 range.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace storage_kernels {

constexpr int kMaxBasis = 16;    // B: basis functions of the regression
constexpr int kMaxFactors = 4;   // F: Markov factors of the price model
constexpr int kWarp = 32;

constexpr int kInterpLinear = 0;
constexpr int kInterpStep = 1;
constexpr int kInterpPoly = 2;

constexpr int kMaxVars = kMaxFactors + 1;  // a column's variables: the spot, then the factors

// Monomial basis: column b = spot^spot_pow[b] * prod_f x_f^fac_pow[b][f].
// The same basis as a table of powers (forward_sim.cu): variable v (0 the
// spot, 1 + f factor f) has its powers 1..max_pow[v] in slots pow_off[v] + p;
// slot[b][v] is the slot of column b's power of v, 0 for a power of 0.
struct BasisDesc {
  int num_basis;
  int num_factors;
  int spot_pow[kMaxBasis];
  int fac_pow[kMaxBasis * kMaxFactors];
  int max_pow[kMaxVars];
  int pow_off[kMaxVars];
  int slot[kMaxBasis * kMaxVars];
  int num_slots;  // 1 + the sum of max_pow (slot 0 is not used)
};

// Operations rounded on their own in either type (no FMA contraction).
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// The library functions torch's CUDA ops call, by type.
__device__ __forceinline__ float exp_of(float x) { return expf(x); }
__device__ __forceinline__ double exp_of(double x) { return exp(x); }
__device__ __forceinline__ float min_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_of(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float max_of(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_of(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float floor_of(float x) { return floorf(x); }
__device__ __forceinline__ double floor_of(double x) { return floor(x); }
__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }

// The rounding policies (see the head of this file).
struct Contract {
  template <class T> static __device__ __forceinline__ T add(T a, T b) { return a + b; }
  template <class T> static __device__ __forceinline__ T sub(T a, T b) { return a - b; }
  template <class T> static __device__ __forceinline__ T mul(T a, T b) { return a * b; }
};

struct TorchRounding {
  template <class T> static __device__ __forceinline__ T add(T a, T b) { return add_rn(a, b); }
  template <class T> static __device__ __forceinline__ T sub(T a, T b) { return sub_rn(a, b); }
  template <class T> static __device__ __forceinline__ T mul(T a, T b) { return mul_rn(a, b); }
};

// Four elements read from shared memory as 16-byte vectors (one float4, or
// two double2), the pair of a (mu, sd) entry, and an int kept in an
// element's bits (a grid index among a row's constants).
template <class T> struct Elem;

template <>
struct Elem<float> {
  using Quad = float4;
  using Pair = float2;
  static __device__ __forceinline__ Quad quad(float x, float y, float z, float w) {
    return make_float4(x, y, z, w);
  }
  static __device__ __forceinline__ float from_index(int j) { return __int_as_float(j); }
  static __device__ __forceinline__ unsigned to_index(float x) { return __float_as_uint(x); }
  static __device__ __forceinline__ int int_at(const float* p) { return __float_as_int(*p); }
};

template <>
struct Elem<double> {
  struct __align__(16) Quad { double x, y, z, w; };
  using Pair = double2;
  static __device__ __forceinline__ Quad quad(double x, double y, double z, double w) {
    return Quad{x, y, z, w};
  }
  static __device__ __forceinline__ double from_index(int j) { return __longlong_as_double(j); }
  static __device__ __forceinline__ unsigned to_index(double x) {
    return (unsigned)__double_as_longlong(x);
  }
  static __device__ __forceinline__ int int_at(const double* p) {
    return *reinterpret_cast<const int*>(p);
  }
};

// The sum of v over each group of kLanes lanes (butterflies), in every lane.
template <int kLanes, class T>
__device__ __forceinline__ T lane_group_sum(T v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Asynchronous copies from global into shared memory (4, 8 or 16 bytes,
// both addresses aligned to the size), grouped by commit and awaited
// together. cp_async_elem copies one element of T.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_elem(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void cp_async_elem(double* dst, const double* src) {
  cp_async8(dst, src);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// x**p for a small positive integer p as the multiply chain x*x*...*x.
template <class R, class T>
__device__ __forceinline__ T ipow(T x, int p) {
  T r = x;
  for (int i = 1; i < p; ++i) r = R::mul(r, x);
  return r;
}

// exp(drift + sum_f vol_f * x_f); coef = [drift, vol_0, ..., vol_{F-1}].
template <class R, class T>
__device__ __forceinline__ T spot_of(const T* coef, const T* x, int num_factors) {
  T log_spot = coef[0];
#pragma unroll
  for (int f = 0; f < kMaxFactors; ++f) {
    if (f < num_factors) log_spot = R::add(log_spot, R::mul(coef[1 + f], x[f]));
  }
  return exp_of(log_spot);
}

// Raw (unstandardized) design-matrix columns for one sim.
template <class R, class T>
__device__ __forceinline__ void design_row(const BasisDesc& bd, T spot, const T* x, T* cols) {
#pragma unroll
  for (int b = 0; b < kMaxBasis; ++b) {
    if (b < bd.num_basis) {
      T col = T(1);
      if (bd.spot_pow[b]) col = R::mul(col, ipow<R>(spot, bd.spot_pow[b]));
#pragma unroll
      for (int f = 0; f < kMaxFactors; ++f) {
        const int p = bd.fac_pow[b * kMaxFactors + f];
        if (f < bd.num_factors && p) col = R::mul(col, ipow<R>(x[f], p));
      }
      cols[b] = col;
    }
  }
}

// Lower index j in [0, G-2] and upper weight w of x on linspace(lo, hi, G),
// given its spacing step = span x (1 / (G - 1)) and whether the span
// hi - lo is positive (both the same for every sim of a step). A difference
// and a quotient: no policy is needed.
template <class T>
__device__ __forceinline__ void frac_index(T x, T lo, T step, bool positive, int num_grid, int* j,
                                           T* w) {
  const T t = positive ? (x - lo) / step : T(0);
  const T jf = min_of(max_of(floor_of(t), T(0)), (T)(num_grid - 2));
  *j = (int)jf;
  *w = min_of(max_of(t - jf, T(0)), T(1));
}

// Min/max rates at inventory inv from pillars [P][C] = (inventory, min, max
// [, min_poly_coef, max_poly_coef]); C = 5 for POLY. POLY is Horner's rule
// over the padded coefficient columns (highest power first, zero rows on
// top). Every product and sum is rounded as torch rounds it (no FMA
// contraction), so the rates are those of the plain version bit for bit.
template <class T>
__device__ __forceinline__ void interp_rates(const T* pil, int num_pillars, int num_cols,
                                             int interp_kind, T inv, T* min_rate, T* max_rate) {
  if (interp_kind == kInterpPoly) {
    T mn = T(0), mx = T(0);
    for (int p = 0; p < num_pillars; ++p) {
      mn = add_rn(mul_rn(mn, inv), pil[num_cols * p + 3]);
      mx = add_rn(mul_rn(mx, inv), pil[num_cols * p + 4]);
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
  const T* p_lo = pil + num_cols * lo;
  const T* p_hi = pil + num_cols * hi;
  const T seg = p_hi[0] - p_lo[0];
  T w = seg > T(0) ? (inv - p_lo[0]) / seg : T(0);
  w = min_of(max_of(w, T(0)), T(1));
  *min_rate = add_rn(p_lo[1], mul_rn(p_hi[1] - p_lo[1], w));
  *max_rate = add_rn(p_lo[2], mul_rn(p_hi[2] - p_lo[2], w));
}

// Feasible (withdraw, inject) rates clipped to the next step's inventory
// space. Sums and differences only: where the operands come rounded on
// their own (float64), so do the results, and no policy is needed.
template <class T>
__device__ __forceinline__ void clipped_decision_bounds(T min_rate, T max_rate, T inv, T inv_loss,
                                                        T next_min, T next_max,
                                                        T* yielded_withdraw, T* yielded_inject) {
  const T inv_after_loss = inv - inv_loss;
  const T after_max_withdraw = min_rate + inv_after_loss;
  *yielded_withdraw = after_max_withdraw > next_max   ? next_max - inv_after_loss
                      : after_max_withdraw > next_min ? min_rate
                                                      : next_min - inv_after_loss;
  const T after_max_inject = max_rate + inv_after_loss;
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
  bd.num_slots = 1;
  for (int v = 0; v <= num_factors; ++v) {
    for (int b = 0; b < num_basis; ++b) {
      const int p = v == 0 ? spot_pow[b] : fac_pow[b * num_factors + v - 1];
      if (p > bd.max_pow[v]) bd.max_pow[v] = p;
    }
    bd.pow_off[v] = bd.num_slots - 1;
    bd.num_slots += bd.max_pow[v];
    for (int b = 0; b < num_basis; ++b) {
      const int p = v == 0 ? spot_pow[b] : fac_pow[b * num_factors + v - 1];
      bd.slot[b * kMaxVars + v] = p > 0 ? bd.pow_off[v] + p : 0;
    }
  }
  return bd;
}

// Sets kernel fn's dynamic shared memory to `smem` bytes and returns its
// persistent grid: blocks per SM from the occupancy calculator (for
// `threads` threads a block) times the SM count, at most one per tile.
inline cudaError_t persistent_grid(const void* fn, int threads, size_t smem, long long tiles,
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
