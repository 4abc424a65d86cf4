// The LSMC forward pass over the whole horizon, for a block of simulations.
//
// Replaces the TPU kernel storage_tpu/ops/pallas_forward.py::_forward_kernel.
// Plain PyTorch version: storage_tpu_torch/ops/forward.py::forward_sim_reference.
//
// One thread per simulation, looping over the n steps and carrying the
// sim's inventory and PV in registers. Each step a thread builds its spot
// and standardized design row [B+1], looks up the ratchet rates at its
// inventory, forms the D = 3 bang-bang decisions with
// clipped_decision_bounds, evaluates the fitted continuation at each
// decision's post-decision inventory by exact two-point interpolation of the
// step's [G, B+1] coefficient table (fractional_index semantics, clipped at
// the ends), adds the immediate NPV, and takes the first-occurrence argmax.
// The step's table, standardization constants, pillars and scalars are
// staged in shared memory (about 4.5 KB at G = 100, B = 10, independent of
// the horizon, so there is no span limit).
//
// Outputs: per (block, step) the 7 sums (inventory, volume, consumed, loss,
// net volume, immediate PV, net volume x spot) and the design-row sums
// [B+1], reduced deterministically (warp butterfly, then a fixed-order sum
// over the block's warps; the wrapper sums over blocks), plus each sim's
// final inventory and PV.
//
// Bound on the H100: the factor paths are read once (4 B x n x F x S); the
// arithmetic per sim and step is a few hundred flops and 7 + B + 1 warp
// reductions.
#include "storage_kernels.cuh"

namespace storage_kernels {

constexpr int kNumSums = 7;
constexpr int kNumDecisions = 3;

// Column layout of scalars[n, 11 + F] (ops/forward.py::pack_scalars).
enum Scalar {
  kLo = 0, kHi, kLoss, kInjectCost, kWithdrawCost, kConsInject, kConsWithdraw,
  kInvCostRate, kDfSettle, kDfCost, kDrift, kVols, kNumFixed = kVols
};

__global__ void forward_sim_kernel(
    const float* __restrict__ factors,  // [n, F, S]
    const float* __restrict__ inv0,     // [S] starting inventory
    const float* __restrict__ tables,   // [n, G, B+1] coefficient tables (+ vbar column)
    const float* __restrict__ mus,      // [n, B]
    const float* __restrict__ sds,      // [n, B]
    const float* __restrict__ pillars,  // [n, P, 3]
    const float* __restrict__ scalars,  // [n, 11 + F]
    float* __restrict__ sums_part,      // [nblk, n, 7]
    float* __restrict__ xsums_part,     // [nblk, n, B+1]
    float* __restrict__ inv_out,        // [S]
    float* __restrict__ pv_out,         // [S]
    long long num_sims, int num_steps, int num_grid, int num_pillars, int interp_kind,
    BasisDesc bd) {
  extern __shared__ float smem[];
  const int B = bd.num_basis;
  const int F = bd.num_factors;
  const int B1 = B + 1;
  const int G = num_grid;
  const int NS = kNumFixed + F;
  const int NV = kNumSums + B1;  // values reduced per step
  const int nwarps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;

  float* s_tab = smem;                       // G * B1
  float* s_mu = s_tab + G * B1;              // B
  float* s_sd = s_mu + B;                    // B
  float* s_pil = s_sd + B;                   // 3 P
  float* s_sc = s_pil + 3 * num_pillars;     // NS
  float* s_red = s_sc + NS;                  // nwarps * NV

  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = s < num_sims;
  float inv = valid ? inv0[s] : 0.0f;
  float pv = 0.0f;

  for (int k = 0; k < num_steps; ++k) {
    __syncthreads();  // the previous step's shared reads are done
    for (int i = threadIdx.x; i < G * B1; i += blockDim.x) s_tab[i] = tables[(size_t)k * G * B1 + i];
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
      s_mu[i] = mus[(size_t)k * B + i];
      s_sd[i] = sds[(size_t)k * B + i];
    }
    for (int i = threadIdx.x; i < 3 * num_pillars; i += blockDim.x) {
      s_pil[i] = pillars[(size_t)k * 3 * num_pillars + i];
    }
    for (int i = threadIdx.x; i < NS; i += blockDim.x) s_sc[i] = scalars[(size_t)k * NS + i];
    __syncthreads();

    float vals[kNumSums + kMaxBasis + 1];
#pragma unroll
    for (int v = 0; v < kNumSums + kMaxBasis + 1; ++v) vals[v] = 0.0f;
    float new_inv = 0.0f;
    if (valid) {
      float x[kMaxFactors];
#pragma unroll
      for (int f = 0; f < kMaxFactors; ++f) {
        if (f < F) x[f] = factors[((size_t)k * F + f) * num_sims + s];
      }
      const float spot = spot_of(s_sc + kDrift, x, F);
      float xn1[kMaxBasis + 1];
      design_row(bd, spot, x, xn1);
#pragma unroll
      for (int b = 0; b < kMaxBasis; ++b) {
        if (b < B) xn1[b] = (xn1[b] - s_mu[b]) / s_sd[b];
      }
#pragma unroll
      for (int b = 0; b <= kMaxBasis; ++b) {
        if (b == B) xn1[b] = 1.0f;
      }

      float min_rate, max_rate;
      interp_rates(s_pil, num_pillars, interp_kind, inv, &min_rate, &max_rate);
      const float lo = s_sc[kLo];
      const float hi = s_sc[kHi];
      const float loss_amt = s_sc[kLoss] * inv;
      float yw, yi;
      clipped_decision_bounds(min_rate, max_rate, inv, loss_amt, lo, hi, &yw, &yi);
      const bool has_zero = (yw < 0.0f) && (yi > 0.0f);
      const float decisions[kNumDecisions] = {yw, has_zero ? 0.0f : yi, yi};

      float best_total = 0.0f, best_vol = 0.0f, best_consumed = 0.0f, best_imm = 0.0f;
#pragma unroll
      for (int di = 0; di < kNumDecisions; ++di) {
        const float d = decisions[di];
        const float after = (inv + d) - loss_amt;
        int j;
        float w;
        frac_index(after, lo, hi, G, &j, &w);
        const float* t0 = s_tab + j * B1;
        const float* t1 = t0 + B1;
        float cont = 0.0f;
#pragma unroll
        for (int b = 0; b <= kMaxBasis; ++b) {
          if (b <= B) cont = cont + xn1[b] * (t0[b] * (1.0f - w) + t1[b] * w);
        }
        const bool inject = d > 0.0f;
        const float abs_d = fabsf(d);
        const float consumed = inject ? s_sc[kConsInject] * abs_d : s_sc[kConsWithdraw] * abs_d;
        const float iw_cost = inject ? s_sc[kInjectCost] * abs_d : s_sc[kWithdrawCost] * abs_d;
        const float cost = (iw_cost + s_sc[kInvCostRate] * inv) * s_sc[kDfCost];
        const float price_coeff = -(d + consumed) * s_sc[kDfSettle];
        const float imm = price_coeff * spot + (-cost);
        const float total = imm + cont;
        if (di == 0 || total > best_total) {
          best_total = total;
          best_vol = d;
          best_consumed = consumed;
          best_imm = imm;
        }
      }
      const float net = -best_vol - best_consumed;
      vals[0] = inv;
      vals[1] = best_vol;
      vals[2] = best_consumed;
      vals[3] = loss_amt;
      vals[4] = net;
      vals[5] = best_imm;
      vals[6] = net * spot;
#pragma unroll
      for (int b = 0; b <= kMaxBasis; ++b) {
        if (b <= B) vals[kNumSums + b] = xn1[b];
      }
      new_inv = inv + best_vol - loss_amt;
      pv = pv + best_imm;
    }
#pragma unroll
    for (int v = 0; v < kNumSums + kMaxBasis + 1; ++v) {
      if (v < NV) {
        const float r = warp_sum(vals[v]);
        if (lane == 0) s_red[warp * NV + v] = r;
      }
    }
    __syncthreads();
    if (threadIdx.x < NV) {
      float acc = 0.0f;
      for (int w = 0; w < nwarps; ++w) acc += s_red[w * NV + threadIdx.x];
      const size_t row = (size_t)blockIdx.x * num_steps + k;
      if (threadIdx.x < kNumSums) {
        sums_part[row * kNumSums + threadIdx.x] = acc;
      } else {
        xsums_part[row * B1 + (threadIdx.x - kNumSums)] = acc;
      }
    }
    inv = new_inv;
  }
  if (valid) {
    inv_out[s] = inv;
    pv_out[s] = pv;
  }
}

}  // namespace storage_kernels

using namespace storage_kernels;

// Launches forward_sim_kernel on `stream`; returns the cudaError_t of the
// launch (0 on success). spot_pow / fac_pow are host arrays.
extern "C" int forward_sim_launch(
    const float* factors, const float* inv0, const float* tables, const float* mus,
    const float* sds, const float* pillars, const float* scalars, float* sums_part,
    float* xsums_part, float* inv_out, float* pv_out, long long num_sims, int num_steps,
    int num_grid, int num_pillars, int interp_kind, int num_basis, int num_factors,
    const int* spot_pow, const int* fac_pow, int block, void* stream) {
  if (num_basis < 1 || num_basis > kMaxBasis || num_factors < 1 || num_factors > kMaxFactors ||
      block % kWarp != 0 || block <= 0 || num_grid < 2 || num_pillars < 1 ||
      (interp_kind != kInterpLinear && interp_kind != kInterpStep)) {
    return (int)cudaErrorInvalidValue;
  }
  const BasisDesc bd = make_basis_desc(num_basis, num_factors, spot_pow, fac_pow);
  const int B1 = num_basis + 1;
  const size_t smem = sizeof(float) * ((size_t)num_grid * B1 + 2 * num_basis + 3 * num_pillars +
                                       kNumFixed + num_factors +
                                       (size_t)(block / kWarp) * (kNumSums + B1));
  cudaError_t err = cudaFuncSetAttribute(forward_sim_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nblk = (num_sims + block - 1) / block;
  forward_sim_kernel<<<(unsigned)nblk, block, smem, (cudaStream_t)stream>>>(
      factors, inv0, tables, mus, sds, pillars, scalars, sums_part, xsums_part, inv_out, pv_out,
      num_sims, num_steps, num_grid, num_pillars, interp_kind, bd);
  return (int)cudaGetLastError();
}

extern "C" const char* storage_kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
