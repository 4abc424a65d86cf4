// One backward LSMC period: the value-surface update and the regression
// partials of the period before it.
//
// Replaces the TPU kernel storage_tpu/ops/pallas_backward.py::_backward_kernel
// (body _backward_tile). Plain PyTorch version:
// storage_tpu_torch/ops/backward.py::backward_update_reference.
//
// One thread per simulation; V is held [G, S] with sims contiguous. For each
// grid point g and decision d the thread evaluates
//   fitted_dg = table[d,g,:B] . xn + table[d,g,B] + table[d,g,B+1] * spot
//   actual_dg = (1-w) (V[j] - vbar[j]) + w (V[j+1] - vbar[j+1])
//               + table[d,g,B] + table[d,g,B+1] * spot
// with (j, w) = geometry[d, g], takes the first-occurrence argmax over d on
// the fitted totals and writes the chosen actual total to V_out[g]. The
// table folds the interpolation through the regression coefficients, so the
// fitted continuation costs B multiply-adds per (g, d) instead of a [G, G]
// product. (j, w) depend only on the grid geometry, so the two V rows a
// warp reads for one (g, d) are coalesced, and every shared-memory read is a
// broadcast (all lanes read the same table entry).
//
// V_out is a separate buffer: a thread reads rows of V_next for every g, so
// writing in place would overwrite rows a later g still needs.
//
// Regression partials for period k-1 (the TPU kernel's second output): the
// previous period's design row, standardized with this period's (mu, sd) and
// with a trailing ones row, contracted with itself (graw [B+1, B+1]) and with
// the new centred surface V_out - vbar (praw [B+1, G]). They are reduced
// deterministically: a warp butterfly, one shared-memory slot per warp, a
// fixed-order sum over the warps, and one partial per thread block
// ([nblk, ...]), which the wrapper sums over blocks. No float atomics.
//
// Bound on the H100: V is read once from DRAM and written once per step
// (2 x 4 B x G x S); the 2 D G row reads per sim hit L1. The arithmetic is
// D G (B + 6) FMAs per sim plus (B + 1) G warp reductions for praw, which
// is what the kernel spends most of its time on.
#include "storage_kernels.cuh"

namespace storage_kernels {

__global__ void backward_update_kernel(
    const float* __restrict__ f_cur,    // [F, S] factors of this period
    const float* __restrict__ f_prev,   // [F, S] factors of the previous period
    const float* __restrict__ v_next,   // [G, S] next-period values
    float* __restrict__ v_out,          // [G, S] this-period values
    const float* __restrict__ table,    // [D, G, B+2] fitted tables + affine columns
    const float* __restrict__ vbar,     // [G] sim-mean of v_next
    const float* __restrict__ musd,     // [2, B] standardization mean / scale
    const int* __restrict__ geom_j,     // [D, G] lower interpolation index
    const float* __restrict__ geom_w,   // [D, G] upper interpolation weight
    const float* __restrict__ scal,     // [2, 1+F] (drift, vols) this / previous period
    float* __restrict__ graw_part,      // [nblk, B+1, B+1]
    float* __restrict__ praw_part,      // [nblk, B+1, G]
    long long num_sims, int num_grid, int num_decisions, BasisDesc bd) {
  extern __shared__ float smem[];
  const int B = bd.num_basis;
  const int F = bd.num_factors;
  const int B1 = B + 1;
  const int B2 = B + 2;
  const int G = num_grid;
  const int DG = num_decisions * G;
  const int nwarps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;

  float* s_table = smem;                     // DG * B2
  float* s_w = s_table + DG * B2;            // DG
  int* s_j = reinterpret_cast<int*>(s_w + DG);  // DG
  float* s_vbar = reinterpret_cast<float*>(s_j + DG);  // G
  float* s_praw = s_vbar + G;                // nwarps * B1 * G
  float* s_graw = s_praw + nwarps * B1 * G;  // nwarps * B1 * B1

  for (int i = threadIdx.x; i < DG * B2; i += blockDim.x) s_table[i] = table[i];
  for (int i = threadIdx.x; i < DG; i += blockDim.x) {
    s_w[i] = geom_w[i];
    s_j[i] = geom_j[i];
  }
  for (int i = threadIdx.x; i < G; i += blockDim.x) s_vbar[i] = vbar[i];
  __syncthreads();

  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = s < num_sims;

  float xn[kMaxBasis];       // this period's standardized design row
  float xr[kMaxBasis + 1];   // previous period's, approx-standardized, ones row last
  float spot = 0.0f;
#pragma unroll
  for (int b = 0; b < kMaxBasis; ++b) xn[b] = 0.0f;
#pragma unroll
  for (int b = 0; b <= kMaxBasis; ++b) xr[b] = 0.0f;
  if (valid) {
    float fc[kMaxFactors], fp[kMaxFactors];
#pragma unroll
    for (int f = 0; f < kMaxFactors; ++f) {
      if (f < F) {
        fc[f] = f_cur[(size_t)f * num_sims + s];
        fp[f] = f_prev[(size_t)f * num_sims + s];
      }
    }
    spot = spot_of(scal, fc, F);
    design_row(bd, spot, fc, xn);
    const float spot_prev = spot_of(scal + 1 + F, fp, F);
    design_row(bd, spot_prev, fp, xr);
#pragma unroll
    for (int b = 0; b < kMaxBasis; ++b) {
      if (b < B) {
        xn[b] = (xn[b] - musd[b]) / musd[B + b];
        xr[b] = (xr[b] - musd[b]) / musd[B + b];
      }
    }
#pragma unroll
    for (int b = 0; b <= kMaxBasis; ++b) {
      if (b == B) xr[b] = 1.0f;
    }
  }

  for (int g = 0; g < G; ++g) {
    float best_fit = 0.0f;
    float best_act = 0.0f;
    for (int d = 0; d < num_decisions; ++d) {
      const int idx = d * G + g;
      const float* T = s_table + idx * B2;
      float fit = 0.0f;
#pragma unroll
      for (int b = 0; b < kMaxBasis; ++b) {
        if (b < B) fit = fit + T[b] * xn[b];
      }
      const float affine = T[B];
      const float price = T[B + 1];
      fit = fit + affine + price * spot;
      float act = 0.0f;
      if (valid) {
        const int j = s_j[idx];
        const float w = s_w[idx];
        const float v0 = __ldg(v_next + (size_t)j * num_sims + s) - s_vbar[j];
        const float v1 = __ldg(v_next + (size_t)(j + 1) * num_sims + s) - s_vbar[j + 1];
        act = v0 * (1.0f - w) + v1 * w + affine + price * spot;
      }
      // Decision 0 seeds unconditionally; later ones replace it only when
      // strictly better (first-occurrence argmax).
      if (d == 0 || fit > best_fit) {
        best_fit = fit;
        best_act = act;
      }
    }
    if (valid) v_out[(size_t)g * num_sims + s] = best_act;
    const float vc = valid ? best_act - s_vbar[g] : 0.0f;
#pragma unroll
    for (int a = 0; a <= kMaxBasis; ++a) {
      if (a <= B) {
        const float p = warp_sum(xr[a] * vc);
        if (lane == 0) s_praw[(warp * B1 + a) * G + g] = p;
      }
    }
  }

#pragma unroll
  for (int a = 0; a <= kMaxBasis; ++a) {
    if (a <= B) {
#pragma unroll
      for (int b = 0; b <= kMaxBasis; ++b) {
        if (b <= B) {
          const float p = warp_sum(xr[a] * xr[b]);
          if (lane == 0) s_graw[(warp * B1 + a) * B1 + b] = p;
        }
      }
    }
  }
  __syncthreads();

  // Fixed-order sum over the block's warps, one partial per block.
  for (int i = threadIdx.x; i < B1 * G; i += blockDim.x) {
    float acc = 0.0f;
    for (int w = 0; w < nwarps; ++w) acc += s_praw[w * B1 * G + i];
    praw_part[(size_t)blockIdx.x * B1 * G + i] = acc;
  }
  for (int i = threadIdx.x; i < B1 * B1; i += blockDim.x) {
    float acc = 0.0f;
    for (int w = 0; w < nwarps; ++w) acc += s_graw[w * B1 * B1 + i];
    graw_part[(size_t)blockIdx.x * B1 * B1 + i] = acc;
  }
}

}  // namespace storage_kernels

using namespace storage_kernels;

// Launches backward_update_kernel on `stream`; returns the cudaError_t of the
// launch (0 on success). Pointers are device pointers except spot_pow /
// fac_pow ([B] and [B, F] ints on the host).
extern "C" int backward_update_launch(
    const float* f_cur, const float* f_prev, const float* v_next, float* v_out,
    const float* table, const float* vbar, const float* musd, const int* geom_j,
    const float* geom_w, const float* scal, float* graw_part, float* praw_part,
    long long num_sims, int num_grid, int num_decisions, int num_basis, int num_factors,
    const int* spot_pow, const int* fac_pow, int block, void* stream) {
  if (num_basis < 1 || num_basis > kMaxBasis || num_factors < 1 || num_factors > kMaxFactors ||
      block % kWarp != 0 || block <= 0 || num_grid < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const BasisDesc bd = make_basis_desc(num_basis, num_factors, spot_pow, fac_pow);
  const int B1 = num_basis + 1;
  const int DG = num_decisions * num_grid;
  const size_t smem = sizeof(float) * ((size_t)DG * (num_basis + 2) + 2 * (size_t)DG + num_grid +
                                       (size_t)(block / kWarp) * B1 * (num_grid + B1));
  cudaError_t err = cudaFuncSetAttribute(backward_update_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nblk = (num_sims + block - 1) / block;
  backward_update_kernel<<<(unsigned)nblk, block, smem, (cudaStream_t)stream>>>(
      f_cur, f_prev, v_next, v_out, table, vbar, musd, geom_j, geom_w, scal, graw_part, praw_part,
      num_sims, num_grid, num_decisions, bd);
  return (int)cudaGetLastError();
}
