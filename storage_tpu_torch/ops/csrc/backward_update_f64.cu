// One backward LSMC period in float64: the value-surface update and the
// regression partials of the period before it.
//
// The float64 instantiation of K1 (backward_update.cu), which replaces the
// TPU kernel storage_tpu/ops/pallas_backward.py::_backward_kernel. The JAX
// package sends float64 to its XLA route (its Pallas kernels are float32
// only); the H100 has native float64, so the port runs the same function in
// a kernel of its own. Plain PyTorch version:
// storage_tpu_torch/ops/backward.py::backward_update_reference in float64.
//
// What it computes: the float32 kernel's function (see the head of
// backward_update.cu) on double operands. Per sim, grid point g and decision
// d the fitted total table[d,g,:B] . xn + table[d,g,B] + table[d,g,B+1] spot;
// the first-occurrence argmax over d picks the actual total
//   (V[j] - vbar[j]) (1 - w) + (V[j+1] - vbar[j+1]) w + affine + price spot
// written to V_out[g]; the previous period's design row xr [B+1] contracted
// with itself (graw) and with V_out - vbar (praw).
//
// What bounds it on the H100: the bytes, 2 x 8 B x G x S for V_next and V_out
// (1.6 GB at 1M sims, G = 100: 0.48 ms at 3.35 TB/s), against D G (2B + 3)
// + 10 G + 2 (B+1)(G + B+1) flops per sim (10.3 GFLOP at D = 3, 0.30 ms at
// the 34 TFLOP/s of float64 outside the tensor cores).
//
// Design (plain; making it fast is later work): one sim per thread, 128
// threads per block, a persistent grid (blocks per SM from the occupancy
// calculator x SMs, at most one per 128-sim tile) walking the tiles. The
// table rows, j and w are read from global memory at addresses uniform over
// the warp (L1 broadcasts). G is walked in chunks of 16 grid points: each
// sim's centred new values go into a [16, 128] shared tile, and the block
// contracts it with the [B+1, 128] tile of design rows (rows padded by one
// double against bank conflicts); each praw and graw entry has one owner
// thread and a fixed order, accumulated over the block's tiles in its
// [B+1, G + B+1] partial, which the wrapper sums over blocks.
//
// Rounding: the fitted totals are an FMA chain in b order, then
// fma(price, spot, dot + affine) (torch takes them from a matrix product
// whose order it does not fix, so near-tie decisions may flip; chip_smoke
// counts them). The design rows and the winner's actual total are rounded
// as the plain version's torch ops round them, so a V entry whose decision
// did not flip is the plain version's bit for bit.
#include "storage_kernels_f64.cuh"

namespace storage_kernels {
namespace backward_f64 {

constexpr int kThreads = 128;         // threads per block = sims per tile
constexpr int kChunk = 16;            // grid points per chunk
constexpr int kPitch = kThreads + 1;  // row pitch of the shared tiles (doubles)

struct Operands {
  const double* f_cur;   // [F, S] factors of this period
  const double* f_prev;  // [F, S] factors of the previous period
  const double* v_next;  // [G, S] next-period values
  double* v_out;         // [G, S] this-period values
  const double* table;   // [D, G, B+2] fitted tables + affine columns
  const double* vbar;    // [G] sim-mean of v_next
  const double* musd;    // [2, B] standardization mean / scale
  const int* geom_j;     // [D, G] lower interpolation index
  const double* geom_w;  // [D, G] upper interpolation weight
  const double* scal;    // [2, 1+F] (drift, vols) this / previous period
  double* part;          // [nblk, B+1, G + B+1] per-block (praw | graw)
  long long num_sims;
  int num_grid;
  int num_decisions;
};

// Standardized design row (col - mu) / sd of one sim's factors x.
__device__ __forceinline__ double standardized_row(const BasisDesc& bd, const double* musd,
                                                   const double* scal, const double* x,
                                                   double (&row)[kMaxBasis + 1]) {
  const int B = bd.num_basis;
  const double spot = spot_of_f64(scal, x, bd.num_factors);
  design_row_f64(bd, spot, x, row);
#pragma unroll
  for (int b = 0; b < kMaxBasis; ++b) {
    if (b < B) row[b] = __ddiv_rn(__dsub_rn(row[b], musd[b]), musd[B + b]);
  }
  return spot;
}

__global__ void __launch_bounds__(kThreads)
    backward_update_f64_kernel(Operands op, BasisDesc bd) {
  __shared__ double s_xr[(kMaxBasis + 1) * kPitch];  // previous period's design rows
  __shared__ double s_vc[kChunk * kPitch];           // centred new values of a chunk
  const int tid = threadIdx.x;
  const int B = bd.num_basis;
  const int F = bd.num_factors;
  const int B1 = B + 1;
  const int G = op.num_grid;
  const int D = op.num_decisions;
  const long long S = op.num_sims;
  const int part_row = G + B1;
  double* my_part = op.part + (size_t)blockIdx.x * B1 * part_row;
  const long long ntiles = (S + kThreads - 1) / kThreads;

  bool first_tile = true;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, first_tile = false) {
    const long long s = tile * kThreads + tid;
    const bool valid = s < S;
    double xn[kMaxBasis + 1], xr[kMaxBasis + 1];
#pragma unroll
    for (int b = 0; b <= kMaxBasis; ++b) xn[b] = xr[b] = 0.0;
    double spot = 0.0;
    if (valid) {
      double fc[kMaxFactors], fp[kMaxFactors];
#pragma unroll
      for (int f = 0; f < kMaxFactors; ++f) {
        if (f < F) {
          fc[f] = op.f_cur[(size_t)f * S + s];
          fp[f] = op.f_prev[(size_t)f * S + s];
        }
      }
      spot = standardized_row(bd, op.musd, op.scal, fc, xn);
      standardized_row(bd, op.musd, op.scal + 1 + F, fp, xr);
#pragma unroll
      for (int b = 0; b <= kMaxBasis; ++b) {
        if (b == B) xr[b] = 1.0;
      }
    }
    __syncthreads();  // the last tile's products have read s_xr
#pragma unroll
    for (int b = 0; b <= kMaxBasis; ++b) {
      if (b < B1) s_xr[b * kPitch + tid] = xr[b];
    }

    for (int g0 = 0; g0 < G; g0 += kChunk) {
      const int gcount = min(kChunk, G - g0);
      for (int gl = 0; gl < gcount; ++gl) {
        const int g = g0 + gl;
        double best_fit = 0.0;
        int best = 0;
        for (int d = 0; d < D; ++d) {
          const double* row = op.table + ((size_t)d * G + g) * (B + 2);
          double dot = 0.0;
#pragma unroll
          for (int b = 0; b < kMaxBasis; ++b) {
            if (b < B) dot = __fma_rn(__ldg(row + b), xn[b], dot);
          }
          const double fit = __fma_rn(__ldg(row + B + 1), spot, __dadd_rn(dot, __ldg(row + B)));
          if (d == 0 || fit > best_fit) {  // first-occurrence argmax
            best_fit = fit;
            best = d;
          }
        }
        double vc = 0.0;
        if (valid) {
          const size_t dg = (size_t)best * G + g;
          const int j = __ldg(op.geom_j + dg);
          const double w = __ldg(op.geom_w + dg);
          const double* row = op.table + dg * (B + 2);
          const double v0 = __dsub_rn(op.v_next[(size_t)j * S + s], __ldg(op.vbar + j));
          const double v1 = __dsub_rn(op.v_next[(size_t)(j + 1) * S + s], __ldg(op.vbar + j + 1));
          const double lin = __dadd_rn(__dmul_rn(v0, __dsub_rn(1.0, w)), __dmul_rn(v1, w));
          const double act =
              __dadd_rn(__dadd_rn(lin, __ldg(row + B)), __dmul_rn(__ldg(row + B + 1), spot));
          op.v_out[(size_t)g * S + s] = act;
          vc = __dsub_rn(act, __ldg(op.vbar + g));
        }
        s_vc[gl * kPitch + tid] = vc;
      }
      __syncthreads();  // the chunk's vc tile is complete
      // praw[a, g0 + gl] += xr[a, tile] . vc[gl, tile], one owner per entry.
      for (int e = tid; e < gcount * B1; e += kThreads) {
        const int a = e / gcount;
        const int gl = e - a * gcount;
        double sum = 0.0;
        for (int t = 0; t < kThreads; ++t) {
          sum = __fma_rn(s_xr[a * kPitch + t], s_vc[gl * kPitch + t], sum);
        }
        double* out = my_part + (size_t)a * part_row + g0 + gl;
        *out = first_tile ? sum : __dadd_rn(*out, sum);
      }
      __syncthreads();  // the next chunk may overwrite s_vc
    }
    // graw += xr[:, tile] xr[:, tile]'.
    for (int e = tid; e < B1 * B1; e += kThreads) {
      const int a = e / B1;
      const int b = e - a * B1;
      double sum = 0.0;
      for (int t = 0; t < kThreads; ++t) {
        sum = __fma_rn(s_xr[a * kPitch + t], s_xr[b * kPitch + t], sum);
      }
      double* out = my_part + (size_t)a * part_row + G + b;
      *out = first_tile ? sum : __dadd_rn(*out, sum);
    }
  }
}

bool valid_shape(long long num_sims, int num_decisions, int num_basis, int num_factors) {
  return num_sims >= 1 && num_sims < (1LL << 40) && num_basis >= 1 && num_basis <= kMaxBasis &&
         num_factors >= 1 && num_factors <= kMaxFactors && num_decisions >= 1;
}

cudaError_t grid(long long num_sims, int* num_blocks) {
  return persistent_grid_f64(reinterpret_cast<const void*>(backward_update_f64_kernel), kThreads,
                             0, (num_sims + kThreads - 1) / kThreads, num_blocks);
}

}  // namespace backward_f64
}  // namespace storage_kernels

using namespace storage_kernels;

// The number of blocks (= partials) backward_update_f64_launch takes for
// these shapes on the current device, or minus a cudaError_t.
extern "C" int backward_update_f64_blocks(long long num_sims, int num_decisions, int num_basis) {
  if (!backward_f64::valid_shape(num_sims, num_decisions, num_basis, 1)) {
    return -(int)cudaErrorInvalidValue;
  }
  int nblk = 0;
  const cudaError_t err = backward_f64::grid(num_sims, &nblk);
  return err == cudaSuccess ? nblk : -(int)err;
}

// backward_update_launch's interface in float64: every floating-point
// operand is double. Returns the cudaError_t of the launch (0 on success).
extern "C" int backward_update_f64_launch(
    const double* f_cur, const double* f_prev, const double* v_next, double* v_out,
    const double* table, const double* vbar, const double* musd, const int* geom_j,
    const double* geom_w, const double* scal, double* partials, long long num_sims, int num_grid,
    int num_decisions, int num_basis, int num_factors, const int* spot_pow, const int* fac_pow,
    int num_blocks, void* stream) {
  if (!backward_f64::valid_shape(num_sims, num_decisions, num_basis, num_factors) ||
      num_grid < 2 || num_blocks < 1 ||
      num_blocks > (num_sims + backward_f64::kThreads - 1) / backward_f64::kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const BasisDesc bd = make_basis_desc(num_basis, num_factors, spot_pow, fac_pow);
  const backward_f64::Operands op = {f_cur,  f_prev, v_next,   v_out,    table,
                                     vbar,   musd,   geom_j,   geom_w,   scal,
                                     partials, num_sims, num_grid, num_decisions};
  backward_f64::backward_update_f64_kernel<<<num_blocks, backward_f64::kThreads, 0,
                                             (cudaStream_t)stream>>>(op, bd);
  return (int)cudaGetLastError();
}
