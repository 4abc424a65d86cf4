// The LSMC forward pass over a span of steps, in float64.
//
// The float64 instantiation of K2 (forward_sim.cu), which replaces the TPU
// kernel storage_tpu/ops/pallas_forward.py::_forward_kernel. The JAX package
// sends float64 to its XLA route (its Pallas kernels are float32 only); the
// H100 has native float64, so the port runs the same function in a kernel
// of its own. Plain PyTorch version:
// storage_tpu_torch/ops/forward.py::forward_sim_reference in float64.
//
// What it computes: the float32 kernel's function (see the head of
// forward_sim.cu) on double operands: per sim and step the spot, the
// standardized design row [B+1], the ratchet rates (LINEAR, STEP or POLY),
// the D = 2 extra + 3 decisions, the continuation of each decision by exact
// two-point interpolation of the step's [G, B+1] table, the first-occurrence
// argmax of immediate NPV + continuation; per step the 7 sums and the
// design-row sums [B+1]; each sim's final inventory and PV; optionally the
// six per-sim panel fields of every step.
//
// What bounds it on the H100: its operations. It must read the factor paths
// once (8 B x n x F x S: 8.2 GB at 340 x 3 x 1M, 2.4 ms at 3.35 TB/s) and
// do the flops chip_smoke.py::k2_bound counts (115 GFLOP there: 3.4 ms at the
// 34 TFLOP/s of float64 outside the tensor cores).
//
// Design (plain; making it fast is later work): one sim per thread, 256
// threads per block, a persistent grid (blocks per SM from the occupancy
// calculator x SMs, at most one per 256-sim tile) walking the tiles, each
// tile all n steps. A step's record (the table [G, B+1], the (mu, sd)
// pairs, the pillars and the scalars, packed by ops/forward.py::pack_records
// with a row pitch of B+1 doubles) is copied into shared memory by the block
// before the step; the step's sums are warp-reduced, then added over the
// warps by one owner thread per value into the block's [n, 7 + B+1] partial
// (fixed order; the wrapper sums the partials over blocks).
//
// Rounding: every product, sum and quotient is rounded as the plain
// version's torch ops round it (__dmul_rn / __dadd_rn / __dsub_rn / IEEE
// division, no FMA contraction; the continuation is the same sequential dot
// product; exp is the function torch's CUDA exp calls; the grid step is
// span x (1 / (G - 1)), as torch's CUDA division by a host scalar computes
// it), so the kernel takes the plain version's decisions and per-sim values
// bit for bit, near-ties between two decisions a few ulp apart included;
// only the sums over sims differ, by their order.
#include "storage_kernels_f64.cuh"

namespace storage_kernels {
namespace forward_f64 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kNumSums = 7;
constexpr int kNumPanelFields = 6;

// Column layout of a record's scalars [11 + F] (ops/forward.py::pack_scalars).
enum Scalar {
  kLo = 0, kHi, kLoss, kInjectCost, kWithdrawCost, kConsInject, kConsWithdraw,
  kInvCostRate, kDfSettle, kDfCost, kDrift, kVols, kNumFixed = kVols
};

struct Operands {
  const double* factors;   // [n, F, S]
  const double* inv0;      // [S] starting inventory
  const double* records;   // [n, RL] per-step table, (mu, sd) pairs, pillars, scalars
  const double* dweights;  // [4, D] decision slot weights
  double* part;            // [nblk, n, 7 + B+1] per-block sums
  double* inv_out;         // [S]
  double* pv_out;          // [S]
  double* panels;          // [n, 6, S] or null
  long long num_sims;
  int num_steps;
  int num_grid;
  int num_pillars;
  int pillar_cols;
  int interp_kind;
  int num_decisions;
  int rec_len;             // RL
};

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads) forward_sim_f64_kernel(Operands op, BasisDesc bd) {
  extern __shared__ double smem_f64[];
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int B = bd.num_basis;
  const int B1 = B + 1;
  const int F = bd.num_factors;
  const int G = op.num_grid;
  const int D = op.num_decisions;
  const int C = op.pillar_cols;
  const int NV = kNumSums + B1;  // values reduced per step
  const int RL = op.rec_len;
  const int n = op.num_steps;
  const long long S = op.num_sims;

  double* s_rec = smem_f64;          // [RL]
  double* s_dw = s_rec + RL;         // [4, D]
  double* s_red = s_dw + 4 * D;      // [warps, NV]
  const double* s_musd = s_rec + G * B1;
  const double* s_pil = s_musd + 2 * B;
  const double* s_sc = s_pil + C * op.num_pillars;
  for (int i = tid; i < 4 * D; i += kThreads) s_dw[i] = op.dweights[i];

  const long long ntiles = (S + kThreads - 1) / kThreads;
  bool first_tile = true;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, first_tile = false) {
    const long long s = tile * kThreads + tid;
    const bool valid = s < S;
    const long long sim = valid ? s : S - 1;  // a sim past the last one shadows it
    double inv = op.inv0[sim];
    double pv = 0.0;
    for (int k = 0; k < n; ++k) {
      __syncthreads();  // the last step's shared reads are done
      for (int i = tid; i < RL; i += kThreads) s_rec[i] = op.records[(size_t)k * RL + i];
      __syncthreads();

      double x[kMaxFactors];
#pragma unroll
      for (int f = 0; f < kMaxFactors; ++f) {
        if (f < F) x[f] = op.factors[((size_t)k * F + f) * S + sim];
      }
      const double spot = spot_of_f64(s_sc + kDrift, x, F);
      double xn[kMaxBasis + 1];
      design_row_f64(bd, spot, x, xn);
#pragma unroll
      for (int b = 0; b <= kMaxBasis; ++b) {
        if (b < B) xn[b] = __ddiv_rn(__dsub_rn(xn[b], s_musd[2 * b]), s_musd[2 * b + 1]);
        if (b == B) xn[b] = 1.0;
      }
      double min_rate, max_rate;
      interp_rates_f64(s_pil, op.num_pillars, C, op.interp_kind, inv, &min_rate, &max_rate);
      const double lo = s_sc[kLo], hi = s_sc[kHi];
      const double loss_amt = __dmul_rn(s_sc[kLoss], inv);
      double yw, yi;
      clipped_bounds_f64(min_rate, max_rate, inv, loss_amt, lo, hi, &yw, &yi);
      const int slot = (yw < 0.0) && (yi > 0.0) ? 0 : 2 * D;
      const double span = __dsub_rn(hi, lo);
      // torch divides a CUDA tensor by a host scalar as a product with its
      // reciprocal (ops/interp.py::fractional_index's span / (G - 1)).
      const double gstep = __dmul_rn(span, __ddiv_rn(1.0, (double)(G - 1)));
      const bool span_pos = span > 0.0;
      const double inv_cost = __dmul_rn(s_sc[kInvCostRate], inv);

      double best_total = 0.0, best_vol = 0.0, best_consumed = 0.0, best_imm = 0.0;
      for (int di = 0; di < D; ++di) {
        const double d = __dadd_rn(__dmul_rn(yw, s_dw[slot + di]),
                                   __dmul_rn(yi, s_dw[slot + D + di]));
        const double after = __dsub_rn(__dadd_rn(inv, d), loss_amt);
        int j;
        double w;
        frac_index_f64(after, lo, gstep, span_pos, G, &j, &w);
        const double* t0 = s_rec + j * B1;
        const double* t1 = t0 + B1;
        const double w0 = __dsub_rn(1.0, w);
        double cont = 0.0;
#pragma unroll
        for (int b = 0; b <= kMaxBasis; ++b) {
          if (b < B1) {
            const double eff = __dadd_rn(__dmul_rn(t0[b], w0), __dmul_rn(t1[b], w));
            cont = __dadd_rn(cont, __dmul_rn(xn[b], eff));
          }
        }
        const bool inject = d > 0.0;
        const double abs_d = fabs(d);
        const double consumed = __dmul_rn(inject ? s_sc[kConsInject] : s_sc[kConsWithdraw], abs_d);
        const double iw_cost = __dmul_rn(inject ? s_sc[kInjectCost] : s_sc[kWithdrawCost], abs_d);
        const double cost = __dmul_rn(__dadd_rn(iw_cost, inv_cost), s_sc[kDfCost]);
        const double price_coeff = __dmul_rn(-__dadd_rn(d, consumed), s_sc[kDfSettle]);
        const double imm = __dadd_rn(__dmul_rn(price_coeff, spot), -cost);
        const double total = __dadd_rn(imm, cont);
        if (di == 0 || total > best_total) {  // first-occurrence argmax
          best_total = total;
          best_vol = d;
          best_consumed = consumed;
          best_imm = imm;
        }
      }

      const double net = __dsub_rn(-best_vol, best_consumed);
      const double fields[kNumSums] = {inv, best_vol, best_consumed, loss_amt,
                                       net, best_imm, __dmul_rn(net, spot)};
      if (valid && op.panels != nullptr) {
#pragma unroll
        for (int f = 0; f < kNumPanelFields; ++f) {
          op.panels[((size_t)k * kNumPanelFields + f) * S + s] = fields[f];
        }
      }
      double* red = s_red + warp * NV;
#pragma unroll
      for (int v = 0; v < kNumSums + kMaxBasis + 1; ++v) {
        if (v < NV) {
          const double val = !valid ? 0.0 : v < kNumSums ? fields[v < kNumSums ? v : 0]
                                                          : xn[v < kNumSums ? 0 : v - kNumSums];
          const double total = warp_sum_f64(val);
          if (lane == 0) red[v] = total;
        }
      }
      inv = __dsub_rn(__dadd_rn(inv, best_vol), loss_amt);
      pv = __dadd_rn(pv, best_imm);
      __syncthreads();  // the warps' sums are in s_red
      if (tid < NV) {
        double acc = 0.0;
        for (int w = 0; w < kWarps; ++w) acc += s_red[w * NV + tid];
        double* out = op.part + ((size_t)blockIdx.x * n + k) * NV + tid;
        *out = first_tile ? acc : *out + acc;
      }
    }
    if (valid) {
      op.inv_out[s] = inv;
      op.pv_out[s] = pv;
    }
  }
}

struct Shape {
  long long num_sims;
  int num_grid, num_basis, num_factors, num_pillars, pillar_cols, num_decisions;
};

bool valid_shape(const Shape& sh) {
  return sh.num_sims >= 1 && sh.num_sims < (1LL << 40) && sh.num_basis >= 1 &&
         sh.num_basis <= kMaxBasis && sh.num_factors >= 1 && sh.num_factors <= kMaxFactors &&
         sh.num_grid >= 2 && sh.num_pillars >= 1 && sh.pillar_cols >= 3 &&
         sh.num_decisions >= 1;
}

// Doubles of a record: the table [G, B+1], the (mu, sd) pairs, the pillars
// and the scalars, padded to a multiple of 4 as pack_records pads it.
int record_len(const Shape& sh) {
  const int used = sh.num_grid * (sh.num_basis + 1) + 2 * sh.num_basis +
                   sh.num_pillars * sh.pillar_cols + kNumFixed + sh.num_factors;
  return (used + 3) / 4 * 4;
}

size_t smem_bytes(const Shape& sh) {
  return sizeof(double) * ((size_t)record_len(sh) + 4 * (size_t)sh.num_decisions +
                           (size_t)kWarps * (kNumSums + sh.num_basis + 1));
}

cudaError_t grid(const Shape& sh, int* num_blocks) {
  return persistent_grid_f64(reinterpret_cast<const void*>(forward_sim_f64_kernel), kThreads,
                             smem_bytes(sh), (sh.num_sims + kThreads - 1) / kThreads, num_blocks);
}

}  // namespace forward_f64
}  // namespace storage_kernels

using namespace storage_kernels;

// The doubles of one table row in `records` for a basis of num_basis terms.
extern "C" int forward_sim_f64_row_pitch(int num_basis) { return num_basis + 1; }

// The number of blocks (= partials) forward_sim_f64_launch takes for these
// shapes on the current device, or minus a cudaError_t. spot_pow / fac_pow
// are taken for the interface's sake (forward_sim_blocks' signature).
extern "C" int forward_sim_f64_blocks(long long num_sims, int num_grid, int num_basis,
                                      int num_factors, int num_pillars, int pillar_cols,
                                      int num_decisions, const int* spot_pow,
                                      const int* fac_pow) {
  (void)spot_pow;
  (void)fac_pow;
  const forward_f64::Shape sh = {num_sims,    num_grid,    num_basis,    num_factors,
                                 num_pillars, pillar_cols, num_decisions};
  if (!forward_f64::valid_shape(sh)) return -(int)cudaErrorInvalidValue;
  int nblk = 0;
  const cudaError_t err = forward_f64::grid(sh, &nblk);
  return err == cudaSuccess ? nblk : -(int)err;
}

// forward_sim_launch's interface in float64: every floating-point operand is
// double and `records` is [n, rec_len] as ops/forward.py::pack_records lays
// it out at forward_sim_f64_row_pitch (a rec_len other than the kernel's own
// count is refused). Returns the cudaError_t of the launch (0 on success).
extern "C" int forward_sim_f64_launch(
    const double* factors, const double* inv0, const double* records, const double* dweights,
    double* partials, double* inv_out, double* pv_out, double* panels, long long num_sims,
    int num_steps, int num_grid, int num_pillars, int pillar_cols, int interp_kind,
    int num_decisions, int num_basis, int num_factors, const int* spot_pow, const int* fac_pow,
    int rec_len, int num_blocks, void* stream) {
  const forward_f64::Shape sh = {num_sims,    num_grid,    num_basis,    num_factors,
                                 num_pillars, pillar_cols, num_decisions};
  const bool interp_ok = interp_kind == kInterpLinear || interp_kind == kInterpStep ||
                         (interp_kind == kInterpPoly && pillar_cols >= 5);
  if (!forward_f64::valid_shape(sh) || !interp_ok || num_steps < 1 ||
      rec_len != forward_f64::record_len(sh) || num_blocks < 1 ||
      num_blocks > (num_sims + forward_f64::kThreads - 1) / forward_f64::kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const BasisDesc bd = make_basis_desc(num_basis, num_factors, spot_pow, fac_pow);
  const forward_f64::Operands op = {factors,     inv0,        records,     dweights,
                                    partials,    inv_out,     pv_out,      panels,
                                    num_sims,    num_steps,   num_grid,    num_pillars,
                                    pillar_cols, interp_kind, num_decisions, rec_len};
  const size_t smem = forward_f64::smem_bytes(sh);
  const void* fn = reinterpret_cast<const void*>(forward_f64::forward_sim_f64_kernel);
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  forward_f64::forward_sim_f64_kernel<<<num_blocks, forward_f64::kThreads, smem,
                                        (cudaStream_t)stream>>>(op, bd);
  return (int)cudaGetLastError();
}
