// The LSMC forward pass over a span of steps.
//
// Replaces the TPU kernel storage_tpu/ops/pallas_forward.py::_forward_kernel.
// Plain PyTorch version: storage_tpu_torch/ops/forward.py::forward_sim_reference.
//
// What it computes. Each sim walks the span's n steps carrying its inventory
// and PV. At a step it builds its spot and standardized design row [B+1],
// looks up the ratchet rates at its inventory (LINEAR, STEP or POLY), forms
// the D = 2 extra + 3 decisions of bang_bang_decisions_fixed from
// clipped_decision_bounds and the slot weights dweights [4, D], evaluates the
// fitted continuation at each decision's post-decision inventory by exact
// two-point interpolation of the step's [G, B+1] coefficient table
// (fractional_index semantics, clipped at the ends), adds the immediate NPV,
// and keeps the first-occurrence argmax (one decision at a time, so D is not
// bounded). Outputs: per step the 7 sums over sims (inventory, volume,
// consumed, loss, net volume, immediate PV, net volume x spot) and the
// design-row sums [B+1]; each sim's final inventory and PV; with a non-null
// `panels` [n, 6, S] (sims contiguous) the six per-sim fields of every step
// (pre-decision inventory, volume, consumed, loss, net volume, immediate PV).
//
// What bounds it on the H100. It must read the factor paths once
// (4 B x n x F x S: 4.08 GB at 340 x 3 x 1M, 1.22 ms at 3.35 TB/s) and, when
// asked, write the panels once (24 B per sim and step: 8.16 GB more). Its
// counted flops (chip_smoke.py::k2_bound) take 1.7 ms at 67 TFLOP/s. What it
// really spends is instruction slots. As compiled its step loop (two sims) is
// 3,619 instructions, the decision loop 236 of them per pass
// (tools/kernel_turns.py --sass): five separately rounded operations per
// basis term (see Rounding) and an IEEE division for the grid index in the
// decisions, B IEEE divisions at a dozen instructions each and the reading
// of a basis known only at run time in the design row, 7 + B + 1 butterflies
// for the sums. Were the whole loop executed every step, 1M sims x 340 steps
// would take about 20 ms at one instruction per scheduler and clock (132 SMs
// x 4 schedulers, 1.76-1.98 GHz); the kernel takes 21-22 ms, with or
// without panels. Taking parts out moves the time in
// proportion to their instructions (PERF.md): it is bound by instruction
// throughput, not by bytes, flops or shared memory.
//
// Design:
// - kR = 2 sims per thread, 128 threads per block, so a tile is 256 sims:
//   sim r of a thread is tile base + 128 r + thread, every load and store
//   coalesced. The kR sims are independent chains through each phase of a
//   step (rows, decisions, outputs), and a thread adds its sims' values
//   before any shuffle, so the 7 + B + 1 warp butterflies, the staging, the
//   reading of the basis and the barrier of a step are shared by kR sims.
//   Measured at 1, 2 and 4 (24.0 / 21.1 / 22.9 ms): at 4 the design rows in
//   registers cost resident blocks and the gain is lost. kFwdMinBlocks = 6
//   holds a thread to 80 registers (48 B of spills); 5 blocks at 96
//   registers were 0.7 ms slower.
// - A step's constants travel as one record: the table [G, 4 NQ] (rows
//   zero-padded to float4s), the (mu, sd) pairs, pillars and scalars, packed
//   by the wrapper into `records` [n, RL], RL a multiple of 4 floats. Record
//   k + 1 is copied into shared memory by 16-byte cp.async while step k
//   computes (double buffer), so a step begins with one wait and one
//   __syncthreads and nothing else stalls on the copy.
// - The design row. The powers 1..max of the spot and of each factor are
//   built once per sim and step as ipow's multiply chains, into a table of
//   this thread's own shared-memory words; column b is the product of its
//   variables' powers read back from there (BasisDesc::slot, a power of 0
//   skipped). Evaluating each column's powers in place instead, per sim,
//   through loops over exponents known only at run time, took 13 of 30 ms
//   at one sim per thread and 70 of 87 ms at four (the unrolled code outgrew
//   the instruction cache).
// - Table rows are read as float4s (NQ per row), and the grid spacing, the
//   inventory-cost term, the loss and the step's scalars are read or
//   computed once per step, outside the decision loop. Bank conflicts of the
//   per-sim row reads cost 0.5 ms (measured by sending every sim to one row).
// - A persistent grid (blocks per SM from the occupancy calculator x SMs, at
//   most one block per tile) walks the tiles; a block's (tile, step) items
//   form one pipeline, so the next tile's first record is in flight during
//   this tile's last step. Each block keeps one [n, 7 + B + 1] partial: a
//   step's warp sums go through a double-buffered shared slot and are added
//   by their owner thread one item later (no second barrier), to the
//   block's partial in place from the second tile on. The wrapper sums the
//   partials over blocks. Every sum has a fixed order (sims of a thread,
//   butterfly, warps, tiles, blocks): reruns are bit-identical.
// - Shared memory: 2 RL + 4 D + 2 x 4 (7 + B + 1) + 128 kR (1 + sum of the
//   highest powers) floats: 19,824 B at G = 100, B = 10, D = 3, kR = 2 and
//   the main path's basis, independent of the horizon (no span limit).
//
// Rounding: every sum and product on the decision's path is rounded as the
// plain version's torch ops round it (__fmul_rn / __fadd_rn, no FMA
// contraction; the continuation is a sequential dot product there too), so
// the kernel and its plain version take the same decisions bit for bit
// wherever the library functions (expf) agree; a near-tie decision flips
// only where they do not. The zero padding of a table row adds exact zeros.
#include "storage_kernels.cuh"

namespace storage_kernels {

constexpr int kNumSums = 7;
constexpr int kNumPanelFields = 6;
constexpr int kFwdThreads = 128;
constexpr int kFwdWarps = kFwdThreads / kWarp;
constexpr int kR = 2;             // sims a thread carries
constexpr int kFwdMinBlocks = 6;  // resident blocks per SM the register bound allows
constexpr int kTile = kR * kFwdThreads;  // sims of a block's tile

// exp(drift + sum_f vol_f * x_f), each step rounded like the torch version
// (spot_of in storage_kernels.cuh lets nvcc contract).
__device__ __forceinline__ float spot_rn(const float* coef, const float* x, int num_factors) {
  float log_spot = coef[0];
#pragma unroll
  for (int f = 0; f < kMaxFactors; ++f) {
    if (f < num_factors) log_spot = __fadd_rn(log_spot, __fmul_rn(coef[1 + f], x[f]));
  }
  return expf(log_spot);
}

// Column layout of a record's scalars [11 + F] (ops/forward.py::pack_scalars).
enum Scalar {
  kLo = 0, kHi, kLoss, kInjectCost, kWithdrawCost, kConsInject, kConsWithdraw,
  kInvCostRate, kDfSettle, kDfCost, kDrift, kVols, kNumFixed = kVols
};

struct FwdOperands {
  const float* factors;   // [n, F, S]
  const float* inv0;      // [S] starting inventory
  const float* records;   // [n, RL] per-step table, (mu, sd) pairs, pillars, scalars
  const float* dweights;  // [4, D] decision slot weights
  float* part;            // [nblk, n, 7 + B+1] per-block sums
  float* inv_out;         // [S]
  float* pv_out;          // [S]
  float* panels;          // [n, 6, S] or null
  long long num_sims;     // S < 2^31
  int num_steps;
  int num_grid;
  int num_pillars;
  int pillar_cols;
  int interp_kind;
  int num_decisions;
  int rec_len;            // RL
};

// Floats of a record before padding to a multiple of 4: the table with rows
// of `pitch` floats, the (mu, sd) pairs, the pillars and the scalars.
__host__ __device__ constexpr int record_floats(int num_grid, int pitch, int num_basis,
                                                int num_pillars, int pillar_cols,
                                                int num_factors) {
  return num_grid * pitch + 2 * num_basis + num_pillars * pillar_cols + kNumFixed + num_factors;
}

// Start the asynchronous copy of one record into shared memory (one group).
__device__ __forceinline__ void stage_record(const float* src, float* dst, int rec_len) {
  for (int i = threadIdx.x * 4; i < rec_len; i += kFwdThreads * 4) cp_async16(dst + i, src + i);
  cp_async_commit();
}

template <int kNQ>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
    forward_sim_kernel(FwdOperands op, BasisDesc bd) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kPitch = 4 * kNQ;  // floats of a table row, and of a design row in registers
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int B = bd.num_basis;
  const int F = bd.num_factors;
  const int G = op.num_grid;
  const int D = op.num_decisions;
  const int C = op.pillar_cols;
  const int NV = kNumSums + B + 1;  // values reduced per step
  const int RL = op.rec_len;
  const int n = op.num_steps;
  const int nq = (B + 1 + 3) / 4;   // float4s of a row that hold terms
  const long long S = op.num_sims;

  float* s_rec = smem;                // [2, RL]
  float* s_dw = s_rec + 2 * RL;       // [4, D]
  float* s_red = s_dw + 4 * D;        // [2, warps, NV]
  // [slots, kR, threads] this thread's table of powers, at + tid
  float* s_pow = s_red + 2 * kFwdWarps * NV + tid;
  const int musd_off = G * kPitch;
  const int pil_off = musd_off + 2 * B;
  const int sc_off = pil_off + C * op.num_pillars;
  for (int i = tid; i < 4 * D; i += kFwdThreads) s_dw[i] = op.dweights[i];

  const long long ntiles = (S + kTile - 1) / kTile;
  const long long my_tiles = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long nitems = my_tiles * n;
  float* my_part = op.part + (size_t)blockIdx.x * n * NV;

  // The sums of one item (step `step` of a tile; its warps' slots in buffer
  // `slot` of s_red), by their owner thread: loaded and added here, stored by
  // the caller after its own work. Tiles after a block's first add to it.
  auto item_sum = [&](int slot, int step, bool first_tile, float** out) {
    const float* red = s_red + slot * kFwdWarps * NV;
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kFwdWarps; ++w) acc += red[w * NV + tid];
    *out = my_part + (size_t)step * NV + tid;
    return first_tile ? acc : **out + acc;
  };

  stage_record(op.records, s_rec, RL);
  int sim[kR];
  bool valid[kR];
  float inv[kR], pv[kR];

  int k = 0;             // the item's step
  long long my_tile = 0;  // and the index of its tile among this block's
  for (long long it = 0; it < nitems; ++it) {
    const int buf = (int)(it & 1);
    const int k_next = k + 1 < n ? k + 1 : 0;
    cp_async_wait_all();
    __syncthreads();  // record k has landed; the last item's shared reads and sums are done
    if (it + 1 < nitems) {
      stage_record(op.records + (size_t)k_next * RL, s_rec + (buf ^ 1) * RL, RL);
    }
    float* prev_out = nullptr;
    float prev_sum = 0.0f;
    if (it > 0 && tid < NV) {  // the item before: step k - 1, or the last tile's last step
      prev_sum = k > 0 ? item_sum(buf ^ 1, k - 1, my_tile == 0, &prev_out)
                       : item_sum(buf ^ 1, n - 1, my_tile == 1, &prev_out);
    }

    const float* s_tab = s_rec + buf * RL;
    const float* s_musd = s_tab + musd_off;  // [B, 2] (mu, sd) pairs
    const float* s_pil = s_tab + pil_off;
    const float* s_sc = s_tab + sc_off;

    if (k == 0) {  // a new tile: sims past the last one shadow it and write nothing
      const long long first = (blockIdx.x + my_tile * gridDim.x) * kTile + tid;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const long long s = first + r * kFwdThreads;
        valid[r] = s < S;
        sim[r] = (int)(valid[r] ? s : S - 1);
        inv[r] = op.inv0[sim[r]];
        pv[r] = 0.0f;
      }
    }
    const float lo = s_sc[kLo];
    const float hi = s_sc[kHi];
    const float span = hi - lo;
    const float gstep = span / (float)(G - 1);
    const bool span_pos = span > 0.0f;

    // Phase 1: each sim's spot, standardized design row and decision range.
    float xn[kR][kPitch];
    float spot[kR], loss_amt[kR], inv_cost[kR], yw[kR], yi[kR];
    int slot[kR];  // offset of the sim's slot weights in s_dw
    {
      float x[kR][kMaxFactors];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int f = 0; f < kMaxFactors; ++f) {
          if (f < F) x[r][f] = op.factors[((size_t)k * F + f) * S + sim[r]];
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) spot[r] = spot_rn(s_sc + kDrift, x[r], F);
      // The powers 1..max_pow of the spot and of each factor, as the multiply
      // chains of ipow, into this thread's table.
#pragma unroll
      for (int v = 0; v < kMaxVars; ++v) {
        if (v <= F && bd.max_pow[v] > 0) {
          float* slots = s_pow + (bd.pow_off[v] + 1) * kTile;
          float base[kR], power[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            base[r] = power[r] = v == 0 ? spot[r] : x[r][v > 0 ? v - 1 : 0];
            slots[r * kFwdThreads] = power[r];
          }
          for (int p = 2; p <= bd.max_pow[v]; ++p) {
            slots += kTile;
#pragma unroll
            for (int r = 0; r < kR; ++r) {
              power[r] = power[r] * base[r];
              slots[r * kFwdThreads] = power[r];
            }
          }
        }
      }
      // Column b = ((1 spot^p) x_0^p) ... as design_row multiplies it, each
      // power read from the table.
#pragma unroll
      for (int b = 0; b < kPitch; ++b) {
        if (b < kMaxBasis && b < B) {
          float col[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) col[r] = 1.0f;
#pragma unroll
          for (int v = 0; v < kMaxVars; ++v) {
            const int slot_bv = bd.slot[(b < kMaxBasis ? b : 0) * kMaxVars + v];
            if (slot_bv != 0) {  // a power of 0 multiplies by 1: skipped, the same bits
              const float* power = s_pow + slot_bv * kTile;
#pragma unroll
              for (int r = 0; r < kR; ++r) col[r] = col[r] * power[r * kFwdThreads];
            }
          }
          const float2 musd = reinterpret_cast<const float2*>(s_musd)[b];
#pragma unroll
          for (int r = 0; r < kR; ++r) xn[r][b] = (col[r] - musd.x) / musd.y;
        } else {
#pragma unroll
          for (int r = 0; r < kR; ++r) xn[r][b] = b == B ? 1.0f : 0.0f;
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        float min_rate, max_rate;
        interp_rates(s_pil, op.num_pillars, C, op.interp_kind, inv[r], &min_rate, &max_rate);
        loss_amt[r] = s_sc[kLoss] * inv[r];
        inv_cost[r] = __fmul_rn(s_sc[kInvCostRate], inv[r]);
        clipped_decision_bounds(min_rate, max_rate, inv[r], loss_amt[r], lo, hi, &yw[r], &yi[r]);
        // bang_bang_decisions_fixed: yw a_d + yi b_d when the range spans
        // zero, else yw (1 - f_d) + yi f_d; rounded as torch rounds it.
        slot[r] = (yw[r] < 0.0f) && (yi[r] > 0.0f) ? 0 : 2 * D;
      }
    }

    // Phase 2: the decisions, one at a time, the kR sims side by side.
    const float cons_inject = s_sc[kConsInject], cons_withdraw = s_sc[kConsWithdraw];
    const float inject_cost = s_sc[kInjectCost], withdraw_cost = s_sc[kWithdrawCost];
    const float df_cost = s_sc[kDfCost], df_settle = s_sc[kDfSettle];
    float best_total[kR], best_vol[kR], best_consumed[kR], best_imm[kR];
    for (int di = 0; di < D; ++di) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float d = __fadd_rn(__fmul_rn(yw[r], s_dw[slot[r] + di]),
                                  __fmul_rn(yi[r], s_dw[slot[r] + D + di]));
        const float after = (inv[r] + d) - loss_amt[r];
        int j;
        float w;
        frac_index(after, lo, gstep, span_pos, G, &j, &w);
        const float4* t0 = reinterpret_cast<const float4*>(s_tab + j * kPitch);
        const float4* t1 = t0 + kNQ;
        const float w0 = 1.0f - w;
        float cont = 0.0f;
#pragma unroll
        for (int q = 0; q < kNQ; ++q) {
          if (q < nq) {
            const float4 a = t0[q];
            const float4 c = t1[q];
            cont = __fadd_rn(cont, __fmul_rn(xn[r][4 * q],
                                             __fadd_rn(__fmul_rn(a.x, w0), __fmul_rn(c.x, w))));
            cont = __fadd_rn(cont, __fmul_rn(xn[r][4 * q + 1],
                                             __fadd_rn(__fmul_rn(a.y, w0), __fmul_rn(c.y, w))));
            cont = __fadd_rn(cont, __fmul_rn(xn[r][4 * q + 2],
                                             __fadd_rn(__fmul_rn(a.z, w0), __fmul_rn(c.z, w))));
            cont = __fadd_rn(cont, __fmul_rn(xn[r][4 * q + 3],
                                             __fadd_rn(__fmul_rn(a.w, w0), __fmul_rn(c.w, w))));
          }
        }
        const bool inject = d > 0.0f;
        const float abs_d = fabsf(d);
        const float consumed = (inject ? cons_inject : cons_withdraw) * abs_d;
        const float iw_cost = (inject ? inject_cost : withdraw_cost) * abs_d;
        const float cost = __fmul_rn(__fadd_rn(iw_cost, inv_cost[r]), df_cost);
        const float price_coeff = -(d + consumed) * df_settle;
        const float imm = __fadd_rn(__fmul_rn(price_coeff, spot[r]), -cost);
        const float total = imm + cont;
        if (di == 0 || total > best_total[r]) {
          best_total[r] = total;
          best_vol[r] = d;
          best_consumed[r] = consumed;
          best_imm[r] = imm;
        }
      }
    }

    // Phase 3: outputs, the next inventory, and this thread's sums over its sims.
    float vals[kNumSums + kPitch];
#pragma unroll
    for (int v = 0; v < kNumSums + kPitch; ++v) vals[v] = 0.0f;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float net = -best_vol[r] - best_consumed[r];
      const float fields[kNumSums] = {inv[r],        best_vol[r], best_consumed[r], loss_amt[r],
                                      net,           best_imm[r], net * spot[r]};
      if (valid[r]) {
#pragma unroll
        for (int v = 0; v < kNumSums; ++v) vals[v] += fields[v];
#pragma unroll
        for (int b = 0; b < kPitch; ++b) vals[kNumSums + b] += xn[r][b];
        if (op.panels != nullptr) {
#pragma unroll
          for (int f = 0; f < kNumPanelFields; ++f) {
            op.panels[((size_t)k * kNumPanelFields + f) * S + sim[r]] = fields[f];
          }
        }
      }
      inv[r] = inv[r] + best_vol[r] - loss_amt[r];
      pv[r] = pv[r] + best_imm[r];
      if (k == n - 1 && valid[r]) {
        op.inv_out[sim[r]] = inv[r];
        op.pv_out[sim[r]] = pv[r];
      }
    }
    float* red = s_red + (buf * kFwdWarps + warp) * NV;
#pragma unroll
    for (int v = 0; v < kNumSums + kPitch; ++v) {
      if (v < NV) {
        const float total = warp_sum(vals[v]);
        if (lane == 0) red[v] = total;
      }
    }
    if (prev_out != nullptr) *prev_out = prev_sum;
    k = k_next;
    my_tile += k_next == 0 ? 1 : 0;
  }
  __syncthreads();
  if (tid < NV) {  // the last item: the last tile's last step
    float* out;
    const float sum = item_sum((int)((nitems - 1) & 1), n - 1, my_tiles == 1, &out);
    *out = sum;
  }
}

namespace forward {

using KernelFn = void (*)(FwdOperands, BasisDesc);

// A table row of B + 1 floats is read as float4s: three up to B = 11, five
// beyond (the interface takes bases of up to kMaxBasis = 16 terms, as K1 does).
int quads_of(int num_basis) { return num_basis + 1 <= 12 ? 3 : 5; }

KernelFn kernel_for(int num_basis) {
  return quads_of(num_basis) == 5 ? forward_sim_kernel<5> : forward_sim_kernel<3>;
}

struct Shape {
  long long num_sims;
  int num_grid, num_basis, num_factors, num_pillars, pillar_cols, num_decisions;
  int num_slots;  // of the basis' table of powers (BasisDesc)
};

bool valid_shape(const Shape& sh) {
  return sh.num_sims >= 1 && sh.num_sims < (1LL << 31) && sh.num_basis >= 1 &&
         sh.num_basis <= kMaxBasis && sh.num_factors >= 1 && sh.num_factors <= kMaxFactors &&
         sh.num_grid >= 2 && sh.num_pillars >= 1 && sh.pillar_cols >= 3 &&
         sh.num_decisions >= 1;
}

int record_len(const Shape& sh) {
  const int used = record_floats(sh.num_grid, 4 * quads_of(sh.num_basis), sh.num_basis,
                                 sh.num_pillars, sh.pillar_cols, sh.num_factors);
  return (used + 3) / 4 * 4;
}

size_t smem_bytes(const Shape& sh) {
  return sizeof(float) * (2 * (size_t)record_len(sh) + 4 * (size_t)sh.num_decisions +
                          2 * (size_t)kFwdWarps * (kNumSums + sh.num_basis + 1) +
                          (size_t)sh.num_slots * kTile);
}

// Sets the kernel's dynamic shared memory and returns its persistent grid
// (blocks per SM from the occupancy calculator x SMs, at most one per tile).
cudaError_t persistent_grid(const Shape& sh, int* num_blocks) {
  const void* fn = reinterpret_cast<const void*>(kernel_for(sh.num_basis));
  const size_t smem = smem_bytes(sh);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kFwdThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  const long long ntiles = (sh.num_sims + kTile - 1) / kTile;
  const long long grid = (long long)per_sm * sms;
  *num_blocks = (int)(ntiles < grid ? ntiles : grid);
  return cudaSuccess;
}

}  // namespace forward
}  // namespace storage_kernels

using namespace storage_kernels;

// The floats of one table row in `records` for a basis of num_basis terms.
extern "C" int forward_sim_row_pitch(int num_basis) { return 4 * forward::quads_of(num_basis); }

// The number of blocks (= partials) forward_sim_launch takes for these
// shapes on the current device, or minus a cudaError_t.
extern "C" int forward_sim_blocks(long long num_sims, int num_grid, int num_basis,
                                  int num_factors, int num_pillars, int pillar_cols,
                                  int num_decisions, const int* spot_pow,
                                  const int* fac_pow) {
  forward::Shape sh = {num_sims,    num_grid,    num_basis,     num_factors,
                       num_pillars, pillar_cols, num_decisions, 1};
  if (!forward::valid_shape(sh)) return -(int)cudaErrorInvalidValue;
  sh.num_slots = make_basis_desc(num_basis, num_factors, spot_pow, fac_pow).num_slots;
  int nblk = 0;
  const cudaError_t err = forward::persistent_grid(sh, &nblk);
  return err == cudaSuccess ? nblk : -(int)err;
}

// Launches forward_sim_kernel on `stream` with `num_blocks` blocks (from
// forward_sim_blocks) writing partials [num_blocks, n, 7 + B+1]; returns the
// cudaError_t of the launch (0 on success). spot_pow / fac_pow are host
// arrays; panels may be null. POLY needs the two coefficient columns
// (pillar_cols = 5). `records` is [n, rec_len] as ops/forward.py::pack_records
// lays it out at forward_sim_row_pitch; a rec_len other than the kernel's own
// count is refused.
extern "C" int forward_sim_launch(
    const float* factors, const float* inv0, const float* records, const float* dweights,
    float* partials, float* inv_out, float* pv_out, float* panels, long long num_sims,
    int num_steps, int num_grid, int num_pillars, int pillar_cols, int interp_kind,
    int num_decisions, int num_basis, int num_factors, const int* spot_pow, const int* fac_pow,
    int rec_len, int num_blocks, void* stream) {
  forward::Shape sh = {num_sims,    num_grid,    num_basis,     num_factors,
                       num_pillars, pillar_cols, num_decisions, 1};
  const bool interp_ok = interp_kind == kInterpLinear || interp_kind == kInterpStep ||
                         (interp_kind == kInterpPoly && pillar_cols >= 5);
  if (!forward::valid_shape(sh) || !interp_ok || num_steps < 1 ||
      rec_len != forward::record_len(sh) || num_blocks < 1 ||
      num_blocks > (num_sims + kTile - 1) / kTile) {
    return (int)cudaErrorInvalidValue;
  }
  const BasisDesc bd = make_basis_desc(num_basis, num_factors, spot_pow, fac_pow);
  sh.num_slots = bd.num_slots;
  const FwdOperands op = {factors, inv0,    records,   dweights,  partials,    inv_out,
                          pv_out,  panels,  num_sims,  num_steps, num_grid,    num_pillars,
                          pillar_cols, interp_kind, num_decisions, rec_len};
  const void* fn = reinterpret_cast<const void*>(forward::kernel_for(num_basis));
  const size_t smem = forward::smem_bytes(sh);
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<FwdOperands*>(&op), const_cast<BasisDesc*>(&bd)};
  return (int)cudaLaunchKernel(fn, dim3(num_blocks), dim3(kFwdThreads), args, smem,
                               (cudaStream_t)stream);
}

extern "C" const char* storage_kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
