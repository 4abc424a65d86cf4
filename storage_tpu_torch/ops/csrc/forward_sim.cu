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
//   butterfly, slots, tiles, blocks): reruns are bit-identical.
// - Shared memory: 2 RL + 4 D + 2 x slots (7 + B + 1) + 128 kR (1 + sum of
//   the highest powers) elements, slots = 128 / kSumLanes (4 in float32, 32
//   in float64): 19,824 B at G = 100, B = 10, D = 3, kR = 2 and the main
//   path's basis in float32, independent of the horizon (no span limit).
//
// Float64 (K2Traits<double>), the same source and design with these
// differences:
// - Its counted flops take 0.636 ms a 64-step span at the 34 TFLOP/s of
//   float64 outside the tensor cores; the float64 pipe issues at half the
//   float32 rate, so the instruction slots bound it as in float32.
// - kR = 2 and three resident blocks (168 registers), measured against four
//   blocks (128 registers, 212 B spilled) and one sim per thread at four to
//   six blocks (PERF.md).
// - A step's sums are added over groups of kSumLanes = 4 lanes by
//   butterflies, not over the warp, into 32 slots a block that the owner
//   threads add one item later (float64 shuffles move two words each; the
//   warp's butterflies took 1.6 ms of a 9 ms span). The order is fixed, so
//   reruns are bit-identical.
// - Table rows are quads read as two double2; a record's rows have the
//   float32 pitch in elements (ops/forward.py::pack_records).
//
// Rounding: every sum and product on the decision's path is rounded as the
// plain version's torch ops round it. In float64 every operation is
// (TorchRounding: __dmul_rn / __dadd_rn / __dsub_rn, IEEE division), so the
// kernel takes the plain version's decisions and per-sim values bit for
// bit, near-ties between decisions 2e-13 apart included. In float32 the
// continuation, the decisions and the costs are written out with
// __fmul_rn / __fadd_rn and the few other products (the loss, the
// consumption) are left to nvcc (Contract). In both the grid step is
// span x (1 / (G - 1)), the product by the reciprocal that torch computes
// for a CUDA tensor divided by a host scalar (fractional_index): with the
// step divided, the float32 kernel flipped 17-79 of 1M paths on the main
// path's launches, with it none. The continuation is a sequential dot
// product, as in the plain version; the zero padding of a table row adds
// exact zeros.
#include "storage_kernels.cuh"

namespace storage_kernels {

constexpr int kNumSums = 7;
constexpr int kNumPanelFields = 6;
constexpr int kFwdThreads = 128;

// The constants of each instantiation and its rounding policy (see Rounding
// in the head of this file).
template <class T> struct K2Traits;

template <>
struct K2Traits<float> {
  using Round = Contract;
  static constexpr int kR = 2;             // sims a thread carries
  static constexpr int kFwdMinBlocks = 6;  // resident blocks per SM the register bound allows
  static constexpr int kSumLanes = kWarp;  // lanes a step's sums are added over by shuffles
};

template <>
struct K2Traits<double> {
  using Round = TorchRounding;
  static constexpr int kR = 2;
  static constexpr int kFwdMinBlocks = 3;
  static constexpr int kSumLanes = 4;
};

// Slots of a step's sums in a block: one per group of kSumLanes lanes.
template <class T>
__host__ __device__ constexpr int sum_slots() {
  return kFwdThreads / K2Traits<T>::kSumLanes;
}

// Sims of a block's tile.
template <class T>
__host__ __device__ constexpr int tile_sims() {
  return K2Traits<T>::kR * kFwdThreads;
}

// Column layout of a record's scalars [11 + F] (ops/forward.py::pack_scalars).
enum Scalar {
  kLo = 0, kHi, kLoss, kInjectCost, kWithdrawCost, kConsInject, kConsWithdraw,
  kInvCostRate, kDfSettle, kDfCost, kDrift, kVols, kNumFixed = kVols
};

template <class T>
struct FwdOperands {
  const T* factors;   // [n, F, S]
  const T* inv0;      // [S] starting inventory
  const T* records;   // [n, RL] per-step table, (mu, sd) pairs, pillars, scalars
  const T* dweights;  // [4, D] decision slot weights
  T* part;            // [nblk, n, 7 + B+1] per-block sums
  T* inv_out;         // [S]
  T* pv_out;          // [S]
  T* panels;          // [n, 6, S] or null
  long long num_sims;     // S < 2^31
  int num_steps;
  int num_grid;
  int num_pillars;
  int pillar_cols;
  int interp_kind;
  int num_decisions;
  int rec_len;            // RL
};

// Elements of a record before padding to a multiple of 4: the table with
// rows of `pitch` elements, the (mu, sd) pairs, the pillars and the scalars.
__host__ __device__ constexpr int record_elems(int num_grid, int pitch, int num_basis,
                                               int num_pillars, int pillar_cols,
                                               int num_factors) {
  return num_grid * pitch + 2 * num_basis + num_pillars * pillar_cols + kNumFixed + num_factors;
}

// Start the asynchronous copy of one record into shared memory (one group),
// 16 bytes at a time.
template <class T>
__device__ __forceinline__ void stage_record(const T* src, T* dst, int rec_len) {
  constexpr int kV = 16 / (int)sizeof(T);
  for (int i = threadIdx.x * kV; i < rec_len; i += kFwdThreads * kV) cp_async16(dst + i, src + i);
  cp_async_commit();
}

template <class T, int kNQ>
__global__ void __launch_bounds__(kFwdThreads, K2Traits<T>::kFwdMinBlocks)
    forward_sim_kernel(FwdOperands<T> op, BasisDesc bd) {
  using R = typename K2Traits<T>::Round;
  using Quad = typename Elem<T>::Quad;
  using Pair = typename Elem<T>::Pair;
  constexpr int kR = K2Traits<T>::kR;
  constexpr int kTile = tile_sims<T>();
  extern __shared__ __align__(16) float smem[];  // of T elements
  constexpr int kPitch = 4 * kNQ;  // elements of a table row, and of a design row in registers
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int B = bd.num_basis;
  const int F = bd.num_factors;
  const int G = op.num_grid;
  const int D = op.num_decisions;
  const int C = op.pillar_cols;
  const int NV = kNumSums + B + 1;  // values reduced per step
  const int RL = op.rec_len;
  const int n = op.num_steps;
  const int nq = (B + 1 + 3) / 4;   // quads of a row that hold terms
  const long long S = op.num_sims;

  T* s_rec = reinterpret_cast<T*>(smem);  // [2, RL]
  T* s_dw = s_rec + 2 * RL;           // [4, D]
  T* s_red = s_dw + 4 * D;            // [2, sum slots, NV]
  // [slots, kR, threads] this thread's table of powers, at + tid
  T* s_pow = s_red + 2 * sum_slots<T>() * NV + tid;
  const int musd_off = G * kPitch;
  const int pil_off = musd_off + 2 * B;
  const int sc_off = pil_off + C * op.num_pillars;
  for (int i = tid; i < 4 * D; i += kFwdThreads) s_dw[i] = op.dweights[i];

  const long long ntiles = (S + kTile - 1) / kTile;
  const long long my_tiles = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long nitems = my_tiles * n;
  T* my_part = op.part + (size_t)blockIdx.x * n * NV;

  // The sums of one item (step `step` of a tile; its warps' slots in buffer
  // `slot` of s_red), by their owner thread: loaded and added here, stored by
  // the caller after its own work. Tiles after a block's first add to it.
  auto item_sum = [&](int slot, int step, bool first_tile, T** out) {
    const T* red = s_red + slot * sum_slots<T>() * NV;
    T acc = T(0);
#pragma unroll
    for (int w = 0; w < sum_slots<T>(); ++w) acc += red[w * NV + tid];
    *out = my_part + (size_t)step * NV + tid;
    return first_tile ? acc : **out + acc;
  };

  stage_record(op.records, s_rec, RL);
  int sim[kR];
  bool valid[kR];
  T inv[kR], pv[kR];

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
    T* prev_out = nullptr;
    T prev_sum = T(0);
    if (it > 0 && tid < NV) {  // the item before: step k - 1, or the last tile's last step
      prev_sum = k > 0 ? item_sum(buf ^ 1, k - 1, my_tile == 0, &prev_out)
                       : item_sum(buf ^ 1, n - 1, my_tile == 1, &prev_out);
    }

    const T* s_tab = s_rec + buf * RL;
    const T* s_musd = s_tab + musd_off;  // [B, 2] (mu, sd) pairs
    const T* s_pil = s_tab + pil_off;
    const T* s_sc = s_tab + sc_off;

    if (k == 0) {  // a new tile: sims past the last one shadow it and write nothing
      const long long first = (blockIdx.x + my_tile * gridDim.x) * kTile + tid;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const long long s = first + r * kFwdThreads;
        valid[r] = s < S;
        sim[r] = (int)(valid[r] ? s : S - 1);
        inv[r] = op.inv0[sim[r]];
        pv[r] = T(0);
      }
    }
    const T lo = s_sc[kLo];
    const T hi = s_sc[kHi];
    const T span = hi - lo;
    // torch divides a CUDA tensor by a host scalar as a product with its
    // reciprocal (ops/interp.py::fractional_index's span / (G - 1)).
    const T gstep = mul_rn(span, T(1) / (T)(G - 1));
    const bool span_pos = span > T(0);

    // Phase 1: each sim's spot, standardized design row and decision range.
    T xn[kR][kPitch];
    T spot[kR], loss_amt[kR], inv_cost[kR], yw[kR], yi[kR];
    int slot[kR];  // offset of the sim's slot weights in s_dw
    {
      T x[kR][kMaxFactors];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int f = 0; f < kMaxFactors; ++f) {
          if (f < F) x[r][f] = op.factors[((size_t)k * F + f) * S + sim[r]];
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) spot[r] = spot_of<TorchRounding>(s_sc + kDrift, x[r], F);
      // The powers 1..max_pow of the spot and of each factor, as the multiply
      // chains of ipow, into this thread's table.
#pragma unroll
      for (int v = 0; v < kMaxVars; ++v) {
        if (v <= F && bd.max_pow[v] > 0) {
          T* slots = s_pow + (bd.pow_off[v] + 1) * kTile;
          T base[kR], power[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            base[r] = power[r] = v == 0 ? spot[r] : x[r][v > 0 ? v - 1 : 0];
            slots[r * kFwdThreads] = power[r];
          }
          for (int p = 2; p <= bd.max_pow[v]; ++p) {
            slots += kTile;
#pragma unroll
            for (int r = 0; r < kR; ++r) {
              power[r] = R::mul(power[r], base[r]);
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
          T col[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) col[r] = T(1);
#pragma unroll
          for (int v = 0; v < kMaxVars; ++v) {
            const int slot_bv = bd.slot[(b < kMaxBasis ? b : 0) * kMaxVars + v];
            if (slot_bv != 0) {  // a power of 0 multiplies by 1: skipped, the same bits
              const T* power = s_pow + slot_bv * kTile;
#pragma unroll
              for (int r = 0; r < kR; ++r) col[r] = R::mul(col[r], power[r * kFwdThreads]);
            }
          }
          const Pair musd = reinterpret_cast<const Pair*>(s_musd)[b];
#pragma unroll
          for (int r = 0; r < kR; ++r) xn[r][b] = R::sub(col[r], musd.x) / musd.y;
        } else {
#pragma unroll
          for (int r = 0; r < kR; ++r) xn[r][b] = b == B ? T(1) : T(0);
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        T min_rate, max_rate;
        interp_rates(s_pil, op.num_pillars, C, op.interp_kind, inv[r], &min_rate, &max_rate);
        loss_amt[r] = R::mul(s_sc[kLoss], inv[r]);
        inv_cost[r] = mul_rn(s_sc[kInvCostRate], inv[r]);
        clipped_decision_bounds(min_rate, max_rate, inv[r], loss_amt[r], lo, hi, &yw[r], &yi[r]);
        // bang_bang_decisions_fixed: yw a_d + yi b_d when the range spans
        // zero, else yw (1 - f_d) + yi f_d; rounded as torch rounds it.
        slot[r] = (yw[r] < T(0)) && (yi[r] > T(0)) ? 0 : 2 * D;
      }
    }

    // Phase 2: the decisions, one at a time, the kR sims side by side.
    const T cons_inject = s_sc[kConsInject], cons_withdraw = s_sc[kConsWithdraw];
    const T inject_cost = s_sc[kInjectCost], withdraw_cost = s_sc[kWithdrawCost];
    const T df_cost = s_sc[kDfCost], df_settle = s_sc[kDfSettle];
    T best_total[kR], best_vol[kR], best_consumed[kR], best_imm[kR];
    for (int di = 0; di < D; ++di) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const T d = add_rn(mul_rn(yw[r], s_dw[slot[r] + di]),
                           mul_rn(yi[r], s_dw[slot[r] + D + di]));
        const T after = R::sub(R::add(inv[r], d), loss_amt[r]);
        int j;
        T w;
        frac_index(after, lo, gstep, span_pos, G, &j, &w);
        const Quad* t0 = reinterpret_cast<const Quad*>(s_tab + j * kPitch);
        const Quad* t1 = t0 + kNQ;
        const T w0 = T(1) - w;
        T cont = T(0);
#pragma unroll
        for (int q = 0; q < kNQ; ++q) {
          if (q < nq) {
            const Quad a = t0[q];
            const Quad c = t1[q];
            cont = add_rn(cont, mul_rn(xn[r][4 * q], add_rn(mul_rn(a.x, w0), mul_rn(c.x, w))));
            cont = add_rn(cont, mul_rn(xn[r][4 * q + 1],
                                       add_rn(mul_rn(a.y, w0), mul_rn(c.y, w))));
            cont = add_rn(cont, mul_rn(xn[r][4 * q + 2],
                                       add_rn(mul_rn(a.z, w0), mul_rn(c.z, w))));
            cont = add_rn(cont, mul_rn(xn[r][4 * q + 3],
                                       add_rn(mul_rn(a.w, w0), mul_rn(c.w, w))));
          }
        }
        const bool inject = d > T(0);
        const T abs_d = abs_of(d);
        const T consumed = R::mul(inject ? cons_inject : cons_withdraw, abs_d);
        const T iw_cost = R::mul(inject ? inject_cost : withdraw_cost, abs_d);
        const T cost = mul_rn(add_rn(iw_cost, inv_cost[r]), df_cost);
        const T price_coeff = R::mul(-R::add(d, consumed), df_settle);
        const T imm = add_rn(mul_rn(price_coeff, spot[r]), -cost);
        const T total = R::add(imm, cont);
        if (di == 0 || total > best_total[r]) {
          best_total[r] = total;
          best_vol[r] = d;
          best_consumed[r] = consumed;
          best_imm[r] = imm;
        }
      }
    }

    // Phase 3: outputs, the next inventory, and this thread's sums over its sims.
    T vals[kNumSums + kPitch];
#pragma unroll
    for (int v = 0; v < kNumSums + kPitch; ++v) vals[v] = T(0);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const T net = R::sub(-best_vol[r], best_consumed[r]);
      const T fields[kNumSums] = {inv[r],        best_vol[r], best_consumed[r], loss_amt[r],
                                  net,           best_imm[r], R::mul(net, spot[r])};
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
      inv[r] = R::sub(R::add(inv[r], best_vol[r]), loss_amt[r]);
      pv[r] = R::add(pv[r], best_imm[r]);
      if (k == n - 1 && valid[r]) {
        op.inv_out[sim[r]] = inv[r];
        op.pv_out[sim[r]] = pv[r];
      }
    }
    // The step's sums over each group of kSumLanes lanes, one slot a group.
    constexpr int kL = K2Traits<T>::kSumLanes;
    T* red = s_red + (buf * sum_slots<T>() + tid / kL) * NV;
#pragma unroll
    for (int v = 0; v < kNumSums + kPitch; ++v) {
      if (v < NV) {
        const T total = lane_group_sum<kL>(vals[v]);
        if (lane % kL == 0) red[v] = total;
      }
    }
    if (prev_out != nullptr) *prev_out = prev_sum;
    k = k_next;
    my_tile += k_next == 0 ? 1 : 0;
  }
  __syncthreads();
  if (tid < NV) {  // the last item: the last tile's last step
    T* out;
    const T sum = item_sum((int)((nitems - 1) & 1), n - 1, my_tiles == 1, &out);
    *out = sum;
  }
}

namespace forward {

template <class T>
using KernelFn = void (*)(FwdOperands<T>, BasisDesc);

// A table row of B + 1 elements is read as quads (four elements, 16-byte
// vectors): three up to B = 11, five beyond (the interface takes bases of
// up to kMaxBasis = 16 terms, as K1 does).
int quads_of(int num_basis) { return num_basis + 1 <= 12 ? 3 : 5; }

template <class T>
KernelFn<T> kernel_for(int num_basis) {
  return quads_of(num_basis) == 5 ? forward_sim_kernel<T, 5> : forward_sim_kernel<T, 3>;
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

// Elements of a record, padded to a multiple of 4 (whole 16-byte copies in
// either type).
int record_len(const Shape& sh) {
  const int used = record_elems(sh.num_grid, 4 * quads_of(sh.num_basis), sh.num_basis,
                                sh.num_pillars, sh.pillar_cols, sh.num_factors);
  return (used + 3) / 4 * 4;
}

template <class T>
size_t smem_bytes(const Shape& sh) {
  return sizeof(T) * (2 * (size_t)record_len(sh) + 4 * (size_t)sh.num_decisions +
                      2 * (size_t)sum_slots<T>() * (kNumSums + sh.num_basis + 1) +
                      (size_t)sh.num_slots * tile_sims<T>());
}

template <class T>
int blocks_for(long long num_sims, int num_grid, int num_basis, int num_factors, int num_pillars,
               int pillar_cols, int num_decisions, const int* spot_pow, const int* fac_pow) {
  Shape sh = {num_sims,    num_grid,    num_basis,     num_factors,
              num_pillars, pillar_cols, num_decisions, 1};
  if (!valid_shape(sh)) return -(int)cudaErrorInvalidValue;
  sh.num_slots = make_basis_desc(num_basis, num_factors, spot_pow, fac_pow).num_slots;
  int nblk = 0;
  const cudaError_t err =
      persistent_grid(reinterpret_cast<const void*>(kernel_for<T>(num_basis)), kFwdThreads,
                      smem_bytes<T>(sh), (num_sims + tile_sims<T>() - 1) / tile_sims<T>(), &nblk);
  return err == cudaSuccess ? nblk : -(int)err;
}

template <class T>
int launch(const T* factors, const T* inv0, const T* records, const T* dweights, T* partials,
           T* inv_out, T* pv_out, T* panels, long long num_sims, int num_steps, int num_grid,
           int num_pillars, int pillar_cols, int interp_kind, int num_decisions, int num_basis,
           int num_factors, const int* spot_pow, const int* fac_pow, int rec_len,
           int num_blocks, void* stream) {
  Shape sh = {num_sims,    num_grid,    num_basis,     num_factors,
              num_pillars, pillar_cols, num_decisions, 1};
  const bool interp_ok = interp_kind == kInterpLinear || interp_kind == kInterpStep ||
                         (interp_kind == kInterpPoly && pillar_cols >= 5);
  if (!valid_shape(sh) || !interp_ok || num_steps < 1 || rec_len != record_len(sh) ||
      num_blocks < 1 || num_blocks > (num_sims + tile_sims<T>() - 1) / tile_sims<T>()) {
    return (int)cudaErrorInvalidValue;
  }
  const BasisDesc bd = make_basis_desc(num_basis, num_factors, spot_pow, fac_pow);
  sh.num_slots = bd.num_slots;
  const FwdOperands<T> op = {factors, inv0,    records,   dweights,  partials,    inv_out,
                             pv_out,  panels,  num_sims,  num_steps, num_grid,    num_pillars,
                             pillar_cols, interp_kind, num_decisions, rec_len};
  const void* fn = reinterpret_cast<const void*>(kernel_for<T>(num_basis));
  const size_t smem = smem_bytes<T>(sh);
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<FwdOperands<T>*>(&op), const_cast<BasisDesc*>(&bd)};
  return (int)cudaLaunchKernel(fn, dim3(num_blocks), dim3(kFwdThreads), args, smem,
                               (cudaStream_t)stream);
}

}  // namespace forward
}  // namespace storage_kernels

using namespace storage_kernels;

// The elements of one table row in `records` for a basis of num_basis
// terms (the same in float32 and float64).
extern "C" int forward_sim_row_pitch(int num_basis) { return 4 * forward::quads_of(num_basis); }

// The number of blocks (= partials) forward_sim_launch takes for these
// shapes on the current device, or minus a cudaError_t.
extern "C" int forward_sim_blocks(long long num_sims, int num_grid, int num_basis,
                                  int num_factors, int num_pillars, int pillar_cols,
                                  int num_decisions, const int* spot_pow,
                                  const int* fac_pow) {
  return forward::blocks_for<float>(num_sims, num_grid, num_basis, num_factors, num_pillars,
                                    pillar_cols, num_decisions, spot_pow, fac_pow);
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
  return forward::launch<float>(factors, inv0, records, dweights, partials, inv_out, pv_out,
                                panels, num_sims, num_steps, num_grid, num_pillars, pillar_cols,
                                interp_kind, num_decisions, num_basis, num_factors, spot_pow,
                                fac_pow, rec_len, num_blocks, stream);
}

// The same three entry points in float64: every floating-point operand is
// double, and `records` rows have forward_sim_f64_row_pitch elements.
extern "C" int forward_sim_f64_row_pitch(int num_basis) { return forward_sim_row_pitch(num_basis); }

extern "C" int forward_sim_f64_blocks(long long num_sims, int num_grid, int num_basis,
                                      int num_factors, int num_pillars, int pillar_cols,
                                      int num_decisions, const int* spot_pow,
                                      const int* fac_pow) {
  return forward::blocks_for<double>(num_sims, num_grid, num_basis, num_factors, num_pillars,
                                     pillar_cols, num_decisions, spot_pow, fac_pow);
}

extern "C" int forward_sim_f64_launch(
    const double* factors, const double* inv0, const double* records, const double* dweights,
    double* partials, double* inv_out, double* pv_out, double* panels, long long num_sims,
    int num_steps, int num_grid, int num_pillars, int pillar_cols, int interp_kind,
    int num_decisions, int num_basis, int num_factors, const int* spot_pow, const int* fac_pow,
    int rec_len, int num_blocks, void* stream) {
  return forward::launch<double>(factors, inv0, records, dweights, partials, inv_out, pv_out,
                                 panels, num_sims, num_steps, num_grid, num_pillars, pillar_cols,
                                 interp_kind, num_decisions, num_basis, num_factors, spot_pow,
                                 fac_pow, rec_len, num_blocks, stream);
}

// Makes `device` this library's current device (its CUDA runtime is its
// own, linked in statically): the launchers start their kernels there.
// Returns the cudaError_t (0 on success).
extern "C" int storage_kernels_set_device(int device) { return (int)cudaSetDevice(device); }

extern "C" const char* storage_kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
