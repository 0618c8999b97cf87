// K5: the recurrent (DRQN) train phase, U sequential sub-updates, in ONE
// cooperative launch (replaces fused_drqn_group_update of
// deepqlearning_tpu/ops/pallas/fused_drqn.py). K8, one sub-update emitting
// its flat gradient for the data-parallel step (fused_drqn_grads of the same
// JAX file), is the same kernel with U = 1 and the summed gradient written
// out in place of Adam.
//
// The Pallas kernel is feature-major: all B windows advance together and a
// step is one [features, B] product. Here the batch parallelism is kept per
// tile. One persistent launch (cudaLaunchCooperativeKernel) loops over u
// with two grid barriers per sub-update:
//   phase A: the B windows of sub-update u are cut into tiles of d.tile
//     windows (DRQNPlan's TILE, fewer for wide nets); blocks stride over
//     the tiles. A block copies the params into a padded shared layout (for
//     u > 0 a flat copy of what phase B staged), loads its tile's inputs,
//     and advances every window of the tile step by step: each block-wide
//     step is one layer of one time step over all rows of the tile, the s
//     unroll and (double-Q) the s' unroll side by side as independent rows
//     on the same weights. The gate product, the bulk of the FLOPs, and the
//     cell update are one block-wide step: a thread takes every gate column
//     of one hidden unit for two rows, reads the rows' inputs feature-major
//     (xT, hT: one float2 per term) beside one weight per gate, so a weight
//     is loaded once per two rows, and updates the unit's cell state. The s
//     rows keep their T step blocks of activations; the s' rows keep two.
//     The masked Huber terms per window and step come with the head's top
//     cotangents. BPTT, t descending, is a block-wide step per layer: the
//     heads below their top layers, the cell's gate cotangents (with the
//     heads' dL/dh; kept per step in a cotangent block), the recurrent
//     dh = dg · Whᵀ and the Dense layers before the cell, each a dot
//     product of two rows read as float4s. Last, a thread per 4 x 4 weight
//     entries sums their gradient over the tile's windows in order and t
//     descending, in registers, and writes it to part_grad[tile, n_params];
//     the tile's Huber sum goes to part_loss[tile]. Partials are per tile,
//     not per block, so no sum depends on the grid size, and no block keeps
//     a shared gradient copy.
//   grid.sync()
//   phase B (dq_reduce_adam, common.cuh, shared with K3): one thread per
//     parameter sums the tile partials in tile order and applies Adam at
//     t = count + u + 1, staging the new params for the next phase A; on
//     the last u the max-abs entry and the loss (the tile-order Huber sum
//     times 1/(B·T)).
//   grid.sync(), then the next u.
// Params, m, v, the stage and the partials are written inside the launch,
// so they are read with __ldcg after each barrier. Every sum has a fixed
// order: a run is deterministic whatever the grid. The tensor table is
// copied to shared memory, where phase B looks a parameter's tensor up at a
// per-thread index.
//
// A tile's T-step region (its inputs, the s step blocks and the cotangent
// blocks) lies in shared memory; for a long trace or a wide net that
// region alone would not fit, it lies in a per-block global scratch
// (d.act_global) and the kernel is the same code (dr_group_gm_kernel). The
// gate (drqn_plan_for in ops/cuda/fused_drqn.py) computes the layout.
// Every weight row starts 16-byte aligned with a stride of 4 (mod 8)
// floats, so float4 reads of eight consecutive rows hit distinct banks.
//
// At the loop's shapes (B = 512 windows, T = 8, LSTM(2, 32) + Dense(32, 4),
// U = 4) a call is ~0.6 GFLOP of dependent dot products of length 34 or
// less, ~9 µs at the FP32 peak: the kernel is bound by latency, not by
// bytes or FLOPs. Measured (PERF.md, k5_phases.py): a sub-update is ~106K
// cycles, ~55 dependent block-wide steps of 1-4K cycles each (unrolls 54%,
// BPTT 21%), the gradient pass 9%, phase B 8%, the barriers 5%; a step's
// time is its chain of dependent shared-memory loads, not its FMAs (a dot
// product split over four lanes was slower). Arithmetic stays FP32 FMA on
// the CUDA cores: TF32 would change the double-Q argmax and the parity with
// the JAX package.
//
// K11 (dr_target_kernel, at the end of this file) computes K5's and K8's
// input Q_tgt(s'): the frozen target net's zero-state unroll over every
// window of the step, forward only, on the same descriptor and gate
// arithmetic.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define DR_MAXL 16
#define DR_MAXT (2 * DR_MAXL + 3)
#define DR_THREADS 512

// Mirrors build.DrqnDesc; every offset and size is computed by
// DRQNPlan.desc (ops/cuda/fused_drqn.py).
struct DrqnDesc {
  int cell;  // 0 LSTM (gates i,f,g,o), 1 GRU (gates r,z,n)
  int n_pre, n_val, n_adv, dueling;
  int in_dim, cin, H, G, A, T;
  int n_params, n_tensors, n_witems;
  int tile;        // windows per tile
  int rp;          // rows of a tile (2 tile) rounded up to 4: xT, hT width
  int act_global;  // 1: the tiles' T-step regions lie in global scratch
  // Dense layers in the order pre, value head, advantage head
  int din[DR_MAXL], dout[DR_MAXL], act[DR_MAXL];
  int off_w[DR_MAXL], off_b[DR_MAXL];         // packed parameter offsets
  int sw[DR_MAXL], ldw[DR_MAXL], sb[DR_MAXL];  // in the shared copy
  int in_a[DR_MAXL];   // the layer's input in a step block, -1: the obs
  int off_a[DR_MAXL];  // its output in a step block
  int off_d[DR_MAXL];  // its dz in a cotangent block
  int off_wi, off_wh, off_bc;          // the cell's packed parameters
  int s_wi, ld_wi, s_wh, ld_wh, s_bc;  // and their shared copy
  int cell_in;  // the cell's input in a step block, -1: the obs
  // a step block: pre outputs; gates [G]; aux [H] (LSTM tanh(c'), GRU
  // h·wh of the n gate); c' [H] (LSTM only); h' [H]; head outputs
  int a_gates, a_aux, a_c, a_h, step_floats;
  // a cotangent block: every Dense layer's dz; the gates' input-side dz
  // [G]; their recurrent-side dg [G] (GRU; the LSTM's is dz itself)
  int d_gates, d_dg, cot_floats;
  // a window's T-step region: T cotangent blocks, T step blocks, obs [T,
  // in_dim], next obs, Q_tgt(s') [T, A], reward, done, mask, action and
  // the Huber term [T] each
  int r_cot, r_steps, r_x, r_x2, r_tgt, r_rew, r_done, r_mask, r_act, r_hub,
      region_floats;
  // shared memory: the padded params [n_sp], the s' step blocks [2, tile],
  // per window state [tile, 3H] (dhc, dcc, dhz), the
  // rows' h and cell input feature-major, by step parity (hT [2, H, rp],
  // xT [2, cin, rp]), then the tiles' regions unless act_global;
  // smem_floats in all
  int n_sp, f_sp2, f_state, f_ht, f_xt, f_region, smem_floats;
  // packed tensors (Dense w, b ..., then wi, wh, b), their shared copy, and
  // their first item in the weight-gradient pass (four entries of a row
  // each)
  int t_off[DR_MAXT], t_size[DR_MAXT];
  int t_dst[DR_MAXT], t_ld[DR_MAXT], t_cols[DR_MAXT];
  int w_start[DR_MAXT + 1];
};

// Everything one call reads (one by-value kernel argument).
struct DrArgs {
  DrqnDesc d;
  DqTab tab;
  const float* obs;
  const float* nobs;
  const int* action;
  const float* reward;
  const float* done;
  const float* mask;
  const float* q_sp_tgt;
  const int* count;
  int U, B, double_q;
  float gamma, inv_bt, lr, b1, b2, adam_eps;
  float* part_grad;
  float* part_loss;
  float* loss;
  float* gnorm;
  float* flat;   // K8: the summed gradient is written here, no Adam
  float* stage;  // K5: the updated params in the padded shared layout
  float* act;    // the blocks' T-step regions when d.act_global
};

#ifdef DR_TRACE
// Timestamps of block 0 (a diagnostic build, -DDR_TRACE), per u: clock64
// at the start, after the param copy, after its tile's input copy, after
// the s'/s unrolls, after the BPTT, after the partial write, after the
// first barrier, after phase B and after the second barrier. dr_steps,
// per u, inside block 0's tile: time step 1 of the unrolls (the start,
// after the Dense layers before the cell, the gates, the cell, the head and
// the TD terms) and time step T-2 of the BPTT (the start, after the head's
// top cotangents, the head, the gate cotangents, dh · Whᵀ and the Dense
// layers before the cell).
#define DR_NMARK 9
#define DR_NSTEP 12
__device__ long long dr_trace[64 * DR_NMARK];
__device__ long long dr_steps[64 * DR_NSTEP];
#define DR_MARK(u, j)                                            \
  if (blockIdx.x == 0 && threadIdx.x == 0 && (u) < 64)           \
    dr_trace[(u) * DR_NMARK + (j)] = clock64();
#define DR_STEP(u, on, j)                                                  \
  if (blockIdx.x == 0 && threadIdx.x == 0 && (on) && (u) < 64)             \
    dr_steps[(u) * DR_NSTEP + (j)] = clock64();
DQ_API int dq_dr_trace(void* out, void* steps) {
  cudaError_t err = cudaMemcpyFromSymbol(out, dr_trace, sizeof(dr_trace));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(steps, dr_steps, sizeof(dr_steps));
  return (int)err;
}
#else
#define DR_MARK(u, j)
#define DR_STEP(u, on, j)
#endif

__device__ __forceinline__ float dr_sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

// sum_c x[c] * y[c] over n terms, both rows 16-byte aligned (as every
// weight row and cotangent block of the layout is): float4 loads (two per
// four FMAs) into four accumulators, one per lane of the float4 (c mod 4,
// each in ascending c; a chain a quarter as long), summed as
// (z0 + z1) + (z2 + z3); then the tail in ascending c.
__device__ __forceinline__ float dr_dot4(const float* __restrict__ x,
                                         const float* __restrict__ y, int n) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float z0 = 0.0f, z1 = 0.0f, z2 = 0.0f, z3 = 0.0f;
  int c = 0;
#pragma unroll 4
  for (; c + 4 <= n; c += 4) {
    const float4 a = x4[c >> 2], b = y4[c >> 2];
    z0 = fmaf(a.x, b.x, z0);
    z1 = fmaf(a.y, b.y, z1);
    z2 = fmaf(a.z, b.z, z2);
    z3 = fmaf(a.w, b.w, z3);
  }
  float z = (z0 + z1) + (z2 + z3);
  for (; c < n; ++c) z = fmaf(x[c], y[c], z);
  return z;
}

// acc[g][q] += sum_i x[i].q * w[i * ws + g * gs] over n terms in ascending
// i, for the ng < 5 gate columns g of one unit and the two rows q of a
// pair: x is a feature-major input (x[i] the pair's feature i, float2s xs
// apart).
__device__ __forceinline__ void dr_pair_dot(const float2* __restrict__ x,
                                            int xs,
                                            const float* __restrict__ w,
                                            int ws, int gs, int ng, int n,
                                            float acc[4][2]) {
#pragma unroll 2
  for (int i = 0; i < n; ++i) {
    const float2 xv = x[i * xs];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if (g >= ng) break;
      const float wv = w[i * ws + g * gs];
      acc[g][0] = fmaf(xv.x, wv, acc[g][0]);
      acc[g][1] = fmaf(xv.y, wv, acc[g][1]);
    }
  }
}

// The rows of a tile: rows [0, nr) are the s unrolls of its nr windows,
// rows [nr, 2 nr) the s' unrolls (double-Q).
struct DrTile {
  float* reg;  // window w's T-step region at reg + w * region_floats
  int nr;      // windows in the tile
  int R;       // rows: nr, or 2 nr with double-Q
  int g0;      // the first window's index in the [U·B] inputs
};

__device__ __forceinline__ float* dr_region(const DrqnDesc& d,
                                            const DrTile& tl, int w) {
  return tl.reg + w * d.region_floats;
}

// Row r's step block at time t.
__device__ __forceinline__ float* dr_blk(const DrqnDesc& d, float* smem,
                                         const DrTile& tl, int r, int t) {
  if (r < tl.nr) return dr_region(d, tl, r) + d.r_steps + t * d.step_floats;
  return smem + d.f_sp2 + ((t & 1) * d.tile + r - tl.nr) * d.step_floats;
}

// Row r's observation at time t.
__device__ __forceinline__ const float* dr_obs(const DrqnDesc& d,
                                               const DrTile& tl, int r,
                                               int t) {
  const int w = (r < tl.nr) ? r : r - tl.nr;
  return dr_region(d, tl, w) + ((r < tl.nr) ? d.r_x : d.r_x2) +
         t * d.in_dim;
}

// The window's state during BPTT (3 arrays of H): dL/dh from step t+1
// (dhc), dL/dc from step t+1 (dcc, LSTM) and the GRU's direct h' -> h term
// (dhz).
__device__ __forceinline__ float* dr_state(const DrqnDesc& d, float* smem,
                                           int w) {
  return smem + d.f_state + w * 3 * d.H;
}

// Copy the tile's inputs into its windows' regions (actions as floats,
// exact below 2^24); zero both parities of hT (step 0 reads the zero
// state) and of xT, filling xT of step 0 with the rows' first observations
// when the cell reads the observation.
__device__ __forceinline__ void dr_load_tile(const DrArgs& a,
                                             const DrqnDesc& d, float* smem,
                                             const DrTile& tl) {
  const int T = d.T, D = d.in_dim, A = d.A, nr = tl.nr;
  const size_t g0 = tl.g0;
  const int nx = T * D, nt = T * A;
  for (int k = threadIdx.x; k < nr * nx; k += blockDim.x) {
    const int w = k / nx, e = k - w * nx;
    float* reg = dr_region(d, tl, w);
    reg[d.r_x + e] = a.obs[g0 * nx + k];
    if (a.double_q) reg[d.r_x2 + e] = a.nobs[g0 * nx + k];
  }
  for (int k = threadIdx.x; k < nr * nt; k += blockDim.x) {
    const int w = k / nt;
    dr_region(d, tl, w)[d.r_tgt + k - w * nt] = a.q_sp_tgt[g0 * nt + k];
  }
  for (int k = threadIdx.x; k < nr * T; k += blockDim.x) {
    const int w = k / T, t = k - w * T;
    float* reg = dr_region(d, tl, w);
    const size_t i = g0 * T + k;
    reg[d.r_rew + t] = a.reward[i];
    reg[d.r_done + t] = a.done[i];
    reg[d.r_mask + t] = a.mask[i];
    reg[d.r_act + t] = (float)a.action[i];
  }
  for (int k = threadIdx.x; k < 2 * d.H * d.rp; k += blockDim.x)
    smem[d.f_ht + k] = 0.0f;
  for (int k = threadIdx.x; k < 2 * d.cin * d.rp; k += blockDim.x) {
    const int i = k / d.rp, r = k - i * d.rp;
    float x = 0.0f;
    if (d.n_pre == 0 && i < d.cin && r < tl.R) {
      const int w = (r < nr) ? r : r - nr;
      x = ((r < nr) ? a.obs : a.nobs)[(g0 + w) * nx + i];
    }
    smem[d.f_xt + k] = x;
  }
  __syncthreads();
}

// Dense layers la and lb (-1: none) side by side as one block-wide step on
// the tile's rows at time t (the value and advantage heads run their layers
// of one depth together). Outputs go to the step blocks and, for the last
// layer before the cell, to xT.
__device__ __forceinline__ void dr_dense_fwd(const DrqnDesc& d, float* smem,
                                             const DrTile& tl, int t, int la,
                                             int lb) {
  const float* sp = smem;
  const int R = tl.R;
  const int na = (la >= 0) ? R * d.dout[la] : 0;
  const int nb = (lb >= 0) ? R * d.dout[lb] : 0;
  for (int k = threadIdx.x; k < na + nb; k += blockDim.x) {
    const int l = (k < na) ? la : lb, kk = (k < na) ? k : k - na;
    const int n = d.dout[l], r = kk / n, o = kk - r * n;
    float* st = dr_blk(d, smem, tl, r, t);
    const float* in = (d.in_a[l] < 0) ? dr_obs(d, tl, r, t) : st + d.in_a[l];
    const float z = dq_dot(in, sp + d.sw[l] + o, d.ldw[l], d.din[l]);
    const float y = dq_act(z + sp[d.sb[l] + o], d.act[l]);
    st[d.off_a[l] + o] = y;
    if (l == d.n_pre - 1)  // the cell's input, xT of this step's parity
      smem[d.f_xt + ((t & 1) * d.cin + o) * d.rp + r] = y;
  }
  __syncthreads();
}

// q(c) of the head outputs in step block st; mean = sum(adv) / A for a
// dueling head.
__device__ __forceinline__ float dr_q(const DrqnDesc& d, const float* st,
                                      int c, float mean) {
  const float* aout = st + d.off_a[d.n_pre + d.n_val + d.n_adv - 1];
  if (!d.dueling) return aout[c];
  return st[d.off_a[d.n_pre + d.n_val - 1]] + aout[c] - mean;
}

__device__ __forceinline__ float dr_mean(const DrqnDesc& d, const float* st) {
  if (!d.dueling) return 0.0f;
  const float* aout = st + d.off_a[d.n_pre + d.n_val + d.n_adv - 1];
  float s = 0.0f;
  for (int c = 0; c < d.A; ++c) s += aout[c];
  return s * (1.0f / (float)d.A);
}

// One time step of the online net on the tile's rows (s rows and, for
// double-Q, s' rows), then the Huber term and dL/dq_sa of each window.
__device__ __forceinline__ void dr_forward_step(const DrArgs& a,
                                                const DrqnDesc& d, float* smem,
                                                const DrTile& tl, int t,
                                                int u) {
  const float* sp = smem;
  const int H = d.H, R = tl.R, rp = d.rp;
  DR_STEP(u, t == 1, 0)
  for (int l = 0; l < d.n_pre; ++l) dr_dense_fwd(d, smem, tl, t, l, -1);
  DR_STEP(u, t == 1, 1)
  // the gates and the cell: thread (row pair p, hidden unit j) takes every
  // gate column of unit j (j, H + j, ...) for its two rows: xi = x·Wi and
  // hh = h·Wh, one accumulator each in ascending order, the rows' inputs
  // read feature-major (xT, hT of this step's parity: one float2 per term
  // beside one weight per gate), then the cell update. h goes to the step
  // block and to hT of the next parity, which no thread reads this step.
  const int NG = (d.cell == 0) ? 4 : 3, cur = t & 1;
  const float2* xT =
      reinterpret_cast<const float2*>(smem + d.f_xt + cur * d.cin * rp);
  const float2* hT =
      reinterpret_cast<const float2*>(smem + d.f_ht + cur * H * rp);
  float* hTn = smem + d.f_ht + (cur ^ 1) * H * rp;
  const int np = (R + 1) >> 1;
  for (int k = threadIdx.x; k < np * H; k += blockDim.x) {
    const int p = k / H, j = k - p * H;
    float xi[4][2] = {}, hh[4][2] = {}, b[4] = {};
    dr_pair_dot(xT + p, rp >> 1, sp + d.s_wi + j, d.ld_wi, H, NG, d.cin, xi);
    dr_pair_dot(hT + p, rp >> 1, sp + d.s_wh + j, d.ld_wh, H, NG, H, hh);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (g < NG) b[g] = sp[d.s_bc + g * H + j];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = 2 * p + q;
      if (r >= R) break;
      float* st = dr_blk(d, smem, tl, r, t);
      const float* prev = t ? dr_blk(d, smem, tl, r, t - 1) : nullptr;
      float* gates = st + d.a_gates;
      float h;
      if (d.cell == 0) {
        const float ig = dr_sigmoid(xi[0][q] + hh[0][q] + b[0]);
        const float fg = dr_sigmoid(xi[1][q] + hh[1][q] + b[1]);
        const float gg = tanhf(xi[2][q] + hh[2][q] + b[2]);
        const float og = dr_sigmoid(xi[3][q] + hh[3][q] + b[3]);
        gates[j] = ig;
        gates[H + j] = fg;
        gates[2 * H + j] = gg;
        gates[3 * H + j] = og;
        const float cp = prev ? prev[d.a_c + j] : 0.0f;
        const float c = fg * cp + ig * gg;
        const float tc = tanhf(c);
        st[d.a_c + j] = c;
        st[d.a_aux + j] = tc;
        h = og * tc;
      } else {
        const float rg = dr_sigmoid(xi[0][q] + hh[0][q] + b[0]);
        const float zg = dr_sigmoid(xi[1][q] + hh[1][q] + b[1]);
        // the n gate: tanh(x·Wi_n + b_n + r · h·Wh_n)
        const float n = tanhf((xi[2][q] + b[2]) + rg * hh[2][q]);
        gates[j] = rg;
        gates[H + j] = zg;
        gates[2 * H + j] = n;
        st[d.a_aux + j] = hh[2][q];
        const float hp = prev ? prev[d.a_h + j] : 0.0f;
        h = (1.0f - zg) * n + zg * hp;
      }
      st[d.a_h + j] = h;
      hTn[j * rp + r] = h;
    }
  }
  // the next step's observations into xT of the next parity when the cell
  // reads them
  if (d.n_pre == 0 && t + 1 < d.T)
    for (int k = threadIdx.x; k < R * d.cin; k += blockDim.x) {
      const int r = k / d.cin, i = k - r * d.cin;
      smem[d.f_xt + (cur ^ 1) * d.cin * rp + i * rp + r] =
          dr_obs(d, tl, r, t + 1)[i];
    }
  __syncthreads();
  DR_STEP(u, t == 1, 2)
  DR_STEP(u, t == 1, 3)
  const int lv = d.n_pre, la = d.n_pre + d.n_val;
  for (int s = 0; s < max(d.n_val, d.n_adv); ++s)
    dr_dense_fwd(d, smem, tl, t, s < d.n_val ? lv + s : -1,
                 s < d.n_adv ? la + s : -1);
  DR_STEP(u, t == 1, 4)
  // the target r + (1 - done)·γ·Q_tgt(s', a*), the masked Huber term and
  // dL/dq_sa, a thread per window
  const int A = d.A;
  for (int w = threadIdx.x; w < tl.nr; w += blockDim.x) {
    float* reg = dr_region(d, tl, w);
    const float* tg = reg + d.r_tgt + t * A;
    float qmax;
    if (a.double_q) {
      const float* st2 = dr_blk(d, smem, tl, tl.nr + w, t);
      const float mean = dr_mean(d, st2);
      int best = 0;
      float bv = dr_q(d, st2, 0, mean);
      for (int c = 1; c < A; ++c) {
        const float q = dr_q(d, st2, c, mean);
        if (q > bv) { bv = q; best = c; }
      }
      qmax = tg[best];
    } else {
      qmax = tg[0];
      for (int c = 1; c < A; ++c) qmax = fmaxf(qmax, tg[c]);
    }
    const float target =
        reg[d.r_rew + t] + (1.0f - reg[d.r_done + t]) * a.gamma * qmax;
    // an action outside [0, A) selects nothing: the port's rule on every
    // route (ops/helpers.py::action_mask)
    const int act = (int)reg[d.r_act + t];
    const float* st = reg + d.r_steps + t * d.step_floats;
    const float q_sa =
        (act >= 0 && act < A) ? dr_q(d, st, act, dr_mean(d, st)) : 0.0f;
    const float mk = reg[d.r_mask + t];
    const float xw = mk * (q_sa - target);
    const float absx = fabsf(xw);
    const float quad = fminf(absx, 1.0f);
    reg[d.r_hub + t] = 0.5f * quad * quad + (absx - quad);
    // dL/dq is g at the taken action; through the dueling combination
    // g_adv = g_q - sum(g_q) / A, g_val = sum(g_q); times act' of the top
    // layers: the BPTT's first cotangents, into step t's cotangent block
    const float g = mk * fminf(fmaxf(xw, -1.0f), 1.0f) * a.inv_bt;
    const float sdq = (act >= 0 && act < A) ? g : 0.0f;
    float* ct = reg + d.r_cot + t * d.cot_floats;
    const int la_top = d.n_pre + d.n_val + d.n_adv - 1;
    for (int c = 0; c < A; ++c) {
      const float gq = (c == act) ? g : 0.0f;
      const float b = d.dueling ? gq - sdq * (1.0f / (float)A) : gq;
      ct[d.off_d[la_top] + c] =
          b * dq_act_grad(st[d.off_a[la_top] + c], d.act[la_top]);
    }
    if (d.dueling) {
      const int lv_top = d.n_pre + d.n_val - 1;
      ct[d.off_d[lv_top]] =
          sdq * dq_act_grad(st[d.off_a[lv_top]], d.act[lv_top]);
    }
  }
  __syncthreads();
  DR_STEP(u, t == 1, 5)
}

// Row i of dL/d(input of Dense layer l) = dz_l · W_lᵀ for window w at time
// t: the dz row and the weight row read as float4s.
__device__ __forceinline__ float dr_dh(const DrqnDesc& d, const float* smem,
                                       const float* ct, int l, int i) {
  return dr_dot4(ct + d.off_d[l], smem + d.sw[l] + i * d.ldw[l], d.dout[l]);
}

// dz of Dense layer l-1 from dz of layer l (l not its chain's first), item
// kk of nr · din.
__device__ __forceinline__ void dr_dense_bwd_item(const DrqnDesc& d,
                                                  float* smem,
                                                  const DrTile& tl, int t,
                                                  int l, int kk) {
  const int din = d.din[l], w = kk / din, i = kk - w * din;
  float* reg = dr_region(d, tl, w);
  float* ct = reg + d.r_cot + t * d.cot_floats;
  const float* st = reg + d.r_steps + t * d.step_floats;
  ct[d.off_d[l - 1] + i] =
      dr_dh(d, smem, ct, l, i) * dq_act_grad(st[d.off_a[l - 1] + i],
                                             d.act[l - 1]);
}

// BPTT through time step t for every window of the tile (the head's top
// cotangents were written with the TD terms): the heads' layers below the
// top, the cell's gate cotangents (with the heads' dL/dh), then dL/dh into
// step t-1 and the Dense layers before the cell. Every dz goes to the
// step's cotangent block.
__device__ __forceinline__ void dr_backward_step(const DrqnDesc& d,
                                                 float* smem, const DrTile& tl,
                                                 int t, int u) {
  DR_STEP(u, t == d.T - 2, 6)
  const float* sp = smem;
  const int nr = tl.nr, H = d.H, G = d.G;
  const int lv0 = d.n_pre, la0 = d.n_pre + d.n_val;
  const int lv_top = la0 - 1, la_top = la0 + d.n_adv - 1;
  DR_STEP(u, t == d.T - 2, 7)
  // the heads below their top layers, top down, both heads' layers of one
  // depth in one step; their first layers' dL/dh is taken in the next step
  for (int s = 0; s + 1 < max(d.n_val, d.n_adv); ++s) {
    const int nv = (s + 1 < d.n_val) ? nr * d.din[lv_top - s] : 0;
    const int na = (s + 1 < d.n_adv) ? nr * d.din[la_top - s] : 0;
    for (int k = threadIdx.x; k < nv + na; k += blockDim.x) {
      if (k < nv)
        dr_dense_bwd_item(d, smem, tl, t, lv_top - s, k);
      else
        dr_dense_bwd_item(d, smem, tl, t, la_top - s, k - nv);
    }
    __syncthreads();
  }
  DR_STEP(u, t == d.T - 2, 8)
  // the cell's gate cotangents
  for (int k = threadIdx.x; k < nr * H; k += blockDim.x) {
    const int w = k / H, j = k - w * H;
    float* reg = dr_region(d, tl, w);
    const float* st = reg + d.r_steps + t * d.step_floats;
    const float* prev = t ? st - d.step_floats : nullptr;
    float* ct = reg + d.r_cot + t * d.cot_floats;
    float* dz = ct + d.d_gates;
    float* ws = dr_state(d, smem, w);
    // dL/dh' from the heads (advantage, then value) and from step t+1
    float dht = dr_dh(d, sp, ct, la0, j);
    if (d.dueling) dht = dht + dr_dh(d, sp, ct, lv0, j);
    const float dh = dht + ws[j];
    const float* gt = st + d.a_gates;
    if (d.cell == 0) {
      const float ig = gt[j], fg = gt[H + j], gg = gt[2 * H + j],
                  og = gt[3 * H + j];
      const float tc = st[d.a_aux + j];
      const float cp = prev ? prev[d.a_c + j] : 0.0f;
      const float dc = ws[H + j] + dh * og * (1.0f - tc * tc);
      dz[j] = (dc * gg) * ig * (1.0f - ig);
      dz[H + j] = (dc * cp) * fg * (1.0f - fg);
      dz[2 * H + j] = (dc * ig) * (1.0f - gg * gg);
      dz[3 * H + j] = (dh * tc) * og * (1.0f - og);
      ws[H + j] = dc * fg;
    } else {
      const float rg = gt[j], zg = gt[H + j], ng = gt[2 * H + j];
      const float hp = prev ? prev[d.a_h + j] : 0.0f;
      const float dpn = dh * (1.0f - zg) * (1.0f - ng * ng);
      const float dr = (dpn * st[d.a_aux + j]) * rg * (1.0f - rg);
      const float dzz = (dh * (hp - ng)) * zg * (1.0f - zg);
      float* dg = ct + d.d_dg;  // the recurrent side: n gate times r
      dz[j] = dg[j] = dr;
      dz[H + j] = dg[H + j] = dzz;
      dz[2 * H + j] = dpn;
      dg[2 * H + j] = dpn * rg;
      ws[2 * H + j] = dh * zg;  // the direct path h' -> h
    }
  }
  __syncthreads();
  DR_STEP(u, t == d.T - 2, 9)
  // dL/dh into step t-1 = dg · Whᵀ, and the cell's input cotangent
  const int nh = nr * H, nx = d.n_pre ? nr * d.cin : 0;
  for (int k = threadIdx.x; k < nh + nx; k += blockDim.x) {
    if (k < nh) {
      const int w = k / H, i = k - w * H;
      const float* ct = dr_region(d, tl, w) + d.r_cot + t * d.cot_floats;
      float* ws = dr_state(d, smem, w);
      const float s = dr_dot4(ct + d.d_dg, sp + d.s_wh + i * d.ld_wh, G);
      ws[i] = (d.cell == 1) ? ws[2 * H + i] + s : s;
    } else {
      const int kk = k - nh, w = kk / d.cin, i = kk - w * d.cin;
      float* reg = dr_region(d, tl, w);
      const float* st = reg + d.r_steps + t * d.step_floats;
      float* ct = reg + d.r_cot + t * d.cot_floats;
      const int l = d.n_pre - 1;
      const float s = dr_dot4(ct + d.d_gates, sp + d.s_wi + i * d.ld_wi, G);
      ct[d.off_d[l] + i] = s * dq_act_grad(st[d.off_a[l] + i], d.act[l]);
    }
  }
  __syncthreads();
  DR_STEP(u, t == d.T - 2, 10)
  for (int l = d.n_pre - 1; l > 0; --l) {
    for (int k = threadIdx.x; k < nr * d.din[l]; k += blockDim.x)
      dr_dense_bwd_item(d, smem, tl, t, l, k);
    __syncthreads();
  }
  DR_STEP(u, t == d.T - 2, 11)
}

// The tile's partial gradient, a thread per 4 x 4 entries of a weight
// matrix (four rows by four columns; a bias is one row): each entry sums
// over the windows in order and t descending (layer input) x (dz), or dz
// for a bias. A term reads the four columns' dz as one float4 and the four
// rows' inputs (broadcast across the warp, whose threads share the rows).
// Written to g[n_params].
__device__ __forceinline__ void dr_weight_grads(const DrqnDesc& d,
                                                const DrTile& tl, float* g) {
  const int nl = d.n_pre + d.n_val + d.n_adv;
  const int SF = d.step_floats, CF4 = d.cot_floats >> 2;
  for (int k = threadIdx.x; k < d.n_witems; k += blockDim.x) {
    int ti = 0;
    while (k >= d.w_start[ti + 1]) ++ti;
    const int cols = d.t_cols[ti], rows = d.t_size[ti] / cols;
    const int nq = (cols + 3) >> 2, j = k - d.w_start[ti];
    const int i0 = 4 * (j / nq), c0 = 4 * (j - (j / nq) * nq);
    // the input: -1 the obs, else its offset in a step block
    int in_a = 0, z, t_lo = 0;
    bool bias = false;
    if (ti < 2 * nl) {  // Dense layer ti / 2
      z = d.off_d[ti >> 1] + c0;
      bias = ti & 1;
      if (!bias) in_a = d.in_a[ti >> 1];
    } else if (ti == 2 * nl) {  // wi
      z = d.d_gates + c0;
      in_a = d.cell_in;
    } else if (ti == 2 * nl + 1) {  // wh, on h of the step before
      z = d.d_dg + c0;
      in_a = d.a_h;
      t_lo = 1;
    } else {  // the cell's bias
      z = d.d_gates + c0;
      bias = true;
    }
    // the input of step t: the obs at x + t·in_dim or a step block's entry
    const int x0 = (in_a == -1) ? d.r_x + i0
                                : d.r_steps + in_a + i0 - t_lo * SF;
    const int xs = (in_a == -1) ? d.in_dim : SF;
    const int ni = min(4, rows - i0);
    float acc[4][4] = {};
    for (int w = 0; w < tl.nr; ++w) {
      const float* reg = dr_region(d, tl, w);
      const float4* zp = reinterpret_cast<const float4*>(reg + d.r_cot + z);
      const float* xp = reg + x0;
      for (int t = d.T - 1; t >= t_lo; --t) {
        const float4 zv = zp[t * CF4];
        if (bias) {
          acc[0][0] += zv.x;
          acc[0][1] += zv.y;
          acc[0][2] += zv.z;
          acc[0][3] += zv.w;
          continue;
        }
        float x[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) x[r] = (r < ni) ? xp[t * xs + r] : 0.0f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][0] = fmaf(x[r], zv.x, acc[r][0]);
          acc[r][1] = fmaf(x[r], zv.y, acc[r][1]);
          acc[r][2] = fmaf(x[r], zv.z, acc[r][2]);
          acc[r][3] = fmaf(x[r], zv.w, acc[r][3]);
        }
      }
    }
    const int nc = min(4, cols - c0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r >= ni) break;
      float* out = g + d.t_off[ti] + (i0 + r) * cols + c0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < nc) out[c] = acc[r][c];
    }
  }
}

// Phase A for one tile of sub-update u; smem already holds the params.
__device__ __forceinline__ void dr_tile(const DrArgs& a, const DrqnDesc& d,
                                        float* smem, float* reg, int tile,
                                        int u) {
  DrTile tl;
  tl.reg = reg;
  tl.nr = min(d.tile, a.B - tile * d.tile);
  tl.R = a.double_q ? 2 * tl.nr : tl.nr;
  tl.g0 = u * a.B + tile * d.tile;
  dr_load_tile(a, d, smem, tl);
  DR_MARK(u, 2)
  for (int t = 0; t < d.T; ++t) dr_forward_step(a, d, smem, tl, t, u);
  DR_MARK(u, 3)
  for (int k = threadIdx.x; k < tl.nr * 2 * d.H; k += blockDim.x) {
    const int w = k / (2 * d.H);
    dr_state(d, smem, w)[k - w * 2 * d.H] = 0.0f;  // dhc, dcc
  }
  __syncthreads();
  for (int t = d.T - 1; t >= 0; --t) dr_backward_step(d, smem, tl, t, u);
  DR_MARK(u, 4)
  dr_weight_grads(d, tl, a.part_grad + (size_t)tile * d.n_params);
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < tl.nr; ++w) {
      const float* hub = dr_region(d, tl, w) + d.r_hub;
      float lw = 0.0f;
      for (int t = 0; t < d.T; ++t) lw += hub[t];
      s += lw;
    }
    a.part_loss[tile] = s;
  }
  __syncthreads();  // the regions are reused by the block's next tile
}

// The whole call; the tiles' T-step regions in global scratch (GM) or, so
// that the compiler addresses them as shared memory, in smem (one kernel
// selecting the pointer at run time reads the regions through generic
// addresses, and measured slower at the loop's shapes).
template <bool GM>
__device__ __forceinline__ void dr_group(const DrArgs& a, float* smem,
                                         DqTab& tab) {
  cg::grid_group grid = cg::this_grid();
  const DrqnDesc& d = a.d;
  dq_tab_copy(a.tab, tab);
  // the max-abs slot: zeroed before the first barrier, atomics after it
  if (blockIdx.x == 0 && threadIdx.x == 0) a.gnorm[0] = 0.0f;
  __syncthreads();
  const int ntiles = (a.B + d.tile - 1) / d.tile;
  float* reg = GM ? a.act + (size_t)blockIdx.x * d.tile * d.region_floats
                  : smem + d.f_region;
  const DqPhaseB b = {a.part_grad, a.part_loss, a.count, d.n_params, ntiles,
                      a.U, a.lr, a.b1, a.b2, a.adam_eps, a.inv_bt, a.loss,
                      a.gnorm, a.flat, a.stage};
  for (int u = 0; u < a.U; ++u) {
    DR_MARK(u, 0)
    if (blockIdx.x < ntiles) {
      if (u == 0)
        dq_load_padded(tab, d.n_params, smem);
      else
        dq_copy_stage(a.stage, smem, d.n_sp);
    }
    DR_MARK(u, 1)
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
      dr_tile(a, d, smem, reg, tile, u);
    DR_MARK(u, 5)
    grid.sync();
    DR_MARK(u, 6)
    dq_reduce_adam(b, tab, u, smem);
    DR_MARK(u, 7)
    if (u + 1 < a.U) grid.sync();
    DR_MARK(u, 8)
  }
}

// One block per SM (the grid is the tile count, at most the SM count at the
// loop's shapes): without the minimum, ptxas caps the kernel at 64
// registers and spills.
__global__ void __launch_bounds__(DR_THREADS, 1)
    dr_group_kernel(const __grid_constant__ DrArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ DqTab tab;
  dr_group<false>(a, smem, tab);
}

__global__ void __launch_bounds__(DR_THREADS, 1)
    dr_group_gm_kernel(const __grid_constant__ DrArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ DqTab tab;
  dr_group<true>(a, smem, tab);
}

// The kernel of a descriptor: the T-step regions in shared memory or not.
static const void* dr_kernel(const DrqnDesc* d) {
  return d->act_global ? (const void*)dr_group_gm_kernel
                       : (const void*)dr_group_kernel;
}

// The tensor table: packed offsets and shared placement from the
// descriptor, with the device pointers (m, v null without Adam).
static void dr_tab(const DrqnDesc* d, const int64_t* p, const int64_t* m,
                   const int64_t* v, DqTab* t) {
  for (int i = 0; i < d->n_tensors; ++i) {
    t->start[i] = d->t_off[i];
    t->dst[i] = d->t_dst[i];
    t->ld[i] = d->t_ld[i];
    t->cols[i] = d->t_cols[i];
    t->p[i] = (float*)p[i];
    t->m[i] = m ? (float*)m[i] : nullptr;
    t->v[i] = v ? (float*)v[i] : nullptr;
  }
  t->start[d->n_tensors] = d->n_params;
}

static bool dr_desc_ok(const DrqnDesc* d) {
  return d->n_tensors <= DR_MAXT && d->n_tensors <= DQ_MAXT &&
         d->n_pre + d->n_val + d->n_adv <= DR_MAXL && d->tile >= 1 &&
         d->smem_floats >= DR_THREADS;
}

// The dynamic shared memory each kernel is allowed on each device so far:
// the attribute is only ever raised (the data-parallel step launches K8 per
// sub-update).
#define DR_MAX_DEVICES 64
static int dr_smem_allowed[2][DR_MAX_DEVICES];

static cudaError_t dr_allow_smem(const DrqnDesc* d, int smem) {
  int dev = 0;
  int* allowed = dr_smem_allowed[d->act_global ? 1 : 0];
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < DR_MAX_DEVICES && smem <= allowed[dev]))
    return err;
  err = cudaFuncSetAttribute(dr_kernel(d),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < DR_MAX_DEVICES) allowed[dev] = smem;
  return err;
}

// The most blocks of dr_group_kernel the card holds at once for this plan
// (co-resident blocks per SM times the SM count): the ceiling of a
// cooperative launch's grid. The wrapper caches it per plan and T.
DQ_API int dq_fused_drqn_max_grid(const DrqnDesc* d, int* max_grid) {
  if (!dr_desc_ok(d)) return (int)cudaErrorInvalidValue;
  const int smem = d->smem_floats * (int)sizeof(float);
  int dev, sms, coop, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = dr_allow_smem(d, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dr_kernel(d),
                                                        DR_THREADS, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return (int)err;
  *max_grid = per_sm * sms;
  return 0;
}

static void dr_inputs(DrArgs* a, int B, const void* obs, const void* nobs,
                      const void* action, const void* reward,
                      const void* done, const void* mask,
                      const void* q_sp_tgt, float gamma, int double_q) {
  a->obs = (const float*)obs;
  a->nobs = (const float*)nobs;
  a->action = (const int*)action;
  a->reward = (const float*)reward;
  a->done = (const float*)done;
  a->mask = (const float*)mask;
  a->q_sp_tgt = (const float*)q_sp_tgt;
  a->B = B;
  a->gamma = gamma;
  a->double_q = double_q;
  a->inv_bt = 1.0f / (float)(B * a->d.T);
}

static int dr_launch(DrArgs* a, int grid, cudaStream_t s) {
  const int smem = a->d.smem_floats * (int)sizeof(float);
  cudaError_t err = dr_allow_smem(&a->d, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {a};
  // a grid larger than the card holds at once is refused
  // (cudaErrorCooperativeLaunchTooLarge) and the wrapper raises
  err = cudaLaunchCooperativeKernel(dr_kernel(&a->d), dim3(grid),
                                    dim3(DR_THREADS), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

DQ_API int dq_fused_drqn(const DrqnDesc* d, const int64_t* p_ptrs,
                         const int64_t* m_ptrs, const int64_t* v_ptrs,
                         const void* count, int U, int B, const void* obs,
                         const void* nobs, const void* action,
                         const void* reward, const void* done,
                         const void* mask, const void* q_sp_tgt, float gamma,
                         int double_q, float lr, float b1, float b2,
                         float adam_eps, void* part_grad, void* part_loss,
                         void* loss, void* gnorm, void* stage, void* act,
                         int grid, void* stream) {
  if (!dr_desc_ok(d)) return (int)cudaErrorInvalidValue;
  DrArgs a;
  a.d = *d;
  dr_tab(d, p_ptrs, m_ptrs, v_ptrs, &a.tab);
  dr_inputs(&a, B, obs, nobs, action, reward, done, mask, q_sp_tgt, gamma,
            double_q);
  a.count = (const int*)count;
  a.U = U;
  a.lr = lr;
  a.b1 = b1;
  a.b2 = b2;
  a.adam_eps = adam_eps;
  a.part_grad = (float*)part_grad;
  a.part_loss = (float*)part_loss;
  a.loss = (float*)loss;
  a.gnorm = (float*)gnorm;
  a.flat = nullptr;
  a.stage = (float*)stage;
  a.act = (float*)act;
  return dr_launch(&a, grid, (cudaStream_t)stream);
}

// K8: the same kernel with U = 1 and `flat` set: the same phase A, the same
// tile partials and the same tile-order sum, written to the flat gradient
// [n_params] in the packed order (Dense w, b ..., then wi, wh, b: the
// plan's names) with the loss and the local max-abs entry; so K8, an
// identity all-reduce and dq_drqn_adam give K5's update bit for bit.
DQ_API int dq_fused_drqn_grads(const DrqnDesc* d, const int64_t* p_ptrs,
                               int B, const void* obs, const void* nobs,
                               const void* action, const void* reward,
                               const void* done, const void* mask,
                               const void* q_sp_tgt, float gamma,
                               int double_q, void* part_grad, void* part_loss,
                               void* flat, void* loss, void* gnorm, void* act,
                               int grid, void* stream) {
  if (!dr_desc_ok(d)) return (int)cudaErrorInvalidValue;
  DrArgs a;
  a.d = *d;
  dr_tab(d, p_ptrs, nullptr, nullptr, &a.tab);
  dr_inputs(&a, B, obs, nobs, action, reward, done, mask, q_sp_tgt, gamma,
            double_q);
  a.count = nullptr;  // no Adam
  a.U = 1;
  a.lr = a.b1 = a.b2 = a.adam_eps = 0.0f;
  a.part_grad = (float*)part_grad;
  a.part_loss = (float*)part_loss;
  a.loss = (float*)loss;
  a.gnorm = (float*)gnorm;
  a.flat = (float*)flat;
  a.stage = nullptr;
  a.act = (float*)act;
  return dr_launch(&a, grid, (cudaStream_t)stream);
}

// Adam on a flat gradient after the all-reduce (the data-parallel step):
// dq_launch_adam_flat (fused_update.cu), a thread per parameter over many
// blocks with phase B's arithmetic.
DQ_API int dq_drqn_adam(const DrqnDesc* d, const int64_t* p_ptrs,
                        const int64_t* m_ptrs, const int64_t* v_ptrs,
                        const void* count, int u, const void* grad, float lr,
                        float b1, float b2, float adam_eps, void* gnorm,
                        void* stream) {
  if (d->n_tensors > DQ_MAXT) return (int)cudaErrorInvalidValue;
  DqTab tab;
  dr_tab(d, p_ptrs, m_ptrs, v_ptrs, &tab);
  return (int)dq_launch_adam_flat(tab, d->n_params, count, u, grad, lr, b1,
                                  b2, adam_eps, gnorm, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// K11: the target net's Q(s') over N windows of T steps from a zero state,
// the input q_sp_tgt of K5 and K8. It replaces no Pallas kernel: the JAX
// package leaves this unroll to XLA, which fuses it; in ATen it was ~108
// short kernels per call (the input projection, per step a GEMM and ~11
// elementwise kernels on strided gate views, the stack, the heads, two
// transposes). The work is small (at the loop's shapes, 2048 windows of 8
// steps of LSTM(2, 32) and a dueling head: ~148 MFLOP, 2.2 µs at the FP32
// peak) and a chain of T dependent steps, so the kernel is bound by the
// latency of that chain, not by bytes or FLOPs.
//
// A plain grid (no grid barrier, no atomics: a call is deterministic and
// replays bit for bit): a block per tile of W windows (DT_TILE, fewer where
// shared memory is short). The block copies the params into K5's padded
// shared layout (dq_load_padded) and advances its windows step by step
// with K5's forward arithmetic: the Dense layers before the cell (dq_dot),
// the gates and the cell update a thread per row pair and hidden unit
// (dr_pair_dot on the rows' h and cell input feature-major, by step
// parity), then the heads' layers of one depth side by side and the
// dueling combination (dr_mean, dr_q), written straight to q [N, T, A].
// Only two step blocks a row are kept (by step parity): nothing is kept
// for a backward pass. The windows' next obs are read from global memory
// where a step needs them.
//
// Measured (PERF.md §6; clock64 marks of block 0 in a timing build):
// at the loop's shapes a step takes ~7K cycles, ~5K of them the gate step
// with 8 warps an SM (the latency of its dependent shared-memory loads
// and FMAs), and the param copy ~10K. Staging the obs in shared memory, a
// compile-time gate count and a deeper param copy each took ~2 µs off the
// ~36 µs, less than 1 % of the iteration: not kept.
#define DT_THREADS 256
#define DT_TILE 16
#define DT_MAX_SMEM (200 * 1024)  // fused_update.py's MAX_SMEM

// A tile's shared layout past the params: two step blocks per row by step
// parity [2, W, step_floats], the rows' h feature-major [2, H, rp] and
// their cell input [2, cin, rp], rp = W rounded up to 4.
struct DtLayout {
  int W, rp, f_st, f_ht, f_xt, smem_floats;
};

static DtLayout dt_layout(const DrqnDesc& d, int W) {
  DtLayout l;
  l.W = W;
  l.rp = (W + 3) & ~3;
  l.f_st = d.n_sp;
  l.f_ht = (l.f_st + 2 * W * d.step_floats + 3) & ~3;
  l.f_xt = l.f_ht + 2 * d.H * l.rp;
  l.smem_floats = l.f_xt + 2 * d.cin * l.rp;
  return l;
}

struct DtArgs {
  DrqnDesc d;
  DqTab tab;
  DtLayout l;
  const float* nobs;  // [N, T, in_dim]
  float* q;           // [N, T, A]
  int N;
};

// Row r's step block at time t.
__device__ __forceinline__ float* dt_blk(const DtArgs& a, float* smem, int r,
                                         int t) {
  return smem + a.l.f_st + ((t & 1) * a.l.W + r) * a.d.step_floats;
}

// Row r's next observation at time t (window g0 + r), in global memory.
__device__ __forceinline__ const float* dt_obs(const DtArgs& a, int g0, int r,
                                               int t) {
  return a.nobs + ((size_t)(g0 + r) * a.d.T + t) * a.d.in_dim;
}

// Dense layers la and lb (-1: none) side by side on the R rows at time t,
// dr_dense_fwd's arithmetic; the last layer before the cell also writes
// xT of this step's parity.
__device__ __forceinline__ void dt_dense(const DtArgs& a, float* smem, int g0,
                                         int R, int t, int la, int lb) {
  const DrqnDesc& d = a.d;
  const int na = (la >= 0) ? R * d.dout[la] : 0;
  const int nb = (lb >= 0) ? R * d.dout[lb] : 0;
  for (int k = threadIdx.x; k < na + nb; k += blockDim.x) {
    const int l = (k < na) ? la : lb, kk = (k < na) ? k : k - na;
    const int n = d.dout[l], r = kk / n, o = kk - r * n;
    float* st = dt_blk(a, smem, r, t);
    const float* in = (d.in_a[l] < 0) ? dt_obs(a, g0, r, t) : st + d.in_a[l];
    const float z = dq_dot(in, smem + d.sw[l] + o, d.ldw[l], d.din[l]);
    const float y = dq_act(z + smem[d.sb[l] + o], d.act[l]);
    st[d.off_a[l] + o] = y;
    if (l == d.n_pre - 1)
      smem[a.l.f_xt + ((t & 1) * d.cin + o) * a.l.rp + r] = y;
  }
  __syncthreads();
}

// One time step of the target net on the tile's R rows, then Q(s') of
// each row into q. No barrier after the Q writes: the next step writes the
// other parity's step blocks, and this parity's only after its barriers.
__device__ __forceinline__ void dt_step(const DtArgs& a, float* smem, int g0,
                                        int R, int t) {
  const DrqnDesc& d = a.d;
  const float* sp = smem;
  const int H = d.H, rp = a.l.rp;
  for (int l = 0; l < d.n_pre; ++l) dt_dense(a, smem, g0, R, t, l, -1);
  // the gates and the cell, dr_forward_step's arithmetic: thread (row pair
  // p, hidden unit j) takes every gate column of unit j for its two rows
  const int NG = (d.cell == 0) ? 4 : 3, cur = t & 1;
  const float2* xT = reinterpret_cast<const float2*>(
      smem + a.l.f_xt + cur * d.cin * rp);
  const float2* hT =
      reinterpret_cast<const float2*>(smem + a.l.f_ht + cur * H * rp);
  float* hTn = smem + a.l.f_ht + (cur ^ 1) * H * rp;
  const int np = (R + 1) >> 1;
  for (int k = threadIdx.x; k < np * H; k += blockDim.x) {
    const int p = k / H, j = k - p * H;
    float xi[4][2] = {}, hh[4][2] = {}, b[4] = {};
    dr_pair_dot(xT + p, rp >> 1, sp + d.s_wi + j, d.ld_wi, H, NG, d.cin, xi);
    dr_pair_dot(hT + p, rp >> 1, sp + d.s_wh + j, d.ld_wh, H, NG, H, hh);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (g < NG) b[g] = sp[d.s_bc + g * H + j];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = 2 * p + q;
      if (r >= R) break;
      float* st = dt_blk(a, smem, r, t);
      const float* prev = t ? dt_blk(a, smem, r, t - 1) : nullptr;
      float h;
      if (d.cell == 0) {
        const float ig = dr_sigmoid(xi[0][q] + hh[0][q] + b[0]);
        const float fg = dr_sigmoid(xi[1][q] + hh[1][q] + b[1]);
        const float gg = tanhf(xi[2][q] + hh[2][q] + b[2]);
        const float og = dr_sigmoid(xi[3][q] + hh[3][q] + b[3]);
        const float cp = prev ? prev[d.a_c + j] : 0.0f;
        const float c = fg * cp + ig * gg;
        st[d.a_c + j] = c;
        h = og * tanhf(c);
      } else {
        const float rg = dr_sigmoid(xi[0][q] + hh[0][q] + b[0]);
        const float zg = dr_sigmoid(xi[1][q] + hh[1][q] + b[1]);
        const float n = tanhf((xi[2][q] + b[2]) + rg * hh[2][q]);
        const float hp = prev ? prev[d.a_h + j] : 0.0f;
        h = (1.0f - zg) * n + zg * hp;
      }
      st[d.a_h + j] = h;
      hTn[j * rp + r] = h;
    }
  }
  // the next step's observations into xT of the next parity when the cell
  // reads them
  if (d.n_pre == 0 && t + 1 < d.T)
    for (int k = threadIdx.x; k < R * d.cin; k += blockDim.x) {
      const int r = k / d.cin, i = k - r * d.cin;
      smem[a.l.f_xt + (cur ^ 1) * d.cin * rp + i * rp + r] =
          dt_obs(a, g0, r, t + 1)[i];
    }
  __syncthreads();
  const int lv = d.n_pre, la = d.n_pre + d.n_val;
  for (int s = 0; s < max(d.n_val, d.n_adv); ++s)
    dt_dense(a, smem, g0, R, t, s < d.n_val ? lv + s : -1,
             s < d.n_adv ? la + s : -1);
  const int A = d.A;
  for (int k = threadIdx.x; k < R * A; k += blockDim.x) {
    const int r = k / A, c = k - r * A;
    const float* st = dt_blk(a, smem, r, t);
    a.q[((size_t)(g0 + r) * d.T + t) * A + c] = dr_q(d, st, c, dr_mean(d, st));
  }
}

__global__ void __launch_bounds__(DT_THREADS)
    dr_target_kernel(const __grid_constant__ DtArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ DqTab tab;
  const DrqnDesc& d = a.d;
  const int rp = a.l.rp, g0 = blockIdx.x * a.l.W;
  const int R = min(a.l.W, a.N - g0);
  dq_tab_copy(a.tab, tab);
  // the zero state: both parities of hT; xT of step 0 holds the rows'
  // first observations when the cell reads them
  for (int k = threadIdx.x; k < 2 * d.H * rp; k += blockDim.x)
    smem[a.l.f_ht + k] = 0.0f;
  for (int k = threadIdx.x; k < 2 * d.cin * rp; k += blockDim.x) {
    const int i = k / rp, r = k - i * rp;
    smem[a.l.f_xt + k] = (d.n_pre == 0 && i < d.cin && r < R)
                             ? dt_obs(a, g0, r, 0)[i] : 0.0f;
  }
  __syncthreads();
  dq_load_padded(tab, d.n_params, smem);
  for (int t = 0; t < d.T; ++t) dt_step(a, smem, g0, R, t);
}

// The shared memory each device allows dr_target_kernel so far (only ever
// raised).
static int dt_smem_allowed[DR_MAX_DEVICES];

// q [N, T, A] = the target net's Q over next_obs [N, T, in_dim] from a zero
// state, params in the plan's packed order; launched on stream.
DQ_API int dq_drqn_target(const DrqnDesc* d, const int64_t* p_ptrs, int N,
                          const void* nobs, void* q, void* stream) {
  if (!dr_desc_ok(d) || N < 1) return (int)cudaErrorInvalidValue;
  DtArgs a;
  a.d = *d;
  dr_tab(d, p_ptrs, nullptr, nullptr, &a.tab);
  int W = DT_TILE;
  while (W > 1 && dt_layout(*d, W).smem_floats * (int)sizeof(float) >
                      DT_MAX_SMEM)
    W >>= 1;
  a.l = dt_layout(*d, W);
  a.nobs = (const float*)nobs;
  a.q = (float*)q;
  a.N = N;
  const int smem = a.l.smem_floats * (int)sizeof(float);
  if (smem > DT_MAX_SMEM) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= DR_MAX_DEVICES ||
                             smem > dt_smem_allowed[dev])) {
    err = cudaFuncSetAttribute(dr_target_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess && dev < DR_MAX_DEVICES)
      dt_smem_allowed[dev] = smem;
  }
  if (err != cudaSuccess) return (int)err;
  dr_target_kernel<<<(N + W - 1) / W, DT_THREADS, smem,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
