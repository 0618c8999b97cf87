// K3: the grouped train phase, U sequential DQN sub-updates, in ONE
// cooperative launch (replaces fused_group_update of
// deepqlearning_tpu/ops/pallas/fused_update.py). K7, one sub-update
// emitting its flat gradient for the data-parallel step, is the same kernel
// with U = 1 and the reduced gradient written out in place of Adam; the
// Adam launch that follows the all-reduce (K8's route takes it too) closes
// the file. Phase B, the padded parameter copy and the dot products are
// shared with K5 (common.cuh).
//
// The Pallas kernel kept params and Adam moments in VMEM across a
// sequential grid over u. Its counterpart here is one persistent launch
// (cudaLaunchCooperativeKernel) whose blocks loop over u, with two grid
// barriers per sub-update:
//   phase A: the batch of B rows is cut into tiles of FU_TILE rows; blocks
//     stride over the tiles. A block copies the current params from global
//     memory (L2) into shared memory (for u > 0 a flat float4 copy of the
//     padded layout phase B staged), runs the (dueling) Dense forward on
//     the tile's s rows and, for double-Q, its s' rows in the same pass
//     (the s activations are kept for the backward; both heads' layers of
//     one depth share a block-wide step), the TD error / priority / Huber
//     terms, and the hand-derived backward (again both heads per step).
//     The tile's partial gradient (summed over its rows in order) goes to
//     part_grad[tile, n_params] and its Huber sum to part_loss[tile]: per
//     tile, not per block, so no sum depends on the grid size.
//   grid.sync()
//   phase B: one thread per parameter, warps interleaved over the blocks,
//     sums the tile partials in tile order and applies Adam at t = count +
//     u + 1 to params, m and v in place, staging the new params in the
//     padded layout for the next copy-in. On the last u the max-abs entry
//     meets in an atomicMax on the float's bits (a slot zeroed in the
//     kernel) and the loss is the tile-order Huber sum times 1/B.
//   grid.sync(), then the next u.
// Params, m and v are written inside the launch by other blocks, so they
// are read with __ldcg (L2, never the non-coherent path) after each grid
// barrier. Every sum has a fixed order, so a run is deterministic whatever
// the grid. The shared copy of each weight matrix has an odd row stride,
// so dh = dz·Wᵀ (consecutive threads on the input index i) reads distinct
// banks; every dot product issues DQ_DOT operand loads before its FMAs.
// Measured (PERF.md, k3_phases.py): per sub-update the tile's steps take
// ~60% of the time, bound by shared-memory load issue in the 64-wide dot
// products and (by the layout) 8-way bank conflicts in the 1- and 4-wide
// output layers;
// phase B's L2 round trips ~25%; the two barriers ~9%.
//
// Arithmetic stays FP32 FMA on the CUDA cores: at the headline shapes
// (B = 512, a 2->64->64->{1,4} dueling net, U = 32) a grouped call is
// ~1.1 GFLOP, 17 µs at the card's FP32 peak, and its time is latency
// (barriers, dependent layer steps, L2 round trips), not FLOPs. TF32
// tensor cores would change the argmax and the parity held against the
// JAX package; they are a candidate for a later PR, not this one.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define FU_TILE 4
#define FU_THREADS 512

// Shared-memory placement of the padded parameter copy: layer l's weight
// rows at sw[l] with row stride ldw[l] (odd), its bias at sb[l]; n floats.
struct FuLayout {
  int ldw[DQ_MAXL];
  int sw[DQ_MAXL];
  int sb[DQ_MAXL];
  int n;
  // ceil(2^32 / dout) and ceil(2^32 / din) per layer (fu_div)
  unsigned long long mdout[DQ_MAXL];
  unsigned long long mdin[DQ_MAXL];
};

// Everything one grouped call reads (one by-value kernel argument).
struct FuArgs {
  NetDesc d;
  FuLayout L;
  DqTab tab;  // the params (and m, v) by tensor, placed as in L
  const float* obs;
  const float* nobs;
  const int* action;
  const float* reward;
  const float* done;
  const float* weights;
  const float* q_sp_tgt;
  const int* count;
  int U, B, double_q;
  float gamma, alpha, eps, inv_b, lr, b1, b2, adam_eps;
  float* td;
  float* prio;
  float* part_grad;
  float* part_loss;
  float* loss;
  float* gnorm;
  float* flat;   // K7: the reduced gradient is written here, no Adam
  float* stage;  // K3: the updated params in the padded shared layout
};

#ifdef FU_TRACE
// Timestamps of block 0 (a diagnostic build, -DFU_TRACE). fu_trace, per u:
// clock64 at the start, after the param copy, after the tiles, after the
// first barrier, after phase B and after the second barrier. fu_trace2,
// per u, inside block 0's tile: the start, after the input copy, after
// each forward step (2..4), after Q, the TD step and dz (5..7), after each
// backward step (8..10).
__device__ long long fu_trace[64 * 6];
__device__ long long fu_trace2[64 * 16];
#define FU_MARK(u, j)                                                  \
  if (blockIdx.x == 0 && threadIdx.x == 0 && (u) < 64)                 \
    fu_trace[(u) * 6 + (j)] = clock64();
#define FU_T(tr, j) \
  if ((tr) != nullptr && threadIdx.x == 0 && (j) < 16) (tr)[j] = clock64();
DQ_API int dq_fu_trace(void* out, void* out2) {
  cudaError_t err = cudaMemcpyFromSymbol(out, fu_trace, sizeof(fu_trace));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out2, fu_trace2, sizeof(fu_trace2));
  return (int)err;
}
#else
#define FU_MARK(u, j)
#define FU_T(tr, j)
#endif

static void fu_layout(const NetDesc* d, FuLayout* L) {
  int n = 0;
  for (int l = 0; l < d->n_val + d->n_adv; ++l) {
    L->ldw[l] = (d->dout[l] % 2) ? d->dout[l] : d->dout[l] + 1;
    L->sw[l] = n;
    L->sb[l] = n + d->din[l] * L->ldw[l];
    n = L->sb[l] + d->dout[l];
    L->mdout[l] = ((1ull << 32) + d->dout[l] - 1) / d->dout[l];
    L->mdin[l] = ((1ull << 32) + d->din[l] - 1) / d->din[l];
  }
  L->n = n;
}

// Shared-memory bytes of one block (FusedPlan.smem_bytes in
// ops/cuda/fused_update.py computes the same sum): the padded params, then
// for 2·TILE forward rows the inputs, every layer's outputs and Q, the
// tile's target-net Q(s') rows and its reward / done / weight / action,
// then the TD terms, the value head's dz and four dz buffers of TILE rows
// (two per head).
static int fu_smem_bytes(const NetDesc* d, const FuLayout* L) {
  const int fr = 2 * FU_TILE;
  int floats = L->n + fr * (d->in_dim + d->h_per_row + d->num_actions) +
               FU_TILE * d->num_actions + 4 * FU_TILE + 3 * FU_TILE +
               4 * FU_TILE * d->maxw;
  if (floats < FU_THREADS) floats = FU_THREADS;  // phase B's block max
  return floats * (int)sizeof(float);
}

// n / d for 0 <= n < 2^16 and 1 <= d <= 2^16, with m = ceil(2^32 / d)
// (FuLayout, computed on the host): one wide multiply in place of an
// integer division per work item.
__device__ __forceinline__ int fu_div(int n, unsigned long long m) {
  return (int)(((unsigned long long)n * m) >> 32);
}

// One Dense layer's constants for a block-wide forward step, read from the
// kernel argument once per step rather than once per work item.
struct FuFwd {
  const float* W;  // shared, row stride ldw
  const float* b;
  const float* in;  // [rows, din]
  float* out;       // [rows, dout]
  int din, dout, ldw, act, items;
  unsigned long long mdout;
};

__device__ __forceinline__ FuFwd fu_fwd_layer(const FuArgs& a, const float* sp,
                                              const float* sX, float* sH,
                                              int l, int first, int nrows) {
  const NetDesc& d = a.d;
  FuFwd f;
  f.W = sp + a.L.sw[l];
  f.b = sp + a.L.sb[l];
  f.in = (l == first) ? sX : sH + d.off_h[l - 1] * (2 * FU_TILE);
  f.out = sH + d.off_h[l] * (2 * FU_TILE);
  f.din = d.din[l];
  f.dout = d.dout[l];
  f.ldw = a.L.ldw[l];
  f.act = d.act[l];
  f.items = nrows * f.dout;
  f.mdout = a.L.mdout[l];
  return f;
}

// Output k (row k / dout, column o) of a forward step: act(b[o] + sum_i
// in[r, i] * W[i, o]), one accumulator summed over i in ascending order;
// consecutive k are consecutive o (conflict-free W reads, broadcast inputs).
__device__ __forceinline__ void fu_fwd_item(const FuFwd& f, int k) {
  const int r = fu_div(k, f.mdout), o = k - r * f.dout;
  const float z = dq_dot(f.in + r * f.din, f.W + o, f.ldw, f.din);
  f.out[k] = dq_act(z + f.b[o], f.act);
}

// The forward of both heads on nrows rows, one block-wide step per depth:
// step s runs value layer s and advantage layer n_val + s side by side
// (a plain chain is the advantage head alone). Every output is kept in sH.
__device__ void fu_forward(const FuArgs& a, const float* sp, const float* sX,
                           float* sH, int nrows, long long* tr) {
  const NetDesc& d = a.d;
  const int nv = d.n_val, na = d.n_adv;
  for (int s = 0; s < max(nv, na); ++s) {
    FuFwd v, w;
    v.items = w.items = 0;
    if (s < nv) v = fu_fwd_layer(a, sp, sX, sH, s, 0, nrows);
    if (s < na) w = fu_fwd_layer(a, sp, sX, sH, nv + s, nv, nrows);
    for (int k = threadIdx.x; k < v.items + w.items; k += blockDim.x) {
      if (k < v.items)
        fu_fwd_item(v, k);
      else
        fu_fwd_item(w, k - v.items);
    }
    __syncthreads();
    FU_T(tr, 2 + s)
  }
}

// One Dense layer's constants for a block-wide backward step on the
// tile's nr rows, from dz = dL/d(pre-activation) in cur. Its work items:
// dW (din*dout, into the tile's partial), db (dout), then, below the
// head's first layer, the next dz (nr*din) = (dz · Wᵀ) * act'(h_{l-1})
// into nxt.
struct FuBwd {
  const float* W;      // shared, row stride ldw
  const float* hprev;  // [nr, din], the layer's input
  const float* cur;    // [nr, dout]
  float* nxt;          // [nr, din]
  float* gw;           // the tile's partial dW, then db
  float* gb;
  int din, dout, ldw, act_prev, nr, n_w, n_wb, items;
  unsigned long long mdout, mdin;
};

__device__ __forceinline__ FuBwd fu_bwd_layer(const FuArgs& a, const float* sp,
                                              const float* sX, const float* sH,
                                              float* g, int l, int first,
                                              const float* cur, float* nxt,
                                              int nr) {
  const NetDesc& d = a.d;
  FuBwd b;
  b.W = sp + a.L.sw[l];
  b.hprev = (l == first) ? sX : sH + d.off_h[l - 1] * (2 * FU_TILE);
  b.cur = cur;
  b.nxt = nxt;
  b.gw = g + d.off_w[l];
  b.gb = g + d.off_b[l];
  b.din = d.din[l];
  b.dout = d.dout[l];
  b.ldw = a.L.ldw[l];
  b.act_prev = (l > first) ? d.act[l - 1] : 0;
  b.nr = nr;
  b.n_w = b.din * b.dout;
  b.n_wb = b.n_w + b.dout;
  b.items = b.n_wb + ((l > first) ? nr * b.din : 0);
  b.mdout = a.L.mdout[l];
  b.mdin = a.L.mdin[l];
  return b;
}

// Work item k of a backward step (see FuBwd); the odd row stride of the
// shared W keeps consecutive i on distinct banks in the dz · Wᵀ items.
__device__ __forceinline__ void fu_bwd_item(const FuBwd& b, int k) {
  const float* __restrict__ cur = b.cur;
  if (k < b.n_w) {
    const int i = fu_div(k, b.mdout), o = k - i * b.dout;
    const float* __restrict__ h = b.hprev + i;
    float hs[FU_TILE], cs[FU_TILE];
#pragma unroll
    for (int r = 0; r < FU_TILE; ++r) {
      hs[r] = (r < b.nr) ? h[r * b.din] : 0.0f;
      cs[r] = (r < b.nr) ? cur[r * b.dout + o] : 0.0f;
    }
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < FU_TILE; ++r)
      if (r < b.nr) s = fmaf(hs[r], cs[r], s);
    b.gw[k] = s;
  } else if (k < b.n_wb) {
    const int o = k - b.n_w;
    float s = 0.0f;
    for (int r = 0; r < b.nr; ++r) s += cur[r * b.dout + o];
    b.gb[o] = s;
  } else {
    k -= b.n_wb;
    const int r = fu_div(k, b.mdin), i = k - r * b.din;
    const float s = dq_dot(cur + r * b.dout, b.W + i * b.ldw, 1, b.dout);
    b.nxt[k] = s * dq_act_grad(b.hprev[k], b.act_prev);
  }
}

// The backward of both heads, one block-wide step per depth from the top:
// step s runs value layer n_val-1-s and advantage layer n_val+n_adv-1-s
// side by side. Each head's dz starts in dzv / dza and moves down in its
// own two buffers (bv0/bv1, ba0/ba1); the tile's dW/db go to g.
__device__ void fu_backward(const FuArgs& a, const float* sp, const float* sX,
                            const float* sH, float* g, int nr,
                            const float* dzv, float* bv0, float* bv1,
                            const float* dza, float* ba0, float* ba1,
                            long long* tr) {
  const NetDesc& d = a.d;
  const int nv = d.n_val, na = d.n_adv;
  const float* cv = dzv;
  const float* ca = dza;
  for (int s = 0; s < max(nv, na); ++s) {
    float* nv_ = (cv == bv0) ? bv1 : bv0;
    float* na_ = (ca == ba0) ? ba1 : ba0;
    FuBwd v, w;
    v.items = w.items = 0;
    if (s < nv) v = fu_bwd_layer(a, sp, sX, sH, g, nv - 1 - s, 0, cv, nv_, nr);
    if (s < na)
      w = fu_bwd_layer(a, sp, sX, sH, g, nv + na - 1 - s, nv, ca, na_, nr);
    for (int k = threadIdx.x; k < v.items + w.items; k += blockDim.x) {
      if (k < v.items)
        fu_bwd_item(v, k);
      else
        fu_bwd_item(w, k - v.items);
    }
    __syncthreads();
    FU_T(tr, 8 + s)
    cv = nv_;
    ca = na_;
  }
}

// Phase A for one tile of sub-update u; sp already holds the params.
__device__ void fu_tile(const FuArgs& a, float* smem, int tile, int u) {
  const NetDesc& d = a.d;
  const int A = d.num_actions, D0 = d.in_dim, FR = 2 * FU_TILE;
  const int r0 = tile * FU_TILE;
  const int nr = min(FU_TILE, a.B - r0);
  const int g0 = u * a.B + r0;  // first global row of the tile in [U*B]
  const int nf = a.double_q ? FR : FU_TILE;  // forward rows: s, then s'
  long long* tr = nullptr;
#ifdef FU_TRACE
  if (blockIdx.x == 0 && tile == 0 && u < 64) tr = fu_trace2 + u * 16;
#endif
  FU_T(tr, 0)

  float* sp = smem;
  float* sX = sp + a.L.n;              // [FR, D0]: s rows, then s' rows
  float* sTgt = sX + FR * D0;          // [TILE, A] target-net Q(s')
  float* sRow = sTgt + FU_TILE * A;    // [4, TILE] reward, done, w, action
  float* sH = sRow + 4 * FU_TILE;      // [FR, h_per_row], layer-major
  float* sQ = sH + FR * d.h_per_row;   // [FR, A]
  float* sG = sQ + FR * A;             // [TILE] dL/dq_sa
  float* sLoss = sG + FU_TILE;         // [TILE]
  float* sDv = sLoss + FU_TILE;        // [TILE] value head's dz
  float* bA = sDv + FU_TILE;           // [4, TILE, maxw] dz buffers,
  float* bB = bA + FU_TILE * d.maxw;   // two per head
  float* bC = bB + FU_TILE * d.maxw;
  float* bD = bC + FU_TILE * d.maxw;

  // every input of the tile in one pass (one memory latency, not one per
  // array): obs, nobs, Q(s') rows, then the four per-row scalars; actions
  // as floats (exact below 2^24)
  const int nx = FU_TILE * D0, nt = FU_TILE * A;
  for (int k = threadIdx.x; k < 2 * nx + nt + 4 * FU_TILE; k += blockDim.x) {
    float x = 0.0f;
    if (k < 2 * nx) {
      const int j = (k < nx) ? k : k - nx;
      if (j / D0 < nr && (k < nx || a.double_q))
        x = ((k < nx) ? a.obs : a.nobs)[(size_t)g0 * D0 + j];
    } else if (k < 2 * nx + nt) {
      const int j = k - 2 * nx;
      if (j / A < nr) x = a.q_sp_tgt[(size_t)g0 * A + j];
    } else {
      const int j = k - 2 * nx - nt, f = j / FU_TILE, r = j - f * FU_TILE;
      if (r < nr) {
        const int gr = g0 + r;
        x = (f == 0) ? a.reward[gr]
            : (f == 1) ? a.done[gr]
            : (f == 2) ? a.weights[gr] : (float)a.action[gr];
      }
    }
    sX[k] = x;
  }
  __syncthreads();
  FU_T(tr, 1)

  // online forward on s (kept for the backward) and s' (double-Q argmax)
  const int la = d.n_val + d.n_adv - 1;  // last adv layer
  fu_forward(a, sp, sX, sH, nf, tr);
  const float* aout = sH + d.off_h[la] * FR;
  const float* vout = d.dueling ? sH + d.off_h[d.n_val - 1] * FR : nullptr;
  // q = V + A - mean(A) (dueling) or q = A; mean summed in order, times 1/A
  for (int r = threadIdx.x; r < nf; r += blockDim.x) {
    if (d.dueling) {
      float s = 0.0f;
      for (int c = 0; c < A; ++c) s += aout[r * A + c];
      const float mean = s * (1.0f / (float)A);
      for (int c = 0; c < A; ++c) sQ[r * A + c] = vout[r] + aout[r * A + c] - mean;
    } else {
      for (int c = 0; c < A; ++c) sQ[r * A + c] = aout[r * A + c];
    }
  }
  __syncthreads();
  FU_T(tr, 5)

  // TD error, priority, Huber term and dL/dq_sa per row
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    const int gr = g0 + r;
    const float* tgt = sTgt + r * A;
    float q_sp_max;
    if (a.double_q) {
      const float* q2 = sQ + (FU_TILE + r) * A;
      int best = 0;
      float bv = q2[0];
      for (int c = 1; c < A; ++c)
        if (q2[c] > bv) { bv = q2[c]; best = c; }
      q_sp_max = tgt[best];
    } else {
      q_sp_max = tgt[0];
      for (int c = 1; c < A; ++c) q_sp_max = fmaxf(q_sp_max, tgt[c]);
    }
    const float target =
        sRow[r] + (1.0f - sRow[FU_TILE + r]) * a.gamma * q_sp_max;
    // an action outside [0, A) selects nothing (Q_sa = 0, no gradient): the
    // port's rule on every route (ops/helpers.py::action_mask)
    const int act = (int)sRow[3 * FU_TILE + r];
    const float td = ((act >= 0 && act < A) ? sQ[r * A + act] : 0.0f) - target;
    const float w = sRow[2 * FU_TILE + r];
    const float x = w * td;
    const float absx = fabsf(x);
    const float quad = fminf(absx, 1.0f);
    sLoss[r] = 0.5f * quad * quad + (absx - quad);
    sG[r] = w * fminf(fmaxf(x, -1.0f), 1.0f) * a.inv_b;
    a.td[gr] = td;
    a.prio[gr] = powf(fabsf(td) + a.eps, a.alpha);
  }
  __syncthreads();
  FU_T(tr, 6)

  // dL/dq is g_sa at the taken action; through the dueling combination
  // g_adv = g_q - (sum_c g_q) / A and g_val = sum_c g_q = g_sa; times the
  // last layers' act'
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int r = 0; r < nr; ++r) s += sLoss[r];
    a.part_loss[tile] = s;
  }
  for (int k = threadIdx.x; k < nr * A; k += blockDim.x) {
    const int r = k / A, c = k - r * A;
    const float gs = sG[r];
    float gq = (c == (int)sRow[3 * FU_TILE + r]) ? gs : 0.0f;
    if (d.dueling) gq -= gs * (1.0f / (float)A);
    bA[k] = gq * dq_act_grad(aout[k], d.act[la]);
  }
  if (d.dueling)
    for (int r = threadIdx.x; r < nr; r += blockDim.x)
      sDv[r] = sG[r] * dq_act_grad(vout[r], d.act[d.n_val - 1]);
  __syncthreads();
  float* g = a.part_grad + (size_t)tile * d.n_params;
  FU_T(tr, 7)
  fu_backward(a, sp, sX, sH, g, nr, sDv, bC, bD, bA, bA, bB, tr);
}

__global__ void __launch_bounds__(FU_THREADS)
    fu_group_kernel(const __grid_constant__ FuArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ DqTab tab;
  cg::grid_group grid = cg::this_grid();
  const int ntiles = (a.B + FU_TILE - 1) / FU_TILE;
  dq_tab_copy(a.tab, tab);
  // the max-abs slot: zeroed before the first barrier, atomics after it
  if (blockIdx.x == 0 && threadIdx.x == 0) a.gnorm[0] = 0.0f;
  __syncthreads();
  for (int u = 0; u < a.U; ++u) {
    FU_MARK(u, 0)
    if (blockIdx.x < ntiles) {
      if (u == 0)
        dq_load_padded(tab, a.d.n_params, smem);
      else
        dq_copy_stage(a.stage, smem, a.L.n);
    }
    FU_MARK(u, 1)
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
      fu_tile(a, smem, tile, u);
    FU_MARK(u, 2)
    grid.sync();
    FU_MARK(u, 3)
    const DqPhaseB b = {a.part_grad, a.part_loss, a.count, a.d.n_params,
                        ntiles, a.U, a.lr, a.b1, a.b2, a.adam_eps, a.inv_b,
                        a.loss, a.gnorm, a.flat, a.stage};
    dq_reduce_adam(b, tab, u, smem);
    FU_MARK(u, 4)
    if (u + 1 < a.U) grid.sync();
    FU_MARK(u, 5)
  }
}

// The tensor table of a network (w0, b0, w1, ...), placed as in L (null:
// no shared copy) with the device pointers of params, m and v (null: no
// Adam).
static void fu_tab(const NetDesc* d, const FuLayout* L, const int64_t* p,
                   const int64_t* m, const int64_t* v, DqTab* t) {
  const int nl = d->n_val + d->n_adv;
  for (int l = 0; l < nl; ++l) {
    t->start[2 * l] = d->off_w[l];
    t->start[2 * l + 1] = d->off_b[l];
    t->cols[2 * l] = t->cols[2 * l + 1] = d->dout[l];
    t->dst[2 * l] = L ? L->sw[l] : 0;
    t->dst[2 * l + 1] = L ? L->sb[l] : 0;
    t->ld[2 * l] = L ? L->ldw[l] : 0;
    t->ld[2 * l + 1] = 0;
  }
  t->start[2 * nl] = d->n_params;
  for (int i = 0; i < 2 * nl; ++i) {
    t->p[i] = (float*)p[i];
    t->m[i] = m ? (float*)m[i] : nullptr;
    t->v[i] = v ? (float*)v[i] : nullptr;
  }
}

// The dynamic shared memory fu_group_kernel is allowed on each device so
// far: the attribute is only ever raised, when a plan needs more (a host
// call saved per launch: the data-parallel step launches K7 per sub-update).
#define FU_MAX_DEVICES 64
static int fu_smem_allowed[FU_MAX_DEVICES];

static cudaError_t fu_allow_smem(int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < FU_MAX_DEVICES && smem <= fu_smem_allowed[dev]))
    return err;
  err = cudaFuncSetAttribute(fu_group_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < FU_MAX_DEVICES) fu_smem_allowed[dev] = smem;
  return err;
}

// The most blocks of fu_group_kernel the card holds at once for this
// network (co-resident blocks per SM times the SM count): the ceiling of a
// cooperative launch's grid. The wrapper caches it per plan.
DQ_API int dq_fused_update_max_grid(const NetDesc* d, int* max_grid) {
  FuLayout L;
  fu_layout(d, &L);
  const int smem = fu_smem_bytes(d, &L);
  int dev, sms, coop, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = fu_allow_smem(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fu_group_kernel,
                                                        FU_THREADS, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return (int)err;
  *max_grid = per_sm * sms;
  return 0;
}

static int fu_launch(FuArgs* a, const int64_t* p, const int64_t* m,
                     const int64_t* v, int grid, cudaStream_t s) {
  fu_layout(&a->d, &a->L);
  fu_tab(&a->d, &a->L, p, m, v, &a->tab);
  const int smem = fu_smem_bytes(&a->d, &a->L);
  cudaError_t err = fu_allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {a};
  // a grid larger than the card holds at once is refused
  // (cudaErrorCooperativeLaunchTooLarge) and the wrapper raises
  err = cudaLaunchCooperativeKernel((const void*)fu_group_kernel, dim3(grid),
                                    dim3(FU_THREADS), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

DQ_API int dq_fused_update(const NetDesc* d, const int64_t* p_ptrs,
                           const int64_t* m_ptrs, const int64_t* v_ptrs,
                           const void* count, int U, int B, const void* obs,
                           const void* nobs, const void* action,
                           const void* reward, const void* done,
                           const void* weights, const void* q_sp_tgt,
                           float gamma, float alpha, float eps, int double_q,
                           float lr, float b1, float b2, float adam_eps,
                           void* td, void* prio, void* part_grad,
                           void* part_loss, void* loss, void* gnorm,
                           void* stage, int grid, void* stream) {
  FuArgs a;
  a.d = *d;
  a.obs = (const float*)obs;
  a.nobs = (const float*)nobs;
  a.action = (const int*)action;
  a.reward = (const float*)reward;
  a.done = (const float*)done;
  a.weights = (const float*)weights;
  a.q_sp_tgt = (const float*)q_sp_tgt;
  a.count = (const int*)count;
  a.U = U;
  a.B = B;
  a.double_q = double_q;
  a.gamma = gamma;
  a.alpha = alpha;
  a.eps = eps;
  a.inv_b = 1.0f / (float)B;
  a.lr = lr;
  a.b1 = b1;
  a.b2 = b2;
  a.adam_eps = adam_eps;
  a.td = (float*)td;
  a.prio = (float*)prio;
  a.part_grad = (float*)part_grad;
  a.part_loss = (float*)part_loss;
  a.loss = (float*)loss;
  a.gnorm = (float*)gnorm;
  a.flat = nullptr;
  a.stage = (float*)stage;
  return fu_launch(&a, p_ptrs, m_ptrs, v_ptrs, grid, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// K7: one sub-update's forward, TD loss and backward, emitting its flat
// gradient (replaces fused_grads of deepqlearning_tpu/ops/pallas/
// fused_update.py). The data-parallel train step all-reduces that gradient
// between K7 and the Adam launch, which is why the two cannot be one kernel
// as in K3. K7 is fu_group_kernel with U = 1 and `flat` set: the same phase
// A, the same per-tile partials and the same tile-order sum, written to the
// flat gradient [n_params] in the packed order w0, b0, w1, b1, ... (the
// plan's names) with the loss and the max-abs entry; so K7, an identity
// all-reduce and the Adam launch below give K3's update bit for bit. The
// flat buffer is the vector the all-reduce takes: nothing is concatenated
// or split.

DQ_API int dq_fused_grads(const NetDesc* d, const int64_t* p_ptrs, int B,
                          const void* obs, const void* nobs,
                          const void* action, const void* reward,
                          const void* done, const void* weights,
                          const void* q_sp_tgt, float gamma, float alpha,
                          float eps, int double_q, void* td, void* prio,
                          void* part_grad, void* part_loss, void* flat,
                          void* loss, void* gnorm, int grid, void* stream) {
  FuArgs a;
  a.d = *d;
  a.obs = (const float*)obs;
  a.nobs = (const float*)nobs;
  a.action = (const int*)action;
  a.reward = (const float*)reward;
  a.done = (const float*)done;
  a.weights = (const float*)weights;
  a.q_sp_tgt = (const float*)q_sp_tgt;
  a.count = nullptr;  // no Adam
  a.U = 1;
  a.B = B;
  a.double_q = double_q;
  a.gamma = gamma;
  a.alpha = alpha;
  a.eps = eps;
  a.inv_b = 1.0f / (float)B;
  a.lr = a.b1 = a.b2 = a.adam_eps = 0.0f;
  a.td = (float*)td;
  a.prio = (float*)prio;
  a.part_grad = (float*)part_grad;
  a.part_loss = (float*)part_loss;
  a.loss = (float*)loss;
  a.gnorm = (float*)gnorm;
  a.flat = (float*)flat;
  a.stage = nullptr;
  return fu_launch(&a, p_ptrs, nullptr, nullptr, grid, (cudaStream_t)stream);
}

// Adam on a flat gradient (the data-parallel steps, after the all-reduce):
// one thread per parameter over ceil(n / 256) blocks, phase B's Adam
// arithmetic (dq_adam) at t = count + u + 1; gnorm is the gradient's
// max-abs entry, as the JAX data-parallel step logs it. K7's route (below)
// and K8's (fused_drqn.cu) launch it.

#define DQ_ADAM_THREADS 256

__global__ void __launch_bounds__(DQ_ADAM_THREADS) dq_adam_flat_kernel(
    const __grid_constant__ DqTab tab, int n, const int* __restrict__ count,
    int u, const float* __restrict__ grad, float lr, float b1, float b2,
    float adam_eps, float* gnorm) {
  __shared__ float red[DQ_ADAM_THREADS];
  const float t = (float)(count[0] + u + 1);
  const float c1 = dq_bias_corr(b1, t), c2 = dq_bias_corr(b2, t);
  const int k = blockIdx.x * DQ_ADAM_THREADS + threadIdx.x;
  float a = 0.0f;
  if (k < n) {
    const float g = grad[k];
    const int ti = dq_tab_find(tab, k), j = k - tab.start[ti];
    float pk = tab.p[ti][j], mk = tab.m[ti][j], vk = tab.v[ti][j];
    dq_adam(pk, mk, vk, g, lr, b1, b2, adam_eps, c1, c2);
    tab.p[ti][j] = pk;
    tab.m[ti][j] = mk;
    tab.v[ti][j] = vk;
    a = fabsf(g);
  }
  dq_block_max(a, red, gnorm);
}

cudaError_t dq_launch_adam_flat(const DqTab& tab, int n, const void* count,
                                int u, const void* grad, float lr, float b1,
                                float b2, float adam_eps, void* gnorm,
                                cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(gnorm, 0, sizeof(float), s);
  if (err != cudaSuccess) return err;
  dq_adam_flat_kernel<<<(n + DQ_ADAM_THREADS - 1) / DQ_ADAM_THREADS,
                        DQ_ADAM_THREADS, 0, s>>>(
      tab, n, (const int*)count, u, (const float*)grad, lr, b1, b2, adam_eps,
      (float*)gnorm);
  return cudaGetLastError();
}

DQ_API int dq_fused_adam(const NetDesc* d, const int64_t* p_ptrs,
                         const int64_t* m_ptrs, const int64_t* v_ptrs,
                         const void* count, int u, const void* grad,
                         float lr, float b1, float b2, float adam_eps,
                         void* gnorm, void* stream) {
  DqTab tab;
  fu_tab(d, nullptr, p_ptrs, m_ptrs, v_ptrs, &tab);
  return (int)dq_launch_adam_flat(tab, d->n_params, count, u, grad, lr, b1,
                                  b2, adam_eps, gnorm, (cudaStream_t)stream);
}
