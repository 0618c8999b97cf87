// K4 and K6: one collect step for all E envs (replace fused_collect /
// _collect_block of deepqlearning_tpu/ops/pallas/fused_collect.py; K4
// fc_kernel the feed-forward plan, K6 fc_rnn_kernel the recurrent plan).
//
// Both do the (dueling) Dense forward with the parameters in shared
// memory, the epsilon-greedy action (first-max argmax over the real
// actions; a random action floor(u1 * A) when u0 < eps), SimpleGridWorld's
// step_cols and reset_cols as device code, truncation at
// max_episode_length, auto-reset and the episode accumulators. Transition
// fields are written straight in replay-row order [E, 2*no + 4] = (obs,
// obs', action, reward, done, ended); each block writes its (sum
// ret*ended, sum len*ended, sum ended) partial, reduced in a fixed order.
// Uniforms come in as u [6, E].
//
// K4 (fc_kernel): a block takes a tile of TE envs (TE from the plan, 128
// for the headline net) and runs each Dense layer as a small matrix
// product [TE, din] x [din, dout] in shared memory. Activations are
// feature-major ([width][TE]); a thread computes a register micro-tile of
// 4 envs x 4 outputs, reading a float4 of W's row and a float4 of the
// input feature per step, one accumulator per output summed over i in
// ascending order (the arithmetic of the thread-per-env forward, so the
// greedy action is the same bits). No per-thread arrays: the kernel uses
// no local-memory stack. The env step and accumulators stay one thread
// per env. At E = 131072 the step does ~17.5K FLOP per env and moves ~112
// bytes per env: the FP32 units bound it, not device memory.
#include "common.cuh"

#define FC_MAXW 128
#define FC_MAXCELLS 16
#define FC_THREADS 256
#define FC_MAX_TE 128

struct GridDesc {
  int n_cells;
  float cell_x[FC_MAXCELLS];
  float cell_y[FC_MAXCELLS];
  float cell_r[FC_MAXCELLS];
  float tprob;
  float size_x;
  float size_y;
};

// Forward through layers [l0, l0 + nl); returns the buffer with the output.
__device__ const float* fc_chain(const NetDesc& d, const float* sp,
                                 const float* x, float* b0, float* b1, int l0,
                                 int nl) {
  const float* in = x;
  float* out = b0;
  for (int l = l0; l < l0 + nl; ++l) {
    const float* W = sp + d.off_w[l];
    const float* bias = sp + d.off_b[l];
    const int din = d.din[l], dout = d.dout[l];
    for (int o = 0; o < dout; ++o) {
      float z = 0.0f;
      for (int i = 0; i < din; ++i) z += in[i] * W[i * dout + o];
      out[o] = dq_act(z + bias[o], d.act[l]);
    }
    in = out;
    out = (out == b0) ? b1 : b0;
  }
  return in;
}

// Q of one env's input x through the (dueling) Dense stack with the
// parameters sp in shared memory; returns the greedy action (first max).
__device__ __forceinline__ int fc_greedy(const NetDesc& d, const float* sp,
                                         const float* x, float* b0,
                                         float* b1) {
  const int A = d.num_actions;
  float q[FC_MAXW];
  // Q(s): dueling V + A - mean(A), or the chain's output
  float v = 0.0f;
  if (d.dueling) v = fc_chain(d, sp, x, b0, b1, 0, d.n_val)[0];
  const float* a_out = fc_chain(d, sp, x, b0, b1, d.n_val, d.n_adv);
  float mean = 0.0f;
  if (d.dueling) {
    for (int c = 0; c < A; ++c) mean += a_out[c];
    mean *= 1.0f / (float)A;
  }
  for (int c = 0; c < A; ++c)
    q[c] = d.dueling ? v + a_out[c] - mean : a_out[c];
  int greedy = 0;
  for (int c = 1; c < A; ++c)
    if (q[c] > q[greedy]) greedy = c;
  return greedy;
}

// SimpleGridWorld.step_cols for env e from obs (x0, x1) and the action,
// truncation, auto-reset (reset_cols) and the episode accumulators; writes
// the transition fields and the env's next obs/state/counters, adds the
// env's (ret, len, ended) terms to s_ret/s_len/s_end. Returns whether the
// episode ended.
__device__ __forceinline__ bool fc_env_step(
    const GridDesc& g, float x0, float x1, float action, int e, int E,
    const float* __restrict__ state, const int* __restrict__ ep_step,
    const float* __restrict__ ep_ret, const float* __restrict__ u,
    int max_len, float* __restrict__ fields, float* __restrict__ obs_out,
    float* __restrict__ state_out, int* __restrict__ ep_step_out,
    float* __restrict__ ep_ret_out, float& s_ret, float& s_len,
    float& s_end) {
  const int no = 2;
  const float px = state[(size_t)e * 3], py = state[(size_t)e * 3 + 1];
  const float term = state[(size_t)e * 3 + 2];
  float cell_r = 0.0f;
  for (int k = 0; k < g.n_cells; ++k)
    cell_r += (px == g.cell_x[k] && py == g.cell_y[k]) ? g.cell_r[k] : 0.0f;
  const float rew = (term > 0.5f) ? 0.0f : cell_r;
  const float in_cell = (cell_r != 0.0f) ? 1.0f : 0.0f;
  float other = floorf(u[3 * (size_t)E + e] * 3.0f);
  if (other >= action) other += 1.0f;
  const float dir = (u[2 * (size_t)E + e] < g.tprob) ? action : other;
  float dx = 0.0f, dy = 0.0f;
  if (dir == 0.0f) dy = 1.0f;
  if (dir == 1.0f) dy = -1.0f;
  if (dir == 2.0f) dx = -1.0f;
  if (dir == 3.0f) dx = 1.0f;
  float npx = fminf(fmaxf(px + dx, 1.0f), g.size_x);
  float npy = fminf(fmaxf(py + dy, 1.0f), g.size_y);
  const float bt = fmaxf(term, in_cell);
  if (bt > 0.5f) { npx = px; npy = py; }
  const float nox = (bt > 0.5f) ? -1.0f : npx;
  const float noy = (bt > 0.5f) ? -1.0f : npy;

  // truncation, auto-reset (reset_cols), accumulators
  const float ep1 = (float)ep_step[e] + 1.0f;
  const float trunc = (ep1 >= (float)max_len) ? 1.0f : 0.0f;
  const float ended = fmaxf(bt, trunc);
  const float ret1 = ep_ret[e] + rew;
  const float rx = 1.0f + floorf(u[4 * (size_t)E + e] * g.size_x);
  const float ry = 1.0f + floorf(u[5 * (size_t)E + e] * g.size_y);
  const bool end = ended > 0.5f;

  float* f = fields + (size_t)e * (2 * no + 4);
  f[0] = x0;
  f[1] = x1;
  f[2] = nox;
  f[3] = noy;
  f[4] = action;
  f[5] = rew;
  f[6] = bt;
  f[7] = ended;
  obs_out[(size_t)e * 2] = end ? rx : nox;
  obs_out[(size_t)e * 2 + 1] = end ? ry : noy;
  state_out[(size_t)e * 3] = end ? rx : npx;
  state_out[(size_t)e * 3 + 1] = end ? ry : npy;
  state_out[(size_t)e * 3 + 2] = end ? 0.0f : bt;
  ep_step_out[e] = end ? 0 : (int)ep1;
  ep_ret_out[e] = end ? 0.0f : ret1;
  s_ret = ret1 * ended;
  s_len = ep1 * ended;
  s_end = ended;
  return end;
}

// Fixed-order block sum of the three accumulators into partials[block].
__device__ __forceinline__ void fc_block_totals(float* red, float s_ret,
                                                float s_len, float s_end,
                                                float* partials) {
  red[threadIdx.x] = s_ret;
  red[blockDim.x + threadIdx.x] = s_len;
  red[2 * blockDim.x + threadIdx.x] = s_end;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      for (int k = 0; k < 3; ++k)
        red[k * blockDim.x + threadIdx.x] += red[k * blockDim.x + threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x < 3) partials[blockIdx.x * 3 + threadIdx.x] = red[threadIdx.x * blockDim.x];
}

// K4's shared parameter copy: each layer's W then b, every tensor starting
// on a 16-byte boundary (float4 reads); returns the floats it spans.
__host__ __device__ inline int fc_tile_layout(const NetDesc& d, int* ow,
                                              int* ob) {
  int n = 0;
  for (int l = 0; l < d.n_val + d.n_adv; ++l) {
    ow[l] = n;
    ob[l] = (n + d.din[l] * d.dout[l] + 3) & ~3;
    n = (ob[l] + d.dout[l] + 3) & ~3;
  }
  return n;
}

// Shared-memory bytes of one K4 block for a tile of TE envs
// (k4_smem_bytes in ops/cuda/fused_collect.py gates on the same sum).
static int fc_tile_smem_bytes(const NetDesc& d, int TE) {
  int ow[DQ_MAXL], ob[DQ_MAXL];
  const int np = fc_tile_layout(d, ow, ob);
  return (np + (d.in_dim + 2 * d.maxw + 1) * TE + 3 * FC_THREADS) *
         (int)sizeof(float);
}

// out[o][e] = act(b[o] + sum_i in[i][e] * W[i][o]) for the tile's TE envs
// (feature-major in/out). A work item is 4 envs x 4 outputs (4 x 1 when
// dout is not a multiple of 4); consecutive threads take consecutive output
// groups of the same 4 envs, so the input float4 is a broadcast and the W
// float4s are consecutive.
__device__ void fc_dense_tile(const float* W, const float* b, int din,
                              int dout, int act, const float* in, float* out,
                              int TE) {
  const int n4 = TE / 4;
  if ((dout & 3) == 0) {
    const int ng = dout / 4;
    for (int k = threadIdx.x; k < n4 * ng; k += blockDim.x) {
      const int og = k % ng, e4 = k / ng;
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
      for (int i = 0; i < din; ++i) {
        const float4 w = *reinterpret_cast<const float4*>(W + i * dout + 4 * og);
        const float4 x = *reinterpret_cast<const float4*>(in + i * TE + 4 * e4);
        const float xs[4] = {x.x, x.y, x.z, x.w};
        const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][c] = fmaf(xs[j], ws[c], acc[j][c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = 4 * og + c;
        *reinterpret_cast<float4*>(out + o * TE + 4 * e4) = make_float4(
            dq_act(acc[0][c] + b[o], act), dq_act(acc[1][c] + b[o], act),
            dq_act(acc[2][c] + b[o], act), dq_act(acc[3][c] + b[o], act));
      }
    }
  } else {
    for (int k = threadIdx.x; k < n4 * dout; k += blockDim.x) {
      const int o = k % dout, e4 = k / dout;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = 0; i < din; ++i) {
        const float w = W[i * dout + o];
        const float4 x = *reinterpret_cast<const float4*>(in + i * TE + 4 * e4);
        acc[0] = fmaf(x.x, w, acc[0]);
        acc[1] = fmaf(x.y, w, acc[1]);
        acc[2] = fmaf(x.z, w, acc[2]);
        acc[3] = fmaf(x.w, w, acc[3]);
      }
      *reinterpret_cast<float4*>(out + o * TE + 4 * e4) = make_float4(
          dq_act(acc[0] + b[o], act), dq_act(acc[1] + b[o], act),
          dq_act(acc[2] + b[o], act), dq_act(acc[3] + b[o], act));
    }
  }
  __syncthreads();
}

// Forward through layers [l0, l0 + nl) from in, ping-ponging b0/b1; the
// last layer writes to last (or the free buffer when last is null).
// Returns the last layer's output.
__device__ const float* fc_chain_tile(const NetDesc& d, const float* sp,
                                      const int* ow, const int* ob,
                                      const float* in, float* b0, float* b1,
                                      float* last, int l0, int nl, int TE) {
  float* out = b0;
  for (int l = l0; l < l0 + nl; ++l) {
    float* dst = (l == l0 + nl - 1 && last != nullptr) ? last : out;
    fc_dense_tile(sp + ow[l], sp + ob[l], d.din[l], d.dout[l], d.act[l], in,
                  dst, TE);
    in = dst;
    out = (out == b0) ? b1 : b0;
  }
  return in;
}

__global__ void __launch_bounds__(FC_THREADS) fc_kernel(
    NetDesc d, TensorPtrs params, GridDesc g, const float* __restrict__ obs,
    const float* __restrict__ state, const int* __restrict__ ep_step,
    const float* __restrict__ ep_ret, const float* __restrict__ u, int E,
    int TE, float eps, int max_len, float* __restrict__ fields,
    float* __restrict__ obs_out, float* __restrict__ state_out,
    int* __restrict__ ep_step_out, float* __restrict__ ep_ret_out,
    float* __restrict__ partials) {
  extern __shared__ __align__(16) float k4_smem[];
  __shared__ int ow[DQ_MAXL], ob[DQ_MAXL], np;
  if (threadIdx.x == 0) np = fc_tile_layout(d, ow, ob);
  __syncthreads();
  const int no = d.in_dim, A = d.num_actions;
  float* sp = k4_smem;
  float* sx = sp + np;              // [no][TE]
  float* b0 = sx + no * TE;         // [maxw][TE]
  float* b1 = b0 + d.maxw * TE;     // [maxw][TE]
  float* sv = b1 + d.maxw * TE;     // [TE] the value head's output
  float* red = sv + TE;             // [3, blockDim]
  for (int l = 0; l < d.n_val + d.n_adv; ++l) {
    for (int k = threadIdx.x; k < d.din[l] * d.dout[l]; k += blockDim.x)
      sp[ow[l] + k] = params.t[2 * l][k];
    for (int k = threadIdx.x; k < d.dout[l]; k += blockDim.x)
      sp[ob[l] + k] = params.t[2 * l + 1][k];
  }
  const int e0 = blockIdx.x * TE;
  const int ne = min(TE, E - e0);
  for (int k = threadIdx.x; k < no * TE; k += blockDim.x) {
    const int i = k / TE, el = k - i * TE;
    sx[k] = (el < ne) ? obs[(size_t)(e0 + el) * no + i] : 0.0f;
  }
  __syncthreads();

  // Q(s): dueling V + A - mean(A), or the chain's output
  if (d.dueling) fc_chain_tile(d, sp, ow, ob, sx, b0, b1, sv, 0, d.n_val, TE);
  const float* aout =
      fc_chain_tile(d, sp, ow, ob, sx, b0, b1, nullptr, d.n_val, d.n_adv, TE);

  float s_ret = 0.0f, s_len = 0.0f, s_end = 0.0f;
  const int el = threadIdx.x;
  if (el < ne) {
    const int e = e0 + el;
    float mean = 0.0f, v = 0.0f;
    if (d.dueling) {
      v = sv[el];
      for (int c = 0; c < A; ++c) mean += aout[c * TE + el];
      mean *= 1.0f / (float)A;
    }
    // first-max argmax of q_c = v + a_c - mean (or a_c)
    int greedy = 0;
    float best = d.dueling ? v + aout[el] - mean : aout[el];
    for (int c = 1; c < A; ++c) {
      const float q = d.dueling ? v + aout[c * TE + el] - mean : aout[c * TE + el];
      if (q > best) {
        best = q;
        greedy = c;
      }
    }
    const float u0 = u[e], u1 = u[(size_t)E + e];
    const float action = (u0 < eps) ? floorf(u1 * (float)A) : (float)greedy;
    fc_env_step(g, sx[el], sx[TE + el], action, e, E, state, ep_step, ep_ret,
                u, max_len, fields, obs_out, state_out, ep_step_out,
                ep_ret_out, s_ret, s_len, s_end);
  }
  fc_block_totals(red, s_ret, s_len, s_end, partials);
}

// K6: the same step for a recurrent net (replaces fused_collect's recurrent
// plan, _cell_cols + _collect_block): one LSTM or GRU cell step on the
// env's obs and its state row nstate[e] = h (;c), the Dense or dueling head
// on h', epsilon-greedy, the env step and bookkeeping as above, and the new
// state row, zeroed where the episode ended. One thread per env; the cell
// and head parameters sit in shared memory (the plan gates their size) and
// the thread's h, h', c' in local arrays of FC_MAXW floats (the plan gates
// H <= FC_MAXW). At E = 16384 and LSTM(2, 32) a step is ~4.5K FMA per env:
// the per-thread dependent dot products bound it, not device memory.
__global__ void __launch_bounds__(FC_THREADS) fc_rnn_kernel(
    NetDesc d, TensorPtrs params, int kind, int H,
    const float* __restrict__ wi, const float* __restrict__ wh,
    const float* __restrict__ bc, GridDesc g, const float* __restrict__ obs,
    const float* __restrict__ state, const int* __restrict__ ep_step,
    const float* __restrict__ ep_ret, const float* __restrict__ u,
    const float* __restrict__ nstate, int E, float eps, int max_len,
    float* __restrict__ fields, float* __restrict__ obs_out,
    float* __restrict__ state_out, int* __restrict__ ep_step_out,
    float* __restrict__ ep_ret_out, float* __restrict__ nstate_out,
    float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int G = (kind == 0 ? 4 : 3) * H, cin = 2;
  float* sp = smem;               // head, NetDesc packing
  float* swi = sp + d.n_params;   // [cin, G]
  float* swh = swi + cin * G;     // [H, G]
  float* sbc = swh + H * G;       // [G]
  float* red = sbc + G;           // [3, blockDim]
  dq_load_params(d, params, sp);
  for (int k = threadIdx.x; k < cin * G; k += blockDim.x) swi[k] = wi[k];
  for (int k = threadIdx.x; k < H * G; k += blockDim.x) swh[k] = wh[k];
  for (int k = threadIdx.x; k < G; k += blockDim.x) sbc[k] = bc[k];
  __syncthreads();

  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  float s_ret = 0.0f, s_len = 0.0f, s_end = 0.0f;
  if (e < E) {
    const int S = (kind == 0 ? 2 : 1) * H;
    const float* ns = nstate + (size_t)e * S;
    const float x0 = obs[(size_t)e * 2], x1 = obs[(size_t)e * 2 + 1];
    float hp[FC_MAXW], hn[FC_MAXW], cn[FC_MAXW], b0[FC_MAXW], b1[FC_MAXW];
    for (int k = 0; k < H; ++k) hp[k] = ns[k];
    for (int j = 0; j < H; ++j) {
      // per gate k: xi = x . wi[:, kH + j], hh = h . wh[:, kH + j]
      float xi[4], hh[4];
      for (int k = 0; k < G / H; ++k) {
        const int col = k * H + j;
        xi[k] = x0 * swi[col] + x1 * swi[G + col];
        float s = 0.0f;
        for (int i = 0; i < H; ++i) s += hp[i] * swh[i * G + col];
        hh[k] = s;
      }
      if (kind == 0) {
        const float ig = 1.0f / (1.0f + expf(-(xi[0] + hh[0] + sbc[j])));
        const float fg = 1.0f / (1.0f + expf(-(xi[1] + hh[1] + sbc[H + j])));
        const float gg = tanhf(xi[2] + hh[2] + sbc[2 * H + j]);
        const float og = 1.0f / (1.0f + expf(-(xi[3] + hh[3] + sbc[3 * H + j])));
        cn[j] = fg * ns[H + j] + ig * gg;
        hn[j] = og * tanhf(cn[j]);
      } else {
        const float r = 1.0f / (1.0f + expf(-(xi[0] + hh[0] + sbc[j])));
        const float z = 1.0f / (1.0f + expf(-(xi[1] + hh[1] + sbc[H + j])));
        const float n = tanhf(xi[2] + r * hh[2] + sbc[2 * H + j]);
        hn[j] = (1.0f - z) * n + z * hp[j];
      }
    }
    const int greedy = fc_greedy(d, sp, hn, b0, b1);
    const float u0 = u[e], u1 = u[(size_t)E + e];
    const float action =
        (u0 < eps) ? floorf(u1 * (float)d.num_actions) : (float)greedy;
    const bool end = fc_env_step(g, x0, x1, action, e, E, state, ep_step,
                                 ep_ret, u, max_len, fields, obs_out,
                                 state_out, ep_step_out, ep_ret_out, s_ret,
                                 s_len, s_end);
    float* nso = nstate_out + (size_t)e * S;
    for (int j = 0; j < H; ++j) nso[j] = end ? 0.0f : hn[j];
    if (kind == 0)
      for (int j = 0; j < H; ++j) nso[H + j] = end ? 0.0f : cn[j];
  }
  fc_block_totals(red, s_ret, s_len, s_end, partials);
}

static void fc_grid(GridDesc* g, const float* cells, int n_cells,
                    float tprob, float size_x, float size_y) {
  g->n_cells = n_cells;
  for (int k = 0; k < n_cells; ++k) {
    g->cell_x[k] = cells[3 * k];
    g->cell_y[k] = cells[3 * k + 1];
    g->cell_r[k] = cells[3 * k + 2];
  }
  g->tprob = tprob;
  g->size_x = size_x;
  g->size_y = size_y;
}

DQ_API int dq_fused_collect(const NetDesc* d, const int64_t* p_ptrs,
                            const float* cells, int n_cells, float tprob,
                            float size_x, float size_y, const void* obs,
                            const void* state, const void* ep_step,
                            const void* ep_ret, const void* u, int E, int TE,
                            float eps, int max_len, void* fields,
                            void* obs_out, void* state_out,
                            void* ep_step_out, void* ep_ret_out,
                            void* partials, void* stream) {
  if (n_cells > FC_MAXCELLS || d->in_dim != 2 || d->maxw > FC_MAXW ||
      TE < 4 || TE > FC_MAX_TE || TE % 4 != 0)
    return (int)cudaErrorInvalidValue;
  TensorPtrs P;
  for (int i = 0; i < 2 * (d->n_val + d->n_adv); ++i)
    P.t[i] = (float*)p_ptrs[i];
  GridDesc g;
  fc_grid(&g, cells, n_cells, tprob, size_x, size_y);
  const int smem = fc_tile_smem_bytes(*d, TE);
  cudaError_t err = cudaFuncSetAttribute(
      fc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (E + TE - 1) / TE;
  fc_kernel<<<blocks, FC_THREADS, smem, (cudaStream_t)stream>>>(
      *d, P, g, (const float*)obs, (const float*)state, (const int*)ep_step,
      (const float*)ep_ret, (const float*)u, E, TE, eps, max_len,
      (float*)fields,
      (float*)obs_out, (float*)state_out, (int*)ep_step_out,
      (float*)ep_ret_out, (float*)partials);
  return (int)cudaGetLastError();
}

DQ_API int dq_fused_collect_rnn(const NetDesc* d, const int64_t* p_ptrs,
                                int kind, int H, const void* wi,
                                const void* wh, const void* bc,
                                const float* cells, int n_cells, float tprob,
                                float size_x, float size_y, const void* obs,
                                const void* state, const void* ep_step,
                                const void* ep_ret, const void* u,
                                const void* nstate, int E, float eps,
                                int max_len, void* fields, void* obs_out,
                                void* state_out, void* ep_step_out,
                                void* ep_ret_out, void* nstate_out,
                                void* partials, void* stream) {
  if (n_cells > FC_MAXCELLS || d->in_dim != H || d->maxw > FC_MAXW ||
      H > FC_MAXW || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  TensorPtrs P;
  for (int i = 0; i < 2 * (d->n_val + d->n_adv); ++i)
    P.t[i] = (float*)p_ptrs[i];
  GridDesc g;
  fc_grid(&g, cells, n_cells, tprob, size_x, size_y);
  const int G = (kind == 0 ? 4 : 3) * H;
  const int smem =
      (d->n_params + 2 * G + H * G + G + 3 * FC_THREADS) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fc_rnn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (E + FC_THREADS - 1) / FC_THREADS;
  fc_rnn_kernel<<<blocks, FC_THREADS, smem, (cudaStream_t)stream>>>(
      *d, P, kind, H, (const float*)wi, (const float*)wh, (const float*)bc, g,
      (const float*)obs, (const float*)state, (const int*)ep_step,
      (const float*)ep_ret, (const float*)u, (const float*)nstate, E, eps,
      max_len, (float*)fields, (float*)obs_out, (float*)state_out,
      (int*)ep_step_out, (float*)ep_ret_out, (float*)nstate_out,
      (float*)partials);
  return (int)cudaGetLastError();
}
