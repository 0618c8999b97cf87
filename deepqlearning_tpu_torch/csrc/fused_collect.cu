// K4 and K6: one collect step for all E envs (replace fused_collect /
// _collect_block of deepqlearning_tpu/ops/pallas/fused_collect.py; K4
// fc_kernel the feed-forward plan, K6 fc_rnn_kernel the recurrent plan).
//
// One thread per env: the (dueling) Dense forward with the parameters in
// shared memory and the activations in per-thread local arrays, the
// epsilon-greedy action (first-max argmax over the real actions; a random
// action floor(u1 * A) when u0 < eps), SimpleGridWorld's step_cols and
// reset_cols as device code, truncation at max_episode_length, auto-reset
// and the episode accumulators. Transition fields are written straight in
// replay-row order [E, 2*no + 4] = (obs, obs', action, reward, done,
// ended); each block writes its (sum ret*ended, sum len*ended, sum ended)
// partial, reduced in a fixed order. Uniforms come in as u [6, E].
// At E = 131072 the step reads/writes ~80 bytes per env and does ~17K
// FLOP per env (the 2->64->64 heads): the FP32 units and the per-thread
// dependent dot products bound it, not device memory.
#include "common.cuh"

#define FC_MAXW 128
#define FC_MAXCELLS 16
#define FC_THREADS 256

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

__global__ void __launch_bounds__(FC_THREADS) fc_kernel(
    NetDesc d, TensorPtrs params, GridDesc g, const float* __restrict__ obs,
    const float* __restrict__ state, const int* __restrict__ ep_step,
    const float* __restrict__ ep_ret, const float* __restrict__ u, int E,
    float eps, int max_len, float* __restrict__ fields,
    float* __restrict__ obs_out, float* __restrict__ state_out,
    int* __restrict__ ep_step_out, float* __restrict__ ep_ret_out,
    float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* sp = smem;
  float* red = sp + d.n_params;  // [3, blockDim]
  dq_load_params(d, params, sp);
  __syncthreads();

  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  float s_ret = 0.0f, s_len = 0.0f, s_end = 0.0f;
  if (e < E) {
    const int no = d.in_dim, A = d.num_actions;
    float x[FC_MAXW], b0[FC_MAXW], b1[FC_MAXW];
    for (int i = 0; i < no; ++i) x[i] = obs[(size_t)e * no + i];
    const int greedy = fc_greedy(d, sp, x, b0, b1);
    const float u0 = u[e], u1 = u[(size_t)E + e];
    const float action =
        (u0 < eps) ? floorf(u1 * (float)A) : (float)greedy;
    fc_env_step(g, x[0], x[1], action, e, E, state, ep_step, ep_ret, u,
                max_len, fields, obs_out, state_out, ep_step_out, ep_ret_out,
                s_ret, s_len, s_end);
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
                            const void* ep_ret, const void* u, int E,
                            float eps, int max_len, void* fields,
                            void* obs_out, void* state_out,
                            void* ep_step_out, void* ep_ret_out,
                            void* partials, void* stream) {
  if (n_cells > FC_MAXCELLS || d->in_dim != 2 || d->maxw > FC_MAXW)
    return (int)cudaErrorInvalidValue;
  TensorPtrs P;
  for (int i = 0; i < 2 * (d->n_val + d->n_adv); ++i)
    P.t[i] = (float*)p_ptrs[i];
  GridDesc g;
  fc_grid(&g, cells, n_cells, tprob, size_x, size_y);
  const int smem = (d->n_params + 3 * FC_THREADS) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (E + FC_THREADS - 1) / FC_THREADS;
  fc_kernel<<<blocks, FC_THREADS, smem, (cudaStream_t)stream>>>(
      *d, P, g, (const float*)obs, (const float*)state, (const int*)ep_step,
      (const float*)ep_ret, (const float*)u, E, eps, max_len, (float*)fields,
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
