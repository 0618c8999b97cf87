// K4 and K6: one collect step for all E envs (replace fused_collect /
// _collect_block of deepqlearning_tpu/ops/pallas/fused_collect.py; K4
// fc_kernel the feed-forward plan, K6 fc_rnn_kernel the recurrent plan).
//
// Both do the (dueling) Dense forward with the parameters in shared
// memory, the epsilon-greedy action (first-max argmax over the real
// actions; a random action floor(u1 * A) when u0 < eps), the env's
// step_cols and reset_cols as device code (SimpleGridWorld, CartPole or
// MountainCar: a template parameter, FcEnv<ENV>), truncation at
// max_episode_length, auto-reset and the episode accumulators. Transition
// fields are written straight in replay-row order [E, 2*no + 4] = (obs,
// obs', action, reward, done, ended); each block writes its (sum
// ret*ended, sum len*ended, sum ended) partial, reduced in a fixed order.
// Uniforms come in as u [2 + ns + nr, E]: explore, random action, the
// env's ns step and nr reset uniforms (6 rows for SimpleGridWorld and
// CartPole, 3 for MountainCar).
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
//
// K6 (fc_rnn_kernel) takes tiles the same way (TE envs per block, from the
// plan; 32 for LSTM(2, 32), so E = 16384 gives 512 blocks) and adds one
// LSTM or GRU cell step before the head, with the cell's wi, wh (rows of
// [cin + H, G], G = 4H or 3H) and b in shared memory and the tile's obs
// and state rows there feature-major. A work item is 4 envs x one hidden
// unit j: it keeps the unit's gate sums for the 4 envs in registers (16
// accumulators), reading a float4 of the input feature and the unit's gate
// weights per row (each sum over the rows in ascending order: x, then h),
// and runs the cell on them in place: LSTM i, f, g, o; GRU r, z and the
// n gate's x . W_in and h . W_hn kept apart, so r * (h . W_hn) is exact.
// It writes h' and c' feature-major; the head (fc_chain_tile) reads h'.
// Then a thread per env takes the action and steps the env, and the new
// state rows [E, S], zeroed where the episode ended, are written with
// neighbouring threads on neighbouring floats. No per-thread arrays. At
// E = 16384 and LSTM(2, 32) a step is ~4.5K FMA and ~0.6 KB per env.
#include "common.cuh"

#define FC_MAXW 128
#define FC_MAXCELLS 16
#define FC_MAXK 16
#define FC_THREADS 256
#define FC_MAX_TE 128

// The envs whose step_cols / reset_cols the kernels run (EnvDesc::kind,
// and the template parameter that selects the device code).
#define FC_GRID 0
#define FC_CARTPOLE 1
#define FC_MOUNTAINCAR 2

// The env's constants, read from the Python object
// (ops/cuda/fused_collect.py::ENVS): SimpleGridWorld's reward cells, and k
// in the order each FcEnv<ENV>::step below names them.
struct EnvDesc {
  int kind;
  int n_cells;
  float cell_x[FC_MAXCELLS];
  float cell_y[FC_MAXCELLS];
  float cell_r[FC_MAXCELLS];
  float k[FC_MAXK];
};

// One env's step_cols and reset_cols for env e: NO obs columns, a state of
// W floats, NS step uniforms and NR reset uniforms (u rows 2.. and 2 + NS..
// of the kernel's u, passed here as the first row, rows E floats apart).
// step writes the next state ns, obs nobs, reward and done; reset the
// fresh state rs and obs robs. The arithmetic is the JAX cols functions'
// op for op, each product and sum rounded on its own (__fmul_rn and
// __fadd_rn keep nvcc from contracting them into FMAs, which round once),
// so the plain PyTorch versions give the same bits where their
// transcendentals do.
template <int ENV>
struct FcEnv;

template <>
struct FcEnv<FC_GRID> {
  static constexpr int NO = 2, W = 3, NS = 2, NR = 2;
  __device__ static __forceinline__ void step(const EnvDesc& g,
                                              const float* s, float action,
                                              const float* __restrict__ u,
                                              size_t E, int e, float* ns,
                                              float* nobs, float& rew,
                                              float& done) {
    const float tprob = g.k[0], size_x = g.k[1], size_y = g.k[2];
    const float px = s[0], py = s[1], term = s[2];
    float cell_r = 0.0f;
    for (int k = 0; k < g.n_cells; ++k)
      cell_r += (px == g.cell_x[k] && py == g.cell_y[k]) ? g.cell_r[k] : 0.0f;
    rew = (term > 0.5f) ? 0.0f : cell_r;
    const float in_cell = (cell_r != 0.0f) ? 1.0f : 0.0f;
    float other = floorf(u[E + e] * 3.0f);
    if (other >= action) other += 1.0f;
    const float dir = (u[e] < tprob) ? action : other;
    float dx = 0.0f, dy = 0.0f;
    if (dir == 0.0f) dy = 1.0f;
    if (dir == 1.0f) dy = -1.0f;
    if (dir == 2.0f) dx = -1.0f;
    if (dir == 3.0f) dx = 1.0f;
    float npx = fminf(fmaxf(px + dx, 1.0f), size_x);
    float npy = fminf(fmaxf(py + dy, 1.0f), size_y);
    const float bt = fmaxf(term, in_cell);
    if (bt > 0.5f) { npx = px; npy = py; }
    ns[0] = npx;
    ns[1] = npy;
    ns[2] = bt;
    nobs[0] = (bt > 0.5f) ? -1.0f : npx;
    nobs[1] = (bt > 0.5f) ? -1.0f : npy;
    done = bt;
  }
  __device__ static __forceinline__ void reset(const EnvDesc& g,
                                               const float* __restrict__ u,
                                               size_t E, int e, float* rs,
                                               float* robs) {
    // k = (tprob, size_x, size_y)
    rs[0] = robs[0] = 1.0f + floorf(u[e] * g.k[1]);
    rs[1] = robs[1] = 1.0f + floorf(u[E + e] * g.k[2]);
    rs[2] = 0.0f;
  }
};

template <>
struct FcEnv<FC_CARTPOLE> {
  static constexpr int NO = 4, W = 4, NS = 0, NR = 4;
  __device__ static __forceinline__ void step(const EnvDesc& g,
                                              const float* s, float action,
                                              const float* __restrict__ u,
                                              size_t E, int e, float* ns,
                                              float* nobs, float& rew,
                                              float& done) {
    const float gravity = g.k[0], masspole = g.k[1], total_mass = g.k[2];
    const float length = g.k[3], pml = g.k[4], force_mag = g.k[5];
    const float tau = g.k[6], theta_thr = g.k[7], x_thr = g.k[8];
    const float four_thirds = g.k[9];
    const float x = s[0], x_dot = s[1], theta = s[2], theta_dot = s[3];
    const float force = (action == 1.0f) ? force_mag : -force_mag;
    const float costh = cosf(theta), sinth = sinf(theta);
    const float temp = __fdiv_rn(
        __fadd_rn(force, __fmul_rn(__fmul_rn(pml, __fmul_rn(theta_dot,
                                                           theta_dot)),
                                   sinth)),
        total_mass);
    const float theta_acc = __fdiv_rn(
        __fsub_rn(__fmul_rn(gravity, sinth), __fmul_rn(costh, temp)),
        __fmul_rn(length,
                  __fsub_rn(four_thirds,
                            __fdiv_rn(__fmul_rn(masspole,
                                                __fmul_rn(costh, costh)),
                                      total_mass))));
    const float x_acc = __fsub_rn(
        temp, __fdiv_rn(__fmul_rn(__fmul_rn(pml, theta_acc), costh),
                        total_mass));
    ns[0] = __fadd_rn(x, __fmul_rn(tau, x_dot));
    ns[1] = __fadd_rn(x_dot, __fmul_rn(tau, x_acc));
    ns[2] = __fadd_rn(theta, __fmul_rn(tau, theta_dot));
    ns[3] = __fadd_rn(theta_dot, __fmul_rn(tau, theta_acc));
#pragma unroll
    for (int i = 0; i < 4; ++i) nobs[i] = ns[i];
    done = (fabsf(ns[0]) > x_thr || fabsf(ns[2]) > theta_thr) ? 1.0f : 0.0f;
    rew = 1.0f;
  }
  __device__ static __forceinline__ void reset(const EnvDesc& g,
                                               const float* __restrict__ u,
                                               size_t E, int e, float* rs,
                                               float* robs) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      rs[i] = robs[i] = __fsub_rn(__fmul_rn(u[i * E + e], 0.1f), 0.05f);
  }
};

template <>
struct FcEnv<FC_MOUNTAINCAR> {
  static constexpr int NO = 2, W = 2, NS = 0, NR = 1;
  __device__ static __forceinline__ void step(const EnvDesc& g,
                                              const float* s, float action,
                                              const float* __restrict__ u,
                                              size_t E, int e, float* ns,
                                              float* nobs, float& rew,
                                              float& done) {
    const float min_pos = g.k[0], max_pos = g.k[1], max_speed = g.k[2];
    const float goal = g.k[3], force = g.k[4], gravity = g.k[5];
    const float pos = s[0];
    float vel = __fsub_rn(
        __fadd_rn(s[1], __fmul_rn(__fsub_rn(action, 1.0f), force)),
        __fmul_rn(cosf(__fmul_rn(3.0f, pos)), gravity));
    vel = fminf(fmaxf(vel, -max_speed), max_speed);
    const float npos = fminf(fmaxf(__fadd_rn(pos, vel), min_pos), max_pos);
    if (npos <= min_pos && vel < 0.0f) vel = 0.0f;
    ns[0] = nobs[0] = npos;
    ns[1] = nobs[1] = vel;
    done = (npos >= goal) ? 1.0f : 0.0f;
    rew = -1.0f;
  }
  __device__ static __forceinline__ void reset(const EnvDesc& g,
                                               const float* __restrict__ u,
                                               size_t E, int e, float* rs,
                                               float* robs) {
    rs[0] = robs[0] = __fadd_rn(-0.6f, __fmul_rn(u[e], 0.2f));
    rs[1] = robs[1] = 0.0f;
  }
};

// The env step of env e (the tile's env el) from its obs rows in shared
// memory (sx, rows ldx floats apart) and the action: step_cols,
// truncation, auto-reset (reset_cols) and the episode accumulators; writes
// the transition fields and the env's next obs/state/counters, sets the
// env's (ret, len, ended) terms s_ret/s_len/s_end. Returns whether the
// episode ended.
template <int ENV>
__device__ __forceinline__ bool fc_env_step(
    const EnvDesc& g, const float* sx, int ldx, int el, float action, int e,
    int E, const float* __restrict__ state, const int* __restrict__ ep_step,
    const float* __restrict__ ep_ret, const float* __restrict__ u,
    int max_len, float* __restrict__ fields, float* __restrict__ obs_out,
    float* __restrict__ state_out, int* __restrict__ ep_step_out,
    float* __restrict__ ep_ret_out, float& s_ret, float& s_len,
    float& s_end) {
  using Env = FcEnv<ENV>;
  constexpr int NO = Env::NO, W = Env::W;
  float s[W], ns[W], rs[W], nobs[NO], robs[NO], rew, done;
#pragma unroll
  for (int k = 0; k < W; ++k) s[k] = state[(size_t)e * W + k];
  Env::step(g, s, action, u + 2 * (size_t)E, (size_t)E, e, ns, nobs, rew,
            done);

  // truncation, auto-reset (reset_cols), accumulators
  const float ep1 = (float)ep_step[e] + 1.0f;
  const float trunc = (ep1 >= (float)max_len) ? 1.0f : 0.0f;
  const float ended = fmaxf(done, trunc);
  const float ret1 = ep_ret[e] + rew;
  Env::reset(g, u + (size_t)(2 + Env::NS) * E, (size_t)E, e, rs, robs);
  const bool end = ended > 0.5f;

  float* f = fields + (size_t)e * (2 * NO + 4);
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    f[i] = sx[i * ldx + el];
    f[NO + i] = nobs[i];
    obs_out[(size_t)e * NO + i] = end ? robs[i] : nobs[i];
  }
  f[2 * NO] = action;
  f[2 * NO + 1] = rew;
  f[2 * NO + 2] = done;
  f[2 * NO + 3] = ended;
#pragma unroll
  for (int k = 0; k < W; ++k)
    state_out[(size_t)e * W + k] = end ? rs[k] : ns[k];
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
// (feature-major in/out; input rows ldi floats apart, output rows TE). A
// work item is 4 envs x 4 outputs (4 x 1 when dout is not a multiple of
// 4); consecutive threads take consecutive output groups of the same 4
// envs, so the input float4 is a broadcast and the W float4s are
// consecutive.
__device__ void fc_dense_tile(const float* W, const float* b, int din,
                              int dout, int act, const float* in, int ldi,
                              float* out, int TE) {
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
        const float4 x = *reinterpret_cast<const float4*>(in + i * ldi + 4 * e4);
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
        const float4 x = *reinterpret_cast<const float4*>(in + i * ldi + 4 * e4);
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

// Forward through layers [l0, l0 + nl) from in (rows ldi floats apart),
// ping-ponging b0/b1; the last layer writes to last (or the free buffer
// when last is null). Returns the last layer's output.
__device__ const float* fc_chain_tile(const NetDesc& d, const float* sp,
                                      const int* ow, const int* ob,
                                      const float* in, int ldi, float* b0,
                                      float* b1, float* last, int l0, int nl,
                                      int TE) {
  float* out = b0;
  for (int l = l0; l < l0 + nl; ++l) {
    float* dst = (l == l0 + nl - 1 && last != nullptr) ? last : out;
    fc_dense_tile(sp + ow[l], sp + ob[l], d.din[l], d.dout[l], d.act[l], in,
                  ldi, dst, TE);
    in = dst;
    ldi = TE;
    out = (out == b0) ? b1 : b0;
  }
  return in;
}

// The shared parameter copy, each layer's W then b (fc_tile_layout), by
// all threads of the block.
__device__ __forceinline__ void fc_load_tile_params(const NetDesc& d,
                                                    const TensorPtrs& params,
                                                    const int* ow,
                                                    const int* ob, float* sp) {
  for (int l = 0; l < d.n_val + d.n_adv; ++l) {
    for (int k = threadIdx.x; k < d.din[l] * d.dout[l]; k += blockDim.x)
      sp[ow[l] + k] = params.t[2 * l][k];
    for (int k = threadIdx.x; k < d.dout[l]; k += blockDim.x)
      sp[ob[l] + k] = params.t[2 * l + 1][k];
  }
}

// The greedy action of env el of the tile (first-max argmax of q_c = v +
// a_c - mean(a), or a_c), from the head's outputs aout [A][TE] and the
// value head's sv [TE].
__device__ __forceinline__ int fc_tile_greedy(const NetDesc& d,
                                              const float* aout,
                                              const float* sv, int el,
                                              int TE) {
  const int A = d.num_actions;
  float mean = 0.0f, v = 0.0f;
  if (d.dueling) {
    v = sv[el];
    for (int c = 0; c < A; ++c) mean += aout[c * TE + el];
    mean *= 1.0f / (float)A;
  }
  int greedy = 0;
  float best = d.dueling ? v + aout[el] - mean : aout[el];
  for (int c = 1; c < A; ++c) {
    const float q = d.dueling ? v + aout[c * TE + el] - mean : aout[c * TE + el];
    if (q > best) {
      best = q;
      greedy = c;
    }
  }
  return greedy;
}

template <int ENV>
__global__ void __launch_bounds__(FC_THREADS) fc_kernel(
    NetDesc d, TensorPtrs params, EnvDesc g, const float* __restrict__ obs,
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
  fc_load_tile_params(d, params, ow, ob, sp);
  const int e0 = blockIdx.x * TE;
  const int ne = min(TE, E - e0);
  for (int k = threadIdx.x; k < no * TE; k += blockDim.x) {
    const int i = k / TE, el = k - i * TE;
    sx[k] = (el < ne) ? obs[(size_t)(e0 + el) * no + i] : 0.0f;
  }
  __syncthreads();

  // Q(s): dueling V + A - mean(A), or the chain's output
  if (d.dueling)
    fc_chain_tile(d, sp, ow, ob, sx, TE, b0, b1, sv, 0, d.n_val, TE);
  const float* aout = fc_chain_tile(d, sp, ow, ob, sx, TE, b0, b1, nullptr,
                                    d.n_val, d.n_adv, TE);

  float s_ret = 0.0f, s_len = 0.0f, s_end = 0.0f;
  const int el = threadIdx.x;
  if (el < ne) {
    const int e = e0 + el;
    const int greedy = fc_tile_greedy(d, aout, sv, el, TE);
    const float u0 = u[e], u1 = u[(size_t)E + e];
    const float action = (u0 < eps) ? floorf(u1 * (float)A) : (float)greedy;
    fc_env_step<ENV>(g, sx, TE, el, action, e, E, state, ep_step, ep_ret, u,
                     max_len, fields, obs_out, state_out, ep_step_out,
                     ep_ret_out, s_ret, s_len, s_end);
  }
  fc_block_totals(red, s_ret, s_len, s_end, partials);
}

// K6's shared layout for a tile of TE envs, in floats from the start of
// dynamic shared memory (k6_smem_bytes in ops/cuda/fused_collect.py gates
// on the same sum): the head's params (fc_tile_layout), the cell's [wi; wh]
// as rows of G and its bias (padded to 4), the tile's obs and h rows and c
// rows (c' in place), h', the head's two buffers and value output, the
// envs' end flags and the accumulator sums. The cell's rows are TP = TE +
// 4 floats apart: the stores of consecutive units' float4s then fall in
// different banks.
struct RnnLayout {
  int np, w, b, x, c, hn, b0, b1, sv, end, red, total;
};

__host__ __device__ inline RnnLayout fc_rnn_layout(const NetDesc& d, int np,
                                                   int kind, int cin, int H,
                                                   int TE) {
  RnnLayout L;
  const int G = (kind == 0 ? 4 : 3) * H, TP = TE + 4;
  L.np = np;
  L.w = np;
  L.b = L.w + ((cin + H) * G + 3) / 4 * 4;
  L.x = L.b + (G + 3) / 4 * 4;
  L.c = L.x + (cin + H) * TP;
  L.hn = L.c + (kind == 0 ? H : 0) * TP;
  L.b0 = L.hn + H * TP;
  L.b1 = L.b0 + d.maxw * TE;
  L.sv = L.b1 + d.maxw * TE;
  L.end = L.sv + TE;
  L.red = L.end + TE;
  L.total = L.red + 3 * FC_THREADS;
  return L;
}

// The cell step on the tile: a work item is 4 envs x unit j. Gate sums in
// registers, each over the rows in ascending order (x rows, then h rows):
// LSTM a[e][q] for gates i, f, g, o; GRU a[e][0..1] for r, z, a[e][2] =
// x . W_in and a[e][3] = h . W_hn. Writes h' (hn) and, for the LSTM, c' in
// place of c. sx holds the x rows then the h rows, TP floats apart.
template <int KIND>
__device__ __forceinline__ void fc_cell_tile(const float* __restrict__ sw,
                                             const float* __restrict__ sb,
                                             const float* sx, float* sc,
                                             float* shn, int cin, int H,
                                             int TE, int TP) {
  constexpr int NG = KIND == 0 ? 4 : 3;
  const int G = NG * H;
  for (int k = threadIdx.x; k < (TE / 4) * H; k += blockDim.x) {
    const int j = k % H, e4 = k / H;
    float a[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[e][q] = 0.0f;
    for (int i = 0; i < cin + H; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(sx + i * TP + 4 * e4);
      const float xs[4] = {x.x, x.y, x.z, x.w};
      float ws[NG];
#pragma unroll
      for (int q = 0; q < NG; ++q) ws[q] = sw[i * G + q * H + j];
      // LSTM: slot q is gate q; GRU: the n gate's x rows go to slot 2, its
      // h rows to slot 3
      const bool hn_row = KIND == 1 && i >= cin;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e][0] = fmaf(xs[e], ws[0], a[e][0]);
        a[e][1] = fmaf(xs[e], ws[1], a[e][1]);
        if (KIND == 0 || !hn_row) a[e][2] = fmaf(xs[e], ws[2], a[e][2]);
        if (KIND == 0)
          a[e][3] = fmaf(xs[e], ws[NG - 1], a[e][3]);
        else if (hn_row)
          a[e][3] = fmaf(xs[e], ws[2], a[e][3]);
      }
    }
    float hn[4];
    if (KIND == 0) {
      const float4 c4 = *reinterpret_cast<const float4*>(sc + j * TP + 4 * e4);
      const float cs[4] = {c4.x, c4.y, c4.z, c4.w};
      float cn[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ig = 1.0f / (1.0f + expf(-(a[e][0] + sb[j])));
        const float fg = 1.0f / (1.0f + expf(-(a[e][1] + sb[H + j])));
        const float gg = tanhf(a[e][2] + sb[2 * H + j]);
        const float og = 1.0f / (1.0f + expf(-(a[e][3] + sb[3 * H + j])));
        cn[e] = fg * cs[e] + ig * gg;
        hn[e] = og * tanhf(cn[e]);
      }
      *reinterpret_cast<float4*>(sc + j * TP + 4 * e4) =
          make_float4(cn[0], cn[1], cn[2], cn[3]);
    } else {
      const float4 h4 =
          *reinterpret_cast<const float4*>(sx + (cin + j) * TP + 4 * e4);
      const float hs[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float r = 1.0f / (1.0f + expf(-(a[e][0] + sb[j])));
        const float z = 1.0f / (1.0f + expf(-(a[e][1] + sb[H + j])));
        const float n = tanhf(a[e][2] + r * a[e][3] + sb[2 * H + j]);
        hn[e] = (1.0f - z) * n + z * hs[e];
      }
    }
    *reinterpret_cast<float4*>(shn + j * TP + 4 * e4) =
        make_float4(hn[0], hn[1], hn[2], hn[3]);
  }
}

// K6: the collect step for a recurrent net (replaces fused_collect's
// recurrent plan, _cell_cols + _collect_block): per tile of TE envs the
// cell step on the obs and the state rows nstate [E, S] = h (;c)
// (fc_cell_tile), the Dense or dueling head on h' (fc_chain_tile), then a
// thread per env for epsilon-greedy, the env step and its bookkeeping, and
// the new state rows, zeroed where the episode ended.
template <int ENV>
__global__ void __launch_bounds__(FC_THREADS) fc_rnn_kernel(
    NetDesc d, TensorPtrs params, int kind, int H,
    const float* __restrict__ wi, const float* __restrict__ wh,
    const float* __restrict__ bc, EnvDesc g, const float* __restrict__ obs,
    const float* __restrict__ state, const int* __restrict__ ep_step,
    const float* __restrict__ ep_ret, const float* __restrict__ u,
    const float* __restrict__ nstate, int E, int TE, float eps, int max_len,
    float* __restrict__ fields, float* __restrict__ obs_out,
    float* __restrict__ state_out, int* __restrict__ ep_step_out,
    float* __restrict__ ep_ret_out, float* __restrict__ nstate_out,
    float* __restrict__ partials) {
  extern __shared__ __align__(16) float k6_smem[];
  __shared__ int ow[DQ_MAXL], ob[DQ_MAXL];
  __shared__ RnnLayout L;
  const int cin = FcEnv<ENV>::NO, G = (kind == 0 ? 4 : 3) * H, TP = TE + 4;
  const int S = (kind == 0 ? 2 : 1) * H;
  if (threadIdx.x == 0)
    L = fc_rnn_layout(d, fc_tile_layout(d, ow, ob), kind, cin, H, TE);
  __syncthreads();
  float* sp = k6_smem;
  float* sw = k6_smem + L.w;    // [cin + H][G]: wi rows, then wh rows
  float* sb = k6_smem + L.b;    // [G]
  float* sx = k6_smem + L.x;    // [cin + H][TP]: obs rows, then h rows
  float* sc = k6_smem + L.c;    // [H][TP] (LSTM): c, then c'
  float* shn = k6_smem + L.hn;  // [H][TP]: h'
  float* b0 = k6_smem + L.b0;   // [maxw][TE]
  float* b1 = k6_smem + L.b1;   // [maxw][TE]
  float* sv = k6_smem + L.sv;   // [TE] the value head's output
  float* send = k6_smem + L.end;  // [TE] 1 where the env's episode ended
  float* red = k6_smem + L.red;   // [3, blockDim]
  fc_load_tile_params(d, params, ow, ob, sp);
  for (int k = threadIdx.x; k < cin * G; k += blockDim.x) sw[k] = wi[k];
  for (int k = threadIdx.x; k < H * G; k += blockDim.x) sw[cin * G + k] = wh[k];
  for (int k = threadIdx.x; k < G; k += blockDim.x) sb[k] = bc[k];
  const int e0 = blockIdx.x * TE;
  const int ne = min(TE, E - e0);
  for (int k = threadIdx.x; k < cin * TE; k += blockDim.x) {
    const int i = k / TE, el = k - i * TE;
    sx[i * TP + el] = (el < ne) ? obs[(size_t)(e0 + el) * cin + i] : 0.0f;
  }
  // the tile's state rows are contiguous in nstate: a coalesced read
  for (int k = threadIdx.x; k < TE * S; k += blockDim.x) {
    const int el = k / S, col = k - el * S;
    const float v = (el < ne) ? nstate[(size_t)e0 * S + k] : 0.0f;
    if (col < H)
      sx[(cin + col) * TP + el] = v;
    else
      sc[(col - H) * TP + el] = v;
  }
  __syncthreads();

  if (kind == 0)
    fc_cell_tile<0>(sw, sb, sx, sc, shn, cin, H, TE, TP);
  else
    fc_cell_tile<1>(sw, sb, sx, sc, shn, cin, H, TE, TP);
  __syncthreads();

  if (d.dueling)
    fc_chain_tile(d, sp, ow, ob, shn, TP, b0, b1, sv, 0, d.n_val, TE);
  const float* aout = fc_chain_tile(d, sp, ow, ob, shn, TP, b0, b1, nullptr,
                                    d.n_val, d.n_adv, TE);

  float s_ret = 0.0f, s_len = 0.0f, s_end = 0.0f;
  const int el = threadIdx.x;
  if (el < ne) {
    const int e = e0 + el;
    const int greedy = fc_tile_greedy(d, aout, sv, el, TE);
    const float u0 = u[e], u1 = u[(size_t)E + e];
    const float action =
        (u0 < eps) ? floorf(u1 * (float)d.num_actions) : (float)greedy;
    const bool end = fc_env_step<ENV>(g, sx, TP, el, action, e, E, state,
                                      ep_step, ep_ret, u, max_len, fields,
                                      obs_out, state_out, ep_step_out,
                                      ep_ret_out, s_ret, s_len, s_end);
    send[el] = end ? 1.0f : 0.0f;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < ne * S; k += blockDim.x) {
    const int el2 = k / S, col = k - el2 * S;
    const float v =
        (col < H) ? shn[col * TP + el2] : sc[(col - H) * TP + el2];
    nstate_out[(size_t)e0 * S + k] = (send[el2] != 0.0f) ? 0.0f : v;
  }
  fc_block_totals(red, s_ret, s_len, s_end, partials);
}

// K4's launch for env ENV (the obs width must be the env's).
template <int ENV>
static int fc_launch(const NetDesc* d, const TensorPtrs& P,
                     const EnvDesc& g, const void* obs, const void* state,
                     const void* ep_step, const void* ep_ret, const void* u,
                     int E, int TE, float eps, int max_len, void* fields,
                     void* obs_out, void* state_out, void* ep_step_out,
                     void* ep_ret_out, void* partials, void* stream) {
  if (d->in_dim != FcEnv<ENV>::NO) return (int)cudaErrorInvalidValue;
  const int smem = fc_tile_smem_bytes(*d, TE);
  cudaError_t err = cudaFuncSetAttribute(
      fc_kernel<ENV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (E + TE - 1) / TE;
  fc_kernel<ENV><<<blocks, FC_THREADS, smem, (cudaStream_t)stream>>>(
      *d, P, g, (const float*)obs, (const float*)state, (const int*)ep_step,
      (const float*)ep_ret, (const float*)u, E, TE, eps, max_len,
      (float*)fields, (float*)obs_out, (float*)state_out,
      (int*)ep_step_out, (float*)ep_ret_out, (float*)partials);
  return (int)cudaGetLastError();
}

DQ_API int dq_fused_collect(const NetDesc* d, const int64_t* p_ptrs,
                            const EnvDesc* env, const void* obs,
                            const void* state, const void* ep_step,
                            const void* ep_ret, const void* u, int E, int TE,
                            float eps, int max_len, void* fields,
                            void* obs_out, void* state_out,
                            void* ep_step_out, void* ep_ret_out,
                            void* partials, void* stream) {
  if (env->n_cells > FC_MAXCELLS || d->maxw > FC_MAXW || TE < 4 ||
      TE > FC_MAX_TE || TE % 4 != 0)
    return (int)cudaErrorInvalidValue;
  TensorPtrs P;
  for (int i = 0; i < 2 * (d->n_val + d->n_adv); ++i)
    P.t[i] = (float*)p_ptrs[i];
#define FC_LAUNCH(ENV)                                                     \
  fc_launch<ENV>(d, P, *env, obs, state, ep_step, ep_ret, u, E, TE, eps,   \
                 max_len, fields, obs_out, state_out, ep_step_out,          \
                 ep_ret_out, partials, stream)
  switch (env->kind) {
    case FC_GRID: return FC_LAUNCH(FC_GRID);
    case FC_CARTPOLE: return FC_LAUNCH(FC_CARTPOLE);
    case FC_MOUNTAINCAR: return FC_LAUNCH(FC_MOUNTAINCAR);
  }
#undef FC_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K6's launch for env ENV (the cell's input width must be the env's obs).
template <int ENV>
static int fc_rnn_launch(const NetDesc* d, const TensorPtrs& P, int kind,
                         int H, int cin, const void* wi, const void* wh,
                         const void* bc, const EnvDesc& g, const void* obs,
                         const void* state, const void* ep_step,
                         const void* ep_ret, const void* u,
                         const void* nstate, int E, int TE, float eps,
                         int max_len, void* fields, void* obs_out,
                         void* state_out, void* ep_step_out,
                         void* ep_ret_out, void* nstate_out, void* partials,
                         void* stream) {
  if (cin != FcEnv<ENV>::NO) return (int)cudaErrorInvalidValue;
  int ow[DQ_MAXL], ob[DQ_MAXL];
  const int np = fc_tile_layout(*d, ow, ob);
  const int smem =
      fc_rnn_layout(*d, np, kind, cin, H, TE).total * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fc_rnn_kernel<ENV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (E + TE - 1) / TE;
  fc_rnn_kernel<ENV><<<blocks, FC_THREADS, smem, (cudaStream_t)stream>>>(
      *d, P, kind, H, (const float*)wi, (const float*)wh, (const float*)bc, g,
      (const float*)obs, (const float*)state, (const int*)ep_step,
      (const float*)ep_ret, (const float*)u, (const float*)nstate, E, TE, eps,
      max_len, (float*)fields, (float*)obs_out, (float*)state_out,
      (int*)ep_step_out, (float*)ep_ret_out, (float*)nstate_out,
      (float*)partials);
  return (int)cudaGetLastError();
}

DQ_API int dq_fused_collect_rnn(const NetDesc* d, const int64_t* p_ptrs,
                                int kind, int H, int cin, const void* wi,
                                const void* wh, const void* bc,
                                const EnvDesc* env, const void* obs,
                                const void* state, const void* ep_step,
                                const void* ep_ret, const void* u,
                                const void* nstate, int E, int TE, float eps,
                                int max_len, void* fields, void* obs_out,
                                void* state_out, void* ep_step_out,
                                void* ep_ret_out, void* nstate_out,
                                void* partials, void* stream) {
  if (env->n_cells > FC_MAXCELLS || d->in_dim != H ||
      (kind != 0 && kind != 1) || TE < 4 || TE > FC_MAX_TE || TE % 4 != 0)
    return (int)cudaErrorInvalidValue;
  TensorPtrs P;
  for (int i = 0; i < 2 * (d->n_val + d->n_adv); ++i)
    P.t[i] = (float*)p_ptrs[i];
#define FC_RNN_LAUNCH(ENV)                                                  \
  fc_rnn_launch<ENV>(d, P, kind, H, cin, wi, wh, bc, *env, obs, state,      \
                     ep_step, ep_ret, u, nstate, E, TE, eps, max_len, fields,\
                     obs_out, state_out, ep_step_out, ep_ret_out, nstate_out,\
                     partials, stream)
  switch (env->kind) {
    case FC_GRID: return FC_RNN_LAUNCH(FC_GRID);
    case FC_CARTPOLE: return FC_RNN_LAUNCH(FC_CARTPOLE);
    case FC_MOUNTAINCAR: return FC_RNN_LAUNCH(FC_MOUNTAINCAR);
  }
#undef FC_RNN_LAUNCH
  return (int)cudaErrorInvalidValue;
}
