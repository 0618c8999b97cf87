// K5: the recurrent (DRQN) train phase, U sequential sub-updates (replaces
// fused_drqn_group_update of deepqlearning_tpu/ops/pallas/fused_drqn.py).
//
// The host issues two launches per sub-update u on one stream, with no host
// sync between them:
//   (a) dr_fwd_bwd_kernel: one warp per trace window; the lanes of the warp
//       split every layer's output columns (and every input row of the
//       transposed products). A block copies the packed parameters into
//       shared memory; each warp keeps its window's T step activations and
//       its own gradient accumulators in shared memory. Per window: the
//       online unroll over s' from a zero state (double-Q argmax, first
//       max), the unroll over s keeping the activations, the masked Huber
//       terms, then BPTT through the head (Dense or dueling), the LSTM or
//       GRU cell and the Dense layers before it. The block sums its warps'
//       gradients and losses in a fixed order into a per-block partial.
//   (b) dr_adam_kernel: one block sums the partials over the blocks in a
//       fixed order, takes the max-abs entry (gnorm), and applies Adam to
//       params, m and v in place with t = count + u + 1.
// Every sum has a fixed order, so a run is deterministic. Launch (a) plus a
// reduce is the grads-emitting variant (fused_drqn_grads) that data
// parallelism needs.
//
// At the loop's shapes (B = 512 windows, T = 8, LSTM(2, 32) + Dense(32, 4))
// a sub-update is ~0.3 GFLOP-equivalent of dependent dot products of
// length 34 or less: the kernel is bound by latency (the T-step recurrence,
// warp syncs, shared-memory traffic), not by bytes or the FP32 units.
// Transposed products walk their reduction index from a per-lane rotated
// start so the lanes of a warp read distinct shared-memory banks.
#include "common.cuh"

#define DR_MAXL 16
#define DR_MAXT (2 * DR_MAXL + 3)
#define DR_MAXWARPS 8

// Mirrors build.DrqnDesc; offsets are computed by DRQNPlan.desc.
struct DrqnDesc {
  int cell;  // 0 LSTM (gates i,f,g,o), 1 GRU (gates r,z,n)
  int n_pre, n_val, n_adv, dueling;
  int in_dim, cin, H, G, A, T;
  int n_params, n_tensors;
  // Dense layers in the order pre, value head, advantage head
  int din[DR_MAXL], dout[DR_MAXL], act[DR_MAXL];
  int off_w[DR_MAXL], off_b[DR_MAXL];  // packed parameter offsets
  int off_a[DR_MAXL];                  // output offset in a step block
  int off_wi, off_wh, off_bc;          // the cell's packed parameters
  // a step block: gates [G]; aux [H] (LSTM tanh(c'), GRU h.wh_n); c' [H]
  // (LSTM only); h' [H]
  int a_gates, a_aux, a_c, a_h;
  int step_floats;
  // a warp's region: gradients [n_params] at 0, T step blocks at s_steps,
  // then scratch
  int s_steps, s_x, s_h2, s_c2, s_tmp, s_q, s_q2, s_zero, s_dht, s_dhc,
      s_dcc, s_dz, s_dhh, s_b0, s_b1, s_gtd, s_act;
  int warp_floats;
  int t_off[DR_MAXT], t_size[DR_MAXT];  // tensors: Dense (w, b)*, wi, wh, b
};

struct DrqnPtrs {
  float* t[DR_MAXT];
};

__device__ __forceinline__ float dr_sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

// out[o] = act(sum_i in[i] * W[i, o] + b[o]); lanes split o
__device__ void dr_dense(const float* W, const float* b, int din, int dout,
                         int act, const float* in, float* out, int lane) {
  for (int o = lane; o < dout; o += 32) {
    float z = 0.0f;
    for (int i = 0; i < din; ++i) z += in[i] * W[i * dout + o];
    out[o] = dq_act(z + b[o], act);
  }
  __syncwarp();
}

// One step of the online net: input x [in_dim] and state (hp, cp) -> the
// step block st and q [A].
__device__ void dr_step_fwd(const DrqnDesc& d, const float* sp,
                            const float* x, const float* hp, const float* cp,
                            float* st, float* q, int lane) {
  const float* in = x;
  for (int l = 0; l < d.n_pre; ++l) {
    dr_dense(sp + d.off_w[l], sp + d.off_b[l], d.din[l], d.dout[l], d.act[l],
             in, st + d.off_a[l], lane);
    in = st + d.off_a[l];
  }
  const int H = d.H, G = d.G;
  const float* wi = sp + d.off_wi;
  const float* wh = sp + d.off_wh;
  const float* bc = sp + d.off_bc;
  float* gates = st + d.a_gates;
  float* aux = st + d.a_aux;
  float* h = st + d.a_h;
  for (int col = lane; col < G; col += 32) {
    float xi = 0.0f, hh = 0.0f;
    for (int i = 0; i < d.cin; ++i) xi += in[i] * wi[i * G + col];
    for (int k = 0; k < H; ++k) hh += hp[k] * wh[k * G + col];
    if (d.cell == 0) {
      const float z = xi + hh + bc[col];
      gates[col] = (col >= 2 * H && col < 3 * H) ? tanhf(z) : dr_sigmoid(z);
    } else if (col < 2 * H) {
      gates[col] = dr_sigmoid(xi + hh + bc[col]);
    } else {
      gates[col] = xi + bc[col];  // the n gate's input part, finished below
      aux[col - 2 * H] = hh;
    }
  }
  __syncwarp();
  for (int j = lane; j < H; j += 32) {
    if (d.cell == 0) {
      const float c = gates[H + j] * cp[j] + gates[j] * gates[2 * H + j];
      const float tc = tanhf(c);
      st[d.a_c + j] = c;
      aux[j] = tc;
      h[j] = gates[3 * H + j] * tc;
    } else {
      const float r = gates[j], z = gates[H + j];
      const float n = tanhf(gates[2 * H + j] + r * aux[j]);
      gates[2 * H + j] = n;
      h[j] = (1.0f - z) * n + z * hp[j];
    }
  }
  __syncwarp();
  const int la = d.n_pre + d.n_val;  // first advantage-head layer
  const float* a_out = h;
  for (int l = la; l < la + d.n_adv; ++l) {
    dr_dense(sp + d.off_w[l], sp + d.off_b[l], d.din[l], d.dout[l], d.act[l],
             a_out, st + d.off_a[l], lane);
    a_out = st + d.off_a[l];
  }
  const float* v_out = h;
  for (int l = d.n_pre; l < la; ++l) {
    dr_dense(sp + d.off_w[l], sp + d.off_b[l], d.din[l], d.dout[l], d.act[l],
             v_out, st + d.off_a[l], lane);
    v_out = st + d.off_a[l];
  }
  const int A = d.A;
  for (int c = lane; c < A; c += 32) {
    if (d.dueling) {
      float s = 0.0f;
      for (int k = 0; k < A; ++k) s += a_out[k];
      q[c] = v_out[0] + a_out[c] - s * (1.0f / (float)A);
    } else {
      q[c] = a_out[c];
    }
  }
  __syncwarp();
}

// Backward through Dense layers [l0, l0 + nl) of one step: dh holds
// dL/d(output of the last layer) on entry; x is the first layer's input.
// Accumulates dW, db into gw; returns the buffer holding dL/dx when need_dx.
__device__ float* dr_dense_bwd(const DrqnDesc& d, const float* sp, int l0,
                               int nl, const float* x, const float* st,
                               float* dh, float* other, float* gw,
                               bool need_dx, int lane) {
  for (int l = l0 + nl - 1; l >= l0; --l) {
    const int din = d.din[l], dout = d.dout[l];
    const float* hpost = st + d.off_a[l];
    const float* hprev = (l == l0) ? x : st + d.off_a[l - 1];
    for (int o = lane; o < dout; o += 32)
      dh[o] *= dq_act_grad(hpost[o], d.act[l]);
    __syncwarp();
    for (int o = lane; o < dout; o += 32) {
      const float dz = dh[o];
      float* g = gw + d.off_w[l] + o;
      for (int i = 0; i < din; ++i) g[i * dout] += hprev[i] * dz;
      gw[d.off_b[l] + o] += dz;
    }
    if (l > l0 || need_dx) {
      const float* W = sp + d.off_w[l];
      for (int i = lane; i < din; i += 32) {
        float s = 0.0f;
        int o = lane % dout;
        for (int k = 0; k < dout; ++k) {
          s += dh[o] * W[i * dout + o];
          if (++o == dout) o = 0;
        }
        other[i] = s;
      }
      __syncwarp();
      float* tmp = dh;
      dh = other;
      other = tmp;
    }
  }
  return dh;
}

// Forward, loss and BPTT of one trace window (flat window index `row`);
// returns the window's Huber sum (valid in lane 0).
__device__ float dr_window(const DrqnDesc& d, const float* sp, float* ws,
                           int row, const float* __restrict__ obs,
                           const float* __restrict__ nobs,
                           const int* __restrict__ action,
                           const float* __restrict__ reward,
                           const float* __restrict__ done,
                           const float* __restrict__ mask,
                           const float* __restrict__ q_sp_tgt, float gamma,
                           int double_q, float inv_bt, int lane) {
  const int T = d.T, H = d.H, G = d.G, A = d.A, D = d.in_dim;
  float* gw = ws;
  float* steps = ws + d.s_steps;
  float* sx = ws + d.s_x;
  float* h2 = ws + d.s_h2;
  float* c2 = ws + d.s_c2;
  float* tmp = ws + d.s_tmp;
  float* q = ws + d.s_q;
  float* q2 = ws + d.s_q2;
  float* zero = ws + d.s_zero;
  float* dht = ws + d.s_dht;
  float* dhc = ws + d.s_dhc;
  float* dcc = ws + d.s_dcc;
  float* dz = ws + d.s_dz;
  float* dhh = ws + d.s_dhh;
  float* b0 = ws + d.s_b0;
  float* b1 = ws + d.s_b1;
  float* gtd = ws + d.s_gtd;
  float* sact = ws + d.s_act;
  for (int j = lane; j < H; j += 32) {
    h2[j] = 0.0f;
    c2[j] = 0.0f;
    zero[j] = 0.0f;
    dhc[j] = 0.0f;
    dcc[j] = 0.0f;
  }
  __syncwarp();

  // ---- forward over the trace
  float loss = 0.0f;
  for (int t = 0; t < T; ++t) {
    const size_t rt = (size_t)row * T + t;
    float* st = steps + t * d.step_floats;
    const float* hp = t ? st - d.step_floats + d.a_h : zero;
    const float* cp = (t && d.cell == 0) ? st - d.step_floats + d.a_c : zero;
    for (int i = lane; i < D; i += 32) sx[i] = obs[rt * D + i];
    __syncwarp();
    dr_step_fwd(d, sp, sx, hp, cp, st, q, lane);
    if (double_q) {
      for (int i = lane; i < D; i += 32) sx[i] = nobs[rt * D + i];
      __syncwarp();
      dr_step_fwd(d, sp, sx, h2, c2, tmp, q2, lane);
      for (int j = lane; j < H; j += 32) {
        h2[j] = tmp[d.a_h + j];
        if (d.cell == 0) c2[j] = tmp[d.a_c + j];
      }
      __syncwarp();
    }
    if (lane == 0) {
      const float* tg = q_sp_tgt + rt * A;
      float qmax;
      if (double_q) {
        int best = 0;
        float bv = q2[0];
        for (int c = 1; c < A; ++c)
          if (q2[c] > bv) { bv = q2[c]; best = c; }
        qmax = tg[best];
      } else {
        qmax = tg[0];
        for (int c = 1; c < A; ++c) qmax = fmaxf(qmax, tg[c]);
      }
      const float target = reward[rt] + (1.0f - done[rt]) * gamma * qmax;
      // an action outside [0, A) selects nothing, as the one-hot select of
      // the TPU kernel does
      const int a = action[rt];
      const float td = ((a >= 0 && a < A) ? q[a] : 0.0f) - target;
      const float mk = mask[rt];
      const float xw = mk * td;
      const float absx = fabsf(xw);
      const float quad = fminf(absx, 1.0f);
      loss += 0.5f * quad * quad + (absx - quad);
      gtd[t] = mk * fminf(fmaxf(xw, -1.0f), 1.0f) * inv_bt;
      sact[t] = (float)a;
    }
    __syncwarp();
  }

  // ---- BPTT
  const float* wi = sp + d.off_wi;
  const float* wh = sp + d.off_wh;
  const float* dg = (d.cell == 0) ? dz : dhh;  // wh-side gate cotangents
  for (int t = T - 1; t >= 0; --t) {
    const size_t rt = (size_t)row * T + t;
    const float* st = steps + t * d.step_floats;
    const float* hp = t ? st - d.step_floats + d.a_h : zero;
    const float* cp = (t && d.cell == 0) ? st - d.step_floats + d.a_c : zero;
    const float* h = st + d.a_h;
    for (int i = lane; i < D; i += 32) sx[i] = obs[rt * D + i];
    // dL/dq at the taken action; through the dueling combination:
    // g_adv = g_q - sum(g_q) / A, g_val = sum(g_q)
    const float g = gtd[t];
    const int a = (int)sact[t];
    const float sdq = (a >= 0 && a < A) ? g : 0.0f;
    for (int c = lane; c < A; c += 32) {
      const float gq = (c == a) ? g : 0.0f;
      b0[c] = d.dueling ? gq - sdq * (1.0f / (float)A) : gq;
    }
    __syncwarp();
    const float* r = dr_dense_bwd(d, sp, d.n_pre + d.n_val, d.n_adv, h, st,
                                  b0, b1, gw, true, lane);
    for (int j = lane; j < H; j += 32) dht[j] = r[j];
    __syncwarp();
    if (d.dueling) {
      if (lane == 0) b0[0] = sdq;
      __syncwarp();
      r = dr_dense_bwd(d, sp, d.n_pre, d.n_val, h, st, b0, b1, gw, true,
                       lane);
      for (int j = lane; j < H; j += 32) dht[j] += r[j];
      __syncwarp();
    }

    // the cell: gate cotangents dz (input side) and dg (recurrent side)
    const float* gt = st + d.a_gates;
    for (int j = lane; j < H; j += 32) {
      const float dh = dht[j] + dhc[j];
      if (d.cell == 0) {
        const float ig = gt[j], fg = gt[H + j], gg = gt[2 * H + j],
                    og = gt[3 * H + j];
        const float tc = st[d.a_aux + j];
        const float dc = dcc[j] + dh * og * (1.0f - tc * tc);
        dz[j] = (dc * gg) * ig * (1.0f - ig);
        dz[H + j] = (dc * cp[j]) * fg * (1.0f - fg);
        dz[2 * H + j] = (dc * ig) * (1.0f - gg * gg);
        dz[3 * H + j] = (dh * tc) * og * (1.0f - og);
        dcc[j] = dc * fg;
      } else {
        const float rg = gt[j], zg = gt[H + j], ng = gt[2 * H + j];
        const float dpn = dh * (1.0f - zg) * (1.0f - ng * ng);
        dz[j] = (dpn * st[d.a_aux + j]) * rg * (1.0f - rg);
        dz[H + j] = (dh * (hp[j] - ng)) * zg * (1.0f - zg);
        dz[2 * H + j] = dpn;
        dhh[j] = dz[j];
        dhh[H + j] = dz[H + j];
        dhh[2 * H + j] = dpn * rg;
        dht[j] = dh * zg;  // the direct path h' -> h
      }
    }
    __syncwarp();
    const float* xL = d.n_pre ? st + d.off_a[d.n_pre - 1] : sx;
    for (int col = lane; col < G; col += 32) {
      const float z = dz[col], zh = dg[col];
      gw[d.off_bc + col] += z;
      for (int i = 0; i < d.cin; ++i) gw[d.off_wi + i * G + col] += xL[i] * z;
      for (int k = 0; k < H; ++k) gw[d.off_wh + k * G + col] += hp[k] * zh;
    }
    for (int k = lane; k < H; k += 32) {
      float s = 0.0f;
      int col = lane % G;
      for (int c = 0; c < G; ++c) {
        s += wh[k * G + col] * dg[col];
        if (++col == G) col = 0;
      }
      dhc[k] = (d.cell == 1 ? dht[k] : 0.0f) + s;
    }
    if (d.n_pre) {
      for (int i = lane; i < d.cin; i += 32) {
        float s = 0.0f;
        int col = lane % G;
        for (int c = 0; c < G; ++c) {
          s += wi[i * G + col] * dz[col];
          if (++col == G) col = 0;
        }
        b0[i] = s;
      }
      __syncwarp();
      dr_dense_bwd(d, sp, 0, d.n_pre, sx, st, b0, b1, gw, false, lane);
    }
    __syncwarp();
  }
  return loss;
}

__global__ void __launch_bounds__(32 * DR_MAXWARPS) dr_fwd_bwd_kernel(
    DrqnDesc d, DrqnPtrs P, const float* __restrict__ obs,
    const float* __restrict__ nobs, const int* __restrict__ action,
    const float* __restrict__ reward, const float* __restrict__ done,
    const float* __restrict__ mask, const float* __restrict__ q_sp_tgt,
    int B, int row0, float gamma, int double_q, float inv_bt,
    float* __restrict__ part_grad, float* __restrict__ part_loss) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  float* sp = smem;
  float* ws = sp + d.n_params + warp * d.warp_floats;
  float* sloss = sp + d.n_params + wpb * d.warp_floats;
  for (int k = 0; k < d.n_tensors; ++k)
    for (int i = threadIdx.x; i < d.t_size[k]; i += blockDim.x)
      sp[d.t_off[k] + i] = P.t[k][i];
  for (int k = lane; k < d.n_params; k += 32) ws[k] = 0.0f;
  __syncthreads();

  const int w = blockIdx.x * wpb + warp;  // window within the sub-batch
  float loss = 0.0f;
  if (w < B)
    loss = dr_window(d, sp, ws, row0 + w, obs, nobs, action, reward, done,
                     mask, q_sp_tgt, gamma, double_q, inv_bt, lane);
  if (lane == 0) sloss[warp] = loss;
  __syncthreads();

  const float* g0 = sp + d.n_params;
  for (int k = threadIdx.x; k < d.n_params; k += blockDim.x) {
    float s = 0.0f;
    for (int v = 0; v < wpb; ++v) s += g0[v * d.warp_floats + k];
    part_grad[(size_t)blockIdx.x * d.n_params + k] = s;
  }
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int v = 0; v < wpb; ++v) s += sloss[v];
    part_loss[blockIdx.x] = s;
  }
}

#define DR_ADAM_THREADS 1024

__global__ void __launch_bounds__(DR_ADAM_THREADS) dr_adam_kernel(
    DrqnDesc d, DrqnPtrs p, DrqnPtrs m, DrqnPtrs v,
    const float* __restrict__ part_grad, const float* __restrict__ part_loss,
    int nblk, const int* __restrict__ count, int u, float lr, float b1,
    float b2, float adam_eps, float inv_bt, float* __restrict__ loss_out,
    float* __restrict__ gnorm_out) {
  __shared__ float red[DR_ADAM_THREADS];
  const float t = (float)(count[0] + u + 1);
  const float c1 = 1.0f / (1.0f - powf(b1, t));
  const float c2 = 1.0f / (1.0f - powf(b2, t));
  float gmax = 0.0f;
  for (int k2 = 0; k2 < d.n_tensors; ++k2) {
    const int n = d.t_size[k2], off = d.t_off[k2];
    float* pt = p.t[k2];
    float* mt = m.t[k2];
    float* vt = v.t[k2];
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      float g = 0.0f;
      for (int b = 0; b < nblk; ++b)
        g += part_grad[(size_t)b * d.n_params + off + k];
      gmax = fmaxf(gmax, fabsf(g));
      const float mk = b1 * mt[k] + (1.0f - b1) * g;
      const float vk = b2 * vt[k] + (1.0f - b2) * (g * g);
      mt[k] = mk;
      vt[k] = vk;
      pt[k] -= lr * (mk * c1) / (sqrtf(vk * c2) + adam_eps);
    }
  }
  red[threadIdx.x] = gmax;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (loss_out != nullptr) {  // null when the loss comes from K8
      float s = 0.0f;
      for (int b = 0; b < nblk; ++b) s += part_loss[b];
      loss_out[0] = s * inv_bt;
    }
    gnorm_out[0] = red[0];
  }
}

static void dr_fill(DrqnPtrs* t, const int64_t* ptrs, int n) {
  for (int i = 0; i < n; ++i) t->t[i] = (float*)ptrs[i];
}

// Shared-memory bytes of one dr_fwd_bwd_kernel block (DRQNPlan.smem_bytes
// in ops/cuda/fused_drqn.py gates on the same sum).
static int dr_smem_bytes(const DrqnDesc* d, int wpb) {
  return (d->n_params + wpb * (d->warp_floats + 1)) * (int)sizeof(float);
}

// One sub-update's forward/BPTT launch (a): per-block partial gradients and
// Huber sums of windows [row0, row0 + B).
static cudaError_t dr_launch_fwd_bwd(const DrqnDesc* d, const DrqnPtrs& P,
                                     int B, int wpb, int row0,
                                     const void* obs, const void* nobs,
                                     const void* action, const void* reward,
                                     const void* done, const void* mask,
                                     const void* q_sp_tgt, float gamma,
                                     int double_q, void* part_grad,
                                     void* part_loss, cudaStream_t s) {
  const int nblk = (B + wpb - 1) / wpb;
  dr_fwd_bwd_kernel<<<nblk, 32 * wpb, dr_smem_bytes(d, wpb), s>>>(
      *d, P, (const float*)obs, (const float*)nobs, (const int*)action,
      (const float*)reward, (const float*)done, (const float*)mask,
      (const float*)q_sp_tgt, B, row0, gamma, double_q,
      1.0f / (float)(B * d->T), (float*)part_grad, (float*)part_loss);
  return cudaGetLastError();
}

DQ_API int dq_fused_drqn(const DrqnDesc* d, const int64_t* p_ptrs,
                         const int64_t* m_ptrs, const int64_t* v_ptrs,
                         const void* count, int U, int B, int wpb,
                         const void* obs, const void* nobs,
                         const void* action, const void* reward,
                         const void* done, const void* mask,
                         const void* q_sp_tgt, float gamma, int double_q,
                         float lr, float b1, float b2, float adam_eps,
                         void* part_grad, void* part_loss, void* loss,
                         void* gnorm, void* stream) {
  if (wpb < 1 || wpb > DR_MAXWARPS || d->n_tensors > DR_MAXT ||
      d->n_pre + d->n_val + d->n_adv > DR_MAXL)
    return (int)cudaErrorInvalidValue;
  DrqnPtrs P, M, V;
  dr_fill(&P, p_ptrs, d->n_tensors);
  dr_fill(&M, m_ptrs, d->n_tensors);
  dr_fill(&V, v_ptrs, d->n_tensors);
  cudaError_t err = cudaFuncSetAttribute(
      dr_fwd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dr_smem_bytes(d, wpb));
  if (err != cudaSuccess) return (int)err;
  const int nblk = (B + wpb - 1) / wpb;
  const float inv_bt = 1.0f / (float)(B * d->T);
  cudaStream_t s = (cudaStream_t)stream;
  for (int u = 0; u < U; ++u) {
    err = dr_launch_fwd_bwd(d, P, B, wpb, u * B, obs, nobs, action, reward,
                            done, mask, q_sp_tgt, gamma, double_q, part_grad,
                            part_loss, s);
    if (err != cudaSuccess) return (int)err;
    dr_adam_kernel<<<1, DR_ADAM_THREADS, 0, s>>>(
        *d, P, M, V, (const float*)part_grad, (const float*)part_loss, nblk,
        (const int*)count, u, lr, b1, b2, adam_eps, inv_bt, (float*)loss,
        (float*)gnorm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// K8: one recurrent sub-update's trace forward, masked TD loss and BPTT,
// emitting gradients (replaces fused_drqn_grads of
// deepqlearning_tpu/ops/pallas/fused_drqn.py). Launch (a) above writes
// per-block partials; dq_grad_reduce_kernel (csrc/fused_update.cu) sums
// them in block order into one flat gradient [n_params] in the packed
// tensor order (Dense w, b ..., then wi, wh, b), with the loss and the
// local max-abs entry. At B = 512 windows both launches are bound by
// latency (the T-step recurrence in (a); the reduce reads 86 partials of
// 4612 floats at LSTM(2, 32) + Dense(32, 4)), not by bytes.
DQ_API int dq_fused_drqn_grads(const DrqnDesc* d, const int64_t* p_ptrs,
                               int B, int wpb, const void* obs,
                               const void* nobs, const void* action,
                               const void* reward, const void* done,
                               const void* mask, const void* q_sp_tgt,
                               float gamma, int double_q, void* part_grad,
                               void* part_loss, void* flat, void* loss,
                               void* gnorm, void* stream) {
  if (wpb < 1 || wpb > DR_MAXWARPS || d->n_tensors > DR_MAXT ||
      d->n_pre + d->n_val + d->n_adv > DR_MAXL)
    return (int)cudaErrorInvalidValue;
  DrqnPtrs P;
  dr_fill(&P, p_ptrs, d->n_tensors);
  cudaError_t err = cudaFuncSetAttribute(
      dr_fwd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dr_smem_bytes(d, wpb));
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  err = dr_launch_fwd_bwd(d, P, B, wpb, 0, obs, nobs, action, reward, done,
                          mask, q_sp_tgt, gamma, double_q, part_grad,
                          part_loss, s);
  if (err != cudaSuccess) return (int)err;
  return (int)dq_launch_grad_reduce(part_grad, part_loss, (B + wpb - 1) / wpb,
                                    d->n_params, 1.0f / (float)(B * d->T),
                                    flat, loss, gnorm, s);
}

// Adam on a flat gradient after the all-reduce: dr_adam_kernel above with
// the averaged gradient as its only partial (see dq_fused_adam).
DQ_API int dq_drqn_adam(const DrqnDesc* d, const int64_t* p_ptrs,
                        const int64_t* m_ptrs, const int64_t* v_ptrs,
                        const void* count, int u, const void* grad, float lr,
                        float b1, float b2, float adam_eps, void* gnorm,
                        void* stream) {
  if (d->n_tensors > DR_MAXT) return (int)cudaErrorInvalidValue;
  DrqnPtrs P, M, V;
  dr_fill(&P, p_ptrs, d->n_tensors);
  dr_fill(&M, m_ptrs, d->n_tensors);
  dr_fill(&V, v_ptrs, d->n_tensors);
  dr_adam_kernel<<<1, DR_ADAM_THREADS, 0, (cudaStream_t)stream>>>(
      *d, P, M, V, (const float*)grad, nullptr, 1, (const int*)count, u, lr,
      b1, b2, adam_eps, 1.0f, nullptr, (float*)gnorm);
  return (int)cudaGetLastError();
}
