// K3: the grouped train phase, U sequential DQN sub-updates (replaces
// fused_group_update of deepqlearning_tpu/ops/pallas/fused_update.py).
// K7, the grads-emitting sub-update of the data-parallel step, and the
// gradient reduce it shares with K8 follow at the end of the file.
//
// The host issues two launches per sub-update u on one stream, with no
// host sync between them:
//   (a) fu_fwd_bwd_kernel: the batch is cut into tiles of FU_TILE rows, one
//       block per tile. Each block copies the packed parameters into shared
//       memory, runs the (dueling) Dense forward on s keeping every
//       layer's post-activation values for its rows, the forward on s' for
//       the double-Q argmax, the TD error / priority / Huber terms of its
//       rows, and the hand-derived backward. Its gradient is a per-block
//       partial, summed over the tile's rows in a fixed order, written to
//       a scratch buffer [n_blocks, n_params]; its Huber sum goes to
//       [n_blocks].
//   (b) fu_adam_kernel: one block sums the partials over the blocks in a
//       fixed order, takes the max-abs entry (gnorm), and applies Adam to
//       params, m and v in place with t = count + u + 1.
// Every sum has a fixed order, so a run is deterministic. At the loop's
// shapes (B = 512, a 2->64->64->{1,4} dueling net) a sub-update is ~10
// MFLOP: the kernel is bound by latency (launches, syncthreads, dependent
// layer steps), not by bytes or the FP32 units; the tile size trades blocks
// in flight against the per-block parameter copy.
#include "common.cuh"

#define FU_TILE 16
#define FU_THREADS 256

// out[r, o] = act(b[o] + sum_i in[r, i] * W[i, o]) for the tile's rows
__device__ void fu_dense(const float* W, const float* b, int din, int dout,
                         int act, const float* in, float* out, int nrows) {
  for (int k = threadIdx.x; k < nrows * dout; k += blockDim.x) {
    const int r = k / dout, o = k % dout;
    float z = 0.0f;
    for (int i = 0; i < din; ++i) z += in[r * din + i] * W[i * dout + o];
    out[k] = dq_act(z + b[o], act);
  }
  __syncthreads();
}

// Forward through layers [l0, l0 + nl) keeping every output in sH.
__device__ void fu_chain_keep(const NetDesc& d, const float* sp,
                              const float* x, float* sH, int l0, int nl,
                              int nrows) {
  const float* in = x;
  for (int l = l0; l < l0 + nl; ++l) {
    float* out = sH + d.off_h[l] * FU_TILE;
    fu_dense(sp + d.off_w[l], sp + d.off_b[l], d.din[l], d.dout[l], d.act[l],
             in, out, nrows);
    in = out;
  }
}

// Forward through layers [l0, l0 + nl) in two ping-pong buffers; returns
// the buffer holding the last layer's output.
__device__ const float* fu_chain_tmp(const NetDesc& d, const float* sp,
                                     const float* x, float* t0, float* t1,
                                     int l0, int nl, int nrows) {
  const float* in = x;
  float* out = t0;
  for (int l = l0; l < l0 + nl; ++l) {
    fu_dense(sp + d.off_w[l], sp + d.off_b[l], d.din[l], d.dout[l], d.act[l],
             in, out, nrows);
    in = out;
    out = (out == t0) ? t1 : t0;
  }
  return in;
}

// q = V + A - mean(A) (dueling) or q = A, per row; mean over the real
// actions, summed in order and scaled by 1/A
__device__ void fu_combine(const NetDesc& d, const float* a_out,
                           const float* v_out, int v_stride, float* q,
                           int nrows) {
  const int A = d.num_actions;
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    if (d.dueling) {
      float s = 0.0f;
      for (int c = 0; c < A; ++c) s += a_out[r * A + c];
      const float mean = s * (1.0f / (float)A);
      const float v = v_out[r * v_stride];
      for (int c = 0; c < A; ++c) q[r * A + c] = v + a_out[r * A + c] - mean;
    } else {
      for (int c = 0; c < A; ++c) q[r * A + c] = a_out[r * A + c];
    }
  }
  __syncthreads();
}

// Backward through layers [l0, l0 + nl): dh holds dL/d(output of the last
// layer) on entry; writes the tile's partial dW/db into g (n_params floats).
__device__ void fu_chain_bwd(const NetDesc& d, const float* sp,
                             const float* x, const float* sH, float* dh,
                             float* other, float* g, int l0, int nl,
                             int nrows) {
  for (int l = l0 + nl - 1; l >= l0; --l) {
    const int din = d.din[l], dout = d.dout[l];
    const float* hpost = sH + d.off_h[l] * FU_TILE;
    const float* hprev = (l == l0) ? x : sH + d.off_h[l - 1] * FU_TILE;
    for (int k = threadIdx.x; k < nrows * dout; k += blockDim.x)
      dh[k] *= dq_act_grad(hpost[k], d.act[l]);
    __syncthreads();
    for (int k = threadIdx.x; k < din * dout; k += blockDim.x) {
      const int i = k / dout, o = k % dout;
      float s = 0.0f;
      for (int r = 0; r < nrows; ++r) s += hprev[r * din + i] * dh[r * dout + o];
      g[d.off_w[l] + k] = s;
    }
    for (int o = threadIdx.x; o < dout; o += blockDim.x) {
      float s = 0.0f;
      for (int r = 0; r < nrows; ++r) s += dh[r * dout + o];
      g[d.off_b[l] + o] = s;
    }
    if (l > l0) {
      const float* W = sp + d.off_w[l];
      for (int k = threadIdx.x; k < nrows * din; k += blockDim.x) {
        const int r = k / din, i = k % din;
        float s = 0.0f;
        for (int o = 0; o < dout; ++o) s += dh[r * dout + o] * W[i * dout + o];
        other[k] = s;
      }
    }
    __syncthreads();
    float* tmp = dh;
    dh = other;
    other = tmp;
  }
}

__global__ void __launch_bounds__(FU_THREADS) fu_fwd_bwd_kernel(
    NetDesc d, TensorPtrs params, const float* __restrict__ obs,
    const float* __restrict__ nobs, const int* __restrict__ action,
    const float* __restrict__ reward, const float* __restrict__ done,
    const float* __restrict__ weights, const float* __restrict__ q_sp_tgt,
    int B, int row0, float gamma, float alpha, float eps, int double_q,
    float inv_b, float* __restrict__ td_out, float* __restrict__ prio_out,
    float* __restrict__ part_grad, float* __restrict__ part_loss) {
  extern __shared__ float smem[];
  const int A = d.num_actions, D0 = d.in_dim;
  const int r0 = blockIdx.x * FU_TILE;
  const int nrows = min(FU_TILE, B - r0);
  const int g0 = row0 + r0;  // first global row of the tile in [U*B]

  float* sp = smem;
  float* sX = sp + d.n_params;
  float* sX2 = sX + FU_TILE * D0;
  float* sH = sX2 + FU_TILE * D0;
  float* sT0 = sH + FU_TILE * d.h_per_row;
  float* sT1 = sT0 + FU_TILE * d.maxw;
  float* sQ = sT1 + FU_TILE * d.maxw;
  float* sQ2 = sQ + FU_TILE * A;
  float* sV2 = sQ2 + FU_TILE * A;
  float* sLoss = sV2 + FU_TILE;
  float* sG = sLoss + FU_TILE;

  dq_load_params(d, params, sp);
  for (int k = threadIdx.x; k < nrows * D0; k += blockDim.x) {
    sX[k] = obs[(size_t)g0 * D0 + k];
    if (double_q) sX2[k] = nobs[(size_t)g0 * D0 + k];
  }
  __syncthreads();

  // online forward on s, activations kept for the backward
  const int la = d.n_val + d.n_adv - 1;  // last adv layer
  if (d.dueling) fu_chain_keep(d, sp, sX, sH, 0, d.n_val, nrows);
  fu_chain_keep(d, sp, sX, sH, d.n_val, d.n_adv, nrows);
  fu_combine(d, sH + d.off_h[la] * FU_TILE,
             d.dueling ? sH + d.off_h[d.n_val - 1] * FU_TILE : nullptr, 1,
             sQ, nrows);

  // online forward on s' for the double-Q argmax (no gradient)
  if (double_q) {
    const float* vout = nullptr;
    if (d.dueling) {
      vout = fu_chain_tmp(d, sp, sX2, sT0, sT1, 0, d.n_val, nrows);
      for (int r = threadIdx.x; r < nrows; r += blockDim.x) sV2[r] = vout[r];
      __syncthreads();
    }
    const float* aout =
        fu_chain_tmp(d, sp, sX2, sT0, sT1, d.n_val, d.n_adv, nrows);
    fu_combine(d, aout, sV2, 1, sQ2, nrows);
  }

  // TD error, priority, Huber term and dL/dq_sa per row
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const int gr = g0 + r;
    const float* tgt = q_sp_tgt + (size_t)gr * A;
    float q_sp_max;
    if (double_q) {
      int best = 0;
      float bv = sQ2[r * A];
      for (int c = 1; c < A; ++c)
        if (sQ2[r * A + c] > bv) { bv = sQ2[r * A + c]; best = c; }
      q_sp_max = tgt[best];
    } else {
      q_sp_max = tgt[0];
      for (int c = 1; c < A; ++c) q_sp_max = fmaxf(q_sp_max, tgt[c]);
    }
    const float target = reward[gr] + (1.0f - done[gr]) * gamma * q_sp_max;
    // an action outside [0, A) selects nothing (Q_sa = 0, no gradient), as
    // the one-hot select of the JAX kernel does
    const int a = action[gr];
    const float td = ((a >= 0 && a < A) ? sQ[r * A + a] : 0.0f) - target;
    const float w = weights[gr];
    const float x = w * td;
    const float absx = fabsf(x);
    const float quad = fminf(absx, 1.0f);
    sLoss[r] = 0.5f * quad * quad + (absx - quad);
    sG[r] = w * fminf(fmaxf(x, -1.0f), 1.0f) * inv_b;
    td_out[gr] = td;
    prio_out[gr] = powf(fabsf(td) + eps, alpha);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int r = 0; r < nrows; ++r) s += sLoss[r];
    part_loss[blockIdx.x] = s;
  }

  // backward. dL/dq is g_sa at the taken action; through the dueling
  // combination: g_adv = g_q - (sum_c g_q) / A, g_val = sum_c g_q = g_sa
  float* g = part_grad + (size_t)blockIdx.x * d.n_params;
  for (int k = threadIdx.x; k < nrows * A; k += blockDim.x) {
    const int r = k / A, c = k % A;
    const float gs = sG[r];
    float gq = (c == action[g0 + r]) ? gs : 0.0f;
    if (d.dueling) gq -= gs * (1.0f / (float)A);
    sT0[k] = gq;
  }
  __syncthreads();
  fu_chain_bwd(d, sp, sX, sH, sT0, sT1, g, d.n_val, d.n_adv, nrows);
  if (d.dueling) {
    for (int r = threadIdx.x; r < nrows; r += blockDim.x) sT0[r] = sG[r];
    __syncthreads();
    fu_chain_bwd(d, sp, sX, sH, sT0, sT1, g, 0, d.n_val, nrows);
  }
}

#define FU_ADAM_THREADS 1024

__global__ void __launch_bounds__(FU_ADAM_THREADS) fu_adam_kernel(
    NetDesc d, TensorPtrs p, TensorPtrs m, TensorPtrs v,
    const float* __restrict__ part_grad, const float* __restrict__ part_loss,
    int nblk, const int* __restrict__ count, int u, float lr, float b1,
    float b2, float adam_eps, float inv_b, float* __restrict__ loss_out,
    float* __restrict__ gnorm_out) {
  __shared__ float red[FU_ADAM_THREADS];
  const float t = (float)(count[0] + u + 1);
  const float c1 = 1.0f / (1.0f - powf(b1, t));
  const float c2 = 1.0f / (1.0f - powf(b2, t));
  float gmax = 0.0f;
  const int nl = d.n_val + d.n_adv;
  for (int k2 = 0; k2 < 2 * nl; ++k2) {
    const int l = k2 / 2;
    const int n = (k2 % 2) ? d.dout[l] : d.din[l] * d.dout[l];
    const int off = (k2 % 2) ? d.off_b[l] : d.off_w[l];
    float* pt = p.t[k2];
    float* mt = m.t[k2];
    float* vt = v.t[k2];
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      float g = 0.0f;
      for (int b = 0; b < nblk; ++b) g += part_grad[(size_t)b * d.n_params + off + k];
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
    if (threadIdx.x < s) red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (loss_out != nullptr) {  // null when the loss comes from K7
      float s = 0.0f;
      for (int b = 0; b < nblk; ++b) s += part_loss[b];
      loss_out[0] = s * inv_b;
    }
    gnorm_out[0] = red[0];
  }
}

static void fu_fill(TensorPtrs* t, const int64_t* ptrs, int n) {
  for (int i = 0; i < n; ++i) t->t[i] = (float*)ptrs[i];
}

// Shared-memory bytes of one fu_fwd_bwd_kernel block for this network
// (FusedPlan.smem_bytes in ops/cuda/fused_update.py gates on the same sum).
static int fu_smem_bytes(const NetDesc* d) {
  const int floats = d->n_params + 2 * FU_TILE * d->in_dim +
                     FU_TILE * d->h_per_row + 2 * FU_TILE * d->maxw +
                     2 * FU_TILE * d->num_actions + 3 * FU_TILE;
  return floats * (int)sizeof(float);
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
                           void* stream) {
  const int nt = 2 * (d->n_val + d->n_adv);
  TensorPtrs P, M, V;
  fu_fill(&P, p_ptrs, nt);
  fu_fill(&M, m_ptrs, nt);
  fu_fill(&V, v_ptrs, nt);
  const int smem = fu_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      fu_fwd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (B + FU_TILE - 1) / FU_TILE;
  const float inv_b = 1.0f / (float)B;
  cudaStream_t s = (cudaStream_t)stream;
  for (int u = 0; u < U; ++u) {
    fu_fwd_bwd_kernel<<<nblk, FU_THREADS, smem, s>>>(
        *d, P, (const float*)obs, (const float*)nobs, (const int*)action,
        (const float*)reward, (const float*)done, (const float*)weights,
        (const float*)q_sp_tgt, B, u * B, gamma, alpha, eps, double_q, inv_b,
        (float*)td, (float*)prio, (float*)part_grad, (float*)part_loss);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    fu_adam_kernel<<<1, FU_ADAM_THREADS, 0, s>>>(
        *d, P, M, V, (const float*)part_grad, (const float*)part_loss, nblk,
        (const int*)count, u, lr, b1, b2, adam_eps, inv_b, (float*)loss,
        (float*)gnorm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// K7: one sub-update's forward, TD loss and backward, emitting gradients
// (replaces fused_grads of deepqlearning_tpu/ops/pallas/fused_update.py).
// The data-parallel train step all-reduces the flat gradient between K7 and
// the Adam launch, which is why the two cannot be one kernel as in K3.
//
// Two launches on the caller's stream, no host sync: launch (a) of K3 above
// (fu_fwd_bwd_kernel, per-block partial gradients [n_blocks, n_params]),
// then dq_grad_reduce_kernel: one thread per parameter sums the n_blocks
// partials in block order into one contiguous flat gradient [n_params] in
// the packed order w0, b0, w1, b1, ... (the plan's names), block 0 sums the
// Huber partials into the loss, and every block's max-abs entry meets in one
// atomicMax on the float's bits (a max does not depend on the order). The
// flat buffer is the vector the all-reduce takes, so nothing is
// concatenated or split. At B = 512 and the headline net (9029 parameters,
// 32 partials) both launches are bound by launch and synchronisation
// latency, not by bytes: the reduce reads 1.2 MB.

#define DQ_RED_THREADS 256

__global__ void __launch_bounds__(DQ_RED_THREADS) dq_grad_reduce_kernel(
    const float* __restrict__ part_grad, const float* __restrict__ part_loss,
    int nblk, int n, float inv, float* __restrict__ flat,
    float* __restrict__ loss, unsigned int* __restrict__ gmax_bits) {
  __shared__ float red[DQ_RED_THREADS];
  const int k = blockIdx.x * DQ_RED_THREADS + threadIdx.x;
  float a = 0.0f;
  if (k < n) {
    float g = 0.0f;
    for (int b = 0; b < nblk; ++b) g += part_grad[(size_t)b * n + k];
    flat[k] = g;
    a = fabsf(g);
  }
  red[threadIdx.x] = a;
  __syncthreads();
  for (int s = DQ_RED_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  // the bits of non-negative floats order as unsigned ints
  if (threadIdx.x == 0) atomicMax(gmax_bits, __float_as_uint(red[0]));
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float s = 0.0f;
    for (int b = 0; b < nblk; ++b) s += part_loss[b];
    loss[0] = s * inv;
  }
}

cudaError_t dq_launch_grad_reduce(const void* part_grad, const void* part_loss,
                                  int nblk, int n, float inv, void* flat,
                                  void* loss, void* gnorm, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(gnorm, 0, sizeof(float), s);
  if (err != cudaSuccess) return err;
  const int grid = (n + DQ_RED_THREADS - 1) / DQ_RED_THREADS;
  dq_grad_reduce_kernel<<<grid, DQ_RED_THREADS, 0, s>>>(
      (const float*)part_grad, (const float*)part_loss, nblk, n, inv,
      (float*)flat, (float*)loss, (unsigned int*)gnorm);
  return cudaGetLastError();
}

DQ_API int dq_fused_grads(const NetDesc* d, const int64_t* p_ptrs, int B,
                          const void* obs, const void* nobs,
                          const void* action, const void* reward,
                          const void* done, const void* weights,
                          const void* q_sp_tgt, float gamma, float alpha,
                          float eps, int double_q, void* td, void* prio,
                          void* part_grad, void* part_loss, void* flat,
                          void* loss, void* gnorm, void* stream) {
  TensorPtrs P;
  fu_fill(&P, p_ptrs, 2 * (d->n_val + d->n_adv));
  const int smem = fu_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      fu_fwd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (B + FU_TILE - 1) / FU_TILE;
  const float inv_b = 1.0f / (float)B;
  cudaStream_t s = (cudaStream_t)stream;
  fu_fwd_bwd_kernel<<<nblk, FU_THREADS, smem, s>>>(
      *d, P, (const float*)obs, (const float*)nobs, (const int*)action,
      (const float*)reward, (const float*)done, (const float*)weights,
      (const float*)q_sp_tgt, B, 0, gamma, alpha, eps, double_q, inv_b,
      (float*)td, (float*)prio, (float*)part_grad, (float*)part_loss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)dq_launch_grad_reduce(part_grad, part_loss, nblk, d->n_params,
                                    inv_b, flat, loss, gnorm, s);
}

// Adam on a flat gradient (the data-parallel step, after the all-reduce):
// fu_adam_kernel above with the averaged gradient as its only "partial".
// One block suffices: it reads 9029 floats once at the headline net, and a
// multi-block Adam would need the same launch; gnorm is the averaged
// gradient's max-abs entry, as the JAX data-parallel step logs it.
DQ_API int dq_fused_adam(const NetDesc* d, const int64_t* p_ptrs,
                         const int64_t* m_ptrs, const int64_t* v_ptrs,
                         const void* count, int u, const void* grad,
                         float lr, float b1, float b2, float adam_eps,
                         void* gnorm, void* stream) {
  const int nt = 2 * (d->n_val + d->n_adv);
  TensorPtrs P, M, V;
  fu_fill(&P, p_ptrs, nt);
  fu_fill(&M, m_ptrs, nt);
  fu_fill(&V, v_ptrs, nt);
  fu_adam_kernel<<<1, FU_ADAM_THREADS, 0, (cudaStream_t)stream>>>(
      *d, P, M, V, (const float*)grad, nullptr, 1, (const int*)count, u, lr,
      b1, b2, adam_eps, 1.0f, nullptr, (float*)gnorm);
  return (int)cudaGetLastError();
}
