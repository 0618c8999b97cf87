// K1: fused TD loss, priorities and dL/dq_s (replaces td_loss_fused of
// deepqlearning_tpu/ops/pallas/td_kernel.py).
//
// One block over all B rows, one thread per row with a loop over the A
// actions; the rows' Huber terms are reduced in shared memory in a fixed
// tree order, so the loss is deterministic. At the shapes of the loop
// (B ~ 32..4096, A ~ 4) the kernel moves a few tens of KB and is bound by
// launch latency, not by bytes or arithmetic.
#include "common.cuh"

__global__ void td_loss_kernel(const float* __restrict__ q_s,
                               const float* __restrict__ q_sp_onl,
                               const float* __restrict__ q_sp_tgt,
                               const int* __restrict__ action,
                               const float* __restrict__ reward,
                               const float* __restrict__ done,
                               const float* __restrict__ weights, int B,
                               int A, float gamma, float alpha, float eps,
                               int double_q, float inv_b,
                               float* __restrict__ loss,
                               float* __restrict__ td_out,
                               float* __restrict__ prio_out,
                               float* __restrict__ grad) {
  extern __shared__ float red[];
  float acc = 0.0f;
  for (int r = threadIdx.x; r < B; r += blockDim.x) {
    const float* tgt = q_sp_tgt + (size_t)r * A;
    float q_sp_max;
    if (double_q) {
      // first-max argmax of the online Q(s'), then the target's value there
      const float* onl = q_sp_onl + (size_t)r * A;
      int best = 0;
      float bv = onl[0];
      for (int c = 1; c < A; ++c)
        if (onl[c] > bv) { bv = onl[c]; best = c; }
      q_sp_max = tgt[best];
    } else {
      q_sp_max = tgt[0];
      for (int c = 1; c < A; ++c) q_sp_max = fmaxf(q_sp_max, tgt[c]);
    }
    const float target = reward[r] + (1.0f - done[r]) * gamma * q_sp_max;
    const int a = action[r];
    const float q_sa = (a >= 0 && a < A) ? q_s[(size_t)r * A + a] : 0.0f;
    const float td = q_sa - target;
    const float w = weights[r];
    const float x = w * td;
    const float absx = fabsf(x);
    const float quad = fminf(absx, 1.0f);
    acc += 0.5f * quad * quad + (absx - quad);
    td_out[r] = td;
    prio_out[r] = powf(fabsf(td) + eps, alpha);
    // d huber(w*td) / d q_sa = w * clip(w*td, -1, 1), loss scaled by 1/B
    const float g = w * fminf(fmaxf(x, -1.0f), 1.0f) * inv_b;
    for (int c = 0; c < A; ++c) grad[(size_t)r * A + c] = (c == a) ? g : 0.0f;
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) loss[0] = red[0] * inv_b;
}

// K1's block: the power of two >= B, from 32 to 1024 threads.
static int k1_threads(int B) {
  int threads = 32;
  while (threads < B && threads < 1024) threads *= 2;
  return threads;
}

DQ_API int dq_td_loss(const void* q_s, const void* q_sp_onl,
                      const void* q_sp_tgt, const void* action,
                      const void* reward, const void* done,
                      const void* weights, int B, int A, float gamma,
                      float alpha, float eps, int double_q, void* loss,
                      void* td, void* prio, void* grad, void* stream) {
  int threads = k1_threads(B);
  td_loss_kernel<<<1, threads, threads * sizeof(float),
                   (cudaStream_t)stream>>>(
      (const float*)q_s, (const float*)q_sp_onl, (const float*)q_sp_tgt,
      (const int*)action, (const float*)reward, (const float*)done,
      (const float*)weights, B, A, gamma, alpha, eps, double_q,
      1.0f / (float)B, (float*)loss, (float*)td, (float*)prio,
      (float*)grad);
  return (int)cudaGetLastError();
}

// An empty one-block kernel: the floor under any one-block launch such as
// K1's, timed by its device events (ops/cuda/kernel_events.py). It takes
// K1's block for B rows and its dynamic shared memory.
__global__ void empty_kernel() {}

DQ_API int dq_empty(int B, void* stream) {
  int threads = k1_threads(B);
  empty_kernel<<<1, threads, threads * sizeof(float),
                 (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

DQ_API const char* dq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
