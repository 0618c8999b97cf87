// Shared declarations of the port's hand-written Hopper kernels.
//
// Every kernel is exported through a plain C function that launches it on
// the caller's stream and returns cudaGetLastError(), so that the Python
// wrapper (ctypes) can raise on a refused launch. Nothing here allocates or
// synchronises: the wrappers allocate outputs and scratch with torch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DQ_API extern "C" __attribute__((visibility("default")))

// Most Dense layers a network may have over both dueling heads.
#define DQ_MAXL 16

// A (dueling) Dense stack, in plan order: value-head layers first
// (n_val of them, 0 for a plain chain), then the advantage head / chain.
// Layer l has weight w [din, dout] and bias b [dout]; off_w/off_b place
// them in one packed parameter index space of n_params floats (also the
// layout of the shared-memory copy), off_h places the layer's output for a
// tile of rows in the fused update's activation buffer.
struct NetDesc {
  int dueling;
  int n_val;
  int n_adv;
  int in_dim;
  int num_actions;
  int n_params;
  int maxw;        // max(in_dim, every dout)
  int h_per_row;   // sum of every dout
  int din[DQ_MAXL];
  int dout[DQ_MAXL];
  int act[DQ_MAXL];  // 0 identity, 1 tanh, 2 relu
  int off_w[DQ_MAXL];
  int off_b[DQ_MAXL];
  int off_h[DQ_MAXL];  // per-row offset of layer l's output
};

// Device pointers of the 2 * (n_val + n_adv) tensors w0, b0, w1, b1, ...
struct TensorPtrs {
  float* t[2 * DQ_MAXL];
};

__device__ __forceinline__ float dq_act(float z, int act) {
  if (act == 1) return tanhf(z);
  if (act == 2) return fmaxf(z, 0.0f);
  return z;
}

// d act / d z expressed through the post-activation value h
__device__ __forceinline__ float dq_act_grad(float h, int act) {
  if (act == 1) return 1.0f - h * h;
  if (act == 2) return h > 0.0f ? 1.0f : 0.0f;
  return 1.0f;
}

// Copy the packed parameters into shared memory (all threads of the block).
__device__ __forceinline__ void dq_load_params(const NetDesc& d,
                                               const TensorPtrs& p,
                                               float* sp) {
  const int nl = d.n_val + d.n_adv;
  for (int l = 0; l < nl; ++l) {
    const int nw = d.din[l] * d.dout[l];
    for (int k = threadIdx.x; k < nw; k += blockDim.x)
      sp[d.off_w[l] + k] = p.t[2 * l][k];
    for (int k = threadIdx.x; k < d.dout[l]; k += blockDim.x)
      sp[d.off_b[l] + k] = p.t[2 * l + 1][k];
  }
}

// ---------------------------------------------------------------------------
// What the cooperative train-phase kernels K3 (fused_update.cu) and K5
// (fused_drqn.cu) share: their dot products, the padded shared copy of the
// params, and phase B (the tile-order gradient sum and Adam).

#define DQ_MAXT 35  // most parameter tensors of a network (K5: 2 * 16 + 3)

// Every parameter tensor of a network in its packed order: tensor i holds
// packed parameters [start[i], start[i + 1]) (start[nt] = n_params); in the
// padded shared copy it starts at dst[i], its rows (of cols floats) at a
// stride ld[i] (odd), or flat when ld[i] is 0 (a bias). p, m and v are its
// device pointers (m and v unused without Adam). Built on the host; a block
// copies it to static shared memory, so that a lookup by packed index reads
// shared memory, not the kernel argument at a per-thread index.
struct DqTab {
  int start[DQ_MAXT + 1];
  int dst[DQ_MAXT];
  int ld[DQ_MAXT];
  int cols[DQ_MAXT];
  float* p[DQ_MAXT];
  float* m[DQ_MAXT];
  float* v[DQ_MAXT];
};

// Copy a table (a kernel argument) into shared memory, a word per thread;
// the caller synchronises.
__device__ __forceinline__ void dq_tab_copy(const DqTab& src, DqTab& dst) {
  const int* s = reinterpret_cast<const int*>(&src);
  int* d = reinterpret_cast<int*>(&dst);
  for (int i = threadIdx.x; i < (int)(sizeof(DqTab) / 4); i += blockDim.x)
    d[i] = s[i];
}

// The tensor holding packed parameter k (k < n_params).
__device__ __forceinline__ int dq_tab_find(const DqTab& t, int k) {
  int i = 0;
  while (k >= t.start[i + 1]) ++i;
  return i;
}

// Offset in the padded shared copy of element j of tensor i.
__device__ __forceinline__ int dq_tab_dst(const DqTab& t, int i, int j) {
  if (t.ld[i] == 0) return t.dst[i] + j;
  const int r = j / t.cols[i];
  return t.dst[i] + r * t.ld[i] + j - r * t.cols[i];
}

#define DQ_DOT 8  // shared-memory operand pairs a dot product loads at once

// sum_i x[i] * y[i * ys] over n terms, one accumulator in ascending i; the
// loads of DQ_DOT terms are issued before their FMAs, so a chain waits on
// shared memory once per DQ_DOT terms rather than once per term.
__device__ __forceinline__ float dq_dot(const float* __restrict__ x,
                                        const float* __restrict__ y, int ys,
                                        int n) {
  float z = 0.0f;
  int i = 0;
  for (; i + DQ_DOT <= n; i += DQ_DOT) {
    float xs[DQ_DOT], ws[DQ_DOT];
#pragma unroll
    for (int j = 0; j < DQ_DOT; ++j) {
      xs[j] = x[i + j];
      ws[j] = y[(i + j) * ys];
    }
#pragma unroll
    for (int j = 0; j < DQ_DOT; ++j) z = fmaf(xs[j], ws[j], z);
  }
  for (; i < n; ++i) z = fmaf(x[i], y[i * ys], z);
  return z;
}

#define DQ_BATCH 8       // loads a thread keeps in flight in a copy
#define DQ_SUM_BATCH 32  // and in phase B's tile sum

// Copy the params phase B left in the padded shared layout (stage, n
// floats) into shared memory: a flat copy, DQ_BATCH float4 L2 reads in
// flight per thread.
__device__ __forceinline__ void dq_copy_stage(const float* stage, float* sp,
                                              int n) {
  const float4* src = reinterpret_cast<const float4*>(stage);
  float4* dst = reinterpret_cast<float4*>(sp);
  const int n4 = n / 4;
  for (int k0 = threadIdx.x; k0 < n4; k0 += DQ_BATCH * blockDim.x) {
    float4 x[DQ_BATCH];
#pragma unroll
    for (int j = 0; j < DQ_BATCH; ++j) {
      const int k = k0 + j * blockDim.x;
      if (k < n4) x[j] = __ldcg(src + k);
    }
#pragma unroll
    for (int j = 0; j < DQ_BATCH; ++j) {
      const int k = k0 + j * blockDim.x;
      if (k < n4) dst[k] = x[j];
    }
  }
  for (int k = 4 * n4 + threadIdx.x; k < n; k += blockDim.x)
    sp[k] = __ldcg(stage + k);
  __syncthreads();
}

// Copy the current params (n packed floats) into the padded shared layout.
// They are L2 reads (other blocks of this launch wrote them), issued
// DQ_BATCH at a time per thread over the packed index space, so a block
// waits for a few L2 round trips rather than one per tensor and element.
__device__ __forceinline__ void dq_load_padded(const DqTab& tab, int n,
                                               float* sp) {
  int t = 0;  // a thread's k only grows: its tensor index only moves on
  for (int k0 = threadIdx.x; k0 < n; k0 += DQ_BATCH * blockDim.x) {
    float x[DQ_BATCH];
    int ti[DQ_BATCH];
#pragma unroll
    for (int j = 0; j < DQ_BATCH; ++j) {
      const int k = k0 + j * blockDim.x;
      if (k < n)
        while (k >= tab.start[t + 1]) ++t;
      ti[j] = t;
      x[j] = (k < n) ? __ldcg(tab.p[t] + (k - tab.start[t])) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < DQ_BATCH; ++j) {
      const int k = k0 + j * blockDim.x;
      if (k < n) sp[dq_tab_dst(tab, ti[j], k - tab.start[ti[j]])] = x[j];
    }
  }
  __syncthreads();
}

// 1 / (1 - beta^t), Adam's bias correction
__device__ __forceinline__ float dq_bias_corr(float beta, float t) {
  return __fdiv_rn(1.0f, __fsub_rn(1.0f, powf(beta, t)));
}

// One parameter's Adam step in registers, rounded explicitly so that phase
// B and the data-parallel Adam launch give the same bits.
__device__ __forceinline__ void dq_adam(float& p, float& m, float& v, float g,
                                        float lr, float b1, float b2,
                                        float adam_eps, float c1, float c2) {
  m = __fmaf_rn(b1, m, __fmul_rn(1.0f - b1, g));
  v = __fmaf_rn(b2, v, __fmul_rn(1.0f - b2, __fmul_rn(g, g)));
  const float step = __fdiv_rn(__fmul_rn(lr, __fmul_rn(m, c1)),
                               __fadd_rn(__fsqrt_rn(__fmul_rn(v, c2)), adam_eps));
  p = __fsub_rn(p, step);
}

// Block max of x (all threads; red holds blockDim.x floats), then one
// atomicMax on the float bits of *slot: the bits of non-negative floats
// order as unsigned ints.
__device__ __forceinline__ void dq_block_max(float x, float* red, float* slot) {
  red[threadIdx.x] = x;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) atomicMax((unsigned int*)slot, __float_as_uint(red[0]));
}

// What phase B of sub-update u (of U) reads and writes.
struct DqPhaseB {
  const float* part_grad;  // [ntiles, n] tile partials
  const float* part_loss;  // [ntiles] tile Huber sums
  const int* count;        // Adam's step count before the call
  int n, ntiles, U;
  float lr, b1, b2, adam_eps;
  float loss_scale;  // the loss is the tile-order Huber sum times this
  float* loss;
  float* gnorm;  // zeroed by the kernel before its first grid barrier
  float* flat;   // set: write the summed gradient here, no Adam (K7, K8)
  float* stage;  // the updated params in the padded shared layout
};

// Phase B of sub-update u over the whole grid: one thread per parameter
// sums the tile partials in tile order and applies Adam at t = count + u +
// 1 to params, m and v in place, staging the new params in the padded
// layout for the next copy-in (or, with flat, writes the sum). On the last
// u the max-abs entry meets in an atomicMax on the float's bits and block 0
// writes the loss. red: blockDim.x floats of shared memory.
__device__ __forceinline__ void dq_reduce_adam(const DqPhaseB& b,
                                               const DqTab& tab, int u,
                                               float* red) {
  const int n = b.n, ntiles = b.ntiles;
  float c1 = 0.0f, c2 = 0.0f;
  if (b.flat == nullptr) {
    const float t = (float)(b.count[0] + u + 1);
    c1 = dq_bias_corr(b.b1, t);
    c2 = dq_bias_corr(b.b2, t);
  }
  float gmax = 0.0f;
  // warp w of the grid (interleaved over the blocks, so that every SM
  // takes a share of the loads) owns parameters [32w, 32w + 32)
  const int w0 = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  for (int k = w0 * 32 + (threadIdx.x & 31); k < n;
       k += gridDim.x * blockDim.x) {
    // p, m, v in flight while the partials arrive
    float *pp = nullptr, *mp = nullptr, *vp = nullptr, p = 0.0f, m = 0.0f,
          v = 0.0f;
    int ti = 0, j = 0;
    if (b.flat == nullptr) {
      ti = dq_tab_find(tab, k);
      j = k - tab.start[ti];
      pp = tab.p[ti] + j;
      mp = tab.m[ti] + j;
      vp = tab.v[ti] + j;
      p = __ldcg(pp);
      m = __ldcg(mp);
      v = __ldcg(vp);
    }
    // the tile partials in tile order, DQ_SUM_BATCH loads in flight
    float g = 0.0f;
    for (int s0 = 0; s0 < ntiles; s0 += DQ_SUM_BATCH) {
      float x[DQ_SUM_BATCH];
#pragma unroll
      for (int i = 0; i < DQ_SUM_BATCH; ++i)
        x[i] = (s0 + i < ntiles)
                   ? __ldcg(b.part_grad + (size_t)(s0 + i) * n + k) : 0.0f;
#pragma unroll
      for (int i = 0; i < DQ_SUM_BATCH; ++i)
        if (s0 + i < ntiles) g += x[i];
    }
    gmax = fmaxf(gmax, fabsf(g));
    if (b.flat != nullptr) {
      b.flat[k] = g;
    } else {
      dq_adam(p, m, v, g, b.lr, b.b1, b.b2, b.adam_eps, c1, c2);
      *pp = p;
      *mp = m;
      *vp = v;
      b.stage[dq_tab_dst(tab, ti, j)] = p;
    }
  }
  if (u != b.U - 1) return;  // uniform over the grid
  dq_block_max(gmax, red, b.gnorm);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float s = 0.0f;
    for (int k = 0; k < ntiles; ++k) s += __ldcg(b.part_loss + k);
    b.loss[0] = s * b.loss_scale;
  }
}

// Adam at t = count + u + 1 from a flat gradient [n] (the data-parallel
// steps, after the all-reduce), one thread per parameter with phase B's
// arithmetic, and the gradient's max-abs entry into gnorm; launched on
// stream s. Defined in fused_update.cu; K7's and K8's routes end with it.
cudaError_t dq_launch_adam_flat(const DqTab& tab, int n, const void* count,
                                int u, const void* grad, float lr, float b1,
                                float b2, float adam_eps, void* gnorm,
                                cudaStream_t s);
