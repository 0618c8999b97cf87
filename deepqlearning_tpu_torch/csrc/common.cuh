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

// Fixed-order sum of nblk per-block partial gradients [nblk, n] into one
// flat gradient [n], the loss (the nblk partial losses summed, times inv)
// and the max-abs entry; launched on stream s after zeroing gnorm. Defined
// in fused_update.cu; kernels K7 and K8 end with it.
cudaError_t dq_launch_grad_reduce(const void* part_grad, const void* part_loss,
                                  int nblk, int n, float inv, void* flat,
                                  void* loss, void* gnorm, cudaStream_t s);
