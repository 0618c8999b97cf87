// K2: stratified proportional draw over the 64-ary sum tree (replaces
// _sample_impl and _windowed_impl of
// deepqlearning_tpu/ops/pallas/tree_sample.py).
//
// One thread per draw walks the levels from the root to the leaves. At each
// node it runs a sequential prefix sum over the node's (<= 64) children,
// takes j = #{k : mass >= csum_k} clamped to bf - 1, and subtracts the mass
// before child j -- the selection rule of sumtree.descend. The levels stay
// in device memory and are read with plain loads: a draw touches at most
// 64 floats per level, which the L2 cache serves, so the kernel is bound by
// the latency of its dependent per-level loads. The TPU's window, boundary
// pass and fallback existed because its leaf level outgrew VMEM; here the
// whole tree is addressable, so they have no counterpart.
#include "common.cuh"

#define TS_MAXL 8

struct TreeLevels {
  const float* lv[TS_MAXL];  // leaves first
  int size[TS_MAXL];
  int n;
};

__global__ void tree_sample_kernel(TreeLevels t,
                                   const float* __restrict__ mass_in, int D,
                                   int* __restrict__ idx_out,
                                   float* __restrict__ prio_out) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float mass = mass_in[d];
  int idx = 0;
  float prio = 0.0f;
  for (int li = t.n - 2; li >= 0; --li) {
    const int bf = t.size[li] / t.size[li + 1];
    const float* ch = t.lv[li] + (size_t)idx * bf;
    float c = 0.0f;
    int cnt = 0;
    for (int k = 0; k < bf; ++k) {
      c += ch[k];
      cnt += (mass >= c) ? 1 : 0;
    }
    const int j = cnt < bf - 1 ? cnt : bf - 1;
    float prev = 0.0f;
    for (int k = 0; k < j; ++k) prev += ch[k];
    mass -= prev;
    idx = idx * bf + j;
    prio = ch[j];
  }
  idx_out[d] = idx;
  prio_out[d] = prio;
}

DQ_API int dq_tree_sample(int n_levels, const int64_t* level_ptrs,
                          const int* level_sizes, const void* mass, int D,
                          void* idx, void* prio, void* stream) {
  if (n_levels < 2 || n_levels > TS_MAXL) return (int)cudaErrorInvalidValue;
  TreeLevels t;
  t.n = n_levels;
  for (int i = 0; i < n_levels; ++i) {
    t.lv[i] = (const float*)level_ptrs[i];
    t.size[i] = level_sizes[i];
  }
  const int threads = 256;
  const int blocks = (D + threads - 1) / threads;
  if (blocks > 0)
    tree_sample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        t, (const float*)mass, D, (int*)idx, (float*)prio);
  return (int)cudaGetLastError();
}
