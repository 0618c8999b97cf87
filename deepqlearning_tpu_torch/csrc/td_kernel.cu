// K1: fused TD loss, priorities and dL/dq_s (replaces td_loss_fused of
// deepqlearning_tpu/ops/pallas/td_kernel.py).
//
// At the shapes of the loop (B ~ 32..4096, A ~ 4) the kernel moves a few
// tens of KB and does ~100 instructions a row: no bound of bytes or
// arithmetic is near, and the time is the launch plus one thread's chain
// (its loads' latency, then its row's instructions) plus, in one block,
// the bytes through one SM's port to L2 and the issue of all its warps.
// The design shortens that chain and spreads the rest:
// - a row per thread, and a loop over chunks of the block's threads past
//   that; every load of a row is issued before any result is needed, and
//   the code from a row's loads to its stores is straight-line: double-Q,
//   A = 4 and the action's width are template parameters, the argmax and
//   the selects are predicated, and the priority is exp2(α·log2(|td| + ε));
// - at A = 4 with the matrices 16-byte aligned (every main path), a row is
//   read and its gradient written as one float4 per matrix; any other A or
//   layout takes one float at a time;
// - the action is read at its own width (int32 or int64) and the four row
//   vectors at their element strides, so the wrapper neither casts nor
//   copies them;
// - up to K1_BLOCK_ROWS rows, one block; past that the rows are cut into
//   spans over a cluster of up to K1_MAX_CLUSTER blocks, one SM each (a
//   Hopper thread block cluster, one launch): one block moves B = 4096's
//   ~330 KB through one SM's port to L2, while at B = 512 the cluster's
//   launch and barrier cost more than one SM's bytes and issue;
// - the Huber terms are summed by each thread over its rows in order, by a
//   5-step __shfl_down_sync within each warp, and after ONE __syncthreads
//   by warp 0 over the warp partials in warp order; in a cluster each
//   block then writes its partial into block 0's shared memory (DSMEM) and
//   after one cluster barrier block 0 sums them in block order. The order
//   depends only on B, so the loss is the same bit for bit on every run.
// Semantics: first-max argmax of the online Q(s') for double-Q, else the
// target's max; an action outside [0, A) selects nothing (Q(s, a) = 0, no
// gradient).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define K1_MAX_THREADS 512
#define K1_MAX_CLUSTER 8  // the portable cluster size
#define K1_BLOCK_ROWS 512

// W Q values of one row: a float4 (W = 4) or one float (W = 1).
template <int W>
struct QChunk {
  float v[W];
};

template <int W>
__device__ __forceinline__ QChunk<W> k1_load(const float* p);

template <>
__device__ __forceinline__ QChunk<4> k1_load<4>(const float* p) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  return {{t.x, t.y, t.z, t.w}};
}

template <>
__device__ __forceinline__ QChunk<1> k1_load<1>(const float* p) {
  return {{__ldg(p)}};
}

template <int W>
__device__ __forceinline__ void k1_store(float* p, const QChunk<W>& c);

template <>
__device__ __forceinline__ void k1_store<4>(float* p, const QChunk<4>& c) {
  *reinterpret_cast<float4*>(p) = make_float4(c.v[0], c.v[1], c.v[2], c.v[3]);
}

template <>
__device__ __forceinline__ void k1_store<1>(float* p, const QChunk<1>& c) {
  *p = c.v[0];
}

__device__ __forceinline__ float k1_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// (|td| + eps)^alpha for |td| + eps > 0: log2f and exp2f to an ulp or two
// each, without powf's branches for negative, zero and infinite bases.
__device__ __forceinline__ float k1_prio(float x, float alpha) {
  return exp2f(alpha * log2f(x));
}

// K1's arguments, passed by value (__grid_constant__).
struct K1Args {
  const float* q_s;
  const float* q_sp_onl;
  const float* q_sp_tgt;
  const void* action;  // int32 or int64, by the kernel's I
  const float* reward;
  const float* done;
  const float* weights;
  long long s_act, s_rew, s_done, s_w;  // element strides
  int B, A;
  int span;  // rows per block
  float gamma, alpha, eps, inv_b;
  float* loss;
  float* td;
  float* prio;
  float* grad;
};

// V4: A = 4 read as one float4 per matrix (else a.A floats one at a
// time), I the action's type, DQ double-Q. Block b takes rows
// [b * span, min(B, (b + 1) * span)), a row per thread and chunk.
template <bool V4, typename I, bool DQ>
__global__ void __launch_bounds__(K1_MAX_THREADS)
    td_loss_kernel(const __grid_constant__ K1Args a) {
  constexpr int W = V4 ? 4 : 1;
  __shared__ float part[32];
  __shared__ float block_part[K1_MAX_CLUSTER];
  const int n_blocks = gridDim.x;
  // in a cluster: this block has started (block 0's shared memory is
  // written only after every block's arrival, below)
  if (n_blocks > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;");
  const int nt = blockDim.x, tid = threadIdx.x;
  const int first = blockIdx.x * a.span, end = min(a.B, first + a.span);
  const int A = V4 ? 4 : a.A;
  const I* __restrict__ action = (const I*)a.action;
  float acc = 0.0f;
  for (int row = first + tid; row < end; row += nt) {
    const I act = __ldg(action + row * a.s_act);
    const float rew = __ldg(a.reward + row * a.s_rew);
    const float dn = __ldg(a.done + row * a.s_done);
    const float w = __ldg(a.weights + row * a.s_w);
    float best = 0.0f, q_next = 0.0f, q_sa = 0.0f;
#pragma unroll
    for (int c = 0; c < A; c += W) {
      const size_t off = (size_t)row * A + c;
      const QChunk<W> qs = k1_load<W>(a.q_s + off);
      const QChunk<W> tg = k1_load<W>(a.q_sp_tgt + off);
      const QChunk<W> on = DQ ? k1_load<W>(a.q_sp_onl + off) : tg;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int col = c + j;
        if (DQ) {
          // strictly greater: the first max of the online Q(s')
          const bool take = col == 0 || on.v[j] > best;
          best = take ? on.v[j] : best;
          q_next = take ? tg.v[j] : q_next;
        } else {
          q_next = col == 0 ? tg.v[j] : fmaxf(q_next, tg.v[j]);
        }
        q_sa = col == act ? qs.v[j] : q_sa;
      }
    }
    const float target = rew + (1.0f - dn) * a.gamma * q_next;
    const float td = q_sa - target;
    const float x = w * td;
    const float absx = fabsf(x);
    const float quad = fminf(absx, 1.0f);
    acc += 0.5f * quad * quad + (absx - quad);
    a.td[row] = td;
    a.prio[row] = k1_prio(fabsf(td) + a.eps, a.alpha);
    // d huber(w*td) / d q_sa = w * clip(w*td, -1, 1), loss scaled by 1/B
    const float g = w * fminf(fmaxf(x, -1.0f), 1.0f) * a.inv_b;
#pragma unroll
    for (int c = 0; c < A; c += W) {
      QChunk<W> gv;
#pragma unroll
      for (int j = 0; j < W; ++j) gv.v[j] = (c + j == act) ? g : 0.0f;
      k1_store<W>(a.grad + (size_t)row * A + c, gv);
    }
  }
  // the block's partial, in thread 0
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  acc = k1_warp_sum(acc);
  if (n_warps > 1) {
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (warp == 0) acc = k1_warp_sum(lane < n_warps ? part[lane] : 0.0f);
  }
  if (n_blocks == 1) {
    if (tid == 0) a.loss[0] = acc * a.inv_b;
    return;
  }
  // the cluster's: every block has started, so block 0's shared memory is
  // there to be written; after the barrier block 0 sums in block order
  asm volatile("barrier.cluster.wait.aligned;");
  cg::cluster_group cluster = cg::this_cluster();
  if (tid == 0) *cluster.map_shared_rank(&block_part[blockIdx.x], 0) = acc;
  cluster.sync();
  if (blockIdx.x == 0 && tid == 0) {
    float s = 0.0f;
    for (int b = 0; b < n_blocks; ++b) s += block_part[b];
    a.loss[0] = s * a.inv_b;
  }
}

// How K1 cuts B rows: a block per K1_BLOCK_ROWS rows up to K1_MAX_CLUSTER
// blocks (one cluster), and a thread per row of a block's span up to
// K1_MAX_THREADS.
struct K1Shape {
  int blocks, threads, span;
};

static K1Shape k1_shape(int B) {
  int blocks = (B + K1_BLOCK_ROWS - 1) / K1_BLOCK_ROWS;
  blocks = blocks > K1_MAX_CLUSTER ? K1_MAX_CLUSTER : blocks;
  const int span = (B + blocks - 1) / blocks;
  int threads = (span + 31) / 32 * 32;
  threads = threads > K1_MAX_THREADS ? K1_MAX_THREADS : threads;
  return {blocks, threads, span};
}

// Launch ``kernel`` on ``shape``: one cluster of all its blocks.
template <typename... Args>
static cudaError_t k1_launch(void (*kernel)(Args...), K1Shape shape,
                             cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(shape.blocks);
  cfg.blockDim = dim3(shape.threads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = shape.blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = shape.blocks > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <bool V4>
static cudaError_t k1_launch_as(int action_bytes, bool double_q,
                                K1Shape shape, cudaStream_t st,
                                const K1Args& a) {
  if (action_bytes == 8 && double_q)
    return k1_launch(td_loss_kernel<V4, long long, true>, shape, st, a);
  if (action_bytes == 8)
    return k1_launch(td_loss_kernel<V4, long long, false>, shape, st, a);
  if (double_q) return k1_launch(td_loss_kernel<V4, int, true>, shape, st, a);
  return k1_launch(td_loss_kernel<V4, int, false>, shape, st, a);
}

static bool k1_aligned(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// One launch of K1 on ``stream``. ``action`` holds int32 (action_bytes 4)
// or int64 (8) values; the four row vectors are read at their element
// strides.
DQ_API int dq_td_loss(const void* q_s, const void* q_sp_onl,
                      const void* q_sp_tgt, const void* action,
                      int action_bytes, long long s_act, const void* reward,
                      long long s_rew, const void* done, long long s_done,
                      const void* weights, long long s_w, int B, int A,
                      float gamma, float alpha, float eps, int double_q,
                      void* loss, void* td, void* prio, void* grad,
                      void* stream) {
  if (B < 1 || A < 1 || (action_bytes != 4 && action_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const K1Shape shape = k1_shape(B);
  const K1Args a = {(const float*)q_s, (const float*)q_sp_onl,
                    (const float*)q_sp_tgt, action, (const float*)reward,
                    (const float*)done, (const float*)weights, s_act, s_rew,
                    s_done, s_w, B, A, shape.span, gamma, alpha, eps,
                    1.0f / (float)B, (float*)loss, (float*)td, (float*)prio,
                    (float*)grad};
  const cudaStream_t st = (cudaStream_t)stream;
  const bool dq = double_q != 0;
  const bool v4 = A == 4 && k1_aligned(q_s) && k1_aligned(q_sp_onl) &&
                  k1_aligned(q_sp_tgt) && k1_aligned(grad);
  const cudaError_t err =
      v4 ? k1_launch_as<true>(action_bytes, dq, shape, st, a)
         : k1_launch_as<false>(action_bytes, dq, shape, st, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// An empty kernel launched as K1 is for B rows (its cluster of blocks and
// its threads): the floor under K1, timed by its device events
// (ops/cuda/kernel_events.py).
__global__ void empty_kernel() {}

DQ_API int dq_empty(int B, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      k1_launch(empty_kernel, k1_shape(B), (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

DQ_API const char* dq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
