// K2: stratified proportional draw over the 64-ary sum tree (replaces
// _sample_impl and _windowed_impl of
// deepqlearning_tpu/ops/pallas/tree_sample.py).
//
// A group of 16 lanes (half a warp) takes one draw and walks the levels
// from the root to the leaves. At each node lane l reads children 4l..4l+3
// (a float4 when the branching factor bf is a multiple of 4, so one level
// is one coalesced 256-byte read; lanes past bf read 0), adds its four in
// order, and a 4-step __shfl_up_sync inclusive scan over the 16 lane sums
// gives each lane the prefix before its children; child k's running sum is
// csum_k = prefix + (the lane's in-order partial). The selection rule is
// sumtree.descend's: j = #{k < bf : mass >= csum_k} (a ballot and popcount
// per in-lane position) clamped to bf - 1, the mass before child j (csum of
// j - 1, by shuffle) is subtracted and the walk goes down to child j.
// tree_sample_scan in ops/cuda/tree_sample.py is this arithmetic in torch,
// step for step. The levels stay in device memory: a draw reads one node
// per level (the L2 cache serves the upper levels), so the kernel is bound
// by the latency of its dependent per-level reads; 16384 draws give 1024
// blocks of 256 threads, several per SM to hide it. Each draw writes its
// leaf index (int64) and priority at its u-major position: draw d =
// b * n + u of n sub-batches of B goes to row u * B + b. The TPU's window,
// boundary pass and fallback existed because its leaf level outgrew VMEM;
// here the whole tree is addressable, so they have no counterpart.
#include "common.cuh"

#define TS_MAXL 8
#define TS_LANES 16
#define TS_THREADS 256

struct TreeLevels {
  const float* lv[TS_MAXL];  // leaves first
  int size[TS_MAXL];
  int bf[TS_MAXL];  // level i's branching factor size[i] / size[i + 1]
  int n;
};

// One level of one draw's descent, on the group's 16 lanes: children of
// node idx of level lv (bf of them) -> the child j the mass falls in, the
// mass left within it and its priority.
__device__ __forceinline__ void ts_level(const float* __restrict__ lv, int bf,
                                         int lane, unsigned half, float& mass,
                                         int64_t& idx, float& prio) {
  const float* ch = lv + idx * bf;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if ((bf & 3) == 0) {
    if (4 * lane < bf) {
      const float4 x = *reinterpret_cast<const float4*>(ch + 4 * lane);
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (4 * lane + m < bf) v[m] = ch[4 * lane + m];
  }
  // in-lane running sums, then the lanes' inclusive scan
  float s[4];
  s[0] = v[0];
  s[1] = s[0] + v[1];
  s[2] = s[1] + v[2];
  s[3] = s[2] + v[3];
  float incl = s[3];
#pragma unroll
  for (int off = 1; off < TS_LANES; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off, TS_LANES);
    if (lane >= off) incl += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1, TS_LANES);
  if (lane == 0) excl = 0.0f;
  float csum[4];
  int cnt = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    csum[m] = excl + s[m];
    const unsigned b =
        __ballot_sync(0xffffffffu, 4 * lane + m < bf && mass >= csum[m]);
    cnt += __popc(b & half);
  }
  const int j = cnt < bf - 1 ? cnt : bf - 1;
  // csum of child j - 1 (when j > 0) and the priority of child j, each
  // from the lane that holds it
  const int jp = j > 0 ? j - 1 : 0;
  float pick = csum[0], vj = v[0];
#pragma unroll
  for (int m = 1; m < 4; ++m) {
    if (m == (jp & 3)) pick = csum[m];
    if (m == (j & 3)) vj = v[m];
  }
  const float prev = __shfl_sync(0xffffffffu, pick, jp / 4, TS_LANES);
  prio = __shfl_sync(0xffffffffu, vj, j / 4, TS_LANES);
  if (j > 0) mass -= prev;
  idx = idx * bf + j;
}

__global__ void __launch_bounds__(TS_THREADS) tree_sample_kernel(
    TreeLevels t, const float* __restrict__ mass_in, int D, int n_batches,
    int64_t* __restrict__ idx_out, float* __restrict__ prio_out) {
  const int lane = threadIdx.x & (TS_LANES - 1);
  const int d = blockIdx.x * (TS_THREADS / TS_LANES) + threadIdx.x / TS_LANES;
  // the 16 bits of this lane's group in a warp-wide ballot
  const unsigned half = 0xffffu << (threadIdx.x & 16);
  const bool live = d < D;
  float mass = live ? mass_in[d] : 0.0f;
  int64_t idx = 0;
  float prio = 0.0f;
  // unrolled, so that every read of the descriptor has a fixed offset (an
  // index known only at run time would copy it to a local-memory stack)
#pragma unroll
  for (int li = TS_MAXL - 2; li >= 0; --li)
    if (li <= t.n - 2) ts_level(t.lv[li], t.bf[li], lane, half, mass, idx, prio);
  if (live && lane == 0) {
    const int B = D / n_batches;
    const int row = (d % n_batches) * B + d / n_batches;
    idx_out[row] = idx;
    prio_out[row] = prio;
  }
}

DQ_API int dq_tree_sample(const TreeLevels* t, const void* mass, int D,
                          int n_batches, void* idx, void* prio,
                          void* stream) {
  if (t->n < 2 || t->n > TS_MAXL || n_batches < 1 || D % n_batches != 0)
    return (int)cudaErrorInvalidValue;
  const int per_block = TS_THREADS / TS_LANES;
  const int blocks = (D + per_block - 1) / per_block;
  if (blocks > 0)
    tree_sample_kernel<<<blocks, TS_THREADS, 0, (cudaStream_t)stream>>>(
        *t, (const float*)mass, D, n_batches, (int64_t*)idx, (float*)prio);
  return (int)cudaGetLastError();
}
