// K9: the plain train steps' Adam update and gradient max-abs in one launch
// (ops/cuda/adam.py). No Pallas kernel is replaced: on the TPU, XLA fuses
// optax's Adam into the jitted update; in PyTorch the same update was a
// loop of 14 (f32) or 16 (bf16) ATen kernels per parameter tensor, plus
// an abs and a max per tensor for the logged gradient max-abs. Every
// plain-step route (the ungrouped and grouped plain steps, the DRQN plain
// steps, the plain data-parallel steps) ends with this one launch.
//
// Work: one pass that reads g, m, v and p and writes m, v and p, 14 bytes
// per bf16 parameter (28 in f32), so the kernel is bound by device memory
// at large nets (the Nature DQN's 3.29M bf16 parameters: 46 MB, 13.8 us
// at 3.35 TB/s) and by its launch at small ones (the 9k-parameter MLP).
//
// Design. The wrapper passes a table of every tensor by value (p, m, v, g
// pointers, element counts, dtype), so the launch is one kernel node in a
// CUDA graph and no copy. The elements of all tensors form one space of
// 16-byte units (4 f32 or 8 bf16 elements; a tensor's last unit may be
// short); a grid sized from the unit count walks it, a unit per thread per
// step, with 16-byte loads and stores where all four pointers of a tensor
// are 16-byte aligned and a scalar loop on a short or unaligned unit.
// The arithmetic is Adam.update's (learner/train_step.py), operation for
// operation: each product, sum, quotient and root rounded on its own
// (__fmul_rn etc.: the ATen chain never contracts a * b + c into an FMA),
// and in bf16 each result rounded to bf16 where the separate ATen kernel
// stored it, so K9 gives that chain's bits. The step count lives on the
// device: every block reads it, takes t = count + 1 and the bias
// corrections 1 - b^t as the chain's ATen kernels did (int to f32, powf,
// a rounded subtraction; bf16 rounds them to bf16 first, as .to(m.dtype)
// does), and the last block writes count + 1. The max-abs of all gradients
// is a max over the bits of |g| (order-free, so exact; NaN, whose bits lie
// above inf, wins as in torch.max): a warp max, a block max into a
// partial, and the last block to finish (an atomic ticket) reduces the
// partials, writes the f32 result and the count, and re-arms the ticket
// for the next call.
#include "common.cuh"

#include <cuda_bf16.h>

#define AD_MAXT 64      // tensors in one table; more take several launches
#define AD_THREADS 256
#define AD_MAXB 1024    // partials of the max-abs: blocks over all launches

// Mirror: ops/cuda/build.py::AdamTab.
struct AdamTab {
  void* p[AD_MAXT];
  void* m[AD_MAXT];
  void* v[AD_MAXT];
  const void* g[AD_MAXT];
  int n[AD_MAXT];          // elements of tensor i
  int start[AD_MAXT + 1];  // its first unit; start[nt] = units of the table
  int flags[AD_MAXT];      // bit 0: bf16 (else f32); bit 1: 16-byte aligned
  int nt;
  float k[2][6];  // f32, bf16: (1-b1, b1, 1-b2, b2, eps, -lr) in that dtype
};

// x rounded to bf16, held in f32
__device__ __forceinline__ float ad_r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Adam.update on one f32 element: m*b1 + c1*g, v*b2 + c2*(g*g), then
// p + (-lr)*((m / bc1) / (sqrt(v / bc2) + eps)).
__device__ __forceinline__ void ad_f32(float& p, float& m, float& v, float g,
                                       const float* k, float bc1,
                                       float bc2) {
  m = __fadd_rn(__fmul_rn(m, k[1]), __fmul_rn(k[0], g));
  v = __fadd_rn(__fmul_rn(v, k[3]), __fmul_rn(k[2], __fmul_rn(g, g)));
  const float u = __fdiv_rn(
      __fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), k[4]));
  p = __fadd_rn(p, __fmul_rn(k[5], u));
}

// The same on one bf16 element (values and bc1, bc2 bf16, held in f32),
// every intermediate rounded to bf16 as its ATen kernel stores it.
__device__ __forceinline__ void ad_bf16(float& p, float& m, float& v,
                                        float g, const float* k, float bc1,
                                        float bc2) {
  m = ad_r(__fadd_rn(ad_r(__fmul_rn(m, k[1])), ad_r(__fmul_rn(k[0], g))));
  const float gg = ad_r(__fmul_rn(g, g));
  v = ad_r(__fadd_rn(ad_r(__fmul_rn(v, k[3])), ad_r(__fmul_rn(k[2], gg))));
  const float mh = ad_r(__fdiv_rn(m, bc1));
  const float vh = ad_r(__fdiv_rn(v, bc2));
  const float den = ad_r(__fadd_rn(ad_r(__fsqrt_rn(vh)), k[4]));
  p = ad_r(__fadd_rn(p, ad_r(__fmul_rn(k[5], ad_r(__fdiv_rn(mh, den))))));
}

// V elements from x into a (16 bytes when vec, else the first cnt).
template <bool BF, int V>
__device__ __forceinline__ void ad_load(const void* x, int j0, int cnt,
                                        bool vec, float (&a)[V]) {
  if constexpr (BF) {
    const unsigned short* s = (const unsigned short*)x + j0;
    if (vec) {
      const uint4 w = *reinterpret_cast<const uint4*>(s);
      const unsigned q[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[2 * i] = __uint_as_float(q[i] << 16);
        a[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        a[i] = i < cnt ? __uint_as_float((unsigned)s[i] << 16) : 0.0f;
    }
  } else {
    const float* s = (const float*)x + j0;
    if (vec) {
      const float4 w = *reinterpret_cast<const float4*>(s);
      a[0] = w.x;
      a[1] = w.y;
      a[2] = w.z;
      a[3] = w.w;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) a[i] = i < cnt ? s[i] : 0.0f;
    }
  }
}

// The inverse of ad_load; a bf16 value is exact in f32, so its upper half
// is the bf16.
template <bool BF, int V>
__device__ __forceinline__ void ad_store(void* x, int j0, int cnt, bool vec,
                                         const float (&a)[V]) {
  if constexpr (BF) {
    unsigned short* s = (unsigned short*)x + j0;
    if (vec) {
      unsigned q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i] = (__float_as_uint(a[2 * i]) >> 16) |
               (__float_as_uint(a[2 * i + 1]) & 0xffff0000u);
      *reinterpret_cast<uint4*>(s) = make_uint4(q[0], q[1], q[2], q[3]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (i < cnt) s[i] = (unsigned short)(__float_as_uint(a[i]) >> 16);
    }
  } else {
    float* s = (float*)x + j0;
    if (vec) {
      *reinterpret_cast<float4*>(s) = make_float4(a[0], a[1], a[2], a[3]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (i < cnt) s[i] = a[i];
    }
  }
}

// Unit u of tensor i: Adam on its elements; returns the max of |g|'s bits.
template <bool BF>
__device__ __forceinline__ unsigned ad_unit(const AdamTab& t, int i, int u,
                                            float bc1, float bc2) {
  constexpr int V = BF ? 8 : 4;
  const int j0 = (u - t.start[i]) * V;
  const int cnt = min(V, t.n[i] - j0);
  const bool vec = cnt == V && (t.flags[i] & 2);
  const float* k = t.k[BF ? 1 : 0];
  float p[V], m[V], v[V], g[V];
  ad_load<BF, V>(t.g[i], j0, cnt, vec, g);
  ad_load<BF, V>(t.p[i], j0, cnt, vec, p);
  ad_load<BF, V>(t.m[i], j0, cnt, vec, m);
  ad_load<BF, V>(t.v[i], j0, cnt, vec, v);
  unsigned amax = 0u;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (e < cnt) {
      amax = max(amax, __float_as_uint(g[e]) & 0x7fffffffu);
      if constexpr (BF)
        ad_bf16(p[e], m[e], v[e], g[e], k, bc1, bc2);
      else
        ad_f32(p[e], m[e], v[e], g[e], k, bc1, bc2);
    }
  }
  ad_store<BF, V>(t.p[i], j0, cnt, vec, p);
  ad_store<BF, V>(t.m[i], j0, cnt, vec, m);
  ad_store<BF, V>(t.v[i], j0, cnt, vec, v);
  return amax;
}

// One launch over the table's units. work[0] is the ticket, work[1 + b]
// block b's partial (this launch's blocks are base .. base + gridDim.x - 1
// of `blocks` over all launches of the call); count is Adam's int32 step
// count, written by the call's last block only, after every block has read
// it.
__global__ void __launch_bounds__(AD_THREADS) adam_kernel(
    const __grid_constant__ AdamTab t, int* __restrict__ count, float b1,
    float b2, unsigned* __restrict__ work, int base, int blocks,
    float* __restrict__ gnorm) {
  __shared__ unsigned red[AD_THREADS / 32];
  __shared__ bool last;
  const int c = __ldcg(count) + 1;
  const float step = (float)c;
  const float bc1 = __fsub_rn(1.0f, powf(b1, step));
  const float bc2 = __fsub_rn(1.0f, powf(b2, step));
  const float rb1 = ad_r(bc1), rb2 = ad_r(bc2);
  const int units = t.start[t.nt];
  unsigned amax = 0u;
  for (int u = blockIdx.x * AD_THREADS + threadIdx.x; u < units;
       u += gridDim.x * AD_THREADS) {
    // the tensor holding unit u: the last i with start[i] <= u
    int lo = 0, hi = t.nt - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.start[mid] <= u)
        lo = mid;
      else
        hi = mid - 1;
    }
    amax = max(amax, (t.flags[lo] & 1) ? ad_unit<true>(t, lo, u, rb1, rb2)
                                       : ad_unit<false>(t, lo, u, bc1, bc2));
  }
  amax = __reduce_max_sync(0xffffffffu, amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned x = threadIdx.x < AD_THREADS / 32 ? red[threadIdx.x] : 0u;
    x = __reduce_max_sync(0xffffffffu, x);
    if (threadIdx.x == 0) {
      work[1 + base + blockIdx.x] = x;
      __threadfence();
      last = atomicAdd(work, 1u) == (unsigned)(blocks - 1);
    }
  }
  __syncthreads();
  if (!last) return;
  // the last block of the call: every partial has been written
  __threadfence();
  unsigned x = 0u;
  for (int b = threadIdx.x; b < blocks; b += AD_THREADS)
    x = max(x, __ldcg(work + 1 + b));
  x = __reduce_max_sync(0xffffffffu, x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < AD_THREADS / 32; ++w) x = max(x, red[w]);
    *gnorm = __uint_as_float(x);
    *count = c;
    work[0] = 0u;
  }
}

DQ_API int dq_adam_update(const AdamTab* t, void* count, float b1, float b2,
                          void* work, int base, int grid, int blocks,
                          void* gnorm, void* stream) {
  if (t->nt < 1 || t->nt > AD_MAXT || grid < 1 || base + grid > blocks ||
      blocks > AD_MAXB)
    return (int)cudaErrorInvalidValue;
  adam_kernel<<<grid, AD_THREADS, 0, (cudaStream_t)stream>>>(
      *t, (int*)count, b1, b2, (unsigned*)work, base, blocks, (float*)gnorm);
  return (int)cudaGetLastError();
}
