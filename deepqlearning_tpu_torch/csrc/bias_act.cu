// K10: every Conv2D and Dense layer's epilogue (ops/cuda/bias_act.py): the
// bias add, the activation and the casts around a layer's product in one
// launch forward and one backward. No Pallas kernel is replaced: on the
// TPU, XLA fuses the epilogue into the product's output. In PyTorch it was
// a chain of ATen kernels: y.float(), b.float(), the add, the activation,
// .to(dtype), each reading and writing the whole activation in f32, and in
// autograd's backward the cotangent's cast, threshold_backward or
// tanh_backward, the bias's sum, its cast and the cast back.
//
// Work: y is a contiguous [M, C] array (a Conv2D's NHWC output, M = N*H*W;
// a Dense layer's [..., C]); the forward reads y once and writes the output
// once, the backward reads the cotangent and one saved array and writes the
// product's cotangent and C bias gradients. So K10 is bound by device
// memory at the conv cells' large activations (2048 x 20 x 20 x 32 bf16:
// 105 MB forward, 31 us at 3.35 TB/s) and by its launch at the small ones.
//
// Design. A block of BA_THREADS threads is laid out [TY][TX] over the
// array: TX = C / V column units (V elements of 16 bytes, or 1 where C is
// not a multiple of V or a pointer is not 16-byte aligned; at most 256, a
// thread then walks several units of a row) and TY rows; the grid walks
// the rows, so each thread keeps its units' bias in registers and a warp
// reads and writes contiguous memory. The arithmetic is the ATen chain's,
// operation for operation: widen to f32, add the f32 bias (rounded once),
// max(z, 0) with NaN kept (clamp_min) or tanhf, and one round to nearest
// even into the output's dtype (__float2bfloat16_rn, as c10::BFloat16 on
// the card). The output is that chain's bits.
//
// The backward reads the cotangent g and, for relu, the stored output o
// (nothing in f32 is saved): the product's cotangent is o <= 0 ? 0 : g, as
// threshold_backward(g, result, 0), and g with no activation, rounded to
// y's dtype. Where o is bf16 the mask is read from the rounded output: a
// result in (0, 2^-134] rounds to a bf16 zero, so K10 gives those elements
// a zero cotangent where ATen (which read the f32 result) passed g; that is
// its one departure, and it is tested. tanh reads the f32 output where the
// output is f32 and otherwise recomputes the f32 result from the saved
// product and bias (the same operations as the forward); its cotangent is
// g * (1 - a * a) with 1 - a * a as one FMA, as nvcc compiled ATen's
// tanh_backward (written out: left to the compiler, the contraction came
// and went with the unrolling, and with it the last bit). The bias
// gradient sums the f32 cotangents in a fixed order: each thread over its
// rows, shuffles over a warp's rows (a fixed tree in shared memory where
// a row's units do not divide a warp), a fixed tree over the warps into a
// per-block partial, and the last block to finish (an atomic ticket that
// the layer's forward launch zeroed; it re-arms it) sums the partials in a
// fixed order and rounds once to the bias's dtype. No float atomics: every
// run, every graph replay, gives the same bits. The backward takes at most
// 264 blocks (2 an SM): that last block's sum and the ticket cost ~4 us at
// every size, more with more partials.
#include "common.cuh"

#include <cuda_bf16.h>

#include <type_traits>

#define BA_THREADS 256
#define BA_MAXB 1024  // blocks of a launch; the backward's partials: blocks x C

typedef unsigned short ba_bf16;  // the bits of a bf16

__device__ __forceinline__ float ba_f(float x) { return x; }
__device__ __forceinline__ float ba_f(ba_bf16 x) {
  return __uint_as_float((unsigned)x << 16);
}

template <typename T>
__device__ __forceinline__ T ba_t(float x);
template <>
__device__ __forceinline__ float ba_t<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ ba_bf16 ba_t<ba_bf16>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// V elements in one load or store (16 bytes at the widest)
template <typename T, int V>
struct alignas(sizeof(T) * V) BaVec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ BaVec<T, V> ba_load(const void* p, size_t off) {
  return *(reinterpret_cast<const BaVec<T, V>*>(
      reinterpret_cast<const T*>(p) + off));
}

template <typename T, int V>
__device__ __forceinline__ void ba_store(void* p, size_t off,
                                         const BaVec<T, V>& x) {
  *(reinterpret_cast<BaVec<T, V>*>(reinterpret_cast<T*>(p) + off)) = x;
}

// the bias of columns c0 .. c0 + V - 1 in f32 (bias_kind 1 f32, 2 bf16;
// 0: no bias, never read)
template <int V>
__device__ __forceinline__ void ba_bias(const void* bias, int bias_kind,
                                        int c0, float (&b)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j)
    b[j] = bias_kind == 1   ? reinterpret_cast<const float*>(bias)[c0 + j]
           : bias_kind == 2
               ? ba_f(reinterpret_cast<const ba_bf16*>(bias)[c0 + j])
               : 0.0f;
}

// 0 none, 1 relu (clamp_min: NaN kept), 2 tanh
template <int ACT>
__device__ __forceinline__ float ba_act(float z) {
  if constexpr (ACT == 1)
    return z != z ? z : fmaxf(z, 0.0f);  // a NaN stays, as clamp_min's
  else if constexpr (ACT == 2)
    return tanhf(z);
  else
    return z;
}

// ticket (or null): the backward's, zeroed here for it
template <typename TY, typename TO, int ACT, int V>
__global__ void __launch_bounds__(BA_THREADS)
    bias_act_kernel(const TY* __restrict__ y, const void* __restrict__ bias,
                    int bias_kind, TO* __restrict__ out,
                    unsigned* __restrict__ ticket, int M, int C) {
  if (ticket && blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0)
    *ticket = 0u;
  const int CV = C / V;
  for (int cv = threadIdx.x; cv < CV; cv += blockDim.x) {
    float b[V];
    ba_bias<V>(bias, bias_kind, cv * V, b);
    for (int r = blockIdx.x * blockDim.y + threadIdx.y; r < M;
         r += gridDim.x * blockDim.y) {
      const size_t off = (size_t)r * C + (size_t)cv * V;
      const BaVec<TY, V> a = ba_load<TY, V>(y, off);
      BaVec<TO, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float z = ba_f(a.v[j]);
        if (bias_kind) z = __fadd_rn(z, b[j]);
        o.v[j] = ba_t<TO>(ba_act<ACT>(z));
      }
      ba_store<TO, V>(out, off, o);
    }
  }
}

// the partials b0, b0 + step, ... (< nb) of column c summed in that order,
// eight loads in flight at a time
__device__ __forceinline__ float ba_sum(const float* part, int C, int c,
                                        int b0, int step, int nb) {
  float s = 0.0f;
  int b = b0;
  for (; b + 7 * step < nb; b += 8 * step) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = __ldcg(part + (size_t)(b + k * step) * C + c);
#pragma unroll
    for (int k = 0; k < 8; ++k) s = __fadd_rn(s, v[k]);
  }
  for (; b < nb; b += step) s = __fadd_rn(s, __ldcg(part + (size_t)b * C + c));
  return s;
}

// rows 0 .. R - 1 of red [R][C] summed into row 0 by a fixed tree (row k
// takes row k + s, s halving); every thread of the block calls it
__device__ __forceinline__ void ba_tree(float* red, int R, int C, int t,
                                        int nt) {
  int s = 1;
  while (2 * s < R) s *= 2;
  for (; s > 0 && R > 1; s >>= 1) {
    for (int q = t; q < s * C; q += nt) {
      const int k = q / C, i = q % C;
      if (k + s < R)
        red[k * C + i] = __fadd_rn(red[k * C + i], red[(k + s) * C + i]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void ba_store_db(void* db, int db_kind, int c,
                                            float s) {
  if (db_kind == 1)
    reinterpret_cast<float*>(db)[c] = s;
  else
    reinterpret_cast<ba_bf16*>(db)[c] = ba_t<ba_bf16>(s);
}

// ACT: 0 none, 1 relu (src: the output, TG), 2 tanh (src: the f32 output),
// 3 tanh recomputed from src = the product y (TY) and the bias.
template <typename TG, typename TY, int ACT, int V>
__global__ void __launch_bounds__(BA_THREADS) bias_act_grad_kernel(
    const TG* __restrict__ g, const void* __restrict__ src,
    const void* __restrict__ bias, int bias_kind, TY* __restrict__ dy,
    float* __restrict__ part, unsigned* __restrict__ ticket,
    void* __restrict__ db, int db_kind, int M, int C) {
  using TS = std::conditional_t<ACT == 3, TY, TG>;
  __shared__ float red[BA_THREADS * 8];
  __shared__ bool last;
  const int CV = C / V;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY_ = blockDim.y;
  const int t = ty * TX + tx, nt = TX * TY_;
  // with several rows a block and TX dividing a warp, a warp's rows of
  // each unit meet by shuffles, else the block's rows in shared memory
  const bool shfl = TY_ > 1 && 32 % TX == 0;
  bool wrote = false;  // this thread wrote partials
  for (int cv = tx; cv < CV; cv += TX) {
    float b[V];
    if constexpr (ACT == 3) ba_bias<V>(bias, bias_kind, cv * V, b);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    for (int r = blockIdx.x * TY_ + ty; r < M; r += gridDim.x * TY_) {
      const size_t off = (size_t)r * C + (size_t)cv * V;
      const BaVec<TG, V> gv = ba_load<TG, V>(g, off);
      float d[V];
      if constexpr (ACT == 0) {
#pragma unroll
        for (int j = 0; j < V; ++j) d[j] = ba_f(gv.v[j]);
      } else {
        const BaVec<TS, V> sv = ba_load<TS, V>(src, off);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float gj = ba_f(gv.v[j]);
          float s = ba_f(sv.v[j]);
          if constexpr (ACT == 1) {
            d[j] = s <= 0.0f ? 0.0f : gj;
          } else {
            if constexpr (ACT == 3) {
              if (bias_kind) s = __fadd_rn(s, b[j]);
              s = tanhf(s);
            }
            d[j] = __fmul_rn(gj, __fmaf_rn(-s, s, 1.0f));
          }
        }
      }
      if (dy) {
        BaVec<TY, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j) o.v[j] = ba_t<TY>(d[j]);
        ba_store<TY, V>(dy, off, o);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], d[j]);
    }
    if (db) {
      if (TY_ == 1) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          part[(size_t)blockIdx.x * C + cv * V + j] = acc[j];
        wrote = true;
      } else if (shfl) {  // the lanes of one unit: every TX-th of a warp
#pragma unroll
        for (int off = TX; off < 32; off <<= 1) {
#pragma unroll
          for (int j = 0; j < V; ++j)
            acc[j] = __fadd_rn(acc[j],
                               __shfl_xor_sync(0xffffffffu, acc[j], off));
        }
        if ((t & 31) < TX) {
#pragma unroll
          for (int j = 0; j < V; ++j) red[(t >> 5) * C + cv * V + j] = acc[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) red[ty * C + cv * V + j] = acc[j];
      }
    }
  }
  if (!db) return;
  if (TY_ > 1) {  // the block's rows (or its warps' sums) into one partial
    __syncthreads();
    ba_tree(red, shfl ? nt / 32 : TY_, C, t, nt);
    for (int c = t; c < C; c += nt) part[(size_t)blockIdx.x * C + c] = red[c];
    wrote = t < C;
  }
  if (wrote) __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: every partial has been written (read past L1)
  const int nb = gridDim.x;
  if (C <= nt) {  // G groups of threads, each over every G-th partial
    const int G = nt / C, c = t % C, grp = t / C;
    if (grp < G) red[grp * C + c] = ba_sum(part, C, c, grp, G, nb);
    __syncthreads();
    ba_tree(red, G, C, t, nt);
    if (t < C) ba_store_db(db, db_kind, t, red[t]);
  } else {
    for (int c = t; c < C; c += nt)
      ba_store_db(db, db_kind, c, ba_sum(part, C, c, 0, 1, nb));
  }
  if (t == 0) *ticket = 0u;
}

// 16 bytes of the wider of two element types
template <typename A, typename B>
constexpr int ba_width() {
  return 16 / (sizeof(A) > sizeof(B) ? sizeof(A) : sizeof(B));
}

template <typename TY, typename TO, int ACT>
static void ba_fwd(bool vec, dim3 grid, dim3 block, cudaStream_t s,
                   const void* y, const void* bias, int bias_kind, void* out,
                   void* ticket, int M, int C) {
  constexpr int V = ba_width<TY, TO>();
  if (vec)
    bias_act_kernel<TY, TO, ACT, V><<<grid, block, 0, s>>>(
        (const TY*)y, bias, bias_kind, (TO*)out, (unsigned*)ticket, M, C);
  else
    bias_act_kernel<TY, TO, ACT, 1><<<grid, block, 0, s>>>(
        (const TY*)y, bias, bias_kind, (TO*)out, (unsigned*)ticket, M, C);
}

template <typename TY, typename TO>
static int ba_fwd_act(int act, bool vec, dim3 grid, dim3 block,
                      cudaStream_t s, const void* y, const void* bias,
                      int bias_kind, void* out, void* ticket, int M, int C) {
  switch (act) {
    case 0:
      ba_fwd<TY, TO, 0>(vec, grid, block, s, y, bias, bias_kind, out, ticket,
                        M, C);
      return 0;
    case 1:
      ba_fwd<TY, TO, 1>(vec, grid, block, s, y, bias, bias_kind, out, ticket,
                        M, C);
      return 0;
    case 2:
      ba_fwd<TY, TO, 2>(vec, grid, block, s, y, bias, bias_kind, out, ticket,
                        M, C);
      return 0;
  }
  return 1;
}

template <typename TG, typename TY, int ACT>
static void ba_bwd(bool vec, dim3 grid, dim3 block, cudaStream_t s,
                   const void* g, const void* src, const void* bias,
                   int bias_kind, void* dy, void* part, void* ticket,
                   void* db, int db_kind, int M, int C) {
  constexpr int V = ba_width<TG, TY>();  // src is TG or TY
  if (vec)
    bias_act_grad_kernel<TG, TY, ACT, V><<<grid, block, 0, s>>>(
        (const TG*)g, src, bias, bias_kind, (TY*)dy, (float*)part,
        (unsigned*)ticket, db, db_kind, M, C);
  else
    bias_act_grad_kernel<TG, TY, ACT, 1><<<grid, block, 0, s>>>(
        (const TG*)g, src, bias, bias_kind, (TY*)dy, (float*)part,
        (unsigned*)ticket, db, db_kind, M, C);
}

template <typename TG, typename TY>
static int ba_bwd_act(int act, bool vec, dim3 grid, dim3 block,
                      cudaStream_t s, const void* g, const void* src,
                      const void* bias, int bias_kind, void* dy, void* part,
                      void* ticket, void* db, int db_kind, int M, int C) {
  switch (act) {
    case 0:
      ba_bwd<TG, TY, 0>(vec, grid, block, s, g, src, bias, bias_kind, dy,
                        part, ticket, db, db_kind, M, C);
      return 0;
    case 1:
      ba_bwd<TG, TY, 1>(vec, grid, block, s, g, src, bias, bias_kind, dy,
                        part, ticket, db, db_kind, M, C);
      return 0;
    case 2:  // the f32 output holds the f32 result
      if constexpr (std::is_same_v<TG, float>) {
        ba_bwd<TG, TY, 2>(vec, grid, block, s, g, src, bias, bias_kind, dy,
                          part, ticket, db, db_kind, M, C);
        return 0;
      }
      return 1;
    case 3:  // a narrower output: the result recomputed from y and the bias
      if constexpr (!std::is_same_v<TG, float>) {
        ba_bwd<TG, TY, 3>(vec, grid, block, s, g, src, bias, bias_kind, dy,
                          part, ticket, db, db_kind, M, C);
        return 0;
      }
      return 1;
  }
  return 1;
}

// a block of tx x ty threads: with several rows (ty > 1) a thread per
// column unit of a row (tx = C / V), with one row up to BA_THREADS
static bool ba_shape_ok(int M, int C, int tx, int ty, int grid, int vec,
                        int width) {
  const int units = vec ? C / width : C;
  return M >= 1 && C >= 1 && tx >= 1 && ty >= 1 && tx * ty <= BA_THREADS &&
         grid >= 1 && grid <= BA_MAXB && (!vec || C % width == 0) &&
         (ty == 1 || tx == units);
}

// The forward: out = dtype(act(f32(y) + f32(bias))). y_kind, out_kind: 0
// f32, 1 bf16; bias_kind 0 none, 1 f32, 2 bf16; act 0 none, 1 relu, 2
// tanh; vec: every pointer 16-byte aligned and C a multiple of the 16-byte
// width; a block of tx x ty threads (ops/cuda/bias_act.py::launch_plan);
// ticket: the backward's (zeroed for it), or null.
DQ_API int dq_bias_act(const void* y, int y_kind, const void* bias,
                       int bias_kind, void* out, int out_kind, void* ticket,
                       int act, int M, int C, int vec, int tx, int ty,
                       int grid, void* stream) {
  const int width = 16 / ((y_kind == 0 || out_kind == 0) ? 4 : 2);
  if (!ba_shape_ok(M, C, tx, ty, grid, vec, width) || bias_kind < 0 ||
      bias_kind > 2 || y_kind < 0 || y_kind > 1 || out_kind < 0 ||
      out_kind > 1)
    return (int)cudaErrorInvalidValue;
  const dim3 g(grid), b(tx, ty);
  cudaStream_t s = (cudaStream_t)stream;
  int bad = 1;
  if (y_kind == 0 && out_kind == 0)
    bad = ba_fwd_act<float, float>(act, vec, g, b, s, y, bias, bias_kind, out,
                                   ticket, M, C);
  else if (y_kind == 0 && out_kind == 1)
    bad = ba_fwd_act<float, ba_bf16>(act, vec, g, b, s, y, bias, bias_kind,
                                     out, ticket, M, C);
  else if (y_kind == 1 && out_kind == 0)
    bad = ba_fwd_act<ba_bf16, float>(act, vec, g, b, s, y, bias, bias_kind,
                                     out, ticket, M, C);
  else
    bad = ba_fwd_act<ba_bf16, ba_bf16>(act, vec, g, b, s, y, bias, bias_kind,
                                       out, ticket, M, C);
  if (bad) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The backward: dy (y's dtype, or null) and db (the bias's dtype, db_kind
// 1 f32 / 2 bf16, or null) from the cotangent g (the output's dtype,
// g_kind) and src (act 1 and 2: the output; 3: y). part: grid x C floats;
// ticket: an unsigned that is 0 before the launch (the forward's launch
// zeroed it) and after it.
DQ_API int dq_bias_act_grad(const void* g, int g_kind, const void* src,
                            const void* bias, int bias_kind, void* dy,
                            int y_kind, void* part, void* ticket, void* db,
                            int db_kind, int act, int M, int C, int vec,
                            int tx, int ty, int grid, void* stream) {
  const int width = 16 / ((y_kind == 0 || g_kind == 0) ? 4 : 2);
  if (!ba_shape_ok(M, C, tx, ty, grid, vec, width) || bias_kind < 0 ||
      bias_kind > 2 || (db && (db_kind < 1 || db_kind > 2 || !part ||
                               !ticket)) ||
      (!dy && !db) || (act != 0 && !src) || (act == 3 && bias_kind && !bias) ||
      g_kind < 0 || g_kind > 1 || y_kind < 0 || y_kind > 1)
    return (int)cudaErrorInvalidValue;
  const dim3 gr(grid), b(tx, ty);
  cudaStream_t s = (cudaStream_t)stream;
  int bad = 1;
  if (g_kind == 0 && y_kind == 0)
    bad = ba_bwd_act<float, float>(act, vec, gr, b, s, g, src, bias,
                                   bias_kind, dy, part, ticket, db, db_kind,
                                   M, C);
  else if (g_kind == 0 && y_kind == 1)
    bad = ba_bwd_act<float, ba_bf16>(act, vec, gr, b, s, g, src, bias,
                                     bias_kind, dy, part, ticket, db,
                                     db_kind, M, C);
  else if (g_kind == 1 && y_kind == 0)
    bad = ba_bwd_act<ba_bf16, float>(act, vec, gr, b, s, g, src, bias,
                                     bias_kind, dy, part, ticket, db,
                                     db_kind, M, C);
  else
    bad = ba_bwd_act<ba_bf16, ba_bf16>(act, vec, gr, b, s, g, src, bias,
                                       bias_kind, dy, part, ticket, db,
                                       db_kind, M, C);
  if (bad) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
