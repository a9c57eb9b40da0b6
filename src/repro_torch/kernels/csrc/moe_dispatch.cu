// Fused MoE dispatch and combine for Hopper, over a leading group dimension
// (one MoE group per serving slot, or one group for a whole batch).
//
// dispatch replaces `_dispatch_kernel` / `dispatch_pallas`
// (src/repro/kernels/moe_dispatch/moe_dispatch.py:38 / :98): the stable
// in-slot rank, the capacity mask, the bucketed store and the routed/kept
// counts per slot.  The TPU kernel carries the rank base across a
// sequential grid and scatters with a one-hot MXU matmul.  Here one block
// owns one group: it walks the group's flat T·k assignments in chunks of
// blockDim, each thread's rank being the carried per-slot base (shared
// memory) plus an exclusive count of equal keys among the earlier threads
// of its chunk, which is exactly the stable-argsort rank.  The store is
// direct: the rank pass records, for every (slot, rank) row, the one
// assignment that owns it (single writer), then the block writes every row
// of the group's [S,C,D] buffer once, w·v[tok] or zeros.
//
// combine replaces `_combine_kernel` / `combine_pallas` (:78 / :129):
// y[t] = sum_j w·keep·buf[slot, rank], the k terms added in j order in f32
// and rounded once (no FMA contraction), one warp per token row: the row's
// routing in one coalesced round, then all k gathers of a lane in flight
// together, 16 bytes each.
//
// Bound: bytes.  Dispatch reads v once and writes the whole [S,C,D]
// buffer; combine reads k rows per token and writes y.  Neither does more
// than a few operations per byte.  At serving shapes (T·k of 2..16 per
// group) both are launch-bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared memory: base[S+1] (carried per-slot histogram; slot S is the
// virtual segment of invalid assignments), keptc[S], keys[blockDim].
template <typename T>
__global__ void dispatch_kernel(const T* __restrict__ v,
                                const float* __restrict__ w,
                                const int32_t* __restrict__ slot,
                                const int32_t* __restrict__ valid,
                                T* __restrict__ buf,
                                int32_t* __restrict__ rank_out,
                                int32_t* __restrict__ keep_out,
                                int32_t* __restrict__ routed,
                                int32_t* __restrict__ kept,
                                int32_t* __restrict__ owner,
                                int Tn, int K, int D, int S, int C) {
  extern __shared__ int smem[];
  int* base = smem;
  int* keptc = base + S + 1;
  int* keys = keptc + S;
  const int g = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int N = Tn * K;
  const size_t a0 = (size_t)g * N;            // first assignment of group
  int32_t* own = owner + (size_t)g * S * C;   // (slot, rank) -> assignment

  for (int i = tid; i < 2 * S + 1; i += nt) smem[i] = 0;
  for (int i = tid; i < S * C; i += nt) own[i] = -1;
  __syncthreads();

  for (int c0 = 0; c0 < N; c0 += nt) {
    const int i = c0 + tid;
    int key = -1, s = 0;
    bool vld = false;
    if (i < N) {
      s = slot[a0 + i];
      // a slot outside [0, S) counts as invalid rather than indexing out
      // of bounds (routing never produces one)
      vld = valid[a0 + i] != 0 && s >= 0 && s < S;
      key = vld ? s : S;
    }
    keys[tid] = key;
    __syncthreads();
    if (i < N) {
      int r = base[key];
      for (int j = 0; j < tid; ++j) r += keys[j] == key;
      const bool kp = vld && r < C;
      rank_out[a0 + i] = vld ? r : 0;
      keep_out[a0 + i] = kp ? 1 : 0;
      if (kp) {
        own[s * C + r] = i;
        atomicAdd(&keptc[s], 1);
      }
    }
    __syncthreads();              // every read of base precedes the update
    if (i < N) atomicAdd(&base[key], 1);
    __syncthreads();
  }
  for (int s = tid; s < S; s += nt) {
    routed[(size_t)g * S + s] = base[s];
    kept[(size_t)g * S + s] = keptc[s];
  }

  // every (slot, rank) row written exactly once, one warp per row: its
  // owner's w·v, or zeros (16-byte stores when the row allows them; most
  // rows are empty at serving shapes)
  T* out = buf + (size_t)g * S * C * D;
  const int lane = tid & 31;
  const bool vec = (D * sizeof(T)) % sizeof(uint4) == 0;
  for (int row = tid >> 5; row < S * C; row += nt >> 5) {
    const int a = own[row];
    T* dst = out + (size_t)row * D;
    if (a < 0 && vec) {
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      const int n4 = (int)(D * sizeof(T) / sizeof(uint4));
      for (int i = lane; i < n4; i += 32) d4[i] = make_uint4(0, 0, 0, 0);
    } else if (a < 0) {
      for (int d = lane; d < D; d += 32) dst[d] = from_f32<T>(0.f);
    } else {
      const float wa = w[a0 + a];
      const T* src = v + ((size_t)g * Tn + a / K) * D;
      for (int d = lane; d < D; d += 32)
        dst[d] = from_f32<T>(__fmul_rn(wa, to_f32(src[d])));
    }
  }
}

// One warp per token row, CW rows a block.  Lanes 0..k-1 load the row's
// routing in one round and shuffles hand each term to every lane; each lane
// then owns 16-byte pieces of the row (8 bf16 or 4 f32 of D), issues the
// loads of all its terms (KB at a time) before the first add, adds them in
// j order and stores 16 bytes.  The buffer is read through its strides
// (sg, ss, sc elements between groups, slots and rows; unit stride along
// D), so a permuted view needs no copy.  Rows that do not start on 16-byte
// boundaries take the same loop element by element.
constexpr int CW = 4;     // token rows (warps) per block
constexpr int KB = 8;     // terms in flight per lane

template <typename T>
__global__ void __launch_bounds__(32 * CW)
combine_kernel(const T* __restrict__ buf, const float* __restrict__ w,
               const int32_t* __restrict__ slot,
               const int32_t* __restrict__ rank,
               const int32_t* __restrict__ keep, T* __restrict__ y, int rows,
               int Tn, int K, int D, long long sg, long long ss, long long sc,
               int vec) {
  constexpr int V = (int)(sizeof(uint4) / sizeof(T));
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * CW + (threadIdx.x >> 5);   // g * Tn + t
  if (row >= rows) return;
  const T* b = buf + (row / Tn) * sg;
  const size_t a0 = (size_t)row * K;
  T* yr = y + (size_t)row * D;

  // term j of the row: the element offset of its buffer row (-1 if not
  // kept) and its weight; j < 32 from lane j by shuffle, later j from
  // memory (K > 32 never occurs in the models)
  long long src_l = -1;
  float w_l = 0.f;
  if (lane < K) {
    const size_t a = a0 + lane;
    const int kp = keep[a], sl = slot[a], rk = rank[a];
    const float wa = w[a];
    if (kp) {
      src_l = sl * ss + rk * sc;
      w_l = wa;
    }
  }
  auto term = [&](int j, long long* src, float* wj) {
    if (j < 32) {
      *src = __shfl_sync(0xffffffffu, src_l, j);
      *wj = __shfl_sync(0xffffffffu, w_l, j);
    } else {
      const size_t a = a0 + j;
      *src = keep[a] ? slot[a] * ss + rank[a] * sc : -1;
      *wj = w[a];
    }
  };

  if (vec) {
    const int nv = D / V;
    for (int i0 = 0; i0 < nv; i0 += 32) {     // warp-uniform trip count
      const int i = i0 + lane;
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      for (int j0 = 0; j0 < K; j0 += KB) {
        uint4 r[KB];
        float wk[KB];
        bool on[KB];
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          long long src = -1;
          wk[u] = 0.f;
          if (j0 + u < K) term(j0 + u, &src, &wk[u]);
          on[u] = src >= 0;
          r[u] = on[u] && i < nv
                     ? *reinterpret_cast<const uint4*>(b + src + (size_t)i * V)
                     : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          if (!on[u]) continue;
          const T* e = reinterpret_cast<const T*>(&r[u]);
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[v] = __fadd_rn(acc[v], __fmul_rn(wk[u], to_f32(e[v])));
        }
      }
      if (i < nv) {
        uint4 o;
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int v = 0; v < V; ++v) oe[v] = from_f32<T>(acc[v]);
        *reinterpret_cast<uint4*>(yr + (size_t)i * V) = o;
      }
    }
  } else {
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int d = d0 + lane;
      float acc = 0.f;
      for (int j0 = 0; j0 < K; j0 += KB) {
        float r[KB], wk[KB];
        bool on[KB];
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          long long src = -1;
          wk[u] = 0.f;
          if (j0 + u < K) term(j0 + u, &src, &wk[u]);
          on[u] = src >= 0;
          r[u] = on[u] && d < D ? to_f32(b[src + d]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < KB; ++u)
          if (on[u]) acc = __fadd_rn(acc, __fmul_rn(wk[u], r[u]));
      }
      if (d < D) yr[d] = from_f32<T>(acc);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (v and buf share it).
// v [G,T,D], w [G,T,K] f32, slot/valid [G,T,K] i32 -> buf [G,S,C,D],
// rank/keep [G,T,K] i32, routed/kept [G,S] i32; owner is [G,S,C] i32
// scratch.  Returns the launch's cudaError_t.
extern "C" int moe_dispatch_launch(const void* v, const void* w,
                                   const void* slot, const void* valid,
                                   void* buf, void* rank, void* keep,
                                   void* routed, void* kept, void* owner,
                                   int G, int T, int K, int D, int S, int C,
                                   int dtype, void* stream) {
  if (G == 0) return 0;
  const int threads = 256;
  const size_t smem = sizeof(int) * (size_t)(2 * S + 1 + threads);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* sl = (const int32_t*)slot;
  const int32_t* va = (const int32_t*)valid;
  int32_t *rk = (int32_t*)rank, *kp = (int32_t*)keep;
  int32_t *ro = (int32_t*)routed, *ke = (int32_t*)kept, *ow = (int32_t*)owner;
  if (dtype == 0)
    dispatch_kernel<float><<<G, threads, smem, st>>>(
        (const float*)v, (const float*)w, sl, va, (float*)buf, rk, kp, ro, ke,
        ow, T, K, D, S, C);
  else if (dtype == 1)
    dispatch_kernel<__nv_bfloat16><<<G, threads, smem, st>>>(
        (const __nv_bfloat16*)v, (const float*)w, sl, va,
        (__nv_bfloat16*)buf, rk, kp, ro, ke, ow, T, K, D, S, C);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// buf [G,S,C,D] (element strides sg, ss, sc, unit stride along D), w
// [G,T,K] f32, slot/rank/keep [G,T,K] i32 -> y [G,T,D] contiguous.
extern "C" int moe_combine_launch(const void* buf, const void* w,
                                  const void* slot, const void* rank,
                                  const void* keep, void* y, int G, int T,
                                  int K, int D, long long sg, long long ss,
                                  long long sc, int dtype, void* stream) {
  const int rows = G * T;
  if (rows == 0) return 0;
  const int blocks = (rows + CW - 1) / CW;
  const int v = dtype == 0 ? 4 : 8;          // elements in 16 bytes
  // 16-byte pieces when every buffer and output row starts on a 16-byte
  // boundary
  const int vec = D % v == 0 && sg % v == 0 && ss % v == 0 && sc % v == 0 &&
                  ((uintptr_t)buf & 15u) == 0 && ((uintptr_t)y & 15u) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* wf = (const float*)w;
  const int32_t* sl = (const int32_t*)slot;
  const int32_t* rk = (const int32_t*)rank;
  const int32_t* kp = (const int32_t*)keep;
  if (dtype == 0)
    combine_kernel<float><<<blocks, 32 * CW, 0, st>>>(
        (const float*)buf, wf, sl, rk, kp, (float*)y, rows, T, K, D, sg, ss,
        sc, vec);
  else if (dtype == 1)
    combine_kernel<__nv_bfloat16><<<blocks, 32 * CW, 0, st>>>(
        (const __nv_bfloat16*)buf, wf, sl, rk, kp, (__nv_bfloat16*)y, rows,
        T, K, D, sg, ss, sc, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
