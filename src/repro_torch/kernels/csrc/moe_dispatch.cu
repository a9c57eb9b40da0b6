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
// and rounded once (no FMA contraction), one block per token row.
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

template <typename T>
__global__ void combine_kernel(const T* __restrict__ buf,
                               const float* __restrict__ w,
                               const int32_t* __restrict__ slot,
                               const int32_t* __restrict__ rank,
                               const int32_t* __restrict__ keep,
                               T* __restrict__ y,
                               int Tn, int K, int D, int S, int C) {
  const int row = blockIdx.x;                 // g * Tn + t
  const int g = row / Tn;
  const T* b = buf + (size_t)g * S * C * D;
  const size_t a0 = (size_t)row * K;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < K; ++j) {
      if (keep[a0 + j]) {
        const size_t src = ((size_t)slot[a0 + j] * C + rank[a0 + j]) * D + d;
        acc = __fadd_rn(acc, __fmul_rn(w[a0 + j], to_f32(b[src])));
      }
    }
    y[(size_t)row * D + d] = from_f32<T>(acc);
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

// buf [G,S,C,D], w [G,T,K] f32, slot/rank/keep [G,T,K] i32 -> y [G,T,D].
extern "C" int moe_combine_launch(const void* buf, const void* w,
                                  const void* slot, const void* rank,
                                  const void* keep, void* y, int G, int T,
                                  int K, int D, int S, int C, int dtype,
                                  void* stream) {
  const int rows = G * T;
  if (rows == 0) return 0;
  const int threads = D >= 256 ? 256 : ((D + 31) / 32) * 32;
  cudaStream_t st = (cudaStream_t)stream;
  const float* wf = (const float*)w;
  const int32_t* sl = (const int32_t*)slot;
  const int32_t* rk = (const int32_t*)rank;
  const int32_t* kp = (const int32_t*)keep;
  if (dtype == 0)
    combine_kernel<float><<<rows, threads, 0, st>>>(
        (const float*)buf, wf, sl, rk, kp, (float*)y, T, K, D, S, C);
  else if (dtype == 1)
    combine_kernel<__nv_bfloat16><<<rows, threads, 0, st>>>(
        (const __nv_bfloat16*)buf, wf, sl, rk, kp, (__nv_bfloat16*)y, T, K, D,
        S, C);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
