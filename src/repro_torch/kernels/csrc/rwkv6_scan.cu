// RWKV6 WKV scan for Hopper: the exact recurrence, per (batch, head),
//     y_t = r_t^T (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T,
// with S an [N,N] f32 state (key channel n, value channel m).
//
// Replaces `_kernel` / `rwkv6_pallas`
// (src/repro/kernels/rwkv6_scan/rwkv6_scan.py:20 / :59).  The TPU kernel
// walks chunks of Q tokens on a sequential grid axis, keeps S in VMEM, and
// turns each chunk into three MXU matmuls by factoring the decay as
// exp(la_prev) * exp(min(-la, 30)), which is exact only while the
// cumulative decay inside a chunk stays above e^-30.  Nothing here factors
// the decay: column m of S evolves on its own,
//     S[:,m] <- w (.) S[:,m] + k v[m],
//     y[m]    = sum_n r[n] S[n,m] + v[m] sum_n r[n] u[n] k[n],
// so one block per (b, h) runs one thread per value channel m, which holds
// column m of S (N floats) in registers, and the sum over n is local to
// the thread.  A loop over T inside the block replaces the sequential grid
// axis.  r, k, w and v of a run of tokens are shared by all threads of the
// block, so they are staged in shared memory as f32 (with r*u*k, the bonus
// term's summand); every thread then reads each value by broadcast.
//
// Bound: operations.  Per token and head the function reads 4N inputs and
// writes N outputs (10N bytes in bf16) but does about 5N^2 f32 operations,
// about 30 per byte at N = 64, above the H100's f32 ridge of 20 operations
// per byte.  This first kernel does not reach that bound: B*H blocks of N
// threads leave most of the card's warps empty at B*H = 128, and each
// thread's dot product over n is one dependent FMA chain per token.
// Spreading n over more threads (with a reduction per token) or a chunked
// tensor-core form is later work.
//
// f32 inside; y is written in the inputs' dtype, sT in f32.  Any T.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRun = 32;   // tokens staged in shared memory per pass

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
  return __float2bfloat16(x);
}

// One block per (b, h), blockDim.x == N.  r/k/v/w are [B,H,T,N] with
// element strides (sb, sh, st) and unit stride along N; y has strides
// (yb, yh, yt).  u [H,N], s0/sT [B,H,N,N] contiguous; s0 may be null.
template <int N, typename T>
__global__ void __launch_bounds__(N)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ y, float* __restrict__ sT, int H, int Tn,
                  long long sb, long long sh, long long st, long long yb,
                  long long yh, long long yt) {
  extern __shared__ float smem[];
  float* sr = smem;                 // [kRun][N] r
  float* sk = sr + kRun * N;        // k
  float* sw = sk + kRun * N;        // w
  float* sv = sw + kRun * N;        // v
  float* sb_ = sv + kRun * N;       // r*u*k
  float* su = sb_ + kRun * N;       // [N] u of this head
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int m = threadIdx.x;
  const T* rp = r + b * sb + h * sh;
  const T* kp = k + b * sb + h * sh;
  const T* vp = v + b * sb + h * sh;
  const T* wp = w + b * sb + h * sh;
  T* yp = y + b * yb + h * yh;

  float S[N];
#pragma unroll
  for (int n = 0; n < N; ++n)
    S[n] = s0 ? s0[((size_t)bh * N + n) * N + m] : 0.f;
  su[m] = u[h * N + m];

  for (int t0 = 0; t0 < Tn; t0 += kRun) {
    const int run = min(kRun, Tn - t0);
    __syncthreads();       // su is written; the last run's readers are done
    for (int i = m; i < run * N; i += N) {
      const int tt = i / N, n = i - tt * N;
      const long long off = (long long)(t0 + tt) * st + n;
      const float rv = to_f32(rp[off]), kv = to_f32(kp[off]);
      sr[i] = rv;
      sk[i] = kv;
      sw[i] = to_f32(wp[off]);
      sv[i] = to_f32(vp[off]);
      sb_[i] = rv * su[n] * kv;
    }
    __syncthreads();
    for (int tt = 0; tt < run; ++tt) {
      const float* rr = sr + tt * N;
      const float* kk = sk + tt * N;
      const float* ww = sw + tt * N;
      const float* bb = sb_ + tt * N;
      const float vm = sv[tt * N + m];
      float acc = 0.f, bonus = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        acc = fmaf(rr[n], S[n], acc);
        bonus += bb[n];
        S[n] = fmaf(ww[n], S[n], kk[n] * vm);
      }
      yp[(long long)(t0 + tt) * yt + m] = from_f32<T>(fmaf(bonus, vm, acc));
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) sT[((size_t)bh * N + n) * N + m] = S[n];
}

template <int N, typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* sT, int B, int H,
           int Tn, long long sb, long long sh, long long st, long long yb,
           long long yh, long long yt, cudaStream_t stream) {
  auto kern = rwkv6_scan_kernel<N, T>;
  const int smem = (5 * kRun + 1) * N * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * H, N, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u,
      (const float*)s0, (T*)y, (float*)sT, H, Tn, sb, sh, st, yb, yh, yt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(int N, const void* r, const void* k, const void* v,
             const void* w, const void* u, const void* s0, void* y, void* sT,
             int B, int H, int Tn, long long sb, long long sh, long long st,
             long long yb, long long yh, long long yt, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<16, T>(r, k, v, w, u, s0, y, sT, B, H, Tn, sb,
                                  sh, st, yb, yh, yt, stream);
    case 32: return launch<32, T>(r, k, v, w, u, s0, y, sT, B, H, Tn, sb,
                                  sh, st, yb, yh, yt, stream);
    case 64: return launch<64, T>(r, k, v, w, u, s0, y, sT, B, H, Tn, sb,
                                  sh, st, yb, yh, yt, stream);
    case 128: return launch<128, T>(r, k, v, w, u, s0, y, sT, B, H, Tn, sb,
                                    sh, st, yb, yh, yt, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, w [B,H,T,N] in f32 (dtype 0) or bf16 (dtype 1), element strides
// (sb, sh, st), unit stride along N; u [H,N] f32; s0 [B,H,N,N] f32 or null;
// y [B,H,T,N] in the inputs' dtype with strides (yb, yh, yt); sT [B,H,N,N]
// f32.  N in {16, 32, 64, 128}.  Returns the launch's cudaError_t.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* y, void* sT, int B, int H, int Tn,
                                 int N, int dtype, long long sb, long long sh,
                                 long long st, long long yb, long long yh,
                                 long long yt, void* stream) {
  if (B * H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_n<float>(N, r, k, v, w, u, s0, y, sT, B, H, Tn, sb, sh, st,
                           yb, yh, yt, s);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(N, r, k, v, w, u, s0, y, sT, B, H, Tn, sb,
                                   sh, st, yb, yh, yt, s);
  return (int)cudaErrorInvalidValue;
}
