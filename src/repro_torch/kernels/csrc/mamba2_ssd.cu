// Mamba2 SSD scan for Hopper: the exact recurrence, per (batch, head),
//     h <- exp(dt_t a) h + (dt_t x_t) B_t^T,   y_t = h C_t + D x_t,
// with h a [P,N] f32 state (head channel p, state channel n); B and C are
// shared by all heads (one group).
//
// Replaces `_kernel` / `mamba2_pallas`
// (src/repro/kernels/mamba2_ssd/mamba2_ssd.py:17 / :52).  The TPU kernel
// walks chunks of Q tokens on a sequential grid axis with h in VMEM and
// turns each chunk into a decay-masked [Q,Q] attention plus two MXU
// matmuls.  Here row p of h evolves on its own,
//     h[p,:] <- exp(dt a) h[p,:] + dt x[p] B,   y[p] = h[p,:] . C + D x[p],
// so one block per (b, h) runs one thread per head channel p, which holds
// row p of h (N floats) in registers, and the dot product with C is local
// to the thread.  A loop over T inside the block replaces the sequential
// grid axis.  B, C, dt and exp(dt a) of a run of tokens are shared by all
// threads (B and C by all heads too), so they are staged in shared memory
// as f32, exp(dt a) computed once per token; every thread then reads them
// by broadcast.  The D skip is added in f32 and y rounded once, as
// `mamba2_ref` does.
//
// Bound: operations.  Per token and head the function reads P inputs of x
// and one dt (B and C are shared by all H heads) and writes P outputs, but
// does about 5PN f32 operations: about 80 per byte at P = N = 64, far above
// the H100's f32 ridge of 20 per byte.  This first kernel does not reach
// that bound: B*H blocks of P threads fill few of the card's warp slots,
// and each thread's dot product with C is one dependent FMA chain per
// token.  A chunked tensor-core form (the SSD's own matmul structure) is
// later work.
//
// f32 inside; y is written in x's dtype, hT in f32.  Any T.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

struct Strides {
  long long xb, xh, xt;   // x [B,H,T,P], unit stride along P
  long long db, dh, dt;   // dt [B,H,T]
  long long cb, ct;       // B and C [B,T,N], unit stride along N
  long long yb, yh, yt;   // y [B,H,T,P], unit stride along P
};
static_assert(sizeof(Strides) == 11 * sizeof(long long), "packed strides");

// One block per (b, h), blockDim.x == P.  a, d [H] f32; h0/hT [B,H,P,N]
// contiguous f32; h0 may be null.
template <int N, typename T>
__global__ void mamba2_ssd_kernel(const T* __restrict__ x,
                                  const float* __restrict__ dt,
                                  const float* __restrict__ a,
                                  const T* __restrict__ bm,
                                  const T* __restrict__ c,
                                  const float* __restrict__ d,
                                  const float* __restrict__ h0,
                                  T* __restrict__ y, float* __restrict__ hT,
                                  int H, int Tn, int P, Strides s) {
  extern __shared__ float smem[];
  float* sB = smem;                 // [kRun][N]
  float* sC = sB + kRun * N;        // [kRun][N]
  float* sdt = sC + kRun * N;       // [kRun] dt
  float* sdec = sdt + kRun;         // [kRun] exp(dt a)
  float* sx = sdec + kRun;          // [kRun][P]
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int p = threadIdx.x;
  const T* xp = x + b * s.xb + h * s.xh;
  const float* dtp = dt + b * s.db + h * s.dh;
  const T* bp = bm + b * s.cb;
  const T* cp = c + b * s.cb;
  T* yp = y + b * s.yb + h * s.yh;
  const float ah = a[h], dh = d[h];

  float hs[N];
#pragma unroll
  for (int n = 0; n < N; ++n)
    hs[n] = h0 ? h0[((size_t)bh * P + p) * N + n] : 0.f;

  for (int t0 = 0; t0 < Tn; t0 += kRun) {
    const int run = min(kRun, Tn - t0);
    __syncthreads();                      // the last run's readers are done
    for (int i = p; i < run * N; i += P) {
      const int tt = i / N, n = i - tt * N;
      const long long off = (long long)(t0 + tt) * s.ct + n;
      sB[i] = to_f32(bp[off]);
      sC[i] = to_f32(cp[off]);
    }
    for (int i = p; i < run; i += P) {
      const float dv = dtp[(long long)(t0 + i) * s.dt];
      sdt[i] = dv;
      sdec[i] = expf(dv * ah);
    }
    for (int tt = 0; tt < run; ++tt)
      sx[tt * P + p] = to_f32(xp[(long long)(t0 + tt) * s.xt + p]);
    __syncthreads();
    for (int tt = 0; tt < run; ++tt) {
      const float* bb = sB + tt * N;
      const float* cc = sC + tt * N;
      const float xv = sx[tt * P + p];
      const float xd = sdt[tt] * xv, dec = sdec[tt];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        hs[n] = fmaf(hs[n], dec, xd * bb[n]);
        acc = fmaf(hs[n], cc[n], acc);
      }
      yp[(long long)(t0 + tt) * s.yt + p] = from_f32<T>(acc + dh * xv);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) hT[((size_t)bh * P + p) * N + n] = hs[n];
}

template <int N, typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* c, const void* d, const void* h0, void* y, void* hT,
           int B, int H, int Tn, int P, const Strides& s,
           cudaStream_t stream) {
  auto kern = mamba2_ssd_kernel<N, T>;
  const int smem = (kRun * (2 * N + 2 + P)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * H, P, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)bm,
      (const T*)c, (const float*)d, (const float*)h0, (T*)y, (float*)hT, H,
      Tn, P, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(int N, const void* x, const void* dt, const void* a,
             const void* bm, const void* c, const void* d, const void* h0,
             void* y, void* hT, int B, int H, int Tn, int P,
             const Strides& s, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<16, T>(x, dt, a, bm, c, d, h0, y, hT, B, H, Tn,
                                  P, s, stream);
    case 32: return launch<32, T>(x, dt, a, bm, c, d, h0, y, hT, B, H, Tn,
                                  P, s, stream);
    case 64: return launch<64, T>(x, dt, a, bm, c, d, h0, y, hT, B, H, Tn,
                                  P, s, stream);
    case 128: return launch<128, T>(x, dt, a, bm, c, d, h0, y, hT, B, H, Tn,
                                    P, s, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B,H,T,P] and B/C [B,T,N] in f32 (dtype 0) or bf16 (dtype 1); dt
// [B,H,T] f32; a, d [H] f32; h0 [B,H,P,N] f32 or null; y [B,H,T,P] in x's
// dtype; hT [B,H,P,N] f32.  Element strides in `strides`, in the order of
// the Strides struct (11 values).  N in {16, 32, 64, 128}, P <= 1024.
// Returns the launch's cudaError_t.
extern "C" int mamba2_ssd_launch(const void* x, const void* dt, const void* a,
                                 const void* bm, const void* c, const void* d,
                                 const void* h0, void* y, void* hT, int B,
                                 int H, int Tn, int P, int N, int dtype,
                                 const long long* strides, void* stream) {
  if (B * H == 0) return 0;
  if (P < 1 || P > 1024) return (int)cudaErrorInvalidValue;
  Strides s;
  memcpy(&s, strides, sizeof(s));
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_n<float>(N, x, dt, a, bm, c, d, h0, y, hT, B, H, Tn, P, s,
                           st);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(N, x, dt, a, bm, c, d, h0, y, hT, B, H,
                                   Tn, P, s, st);
  return (int)cudaErrorInvalidValue;
}
