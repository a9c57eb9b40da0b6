// Flash attention for Hopper: a blocked online-softmax forward that also
// writes each row's log-sum-exp, and a backward that recomputes the
// probabilities tile by tile.
//
// The forward replaces `_kernel` / `flash_attention_pallas`
// (src/repro/kernels/flash_attention/flash_attention.py:22 / :58).  The TPU
// kernel keeps a (bq x hd) query tile and the whole K and V of its head in
// VMEM and walks KV tiles on a loop with the (m, l, acc) carry; it asserts
// Sq % bq == 0 and Sk % bk == 0.  Here one block of 256 threads owns 64
// query rows of one (batch, head) and loops over 64-row KV tiles staged in
// shared memory as f32, so the carry lives in registers and shared memory
// and any Sq, Sk works: rows and keys past the end load as zeros and are
// masked.  The reference has no backward kernel (JAX differentiates its
// chunked jnp form); the backward here is the usual recomputing one, in
// three launches: delta_i = sum_d dO·O per row, then dK and dV with one
// block per KV tile (a single writer per row: it loops over the query
// tiles that see the tile), then dQ with one block per query tile (a
// single writer: it loops over the KV tiles), so no atomics are used and
// the gradients are the same bits in every run.
//
// Numerics follow the plain version (models/attention.py
// chunked_attention): q is scaled by 1/sqrt(hd) and rounded to its dtype,
// logits, the softmax statistics and accumulators are f32, the
// probabilities are rounded to V's dtype where they meet V (and dO, for
// dV), and the output is rounded once to q's dtype.  The straight-through
// gradient of q's rounding is the scale, so dq = scale * dS K.
//
// Masks: key j of query row i (absolute position q_offset + i) is visible
// when j < Sk, i < Sq, (not causal or j <= q_offset + i) and (window <= 0
// or j > q_offset + i - window).  Tiles that no row of the block can see
// are skipped.
//
// Layout: q, o [B,Sq,H,hd], k, v [B,Sk,H,hd] contiguous (the model's
// layout, so no transpose is made on either side); lse and delta
// [B,H,Sq] f32.  hd <= 128: tiles hold 64 or 128 columns, zero-padded.
//
// Bound: at training shapes (Sq = Sk = 1024, hd 64, causal) the function
// does about 2·Sq·Sk·hd f32 operations per head in the forward and 5 in
// the backward against 8·S·hd bytes, far above the ridge, so it is bound
// by operations.  This first kernel runs them as f32 FMAs out of shared
// memory (4x4 register tiles), not on the tensor cores; mma/wgmma tiles
// with K and V kept in bf16 are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // key rows per tile
constexpr int NT = 256;           // threads per block
constexpr int SLD = BK + 1;       // row stride of a [BQ, BK] score tile
constexpr float NEG_INF = -1e30f;

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
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct Shape {
  int B, H, Sq, Sk, hd, causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ bool visible(const Shape& p, int i, int j) {
  if (i >= p.Sq || j >= p.Sk) return false;
  const int qpos = p.q_offset + i;
  if (p.causal && j > qpos) return false;
  if (p.window > 0 && j <= qpos - p.window) return false;
  return true;
}

// rows [row0, row0 + 64) of one head of a [B,S,H,hd] tensor into a
// [64, HDP+1] f32 tile; with SCALE the values are multiplied by p.scale
// and rounded to T (the plain version's scaled q)
template <typename T, int HDP, bool SCALE>
__device__ __forceinline__ void load_tile(float* dst, const T* head, int row0,
                                          int S, const Shape& p) {
  const size_t stride = (size_t)p.H * p.hd;
  for (int i = threadIdx.x; i < 64 * HDP; i += NT) {
    const int r = i / HDP, d = i % HDP, s = row0 + r;
    float x = 0.f;
    if (s < S && d < p.hd) {
      x = to_f32(head[(size_t)s * stride + d]);
      if (SCALE) x = round_to<T>(x * p.scale);
    }
    dst[r * (HDP + 1) + d] = x;
  }
}

// range of KV tiles a query tile starting at q0 can see: [lo, hi)
__device__ __forceinline__ void key_range(const Shape& p, int q0, int* lo,
                                          int* hi) {
  int k_lo = 0, k_hi = p.Sk;
  if (p.window > 0) k_lo = max(0, p.q_offset + q0 - p.window + 1);
  if (p.causal) k_hi = min(p.Sk, p.q_offset + q0 + BQ);
  *lo = (k_lo / BK) * BK;
  *hi = k_hi;
}

// 4x4 register tile of A·B^T over HDP columns: rows tr + 16 i of A, rows
// tc + 16 j of B
template <int HDP>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm,
                                         int tr, int tc, float out[4][4]) {
  constexpr int LD = HDP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
  for (int d = 0; d < HDP; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(tr + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tc + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(a[i], b[j], out[i][j]);
  }
}

template <int HDP>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (HDP + 1) + BQ * SLD +
                          2 * BQ);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Shape p) {
  constexpr int LD = HDP + 1, NC = HDP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ss = Vs + BK * LD;
  float* corr_s = Ss + BQ * SLD;
  float* l_s = corr_s + BQ;

  const int tid = threadIdx.x, q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const size_t stride = (size_t)p.H * p.hd;
  const T* qh = q + ((size_t)b * p.Sq * p.H + h) * p.hd;
  const T* kh = k + ((size_t)b * p.Sk * p.H + h) * p.hd;
  const T* vh = v + ((size_t)b * p.Sk * p.H + h) * p.hd;
  T* oh = o + ((size_t)b * p.Sq * p.H + h) * p.hd;

  load_tile<T, HDP, true>(Qs, qh, q0, p.Sq, p);
  // tile mapping: rows tr + 16 i, columns tc + 16 j; softmax mapping: row
  // sr, columns sp + 4 c (the four threads of a row hold equal m and l)
  const int tr = tid >> 4, tc = tid & 15, sr = tid >> 2, sp = tid & 3;
  float m_run = NEG_INF, l_run = 0.f;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  int k_begin, k_end;
  key_range(p, q0, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();            // the last tile's readers are done
    load_tile<T, HDP, false>(Ks, kh, k0, p.Sk, p);
    load_tile<T, HDP, false>(Vs, vh, k0, p.Sk, p);
    __syncthreads();
    float s[4][4];
    dot_tile<HDP>(Qs, Ks, tr, tc, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tr + 16 * i, c = tc + 16 * j;
        Ss[r * SLD + c] = visible(p, q0 + r, k0 + c) ? s[i][j] : NEG_INF;
      }
    __syncthreads();
    {
      float mx = NEG_INF;
      for (int c = sp; c < BK; c += 4) mx = fmaxf(mx, Ss[sr * SLD + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
      for (int c = sp; c < BK; c += 4) {
        const float x = Ss[sr * SLD + c];
        const float e = x > NEG_INF ? expf(x - m_new) : 0.f;
        Ss[sr * SLD + c] = round_to<T>(e);   // p meets V in V's dtype
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = expf(m_run - m_new);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if (sp == 0) corr_s[sr] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cr = corr_s[tr + 16 * i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= cr;
    }
    for (int j = 0; j < BK; ++j) {
      float pr[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ss[(tr + 16 * i) * SLD + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * LD + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
  }
  if (sp == 0) {
    l_s[sr] = l_run;
    if (q0 + sr < p.Sq)
      lse[(size_t)bh * p.Sq + q0 + sr] =
          l_run > 0.f ? m_run + logf(l_run) : INFINITY;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i, s = q0 + r;
    if (s >= p.Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tc + 16 * c;
      if (d < p.hd) oh[(size_t)s * stride + d] = from_f32<T>(acc[i][c] / l);
    }
  }
}

// delta[b,h,s] = sum_d dO·O, one warp per row
template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o,
                                       const T* __restrict__ dout,
                                       float* __restrict__ delta, Shape p) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= p.B * p.H * p.Sq) return;     // uniform within the warp
  const int s = row % p.Sq, bh = row / p.Sq, b = bh / p.H, h = bh % p.H;
  const size_t off = (((size_t)b * p.Sq + s) * p.H + h) * p.hd;
  float acc = 0.f;
  for (int d = lane; d < p.hd; d += 32)
    acc = fmaf(to_f32(o[off + d]), to_f32(dout[off + d]), acc);
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[row] = acc;
}

template <int HDP>
constexpr size_t bwd_smem() {
  return sizeof(float) * ((size_t)4 * 64 * (HDP + 1) + 2 * BQ * SLD + 2 * BQ);
}

// P (rounded to T, as it met V in the forward) into Ps, if not null, and
// dS into dSs for one (query tile q0, KV tile k0) pair; Qs holds the
// scaled q, dOs dO, Ks/Vs the KV tile, lse_s and d_s the rows'
// log-sum-exp and delta
template <typename T, int HDP>
__device__ __forceinline__ void probs_tile(const Shape& p, int q0, int k0,
                                           const float* Qs, const float* dOs,
                                           const float* Ks, const float* Vs,
                                           const float* lse_s,
                                           const float* d_s, float* Ps,
                                           float* dSs, int tr, int tc) {
  float s[4][4], dp[4][4];
  dot_tile<HDP>(Qs, Ks, tr, tc, s);
  dot_tile<HDP>(dOs, Vs, tr, tc, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tr + 16 * i, c = tc + 16 * j;
      const float pr =
          visible(p, q0 + r, k0 + c) ? expf(s[i][j] - lse_s[r]) : 0.f;
      if (Ps != nullptr) Ps[r * SLD + c] = round_to<T>(pr);
      dSs[r * SLD + c] = pr * (dp[i][j] - d_s[r]);
    }
}

template <int HDP>
__device__ __forceinline__ void load_rows_stats(const Shape& p, int bh,
                                                int q0, const float* lse,
                                                const float* delta,
                                                float* lse_s, float* d_s) {
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int s = q0 + r;
    lse_s[r] = s < p.Sq ? lse[(size_t)bh * p.Sq + s] : 0.f;
    d_s[r] = s < p.Sq ? delta[(size_t)bh * p.Sq + s] : 0.f;
  }
}

// dK, dV of one KV tile: the block loops over the query tiles that see it
template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Shape p) {
  constexpr int LD = HDP + 1, NC = HDP / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * SLD;
  float* lse_s = dSs + BQ * SLD;
  float* d_s = lse_s + BQ;

  const int tid = threadIdx.x, k0 = blockIdx.x * BK, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const size_t stride = (size_t)p.H * p.hd;
  const T* qh = q + ((size_t)b * p.Sq * p.H + h) * p.hd;
  const T* gh = dout + ((size_t)b * p.Sq * p.H + h) * p.hd;
  const size_t koff = ((size_t)b * p.Sk * p.H + h) * p.hd;
  load_tile<T, HDP, false>(Ks, k + koff, k0, p.Sk, p);
  load_tile<T, HDP, false>(Vs, v + koff, k0, p.Sk, p);

  const int tr = tid >> 4, tc = tid & 15;
  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.f;

  // query rows that can see a key of [k0, k0 + BK): absolute position
  // >= k0 (causal) and < k0 + BK - 1 + window (window)
  int q_lo = 0, q_hi = p.Sq;
  if (p.causal) q_lo = max(0, k0 - p.q_offset);
  if (p.window > 0) q_hi = min(p.Sq, k0 + BK - 1 + p.window - p.q_offset);
  for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
    __syncthreads();            // the last tile's readers are done
    load_tile<T, HDP, true>(Qs, qh, q0, p.Sq, p);
    load_tile<T, HDP, false>(dOs, gh, q0, p.Sq, p);
    load_rows_stats<HDP>(p, bh, q0, lse, delta, lse_s, d_s);
    __syncthreads();
    probs_tile<T, HDP>(p, q0, k0, Qs, dOs, Ks, Vs, lse_s, d_s, Ps, dSs, tr,
                       tc);
    __syncthreads();
    // dV[j] += sum_r P[r, j] dO[r];  dK[j] += sum_r dS[r, j] q_s[r]
    for (int r = 0; r < BQ; ++r) {
      float pj[4], sj[4], go[NC], qq[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pj[i] = Ps[r * SLD + tr + 16 * i];
        sj[i] = dSs[r * SLD + tr + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        go[c] = dOs[r * LD + tc + 16 * c];
        qq[c] = Qs[r * LD + tc + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dva[i][c] = fmaf(pj[i], go[c], dva[i][c]);
          dka[i][c] = fmaf(sj[i], qq[c], dka[i][c]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = k0 + tr + 16 * i;
    if (j >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tc + 16 * c;
      if (d < p.hd) {
        dk[koff + (size_t)j * stride + d] = from_f32<T>(dka[i][c]);
        dv[koff + (size_t)j * stride + d] = from_f32<T>(dva[i][c]);
      }
    }
  }
}

// dQ of one query tile: the block loops over the KV tiles it sees
template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Shape p) {
  constexpr int LD = HDP + 1, NC = HDP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* lse_s = dSs + BQ * SLD;
  float* d_s = lse_s + BQ;

  const int tid = threadIdx.x, q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const size_t stride = (size_t)p.H * p.hd;
  const size_t qoff = ((size_t)b * p.Sq * p.H + h) * p.hd;
  const T* kh = k + ((size_t)b * p.Sk * p.H + h) * p.hd;
  const T* vh = v + ((size_t)b * p.Sk * p.H + h) * p.hd;
  load_tile<T, HDP, true>(Qs, q + qoff, q0, p.Sq, p);
  load_tile<T, HDP, false>(dOs, dout + qoff, q0, p.Sq, p);
  load_rows_stats<HDP>(p, bh, q0, lse, delta, lse_s, d_s);

  const int tr = tid >> 4, tc = tid & 15;
  float dqa[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dqa[i][c] = 0.f;

  int k_begin, k_end;
  key_range(p, q0, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<T, HDP, false>(Ks, kh, k0, p.Sk, p);
    load_tile<T, HDP, false>(Vs, vh, k0, p.Sk, p);
    __syncthreads();
    probs_tile<T, HDP>(p, q0, k0, Qs, dOs, Ks, Vs, lse_s, d_s, nullptr, dSs,
                       tr, tc);
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      float ds[4], kk[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(tr + 16 * i) * SLD + c];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) kk[cc] = Ks[c * LD + tc + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          dqa[i][cc] = fmaf(ds[i], kk[cc], dqa[i][cc]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + tr + 16 * i;
    if (s >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tc + 16 * c;
      if (d < p.hd)
        dq[qoff + (size_t)s * stride + d] = from_f32<T>(dqa[i][c] * p.scale);
    }
  }
}

Shape make_shape(int B, int H, int Sq, int Sk, int hd, int causal,
                 int window, int q_offset, float scale) {
  Shape p;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.hd = hd; p.causal = causal;
  p.window = window; p.q_offset = q_offset; p.scale = scale;
  return p;
}

// Allow `kernel` `bytes` of dynamic shared memory (above the default 48 KB),
// once per kernel: the first launch sets it, before any graph capture.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  *done = e == cudaSuccess;
  return e;
}

template <typename T, int HDP>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        const Shape& p, cudaStream_t st) {
  static bool smem_set = false;
  const size_t smem = fwd_smem<HDP>();
  cudaError_t e = allow_smem(flash_fwd_kernel<T, HDP>, smem, &smem_set);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_kernel<T, HDP><<<grid, NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, p);
  return (int)cudaGetLastError();
}

template <typename T, int HDP>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* delta, void* dq, void* dk,
        void* dv, const Shape& p, cudaStream_t st) {
  const int rows = p.B * p.H * p.Sq;
  flash_bwd_delta_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(
      (const T*)o, (const T*)dout, (float*)delta, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  static bool dkdv_set = false, dq_set = false;
  const size_t smem = bwd_smem<HDP>();
  e = allow_smem(flash_bwd_dkdv_kernel<T, HDP>, smem, &dkdv_set);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_bwd_dq_kernel<T, HDP>, smem, &dq_set);
  if (e != cudaSuccess) return (int)e;
  dim3 gk((p.Sk + BK - 1) / BK, p.B * p.H);
  flash_bwd_dkdv_kernel<T, HDP><<<gk, NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gq((p.Sq + BQ - 1) / BQ, p.B * p.H);
  flash_bwd_dq_kernel<T, HDP><<<gq, NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, p);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int hd) {
  return hd < 1 || hd > 128 || B * H > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o share it).  q [B,Sq,H,hd],
// k/v [B,Sk,H,hd] -> o [B,Sq,H,hd], lse [B,H,Sq] f32.  window <= 0 means
// none.  Returns the launch's cudaError_t.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int H, int Sq,
                                int Sk, int hd, int causal, int window,
                                int q_offset, float scale, int dtype,
                                void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (bad_shape(B, H, hd)) return (int)cudaErrorInvalidValue;
  const Shape p = make_shape(B, H, Sq, Sk, hd, causal, window, q_offset,
                             scale);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return hd <= 64 ? fwd<float, 64>(q, k, v, o, lse, p, st)
                    : fwd<float, 128>(q, k, v, o, lse, p, st);
  if (dtype == 1)
    return hd <= 64 ? fwd<__nv_bfloat16, 64>(q, k, v, o, lse, p, st)
                    : fwd<__nv_bfloat16, 128>(q, k, v, o, lse, p, st);
  return (int)cudaErrorInvalidValue;
}

// The backward of flash_fwd_launch: dO [B,Sq,H,hd] and the forward's o and
// lse -> dq [B,Sq,H,hd], dk/dv [B,Sk,H,hd] (every element written; rows
// no query sees get zeros); delta is [B,H,Sq] f32 scratch.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* delta, void* dq,
                                void* dk, void* dv, int B, int H, int Sq,
                                int Sk, int hd, int causal, int window,
                                int q_offset, float scale, int dtype,
                                void* stream) {
  if (B == 0 || H == 0 || (Sq == 0 && Sk == 0)) return 0;
  if (bad_shape(B, H, hd)) return (int)cudaErrorInvalidValue;
  const Shape p = make_shape(B, H, Sq, Sk, hd, causal, window, q_offset,
                             scale);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return hd <= 64
               ? bwd<float, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, st)
               : bwd<float, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, p,
                                 st);
  if (dtype == 1)
    return hd <= 64 ? bwd<__nv_bfloat16, 64>(q, k, v, o, dout, lse, delta, dq,
                                             dk, dv, p, st)
                    : bwd<__nv_bfloat16, 128>(q, k, v, o, dout, lse, delta,
                                              dq, dk, dv, p, st);
  return (int)cudaErrorInvalidValue;
}
