// Mamba2 SSD scan, backward, for Hopper.  The forward (csrc/mamba2_ssd.cu)
// is, per (batch, head), with h a [P,N] f32 state (P = head dim, N =
// d_state) and a_t = exp(dt_t A):
//     h_t = a_t h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t,
// B and C shared by the heads.  With G_t the adjoint of h_t, carried back
// as G_t = dy_t C_t^T + a_{t+1} G_{t+1} from dhT (or 0):
//     dx_t = dt_t G_t B_t + D dy_t
//     ddt_t = x_t^T G_t B_t + A a_t <G_t, h_{t-1}>
//     dA = sum dt_t a_t <G_t, h_{t-1}>,   dD = sum <dy_t, x_t>
//     dB_t = sum_heads dt_t G_t^T x_t,    dC_t = sum_heads h_t^T dy_t
//     dh0 = a_1 G_1.
// f32 inside; dx, dB, dC are written in the inputs' dtype, ddt, dA, dD and
// dh0 in f32.  Any T (0 included).
//
// Replaces no Pallas kernel: the reference differentiates its jnp scans
// (src/repro/kernels/mamba2_ssd/ref.py `mamba2_ref`, and `mamba2_chunked`,
// its training path) with jax autodiff.  This is the backward of
// `mamba2_ssd_*_kernel`, so that a training step on the card reaches the
// Mamba2 blocks' projections.
//
// Design (simple and right; the chunked tensor-core form is later work):
// - Every element (p, n) of h and of G runs its own recurrence with
//   per-token scalars; the sums couple them along n (dx, and the two dots
//   of ddt) or along p (dB, dC).  So one block per (b, h) has two groups:
//   group A, thread p, keeps row p of G (and of h while it recomputes the
//   states) and sums along n in registers; group B, thread n, keeps column
//   n of G (and of h) and sums along p.  The two copies run the same fmaf
//   on the same operands, so they hold the same bits.
// - The walk back needs h_{t-1} (group A) and h_t (group B).  They are
//   recomputed, not undone: a forward pass writes h at the start of every
//   chunk of L tokens (`ckpt`), and each chunk, walked in reverse order,
//   first recomputes its states from its checkpoint into per-block global
//   scratch, each group in the layout its own loads coalesce in
//   (`states_a` [L][n][p], `states_b` [L][p][n]).  A chunk's inputs (x,
//   dy, B, C, dt and a) are staged in shared memory as f32.
// - Sums across threads, heads or batch rows are never atomic: ddt's two
//   dots over p go through shared memory, summed in order of p by one
//   thread a token; dA and dD are per-block partials; dB and dC are
//   per-(b, h) partials [T, N], and a second kernel sums them over the
//   heads in order (and a third dA and dD over b).  Every output element
//   has one writer: the result is the same bit for bit from run to run.
// Bound: per token and head the function reads x, dy and writes dx (and
// dt, ddt, and B, C, dB, dC once for all heads).  In bf16 its work, in
// the chunked form on the tensor cores (twice the forward's products),
// takes less time than those bytes: the function is bound by bytes.  In
// f32 it is about 14 P N flops on the CUDA cores (the states once, 3PN,
// and the walk back's G update and sums, 11PN), past the bytes.  This
// kernel runs the exact recurrence in f32 for both dtypes, about 24 P N
// (the states three times, G twice), and what holds it far above either
// bound is the sequential walk of one block per (b, h) of P + N threads,
// each with a chain of N or P dependent FMAs a token.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int L = 32;   // tokens a chunk: the checkpoint interval

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Bwd {
  const void* x;       // [B,H,T,P]
  const float* dt;     // [B,H,T]
  const float* a;      // [H]
  const void* bm;      // [B,T,N]
  const void* c;
  const float* d;      // [H]
  const void* dy;      // [B,H,T,P]
  const float* h0;     // [B,H,P,N] or null
  const float* dhT;    // [B,H,P,N] or null
  void* dx;
  float* ddt;
  float* dh0;          // or null
  float* db_part;      // [B*H, T, N]
  float* dc_part;
  float* da_part;      // [B*H]
  float* dd_part;
  float* ckpt;         // [B*H, NC, N, P]
  float* states_a;     // [B*H, L, N, P]  h_{t-1}
  float* states_b;     // [B*H, L, P, N]  h_t
  int H, T;
  long long xb, xh, xt;   // x (unit along P)
  long long db, dh, dtt;  // dt
  long long bb, bt;       // B and C (unit along N)
  long long gb, gh, gt;   // dy (unit along P)
  long long ob, oh, ot;   // dx
  long long eb, eh, et;   // ddt
};

template <typename T, int W>
__device__ __forceinline__ void stage(float* sm, const T* p, long long stride,
                                      int t0, int len, int nthreads) {
  for (int i = threadIdx.x; i < len * W; i += nthreads) {
    const int tt = i / W, j = i - tt * W;
    sm[i] = ld(p + (long long)(t0 + tt) * stride + j);
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(P + N)
mamba2_ssd_bwd_kernel(Bwd q) {
  constexpr int NT = P + N;
  extern __shared__ float smem[];
  float* sx = smem;            // [L][P]
  float* sdy = sx + L * P;     // [L][P]
  float* sB = sdy + L * P;     // [L][N]
  float* sC = sB + L * N;      // [L][N]
  float* srho = sC + L * N;    // [L][P] x_p (G B)_p
  float* ssig = srho + L * P;  // [L][P] <G_p, h_{t-1,p}>
  float* sdt = ssig + L * P;   // [L]
  float* sa = sdt + L;         // [L] exp(dt A)
  float* sda = sa + L;         // [L] dt a <G, h_{t-1}>
  float* sdd = sda + L;        // [P] dD partials of group A
  const int bh = blockIdx.x;
  const int b = bh / q.H, h = bh - b * q.H;
  const int tid = threadIdx.x;
  const bool row = tid < P;    // group A (row p = tid) or B (column n)
  const int me = row ? tid : tid - P;
  const T* xp = (const T*)q.x + b * q.xb + h * q.xh;
  const T* gp = (const T*)q.dy + b * q.gb + h * q.gh;
  const T* bp = (const T*)q.bm + b * q.bb;
  const T* cp = (const T*)q.c + b * q.bb;
  const float* dtp = q.dt + b * q.db + h * q.dh;
  const float A = q.a[h], D = q.d[h];
  const int nc = (q.T + L - 1) / L;
  float* ck = q.ckpt + (size_t)bh * nc * N * P;
  float* sta = q.states_a + (size_t)bh * L * N * P;
  float* stb = q.states_b + (size_t)bh * L * P * N;

  // 1. the forward, state rows in registers: h at every chunk's start
  float S[P > N ? P : N];      // A: h[me][0..N); B: h[0..P)[me]
#pragma unroll
  for (int j = 0; j < N; ++j)
    S[j] = (row && q.h0) ? q.h0[((size_t)bh * P + me) * N + j] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L, len = min(L, q.T - t0);
    __syncthreads();
    stage<T, P>(sx, xp, q.xt, t0, len, NT);
    stage<T, N>(sB, bp, q.bt, t0, len, NT);
    for (int tt = tid; tt < len; tt += NT) {
      const float dtv = dtp[(long long)(t0 + tt) * q.dtt];
      sdt[tt] = dtv;
      sa[tt] = expf(dtv * A);
    }
    __syncthreads();
    if (row) {
#pragma unroll
      for (int j = 0; j < N; ++j) ck[((size_t)c * N + j) * P + me] = S[j];
      for (int tt = 0; tt < len; ++tt) {
        const float at = sa[tt], xd = sdt[tt] * sx[tt * P + me];
#pragma unroll
        for (int j = 0; j < N; ++j) S[j] = fmaf(at, S[j], xd * sB[tt * N + j]);
      }
    }
  }

  // 2. the walk back, chunk by chunk from the last
  constexpr int GW = P > N ? P : N;
  float G[GW];                 // A: G[me][0..N); B: G[0..P)[me]
#pragma unroll
  for (int j = 0; j < GW; ++j) {
    float g = 0.f;
    if (q.dhT) {
      if (row && j < N) g = q.dhT[((size_t)bh * P + me) * N + j];
      if (!row && j < P) g = q.dhT[((size_t)bh * P + j) * N + me];
    }
    G[j] = g;
  }
  float dd_acc = 0.f, da_acc = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L, len = min(L, q.T - t0);
    __syncthreads();
    stage<T, P>(sx, xp, q.xt, t0, len, NT);
    stage<T, P>(sdy, gp, q.gt, t0, len, NT);
    stage<T, N>(sB, bp, q.bt, t0, len, NT);
    stage<T, N>(sC, cp, q.bt, t0, len, NT);
    for (int tt = tid; tt < len; tt += NT) {
      const float dtv = dtp[(long long)(t0 + tt) * q.dtt];
      sdt[tt] = dtv;
      sa[tt] = expf(dtv * A);
    }
    __syncthreads();
    // the chunk's states, recomputed from its checkpoint: group A keeps
    // h_{t-1} by rows, group B h_t by columns
    if (row) {
#pragma unroll
      for (int j = 0; j < N; ++j) S[j] = ck[((size_t)c * N + j) * P + me];
      for (int tt = 0; tt < len; ++tt) {
        const float at = sa[tt], xd = sdt[tt] * sx[tt * P + me];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          sta[((size_t)tt * N + j) * P + me] = S[j];
          S[j] = fmaf(at, S[j], xd * sB[tt * N + j]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) S[j] = ck[((size_t)c * N + me) * P + j];
      for (int tt = 0; tt < len; ++tt) {
        const float at = sa[tt], dtv = sdt[tt], bn = sB[tt * N + me];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          S[j] = fmaf(at, S[j], (dtv * sx[tt * P + j]) * bn);
          stb[((size_t)tt * P + j) * N + me] = S[j];
        }
      }
    }
    for (int tt = len - 1; tt >= 0; --tt) {
      const long long t = t0 + tt;
      const float at = sa[tt], dtv = sdt[tt];
      const float* dyt = sdy + tt * P;
      const float* xt = sx + tt * P;
      if (row) {
        const float* bt = sB + tt * N;
        const float* ct = sC + tt * N;
        const float dyp = dyt[me], xv = xt[me];
        float gbv = 0.f, sig = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float g = fmaf(dyp, ct[j], G[j]);
          gbv = fmaf(g, bt[j], gbv);
          sig = fmaf(g, sta[((size_t)tt * N + j) * P + me], sig);
          G[j] = at * g;
        }
        put((T*)q.dx + b * q.ob + h * q.oh + t * q.ot + me,
            fmaf(dtv, gbv, D * dyp));
        srho[tt * P + me] = xv * gbv;
        ssig[tt * P + me] = sig;
        dd_acc = fmaf(dyp, xv, dd_acc);
      } else {
        const float cn = sC[tt * N + me];
        float dbv = 0.f, dcv = 0.f;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float g = fmaf(dyt[j], cn, G[j]);
          dbv = fmaf(g, xt[j], dbv);
          dcv = fmaf(stb[((size_t)tt * P + j) * N + me], dyt[j], dcv);
          G[j] = at * g;
        }
        const size_t o = ((size_t)bh * q.T + t) * N + me;
        q.db_part[o] = dtv * dbv;
        q.dc_part[o] = dcv;
      }
    }
    __syncthreads();           // srho, ssig
    for (int tt = tid; tt < len; tt += NT) {
      float rho = 0.f, sig = 0.f;
      for (int j = 0; j < P; ++j) {
        rho += srho[tt * P + j];
        sig += ssig[tt * P + j];
      }
      const float as = sa[tt] * sig;
      q.ddt[b * q.eb + h * q.eh + (long long)(t0 + tt) * q.et] =
          fmaf(A, as, rho);
      sda[tt] = sdt[tt] * as;
    }
    __syncthreads();           // sda
    if (tid == 0)
      for (int tt = len - 1; tt >= 0; --tt) da_acc += sda[tt];
  }
  if (row) sdd[me] = dd_acc;
  if (!row && q.dh0) {
#pragma unroll
    for (int j = 0; j < P; ++j) q.dh0[((size_t)bh * P + j) * N + me] = G[j];
  }
  __syncthreads();
  if (tid == 0) {
    float dd = 0.f;
    for (int j = 0; j < P; ++j) dd += sdd[j];
    q.dd_part[bh] = dd;
    q.da_part[bh] = da_acc;
  }
}

// dB[b,t,n] and dC[b,t,n] = the per-head partials summed over h in order;
// one block per (b, t), one thread per n
template <typename T>
__global__ void mamba2_ssd_bwd_bc_kernel(const float* __restrict__ db_part,
                                         const float* __restrict__ dc_part,
                                         T* __restrict__ dbm,
                                         T* __restrict__ dc, int H, int Tn,
                                         int N) {
  const int bt = blockIdx.x, b = bt / Tn, t = bt - b * Tn;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      const size_t o = (((size_t)b * H + h) * Tn + t) * N + n;
      sb += db_part[o];
      sc += dc_part[o];
    }
    put(dbm + (size_t)bt * N + n, sb);
    put(dc + (size_t)bt * N + n, sc);
  }
}

// dA[h] and dD[h] = the per-(b, h) partials summed over b in order
__global__ void mamba2_ssd_bwd_heads_kernel(const float* __restrict__ da_part,
                                            const float* __restrict__ dd_part,
                                            float* __restrict__ da,
                                            float* __restrict__ dd, int B,
                                            int H) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float sa = 0.f, sd = 0.f;
    for (int b = 0; b < B; ++b) {
      sa += da_part[b * H + h];
      sd += dd_part[b * H + h];
    }
    da[h] = sa;
    dd[h] = sd;
  }
}

template <typename T, int P, int N>
int launch(const Bwd& q, int B, void* dbm, void* dc, float* da, float* dd,
           cudaStream_t stream) {
  auto kern = mamba2_ssd_bwd_kernel<T, P, N>;
  const int smem = (int)sizeof(float) * (4 * L * P + 2 * L * N + 3 * L + P);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * q.H, P + N, smem, stream>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (B * q.T > 0) {
    mamba2_ssd_bwd_bc_kernel<T><<<B * q.T, N, 0, stream>>>(
        q.db_part, q.dc_part, (T*)dbm, (T*)dc, q.H, q.T, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  mamba2_ssd_bwd_heads_kernel<<<1, 128, 0, stream>>>(q.da_part, q.dd_part,
                                                     da, dd, B, q.H);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int dispatch_n(const Bwd& q, int B, int N, void* dbm, void* dc, float* da,
               float* dd, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, P, 16>(q, B, dbm, dc, da, dd, s);
    case 32: return launch<T, P, 32>(q, B, dbm, dc, da, dd, s);
    case 64: return launch<T, P, 64>(q, B, dbm, dc, da, dd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_p(const Bwd& q, int B, int P, int N, void* dbm, void* dc,
               float* da, float* dd, cudaStream_t s) {
  switch (P) {
    case 16: return dispatch_n<T, 16>(q, B, N, dbm, dc, da, dd, s);
    case 32: return dispatch_n<T, 32>(q, B, N, dbm, dc, da, dd, s);
    case 64: return dispatch_n<T, 64>(q, B, N, dbm, dc, da, dd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The chunk length of the checkpoints, for the wrapper's scratch.
extern "C" int mamba2_ssd_bwd_chunk() { return L; }

// x, dy [B,H,T,P] in f32 (dtype 0) or bf16 (dtype 1), unit stride along P;
// dt [B,H,T] f32; a, d [H] f32; bm, c [B,T,N] in x's dtype with shared
// strides, unit along N; h0, dhT [B,H,P,N] f32 or null.  Writes dx (x's
// dtype), ddt (f32, strides of its own), dbm and dc ([B,T,N] contiguous, x's
// dtype), da, dd [H] f32 and, if not null, dh0 [B,H,P,N] f32.  Scratch:
// ckpt [B*H, ceil(T/L), N, P], states_a [B*H, L, N, P], states_b [B*H, L,
// P, N], db_part and dc_part [B*H, T, N], da_part and dd_part [B*H], all
// f32.  P and N in {16, 32, 64} (a thread keeps a row or a column of G and
// of h in registers: at 128, 512 floats, it would spill).  strides: x (3), dt (3), B/C (2), dy
// (3), dx (3), ddt (3).  Three kernels; returns the first failing launch's
// cudaError_t.
extern "C" int mamba2_ssd_bwd_launch(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* c, const void* d, const void* dy, const void* h0,
    const void* dhT, void* dx, void* ddt, void* da, void* dbm, void* dc,
    void* dd, void* dh0, void* ckpt, void* states_a, void* states_b,
    void* db_part, void* dc_part, void* da_part, void* dd_part, int B, int H,
    int Tn, int P, int N, int dtype, const long long* strides,
    void* stream) {
  if (B * H == 0) return 0;
  Bwd q;
  q.x = x;
  q.dt = (const float*)dt;
  q.a = (const float*)a;
  q.bm = bm;
  q.c = c;
  q.d = (const float*)d;
  q.dy = dy;
  q.h0 = (const float*)h0;
  q.dhT = (const float*)dhT;
  q.dx = dx;
  q.ddt = (float*)ddt;
  q.dh0 = (float*)dh0;
  q.db_part = (float*)db_part;
  q.dc_part = (float*)dc_part;
  q.da_part = (float*)da_part;
  q.dd_part = (float*)dd_part;
  q.ckpt = (float*)ckpt;
  q.states_a = (float*)states_a;
  q.states_b = (float*)states_b;
  q.H = H;
  q.T = Tn;
  q.xb = strides[0];
  q.xh = strides[1];
  q.xt = strides[2];
  q.db = strides[3];
  q.dh = strides[4];
  q.dtt = strides[5];
  q.bb = strides[6];
  q.bt = strides[7];
  q.gb = strides[8];
  q.gh = strides[9];
  q.gt = strides[10];
  q.ob = strides[11];
  q.oh = strides[12];
  q.ot = strides[13];
  q.eb = strides[14];
  q.eh = strides[15];
  q.et = strides[16];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_p<float>(q, B, P, N, dbm, dc, (float*)da, (float*)dd, s);
  if (dtype == 1)
    return dispatch_p<bf16>(q, B, P, N, dbm, dc, (float*)da, (float*)dd, s);
  return (int)cudaErrorInvalidValue;
}
