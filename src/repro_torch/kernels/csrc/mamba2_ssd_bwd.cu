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
// bf16 route (the model's): the chunked form on the tensor cores, the
// backward of the forward's three passes (Dao and Gu 2024, section 6; the
// split of mamba_ssm's `ssd_combined` backward).  Chunks of Q = 64 tokens,
// all of them in parallel; la is the cumulative sum of dt A from the
// chunk's start (inclusive), L[t,s] = exp(la_t - la_s) on s <= t, h_in the
// state entering a chunk and G_end the adjoint of the state at its end.
// Inside a chunk
//     h_t = exp(la_t) h_in + sum_{s<=t} L[t,s] dt_s x_s B_s^T,
//     G_t = exp(la_Q - la_t) G_end + sum_{s>=t} L[s,t] dy_s C_s^T,
// so that, with the [Q,Q] tiles C B^T and dy x^T,
//     dx = dt (exp(la_Q - la) B G_end^T + (L . C B^T)^T dy) + D dy
//     dB_h = dt (exp(la_Q - la) x G_end + (L . dy x^T)^T C)
//     dC_h = exp(la) dy h_in + (L . dy x^T . dt_s) B
// and the gradient of step t's log decay dt_t A, a_t <G_t, h_{t-1}>,
// expanded the same way into four terms, none a difference of large ones:
//     dtheta_t = sum_{s>=t} exp(la_s) C_s.(dy_s h_in)
//              + sum_{s>=t} sum_{r<t} Z[s,r]    (Z = L . dt_r . C B^T . dy x^T)
//              + exp(la_Q) <G_end, h_in>
//              + sum_{r<t} exp(la_Q - la_r) dt_r B_r.(x_r G_end),
// ddt_t = x_t.(G_t B_t) + A dtheta_t, dA = sum dt_t dtheta_t.  Per-token
// states are never formed.  Five kernels a call:
//   1. `mamba2_ssd_bwd_state_kernel`, per (b, h, chunk): the chunk's state
//      from zero, (x . dt . exp(la_Q - la))^T B, its decay exp(la_Q), and
//      its local adjoint of h_in, (dy . exp(la))^T C: [P,Q]·[Q,N] products.
//   2. `mamba2_ssd_bwd_pass_kernel`, one thread per 4 state values of a
//      (b, h): the forward's pass 2 (h_in of every chunk from h0), then the
//      same scan run backwards from dhT (G_end of every chunk, and dh0),
//      each written in place of its input as two bf16 pieces.
//   3. `mamba2_ssd_bwd_chunk_kernel`, per (b, h, chunk), warp w owning the
//      chunk's tokens 16 w .. 16 w + 15: dx, ddt, the per-head partials of
//      dB and dC, and the chunk's partials of dA and dD.  The tiles a
//      warp needs, on the key tiles the causal mask leaves it (B C^T and
//      x dy^T on s >= t for dx and dB; dy x^T and C B^T on s <= t for dC
//      and Z), are weighted and cut into the two pieces of A operands in
//      registers; the rectangle sums of Z go through shared memory (rows'
//      exclusive prefix sums, then columns' sums).
//   4. `mamba2_ssd_bwd_bc_kernel` (shared with the f32 route): dB and dC,
//      the per-head partials summed over the heads in order.
//   5. `mamba2_ssd_bwd_heads_kernel` (shared with the f32 route): dA and
//      dD, the per-chunk partials summed over batch rows and chunks in
//      order.
// - Products: `mma.sync.m16n8k16` (bf16 in, f32 accumulators) with
//   operands by `ldmatrix` from XOR-swizzled bf16 tiles, as in
//   csrc/mamba2_ssd.cu.  Every product has one bf16 operand (x, dy, B or
//   C) and at most one computed in f32 (a weighted tile, or a boundary
//   state), which is cut into hi = bf16(v) and lo = bf16(v - hi) and
//   multiplied twice; C B^T and dy x^T are products of bf16 values, exact
//   per term.
// - Copies: x, dy, B and C by `cp.async` (16 bytes) where pointers and
//   strides allow it; the boundary states, stored as groups of four hi
//   then four lo, are unpacked into their two swizzled tiles.
// - Determinism: no atomics; every output element has one writer, and
//   every sum runs in a fixed order.
// Bound: bytes.  Per token and head the function reads x and dy and writes
// dx, and reads dt and writes ddt (B, C, dB and dC once for all heads);
// its products, about twice the forward's with the split, are far below
// the bf16 ridge.  The kernels also move the chunk states (S, the local
// adjoints, h_in and G_end, each [P,N] f32 a chunk) and the per-head
// partials of dB and dC, which the function's own bound leaves out.
//
// f32 route (tests only; P and N in {16, 32, 64}): `mamba2_ssd_bwd_kernel`,
// the exact recurrence.
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
// In f32 the function is about 14 P N flops a token and head on the CUDA
// cores (the states once, 3PN, and the walk back's G update and sums,
// 11PN), past its bytes; this kernel runs about 24 P N (the states three
// times, G twice), in a sequential walk of one block per (b, h).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int L = 32;   // tokens a chunk: the checkpoint interval

__device__ __forceinline__ float ld(const float* p) { return *p; }
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

// dA[h] and dD[h] = the per-(b, h, piece) partials, [B, H, npiece],
// summed over b and the pieces in order (f32: one piece, the whole
// sequence; bf16: its chunks)
__global__ void mamba2_ssd_bwd_heads_kernel(const float* __restrict__ da_part,
                                            const float* __restrict__ dd_part,
                                            float* __restrict__ da,
                                            float* __restrict__ dd, int B,
                                            int H, int npiece) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float sa = 0.f, sd = 0.f;
    for (int b = 0; b < B; ++b)
      for (int c = 0; c < npiece; ++c) {
        const size_t o = ((size_t)b * H + h) * npiece + c;
        sa += da_part[o];
        sd += dd_part[o];
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
                                                     da, dd, B, q.H, 1);
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


// ------------------------------------------------------------ bf16 route

constexpr int Q = 64;      // tokens per chunk
constexpr int PT = 64;     // head channels a block (P <= 64, zeros past P)
constexpr int NT = 128;    // threads per block: 4 warps x 16 rows

// 16-byte chunks in a shared-memory row of COLS bf16 columns, rounded up
// to 8 so that the XOR swizzle stays inside the row
template <int COLS>
__host__ __device__ constexpr int pitch() {
  return (COLS / 8 + 7) & ~7;
}
template <int COLS>
__host__ __device__ constexpr uint32_t row_bytes() {
  return pitch<COLS>() * 16;
}
template <int COLS>
__host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return rows * row_bytes<COLS>();
}
// byte offset of chunk ch of row r in a swizzled tile
template <int COLS>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return (uint32_t)(r * pitch<COLS>() + (ch ^ (r & 7))) * 16u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// dynamic shared memory, its start rounded up to 256 bytes (the XOR
// addressing needs it; SMEM_SLACK more bytes are asked for)
constexpr uint32_t SMEM_SLACK = 256;
__device__ __forceinline__ uint32_t smem_base(const uint8_t* smem) {
  return (smem_u32(smem) + 255u) & ~255u;
}

// asynchronous copy of 16 bytes; zeros when !ok (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 address the rows of matrix i
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c[16x8] += a[16x16] b[16x8]: bf16 operands, f32 accumulators.  With g =
// lane / 4, t = lane % 4: a holds (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..); b holds (k 2t..2t+1, n g), (k 2t+8.., n g); c holds
// (g, 2t..2t+1), (g+8, 2t..2t+1)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two f32 values as their two bf16 pieces: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t* hi,
                                       uint32_t* lo) {
  const bf16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
  __nv_bfloat162 h;
  h.x = h0;
  h.y = h1;
  *hi = *reinterpret_cast<uint32_t*>(&h);
  *lo = pack_bf16(v0 - __bfloat162float(h0), v1 - __bfloat162float(h1));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return __bfloat1622float2(b);
}

template <int M>
__device__ __forceinline__ void zero(float (&x)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// A lane's row address, at k-step 0, in the `ldmatrix` patterns of a
// swizzled tile (every row a lane addresses has (row & 7) == (lane & 7)):
// - a: the A operand, 16 rows x the 16 columns of a k-step;
// - bn: the B operand from rows = n, two 8-wide n-tiles (16 rows) x a
//   k-step (registers 0-1: n-tile 0, 2-3: n-tile 1); with .trans, the
//   A operand of 16 columns (chunks 0-1) x 16 rows = k;
// - bk: the B operand from rows = k (16 rows) x two 8-wide n-tiles of
//   columns, with .trans (registers 0-1: n-tile 0, 2-3: n-tile 1).
template <int COLS>
__device__ __forceinline__ uint32_t lane_a(int lane) {
  return swz<COLS>(lane & 15, lane >> 4);
}
template <int COLS>
__device__ __forceinline__ uint32_t lane_bn(int lane, int ch0 = 0) {
  return swz<COLS>((lane & 7) + ((lane >> 4) << 3), ch0 + ((lane >> 3) & 1));
}
template <int COLS>
__device__ __forceinline__ uint32_t lane_bk(int lane) {
  return swz<COLS>((lane & 7) + (((lane >> 3) & 1) << 3), lane >> 4);
}

struct Chunked {
  const bf16 *x, *bm, *c, *dy;
  const float *dt, *a, *d, *h0, *dhT;
  bf16 *dx, *dbm, *dc;
  float *ddt, *dh0, *da, *dd;
  float* states;    // [B*H, nc, P, N]: S_c (pass 1), then h_in as pieces
  float* adj;       // [B*H, nc, P, N]: local adjoints, then G_end as pieces
  float* dec;       // [B*H, nc]: exp(la_Q)
  float *db_part, *dc_part;   // [B*H, T, N]
  float *da_part, *dd_part;   // [B*H, nc]
  int H, T, P, nc;
  int vec_x, vec_dy, vec_bc, vec_dx;   // 16-byte loads; pair stores of dx
  long long xb, xh, xt, db, dh, dtt, bb, bt, gb, gh, gt, ob, oh, ot, eb, eh,
      et;
};

// rows [0, rows) x columns [0, COLS) of a bf16 matrix (row stride ld
// elements, unit column stride) into a swizzled tile at dst (gdst: the
// same address as a generic pointer); rows >= nr and columns >= ncol are
// zeros.  vec: 16-byte copies (ncol a multiple of 8, src and ld aligned).
template <int COLS>
__device__ __forceinline__ void load_tile(uint32_t dst, uint8_t* gdst,
                                          const bf16* src, long long ld,
                                          int rows, int nr, int ncol,
                                          bool vec) {
  constexpr int NCH = COLS / 8;
  for (int i = threadIdx.x; i < rows * NCH; i += NT) {
    const int r = i / NCH, ch = i % NCH;
    if (vec) {
      const bool ok = r < nr && ch * 8 < ncol;
      cp_async16(dst + swz<COLS>(r, ch), ok ? src + r * ld + ch * 8 : src,
                 ok);
    } else {
      uint16_t v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int col = ch * 8 + u;
        v[u] = r < nr && col < ncol
                   ? reinterpret_cast<const uint16_t*>(src)[r * ld + col]
                   : (uint16_t)0;
      }
      *reinterpret_cast<uint4*>(gdst + swz<COLS>(r, ch)) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
}

// A [P,N] state stored as pieces (each group of four values as four hi
// then four lo bf16) into its swizzled hi and lo tiles of PT rows; rows
// >= P are zeros.
template <int N>
__device__ __forceinline__ void load_pieces(uint8_t* ghi, uint8_t* glo,
                                            const float* src, int P) {
  constexpr int NCH = N / 8;
  for (int i = threadIdx.x; i < PT * NCH; i += NT) {
    const int r = i / NCH, ch = i % NCH;
    uint4 u = make_uint4(0u, 0u, 0u, 0u), w = u;
    if (r < P) {
      const uint4* s = reinterpret_cast<const uint4*>(src + r * N + ch * 8);
      u = s[0];
      w = s[1];
    }
    *reinterpret_cast<uint4*>(ghi + swz<N>(r, ch)) =
        make_uint4(u.x, u.y, w.x, w.y);
    *reinterpret_cast<uint4*>(glo + swz<N>(r, ch)) =
        make_uint4(u.z, u.w, w.z, w.w);
  }
}

// four f32 values as pieces: four hi, then four lo
__device__ __forceinline__ float4 pieces(float4 v) {
  uint4 o;
  split2(v.x, v.y, &o.x, &o.z);
  split2(v.z, v.w, &o.y, &o.w);
  return *reinterpret_cast<float4*>(&o);
}

// dt of the chunk's tokens [t0, t0 + nv) (zeros past the end) into sdt,
// and la, the inclusive cumulative sum of dt a from the chunk's start,
// into sla: warp 0, Q / 32 tokens a lane, a shuffle scan over the lanes
__device__ __forceinline__ void chunk_decay(float* sdt, float* sla,
                                            const float* dtp, long long st,
                                            int t0, int nv, float ah) {
  constexpr int PER = Q / 32;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  float dv[PER], v[PER], tot = 0.f;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = PER * lane + u;
    dv[u] = i < nv ? dtp[(long long)(t0 + i) * st] : 0.f;
    v[u] = dv[u] * ah;
    tot += v[u];
  }
  float incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = 0.f;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    run += v[u];
    sdt[PER * lane + u] = dv[u];
    sla[PER * lane + u] = run;
  }
}

// 1. The chunk's state from zero, S[p, n] = sum_s x[s, p] w[s] B[s, n]
// with w = dt exp(la_Q - la), its decay exp(la_Q), and its local adjoint
// of h_in, sum_s dy[s, p] exp(la_s) C[s, n].  Warp w owns head channels
// 16 w .. 16 w + 15.
template <int N>
constexpr size_t state_smem() {
  return SMEM_SLACK + 2 * tile_bytes<PT>(Q) + 2 * tile_bytes<N>(Q) +
         4 * Q * 4;
}
template <int N>
__global__ void __launch_bounds__(NT) mamba2_ssd_bwd_state_kernel(Chunked q) {
  constexpr uint32_t RBX = row_bytes<PT>(), RBN = row_bytes<N>();
  constexpr uint32_t TX = tile_bytes<PT>(Q), TN = tile_bytes<N>(Q);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Xs = smem_base(smem_raw), Ys = Xs + TX, Bs = Ys + TX,
                 Cs = Bs + TN;
  uint8_t* gX = smem_raw + (Xs - smem_u32(smem_raw));
  float* sdt = reinterpret_cast<float*>(gX + 2 * TX + 2 * TN);
  float* sla = sdt + Q;
  float* swx = sla + Q;      // dt exp(la_Q - la)
  float* swy = swx + Q;      // exp(la)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, ci = blockIdx.y;
  const int b = bh / q.H, h = bh % q.H;
  const int t0 = ci * Q, nv = min(Q, q.T - t0);
  load_tile<PT>(Xs, gX, q.x + b * q.xb + h * q.xh + t0 * q.xt, q.xt, Q, nv,
                q.P, q.vec_x);
  load_tile<PT>(Ys, gX + TX, q.dy + b * q.gb + h * q.gh + t0 * q.gt, q.gt, Q,
                nv, q.P, q.vec_dy);
  load_tile<N>(Bs, gX + 2 * TX, q.bm + b * q.bb + t0 * q.bt, q.bt, Q, nv, N,
               q.vec_bc);
  load_tile<N>(Cs, gX + 2 * TX + TN, q.c + b * q.bb + t0 * q.bt, q.bt, Q, nv,
               N, q.vec_bc);
  cp_commit();
  chunk_decay(sdt, sla, q.dt + b * q.db + h * q.dh, q.dtt, t0, nv, q.a[h]);
  __syncthreads();
  if (tid < Q) {
    swx[tid] = sdt[tid] * expf(sla[Q - 1] - sla[tid]);
    swy[tid] = expf(sla[tid]);
  }
  if (tid == 0) q.dec[(size_t)bh * q.nc + ci] = expf(sla[Q - 1]);
  cp_wait_all();
  __syncthreads();
  if (16 * warp >= q.P) return;

#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const float* wt = pass ? swy : swx;
    float acc[N / 8][4];
    zero(acc);
    // x^T (dy^T) as the A operand: .trans over rows s, columns p
    const uint32_t xa = (pass ? Ys : Xs) + lane_bn<PT>(lane, 2 * warp);
    const uint32_t bk = (pass ? Cs : Bs) + lane_bk<N>(lane);
#pragma unroll
    for (int ks = 0; ks < Q / 16; ++ks) {
      uint32_t xf[4], hi[4], lo[4];
      ldsm4t(xf, xa + ks * 16 * RBX);
#pragma unroll
      for (int i = 0; i < 4; ++i) {       // (p = g + 8 (i & 1), s = ...)
        const int sj = 16 * ks + 2 * t + 8 * (i >> 1);
        const float2 v = unpack_bf16(xf[i]);
        split2(v.x * wt[sj], v.y * wt[sj + 1], &hi[i], &lo[i]);
      }
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t bf[4];
        ldsm4t(bf, ((bk ^ (32u * np)) + ks * 16 * RBN));
        mma(acc[2 * np], hi, bf[0], bf[1]);
        mma(acc[2 * np], lo, bf[0], bf[1]);
        mma(acc[2 * np + 1], hi, bf[2], bf[3]);
        mma(acc[2 * np + 1], lo, bf[2], bf[3]);
      }
    }
    float* out = (pass ? q.adj : q.states) + ((size_t)bh * q.nc + ci) * q.P * N;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 16 * warp + g + 8 * r;
      if (p < q.P)
#pragma unroll
        for (int nt = 0; nt < N / 8; ++nt)
          *reinterpret_cast<float2*>(out + (size_t)p * N + 8 * nt + 2 * t) =
              make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
}

// 2. h_in[c] = exp(la_Q[c-1]) h_in[c-1] + S_{c-1} from h0 (or zeros), then
// G_end[c] = exp(la_Q[c+1]) G_end[c+1] + (local adjoint)_{c+1} from dhT
// (or zeros), and dh0 = exp(la_Q[0]) G_end[0] + (local adjoint)_0; each in
// f32, written in place of the value it was read from as pieces.  One
// thread per 4 consecutive state values of one (b, h), the loads of KC
// chunks issued together.
constexpr int KC = 8;
__global__ void mamba2_ssd_bwd_pass_kernel(float* __restrict__ states,
                                           float* __restrict__ adj,
                                           const float* __restrict__ dec,
                                           const float* __restrict__ h0,
                                           const float* __restrict__ dhT,
                                           float* __restrict__ dh0, int BH,
                                           int PN4, int nc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)BH * PN4) return;
  const int bh = (int)(i / PN4), e = (int)(i % PN4);
  const float* dp = dec + (size_t)bh * nc;
  float4* sp = reinterpret_cast<float4*>(states) + (size_t)bh * nc * PN4 + e;
  float4* ap = reinterpret_cast<float4*>(adj) + (size_t)bh * nc * PN4 + e;
  float4 v = h0 ? reinterpret_cast<const float4*>(h0)[i]
                : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += KC) {
    float4 sc[KC];
    float dc[KC];
#pragma unroll
    for (int u = 0; u < KC; ++u)
      if (c0 + u < nc) {
        sc[u] = sp[(size_t)(c0 + u) * PN4];
        dc[u] = dp[c0 + u];
      }
#pragma unroll
    for (int u = 0; u < KC; ++u)
      if (c0 + u < nc) {
        sp[(size_t)(c0 + u) * PN4] = pieces(v);
        v = make_float4(fmaf(dc[u], v.x, sc[u].x), fmaf(dc[u], v.y, sc[u].y),
                        fmaf(dc[u], v.z, sc[u].z), fmaf(dc[u], v.w, sc[u].w));
      }
  }
  v = dhT ? reinterpret_cast<const float4*>(dhT)[i]
          : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = nc - 1; c0 >= 0; c0 -= KC) {
    float4 sc[KC];
    float dc[KC];
#pragma unroll
    for (int u = 0; u < KC; ++u)
      if (c0 - u >= 0) {
        sc[u] = ap[(size_t)(c0 - u) * PN4];
        dc[u] = dp[c0 - u];
      }
#pragma unroll
    for (int u = 0; u < KC; ++u)
      if (c0 - u >= 0) {
        ap[(size_t)(c0 - u) * PN4] = pieces(v);
        v = make_float4(fmaf(dc[u], v.x, sc[u].x), fmaf(dc[u], v.y, sc[u].y),
                        fmaf(dc[u], v.z, sc[u].z), fmaf(dc[u], v.w, sc[u].w));
      }
  }
  if (dh0) reinterpret_cast<float4*>(dh0)[i] = v;
}

// 3. The chunk's gradients.  Shared memory, byte offsets from the
// 256-aligned base: swizzled bf16 tiles of x, dy [Q][PT], B, C [Q][N],
// h_in and G_end [PT][N] (hi and lo each), then f32 vectors over the
// chunk's tokens and Z [Q][Q + 1].
template <int N>
struct ChunkLay {
  static constexpr uint32_t TX = tile_bytes<PT>(Q), TN = tile_bytes<N>(Q),
                            TS = tile_bytes<N>(PT);
  static constexpr uint32_t X = 0, Y = X + TX, B = Y + TX, C = B + TN,
                            HH = C + TN, HL = HH + TS, GH = HL + TS,
                            GL = GH + TS, F = GL + TS;
  static constexpr int ZP = Q + 1;
  // dt, la, x.(G B), exp(la) C.(dy h_in), exp(la_Q - la) dt B.(x G_end),
  // dt dtheta, dy.x: [Q] each; the <G_end, h_in> partials [NT] and their
  // sum; Z [Q][ZP]
  static constexpr uint32_t BYTES = F + 4 * (7 * Q + NT + 1 + Q * ZP);
};
template <int N>
constexpr size_t chunk_smem() {
  return SMEM_SLACK + ChunkLay<N>::BYTES;
}

template <int N>
__global__ void __launch_bounds__(NT, 2) mamba2_ssd_bwd_chunk_kernel(Chunked q) {
  using Y = ChunkLay<N>;
  constexpr uint32_t RBX = row_bytes<PT>(), RBN = row_bytes<N>();
  constexpr int ZP = Y::ZP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  uint8_t* gb = smem_raw + (base - smem_u32(smem_raw));
  float* sdt = reinterpret_cast<float*>(gb + Y::F);
  float* sla = sdt + Q;
  float* st1 = sla + Q;      // x_t . (G_t B_t)
  float* sy = st1 + Q;       // exp(la_t) C_t . (dy_t h_in)
  float* se = sy + Q;        // exp(la_Q - la_t) dt_t B_t . (x_t G_end)
  float* sda = se + Q;       // dt_t dtheta_t
  float* sdd = sda + Q;      // dy_t . x_t
  float* red = sdd + Q;      // <G_end, h_in>, per thread
  float* sgh = red + NT;
  float* sz = sgh + 1;       // Z, then its rows' exclusive prefix sums

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, ci = blockIdx.y;
  const int b = bh / q.H, h = bh % q.H;
  const int t0 = ci * Q, nv = min(Q, q.T - t0), P = q.P;
  load_tile<PT>(base + Y::X, gb + Y::X,
                q.x + b * q.xb + h * q.xh + t0 * q.xt, q.xt, Q, nv, P,
                q.vec_x);
  load_tile<PT>(base + Y::Y, gb + Y::Y,
                q.dy + b * q.gb + h * q.gh + t0 * q.gt, q.gt, Q, nv, P,
                q.vec_dy);
  load_tile<N>(base + Y::B, gb + Y::B, q.bm + b * q.bb + t0 * q.bt, q.bt, Q,
               nv, N, q.vec_bc);
  load_tile<N>(base + Y::C, gb + Y::C, q.c + b * q.bb + t0 * q.bt, q.bt, Q,
               nv, N, q.vec_bc);
  cp_commit();
  const size_t so = ((size_t)bh * q.nc + ci) * P * N;
  load_pieces<N>(gb + Y::HH, gb + Y::HL, q.states + so, P);
  load_pieces<N>(gb + Y::GH, gb + Y::GL, q.adj + so, P);
  const float A = q.a[h], D = q.d[h];
  chunk_decay(sdt, sla, q.dt + b * q.db + h * q.dh, q.dtt, t0, nv, A);
  cp_wait_all();
  __syncthreads();
  {  // <G_end, h_in>, this thread's share of the elements
    float acc = 0.f;
    for (int i = tid; i < PT * N / 2; i += NT) {
      const int r = i / (N / 2), c2 = i % (N / 2);
      const uint32_t o = swz<N>(r, c2 / 4) + 4 * (c2 % 4);
      const float2 hh = unpack_bf16(*reinterpret_cast<uint32_t*>(gb + Y::HH + o));
      const float2 hl = unpack_bf16(*reinterpret_cast<uint32_t*>(gb + Y::HL + o));
      const float2 gh = unpack_bf16(*reinterpret_cast<uint32_t*>(gb + Y::GH + o));
      const float2 gl = unpack_bf16(*reinterpret_cast<uint32_t*>(gb + Y::GL + o));
      acc = fmaf(hh.x + hl.x, gh.x + gl.x, acc);
      acc = fmaf(hh.y + hl.y, gh.y + gl.y, acc);
    }
    red[tid] = acc;
  }

  // this thread's tokens: row0 + g and row0 + g + 8
  const int row0 = 16 * warp;
  const float la_q = sla[Q - 1];
  float la_r[2], dt_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    la_r[r] = sla[row0 + g + 8 * r];
    dt_r[r] = sdt[row0 + g + 8 * r];
  }
  const uint32_t bnx = lane_bn<PT>(lane), bnn = lane_bn<N>(lane);
  const uint32_t bkx = lane_bk<PT>(lane), bkn = lane_bk<N>(lane);
  const uint32_t xa = base + Y::X + row0 * RBX + lane_a<PT>(lane);
  const uint32_t ya = base + Y::Y + row0 * RBX + lane_a<PT>(lane);
  const uint32_t ba = base + Y::B + row0 * RBN + lane_a<N>(lane);
  const uint32_t ca = base + Y::C + row0 * RBN + lane_a<N>(lane);

  // A [Q-wide tile] (key tiles np >= warp for s >= t, np <= warp for
  // s <= t) = the rows' operand (af source, k over KC columns) times the
  // keys' rows of another tile (k over the same columns)
  auto tile = [&](float (&acc)[Q / 8][4], uint32_t arow, uint32_t keys,
                  uint32_t kb, bool later, auto kc) {
    constexpr int KCOLS = decltype(kc)::value;
    constexpr uint32_t RB = row_bytes<KCOLS>();
    zero(acc);
#pragma unroll
    for (int ks = 0; ks < KCOLS / 16; ++ks) {
      uint32_t af[4];
      ldsm4(af, arow ^ (32u * ks));
#pragma unroll
      for (int np = 0; np < Q / 16; ++np) {
        if (later ? np < warp : np > warp) continue;
        uint32_t bf[4];
        ldsm4(bf, ((keys + kb) ^ (32u * ks)) + np * 16 * RB);
        mma(acc[2 * np], af, bf[0], bf[1]);
        mma(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  };
  // acc[16 x COLS] += W[16 x Q] V[Q x COLS], W the weighted tile in
  // registers (wt(nt, r, u) its value at row g + 8 r, key 8 nt + 2 t + u),
  // cut into two pieces; V a swizzled tile with rows = keys
  auto times = [&](auto& acc, uint32_t vt, bool later, auto wt, auto cols) {
    constexpr int COLS = decltype(cols)::value;
    constexpr uint32_t RB = row_bytes<COLS>();
    const uint32_t vk = vt + lane_bk<COLS>(lane);
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      if (later ? kk < warp : kk > warp) continue;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // a[i]: row g + 8 (i & 1), col 8 (i >> 1)
        const int nt = 2 * kk + (i >> 1), r = i & 1;
        split2(wt(nt, r, 0), wt(nt, r, 1), &hi[i], &lo[i]);
      }
#pragma unroll
      for (int dp = 0; dp < COLS / 16; ++dp) {
        uint32_t bf[4];
        ldsm4t(bf, (vk ^ (32u * dp)) + kk * 16 * RB);
        mma(acc[2 * dp], hi, bf[0], bf[1]);
        mma(acc[2 * dp], lo, bf[0], bf[1]);
        mma(acc[2 * dp + 1], hi, bf[2], bf[3]);
        mma(acc[2 * dp + 1], lo, bf[2], bf[3]);
      }
    }
  };
  // acc[16 x N] += rows (A operand, k over PT columns) times a [PT][N]
  // state's two pieces (rows = k)
  auto times_state = [&](float (&acc)[N / 8][4], uint32_t arow, uint32_t shi,
                         uint32_t slo) {
#pragma unroll
    for (int ks = 0; ks < PT / 16; ++ks) {
      uint32_t af[4];
      ldsm4(af, arow ^ (32u * ks));
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t bf[4];
        ldsm4t(bf, (((shi + bkn) ^ (32u * np)) + ks * 16 * RBN));
        mma(acc[2 * np], af, bf[0], bf[1]);
        mma(acc[2 * np + 1], af, bf[2], bf[3]);
        ldsm4t(bf, (((slo + bkn) ^ (32u * np)) + ks * 16 * RBN));
        mma(acc[2 * np], af, bf[0], bf[1]);
        mma(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  };
  // a [16 x N] accumulator's row dots with a bf16 tile's rows (the lanes of
  // a quad hold one row: summed over them by shuffles, one order for all)
  auto row_dot = [&](const float (&acc)[N / 8][4], uint32_t tb, int r) {
    const int tt = row0 + g + 8 * r;
    float s = 0.f;
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const float2 v = unpack_bf16(
          *reinterpret_cast<const uint32_t*>(gb + tb + swz<N>(tt, nt) + 4 * t));
      s = fmaf(acc[nt][2 * r], v.x, s);
      s = fmaf(acc[nt][2 * r + 1], v.y, s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    return s;
  };
  using KX = std::integral_constant<int, PT>;
  using KN = std::integral_constant<int, N>;

  // --- dx = dt (exp(la_Q - la) B G_end^T + (L . C B^T)^T dy) + D dy, and
  // x . (G B), the first term of ddt
  {
    float acc[PT / 8][4];
    zero(acc);
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t af[4];
      ldsm4(af, ba ^ (32u * ks));
#pragma unroll
      for (int np = 0; np < PT / 16; ++np) {
        uint32_t bf[4];
        ldsm4(bf, ((base + Y::GH + bnn) ^ (32u * ks)) + np * 16 * RBN);
        mma(acc[2 * np], af, bf[0], bf[1]);
        mma(acc[2 * np + 1], af, bf[2], bf[3]);
        ldsm4(bf, ((base + Y::GL + bnn) ^ (32u * ks)) + np * 16 * RBN);
        mma(acc[2 * np], af, bf[0], bf[1]);
        mma(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float e = expf(la_q - la_r[r]);
#pragma unroll
      for (int nt = 0; nt < PT / 8; ++nt) {
        acc[nt][2 * r] *= e;
        acc[nt][2 * r + 1] *= e;
      }
    }
    float bc[Q / 8][4];    // B_t . C_s, s >= t
    tile(bc, ba, base + Y::C, bnn, true, KN{});
    times(acc, base + Y::Y, true,
          [&](int nt, int r, int u) {
            const int s = 8 * nt + 2 * t + u, tt = row0 + g + 8 * r;
            return bc[nt][2 * r + u] *
                   expf(s >= tt ? sla[s] - la_r[r] : -INFINITY);
          },
          KX{});
    bf16* dxp = q.dx + b * q.ob + h * q.oh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tt = row0 + g + 8 * r;
      float s = 0.f;
#pragma unroll
      for (int nt = 0; nt < PT / 8; ++nt) {
        const int p = 8 * nt + 2 * t;
        const uint32_t o = swz<PT>(tt, nt) + 4 * t;
        const float2 xv = unpack_bf16(*reinterpret_cast<uint32_t*>(gb + Y::X + o));
        const float2 yv = unpack_bf16(*reinterpret_cast<uint32_t*>(gb + Y::Y + o));
        s = fmaf(xv.x, acc[nt][2 * r], s);
        s = fmaf(xv.y, acc[nt][2 * r + 1], s);
        if (tt >= nv || p >= P) continue;
        const float v0 = fmaf(dt_r[r], acc[nt][2 * r], D * yv.x);
        const float v1 = fmaf(dt_r[r], acc[nt][2 * r + 1], D * yv.y);
        bf16* dr = dxp + (long long)(t0 + tt) * q.ot + p;
        if (q.vec_dx && p + 1 < P) {
          *reinterpret_cast<uint32_t*>(dr) = pack_bf16(v0, v1);
        } else {
          dr[0] = __float2bfloat16_rn(v0);
          if (p + 1 < P) dr[1] = __float2bfloat16_rn(v1);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) st1[tt] = s;
    }
  }

  // --- dB_h = dt (exp(la_Q - la) x G_end + (L . dy x^T)^T C), and the last
  // term of dtheta, exp(la_Q - la) dt B . (x G_end)
  {
    float acc[N / 8][4];
    zero(acc);
    times_state(acc, xa, base + Y::GH, base + Y::GL);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float e = expf(la_q - la_r[r]);
      const float s = row_dot(acc, Y::B, r);
      if (t == 0) se[row0 + g + 8 * r] = e * dt_r[r] * s;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        acc[nt][2 * r] *= e;
        acc[nt][2 * r + 1] *= e;
      }
    }
    float xy[Q / 8][4];    // x_t . dy_s, s >= t
    tile(xy, xa, base + Y::Y, bnx, true, KX{});
    times(acc, base + Y::C, true,
          [&](int nt, int r, int u) {
            const int s = 8 * nt + 2 * t + u, tt = row0 + g + 8 * r;
            return xy[nt][2 * r + u] *
                   expf(s >= tt ? sla[s] - la_r[r] : -INFINITY);
          },
          KN{});
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tt = row0 + g + 8 * r;
      if (tt >= nv) continue;
      float* o = q.db_part + ((size_t)bh * q.T + t0 + tt) * N + 2 * t;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
        *reinterpret_cast<float2*>(o + 8 * nt) =
            make_float2(dt_r[r] * acc[nt][2 * r], dt_r[r] * acc[nt][2 * r + 1]);
    }
  }

  // --- dC_h = exp(la) dy h_in + (L . dy x^T . dt_s) B; the first term of
  // dtheta, exp(la) C . (dy h_in); Z = (L . dy x^T . dt_s) . C B^T
  {
    float acc[N / 8][4];
    zero(acc);
    times_state(acc, ya, base + Y::HH, base + Y::HL);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float e = expf(la_r[r]);
      const float s = row_dot(acc, Y::C, r);
      if (t == 0) sy[row0 + g + 8 * r] = e * s;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        acc[nt][2 * r] *= e;
        acc[nt][2 * r + 1] *= e;
      }
    }
    float yx[Q / 8][4];    // dy_t . x_s, s <= t; weighted in place
    tile(yx, ya, base + Y::X, bnx, false, KX{});
    {
      float cb[Q / 8][4];  // C_t . B_s, s <= t
      tile(cb, ca, base + Y::B, bnn, false, KN{});
#pragma unroll
      for (int nt = 0; nt < Q / 8; ++nt) {
        if (nt / 2 > warp) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int tt = row0 + g + 8 * r;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int s = 8 * nt + 2 * t + u;
            const float w = yx[nt][2 * r + u] * sdt[s] *
                            expf(s <= tt ? la_r[r] - sla[s] : -INFINITY);
            yx[nt][2 * r + u] = w;
            sz[tt * ZP + s] = w * cb[nt][2 * r + u];
          }
        }
      }
    }
    times(acc, base + Y::B, false,
          [&](int nt, int r, int u) { return yx[nt][2 * r + u]; }, KN{});
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tt = row0 + g + 8 * r;
      if (tt >= nv) continue;
      float* o = q.dc_part + ((size_t)bh * q.T + t0 + tt) * N + 2 * t;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
        *reinterpret_cast<float2*>(o + 8 * nt) =
            make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
  __syncthreads();

  // --- dtheta and ddt per token; the chunk's partials of dA and dD
  if (tid < Q) {             // row s of Z: its exclusive prefix sums, r <= s
    float run = 0.f;
    float* zr = sz + tid * ZP;
    for (int r = 0; r <= tid; ++r) {
      const float z = zr[r];
      zr[r] = run;
      run += z;
    }
  } else if (tid == NT - 1) {
    float s = 0.f;
    for (int i = 0; i < NT; ++i) s += red[i];
    *sgh = s;
  }
  __syncthreads();
  if (tid < Q) {
    const int tt = tid;
    float rect = 0.f, suf = 0.f, pre = 0.f;
    for (int s = tt; s < Q; ++s) {
      rect += sz[s * ZP + tt];
      suf += sy[s];
    }
    for (int r = 0; r < tt; ++r) pre += se[r];
    const float dth = ((suf + rect) + expf(la_q) * *sgh) + pre;
    if (tt < nv)
      q.ddt[b * q.eb + h * q.eh + (long long)(t0 + tt) * q.et] =
          fmaf(A, dth, st1[tt]);
    sda[tt] = sdt[tt] * dth;
  } else {
    const int tt = tid - Q;
    float s = 0.f;
#pragma unroll
    for (int ch = 0; ch < PT / 8; ++ch) {
      const uint4 xv = *reinterpret_cast<const uint4*>(gb + Y::X + swz<PT>(tt, ch));
      const uint4 yv = *reinterpret_cast<const uint4*>(gb + Y::Y + swz<PT>(tt, ch));
      const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
      const uint32_t yw[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a2 = unpack_bf16(xw[j]), b2 = unpack_bf16(yw[j]);
        s = fmaf(a2.x, b2.x, s);
        s = fmaf(a2.y, b2.y, s);
      }
    }
    sdd[tt] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float sa = 0.f, sd = 0.f;
    for (int tt = 0; tt < Q; ++tt) {
      sa += sda[tt];
      sd += sdd[tt];
    }
    q.da_part[(size_t)bh * q.nc + ci] = sa;
    q.dd_part[(size_t)bh * q.nc + ci] = sd;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <int N>
int launch_chunked(const Chunked& q, int B, cudaStream_t st) {
  const int BH = B * q.H;
  cudaError_t err;
  const dim3 grid(BH, q.nc);
  if (q.nc > 0) {
    auto k1 = mamba2_ssd_bwd_state_kernel<N>;
    err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)state_smem<N>());
    if (err != cudaSuccess) return (int)err;
    k1<<<grid, NT, state_smem<N>(), st>>>(q);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int pn4 = q.P * N / 4;
  const long long n4 = (long long)BH * pn4;
  mamba2_ssd_bwd_pass_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
      q.states, q.adj, q.dec, q.h0, q.dhT, q.dh0, BH, pn4, q.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (q.nc > 0) {
    auto k3 = mamba2_ssd_bwd_chunk_kernel<N>;
    err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)chunk_smem<N>());
    if (err != cudaSuccess) return (int)err;
    k3<<<grid, NT, chunk_smem<N>(), st>>>(q);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (B * q.T > 0) {
    mamba2_ssd_bwd_bc_kernel<bf16><<<B * q.T, N, 0, st>>>(
        q.db_part, q.dc_part, q.dbm, q.dc, q.H, q.T, N);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  mamba2_ssd_bwd_heads_kernel<<<1, 128, 0, st>>>(q.da_part, q.dd_part, q.da,
                                                 q.dd, B, q.H, q.nc);
  return (int)cudaGetLastError();
}
}  // namespace

// Tokens between the f32 route's checkpoints, and a chunk of the bf16
// route: the wrapper sizes the scratch below with them.
extern "C" int mamba2_ssd_bwd_chunk() { return L; }
extern "C" int mamba2_ssd_bwd_bf16_chunk() { return Q; }

// x, dy [B,H,T,P] in f32 (dtype 0) or bf16 (dtype 1), unit stride along P;
// dt [B,H,T] f32; a, d [H] f32; bm, c [B,T,N] in x's dtype with shared
// strides, unit along N; h0, dhT [B,H,P,N] f32 or null.  Writes dx (x's
// dtype), ddt (f32, strides of its own), dbm and dc ([B,T,N] contiguous, x's
// dtype), da, dd [H] f32 and, if not null, dh0 [B,H,P,N] f32.  P and N in
// {16, 32, 64}.  strides: x (3), dt (3), B/C (2), dy (3), dx (3), ddt (3).
// Seven f32 scratch buffers, nc = ceil(T / mamba2_ssd_bwd_chunk()) in f32
// and ceil(T / mamba2_ssd_bwd_bf16_chunk()) in bf16:
// - f32: ckpt [B*H, nc, N, P], states_a [B*H, L, N, P], states_b [B*H, L,
//   P, N] (a thread keeps a row or a column of G and of h in registers: at
//   128, 512 floats, it would spill);
// - bf16: states and adjoints [B*H, nc, P, N], decays [B*H, nc];
// then db_part, dc_part [B*H, T, N] and da_part, dd_part ([B*H] in f32,
// [B*H, nc] in bf16).  Three kernels in f32, five in bf16; returns the
// first failing launch's cudaError_t.
extern "C" int mamba2_ssd_bwd_launch(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* c, const void* d, const void* dy, const void* h0,
    const void* dhT, void* dx, void* ddt, void* da, void* dbm, void* dc,
    void* dd, void* dh0, void* const* scratch, int B, int H, int Tn, int P,
    int N, int dtype, const long long* strides, void* stream) {
  if (B * H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if ((P != 16 && P != 32 && P != 64) || (N != 16 && N != 32 && N != 64))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    Chunked q;
    q.x = (const bf16*)x;
    q.bm = (const bf16*)bm;
    q.c = (const bf16*)c;
    q.dy = (const bf16*)dy;
    q.dt = (const float*)dt;
    q.a = (const float*)a;
    q.d = (const float*)d;
    q.h0 = (const float*)h0;
    q.dhT = (const float*)dhT;
    q.dx = (bf16*)dx;
    q.dbm = (bf16*)dbm;
    q.dc = (bf16*)dc;
    q.ddt = (float*)ddt;
    q.dh0 = (float*)dh0;
    q.da = (float*)da;
    q.dd = (float*)dd;
    q.states = (float*)scratch[0];
    q.adj = (float*)scratch[1];
    q.dec = (float*)scratch[2];
    q.db_part = (float*)scratch[3];
    q.dc_part = (float*)scratch[4];
    q.da_part = (float*)scratch[5];
    q.dd_part = (float*)scratch[6];
    q.H = H;
    q.T = Tn;
    q.P = P;
    q.nc = (Tn + Q - 1) / Q;
    if (q.nc > 65535) return (int)cudaErrorInvalidValue;
    const long long* st = strides;
    q.xb = st[0];
    q.xh = st[1];
    q.xt = st[2];
    q.db = st[3];
    q.dh = st[4];
    q.dtt = st[5];
    q.bb = st[6];
    q.bt = st[7];
    q.gb = st[8];
    q.gh = st[9];
    q.gt = st[10];
    q.ob = st[11];
    q.oh = st[12];
    q.ot = st[13];
    q.eb = st[14];
    q.eh = st[15];
    q.et = st[16];
    q.vec_x = aligned16(x) && q.xb % 8 == 0 && q.xh % 8 == 0 && q.xt % 8 == 0;
    q.vec_dy = aligned16(dy) && q.gb % 8 == 0 && q.gh % 8 == 0 &&
               q.gt % 8 == 0;
    q.vec_bc = aligned16(bm) && aligned16(c) && q.bb % 8 == 0 &&
               q.bt % 8 == 0;
    q.vec_dx = ((uintptr_t)dx & 3u) == 0 && q.ob % 2 == 0 && q.oh % 2 == 0 &&
               q.ot % 2 == 0;
    switch (N) {
      case 16: return launch_chunked<16>(q, B, s);
      case 32: return launch_chunked<32>(q, B, s);
      default: return launch_chunked<64>(q, B, s);
    }
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
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
  q.ckpt = (float*)scratch[0];
  q.states_a = (float*)scratch[1];
  q.states_b = (float*)scratch[2];
  q.db_part = (float*)scratch[3];
  q.dc_part = (float*)scratch[4];
  q.da_part = (float*)scratch[5];
  q.dd_part = (float*)scratch[6];
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
  return dispatch_p<float>(q, B, P, N, dbm, dc, (float*)da, (float*)dd, s);
}
