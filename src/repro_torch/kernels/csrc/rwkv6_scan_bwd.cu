// RWKV6 WKV scan, backward, for Hopper.  The forward (csrc/rwkv6_scan.cu)
// is, per (batch, head), with S an [N,N] f32 state (key channel n, value
// channel m):
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1}
//     + k_t v_t^T.
// With G_t the adjoint of S_t (G_T = dsT, or 0), walked from t = T down:
//     dr_t = S_{t-1} dy_t + u * k_t (v_t . dy_t)
//     dk_t = G_t v_t + u * r_t (v_t . dy_t)
//     dv_t = G_t^T k_t + (sum_n r u k)_t dy_t
//     dw_t[n] = sum_m G_t[n,m] S_{t-1}[n,m]
//     du = sum_{b,t} r_t * k_t (v_t . dy_t)
//     G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   ds0 = G_0.
// f32 inside; dr, dk, dv, dw are written in the inputs' dtype, du and ds0
// in f32.  Any T (0 included).
//
// Replaces no Pallas kernel: the reference differentiates its jnp scan
// (src/repro/kernels/rwkv6_scan/ref.py, `rwkv6_ref`) with jax autodiff.
// This is the backward of `rwkv6_scan_*_kernel`, so that a training step
// on the card reaches the recurrent blocks' projections.
//
// Design (simple and right; the tensor-core form is later work):
// - Every element (n, m) of S and of G runs its own recurrence with
//   per-token scalars; the sums couple them only along m (dr, dk, dw) or
//   along n (dv).  So one block per (b, h) has two groups of N threads:
//   group A, thread n, keeps row n of G (and of S while it recomputes the
//   states) and sums dr, dk, dw over m in registers; group B, thread m,
//   keeps column m of G and sums dv over n.  The two copies of G run the
//   same fmaf on the same operands, so they hold the same bits, and no sum
//   crosses threads: there are no atomics and no shuffles, every output
//   element has one writer, and the result is the same bit for bit from
//   run to run.
// - The walk back needs S_{t-1}.  Undoing a step (dividing by w_t) is
//   unstable at the model's decays (down to 0.0113 a token), so the states
//   are recomputed: a forward pass writes S at the start of every chunk of
//   L tokens (`ckpt`), and each chunk, walked in reverse order, first
//   recomputes its L states from its checkpoint into a per-block global
//   scratch (`states`, [L][m][n]: thread n's stores and loads are
//   coalesced), then walks back through them.  A chunk's inputs (r, k, v,
//   w, dy) are staged in shared memory as f32, with the per-token scalars
//   v . dy and sum_n r u k.
// - du sums over batch rows: each block writes its partial [N], and a
//   second kernel sums the partials over b in order.
// Bound: per token and head the function reads r, k, v, w, dy and writes
// dr, dk, dv, dw (18N bytes in bf16).  In bf16 its work, in the chunked
// form on the tensor cores (twice the forward's products), takes less
// time than those bytes: the function is bound by bytes.  In f32 it is
// about 14 N^2 flops on the CUDA cores (the states once, 3N^2, and the
// walk back's sums and G update, 11N^2), far past the bytes.  This kernel
// runs the exact recurrence in f32 for both dtypes, about 20 N^2 (the
// states twice, G twice), and what holds it far above either bound is
// the sequential walk of one block per (b, h): 2N threads a block, each
// with a chain of N dependent FMAs a token.
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
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const void* dy;
  const float* u;      // [H,N]
  const float* s0;     // [B,H,N,N] or null
  const float* dsT;    // [B,H,N,N] or null
  void* dr;
  void* dk;
  void* dv;
  void* dw;
  float* du_part;      // [B,H,N]
  float* ds0;          // [B,H,N,N] or null
  float* ckpt;         // [B*H, NC, N(m), N(n)]
  float* states;       // [B*H, L, N(m), N(n)]
  int H, T;
  long long sb, sh, st;   // r, k, v, w (element strides; unit along N)
  long long gb, gh, gt;   // dy
  long long ob, oh, ot;   // dr, dk, dv, dw
};

// stage rows [t0, t0 + len) of a [T,N] slice into sm [len][N] as f32
template <typename T, int N>
__device__ __forceinline__ void stage(float* sm, const T* p, long long stride,
                                      int t0, int len) {
  for (int i = threadIdx.x; i < len * N; i += 2 * N) {
    const int tt = i / N, j = i - tt * N;
    sm[i] = ld(p + (long long)(t0 + tt) * stride + j);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(2 * N)
rwkv6_scan_bwd_kernel(Bwd q) {
  extern __shared__ float smem[];
  float* sr = smem;            // [L][N] each
  float* sk = sr + L * N;
  float* sv = sk + L * N;
  float* sw = sv + L * N;
  float* sdy = sw + L * N;
  float* su = sdy + L * N;     // [N]
  float* svdy = su + N;        // [L] v . dy
  float* srku = svdy + L;      // [L] sum_n r u k
  const int bh = blockIdx.x;
  const int b = bh / q.H, h = bh - b * q.H;
  const int tid = threadIdx.x;
  const bool row = tid < N;    // group A (row n = tid) or B (column m)
  const int me = row ? tid : tid - N;
  const long long in_off = b * q.sb + h * q.sh;
  const T* rp = (const T*)q.r + in_off;
  const T* kp = (const T*)q.k + in_off;
  const T* vp = (const T*)q.v + in_off;
  const T* wp = (const T*)q.w + in_off;
  const T* gp = (const T*)q.dy + b * q.gb + h * q.gh;
  const long long out_off = b * q.ob + h * q.oh;
  const int nc = (q.T + L - 1) / L;
  float* ck = q.ckpt + (size_t)bh * nc * N * N;
  float* sts = q.states + (size_t)bh * L * N * N;
  if (row) su[me] = q.u[h * N + me];

  // 1. the forward, state rows in registers: S at every chunk's start
  float S[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    S[j] = (row && q.s0) ? q.s0[((size_t)bh * N + me) * N + j] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L, len = min(L, q.T - t0);
    __syncthreads();           // the last chunk's readers are done
    stage<T, N>(sk, kp, q.st, t0, len);
    stage<T, N>(sv, vp, q.st, t0, len);
    stage<T, N>(sw, wp, q.st, t0, len);
    __syncthreads();
    if (row) {
#pragma unroll
      for (int j = 0; j < N; ++j) ck[((size_t)c * N + j) * N + me] = S[j];
      for (int tt = 0; tt < len; ++tt) {
        const float kn = sk[tt * N + me], wn = sw[tt * N + me];
#pragma unroll
        for (int j = 0; j < N; ++j)
          S[j] = fmaf(wn, S[j], kn * sv[tt * N + j]);
      }
    }
  }

  // 2. the walk back, chunk by chunk from the last
  float G[N];                  // A: G[me][j]; B: G[j][me]
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const size_t at = row ? ((size_t)bh * N + me) * N + j
                          : ((size_t)bh * N + j) * N + me;
    G[j] = q.dsT ? q.dsT[at] : 0.f;
  }
  float du_acc = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L, len = min(L, q.T - t0);
    __syncthreads();
    stage<T, N>(sr, rp, q.st, t0, len);
    stage<T, N>(sk, kp, q.st, t0, len);
    stage<T, N>(sv, vp, q.st, t0, len);
    stage<T, N>(sw, wp, q.st, t0, len);
    stage<T, N>(sdy, gp, q.gt, t0, len);
    __syncthreads();
    for (int tt = tid; tt < len; tt += 2 * N) {
      float vdy = 0.f, rku = 0.f;
      for (int j = 0; j < N; ++j) {
        vdy = fmaf(sv[tt * N + j], sdy[tt * N + j], vdy);
        rku = fmaf(sr[tt * N + j] * su[j], sk[tt * N + j], rku);
      }
      svdy[tt] = vdy;
      srku[tt] = rku;
    }
    if (row) {                 // the chunk's states S_{t-1}, recomputed
#pragma unroll
      for (int j = 0; j < N; ++j) S[j] = ck[((size_t)c * N + j) * N + me];
      for (int tt = 0; tt < len; ++tt) {
        const float kn = sk[tt * N + me], wn = sw[tt * N + me];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          sts[((size_t)tt * N + j) * N + me] = S[j];
          S[j] = fmaf(wn, S[j], kn * sv[tt * N + j]);
        }
      }
    }
    __syncthreads();           // svdy, srku
    for (int tt = len - 1; tt >= 0; --tt) {
      const long long t = t0 + tt;
      const float* dyt = sdy + tt * N;
      if (row) {
        const float rn = sr[tt * N + me], kn = sk[tt * N + me];
        const float wn = sw[tt * N + me], un = su[me];
        const float* vt = sv + tt * N;
        float dr = 0.f, dk = 0.f, dw = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float s = sts[((size_t)tt * N + j) * N + me];
          const float g = G[j];
          dr = fmaf(s, dyt[j], dr);
          dk = fmaf(g, vt[j], dk);
          dw = fmaf(g, s, dw);
          G[j] = fmaf(wn, g, rn * dyt[j]);
        }
        const float vdy = svdy[tt];
        dr = fmaf(un * kn, vdy, dr);
        dk = fmaf(un * rn, vdy, dk);
        du_acc = fmaf(rn * kn, vdy, du_acc);
        const long long o = out_off + t * q.ot + me;
        put((T*)q.dr + o, dr);
        put((T*)q.dk + o, dk);
        put((T*)q.dw + o, dw);
      } else {
        const float dym = dyt[me];
        const float* rt = sr + tt * N;
        const float* kt = sk + tt * N;
        const float* wt = sw + tt * N;
        float dv = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float g = G[j];
          dv = fmaf(g, kt[j], dv);
          G[j] = fmaf(wt[j], g, rt[j] * dym);
        }
        dv = fmaf(srku[tt], dym, dv);
        put((T*)q.dv + out_off + t * q.ot + me, dv);
      }
    }
  }
  if (row) {
    q.du_part[(size_t)bh * N + me] = du_acc;
  } else if (q.ds0) {
#pragma unroll
    for (int j = 0; j < N; ++j) q.ds0[((size_t)bh * N + j) * N + me] = G[j];
  }
}

// du[h][n] = sum_b du_part[b][h][n], in order of b
__global__ void rwkv6_scan_bwd_du_kernel(const float* __restrict__ part,
                                         float* __restrict__ du, int B,
                                         int HN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HN) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += part[(size_t)b * HN + i];
  du[i] = acc;
}

template <typename T, int N>
int launch(const Bwd& q, int B, float* du, cudaStream_t stream) {
  auto kern = rwkv6_scan_bwd_kernel<T, N>;
  const int smem = (int)sizeof(float) * (5 * L * N + N + 2 * L);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * q.H, 2 * N, smem, stream>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int hn = q.H * N;
  rwkv6_scan_bwd_du_kernel<<<(hn + 255) / 256, 256, 0, stream>>>(
      q.du_part, du, B, hn);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(const Bwd& q, int B, int N, float* du, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, 16>(q, B, du, s);
    case 32: return launch<T, 32>(q, B, du, s);
    case 64: return launch<T, 64>(q, B, du, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The chunk length of the checkpoints, for the wrapper's scratch.
extern "C" int rwkv6_scan_bwd_chunk() { return L; }

// r, k, v, w [B,H,T,N] in f32 (dtype 0) or bf16 (dtype 1), element strides
// (sb, sh, st), unit stride along N; dy the same with strides (gb, gh, gt);
// u [H,N] f32; s0, dsT [B,H,N,N] f32 or null.  Writes dr, dk, dv, dw (the
// inputs' dtype, strides (ob, oh, ot)), du [H,N] f32 and, if not null, ds0
// [B,H,N,N] f32.  Scratch: ckpt [B*H, ceil(T/L), N, N] f32, states [B*H, L,
// N, N] f32, du_part [B,H,N] f32.  N in {16, 32, 64} (a thread keeps a row
// of G and of S in registers: at 128, 256 floats, it would spill).  Two kernels;
// returns the first failing launch's cudaError_t.
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* dy, const void* u, const void* s0, const void* dsT, void* dr,
    void* dk, void* dv, void* dw, void* du, void* ds0, void* ckpt,
    void* states, void* du_part, int B, int H, int Tn, int N, int dtype,
    long long sb, long long sh, long long st, long long gb, long long gh,
    long long gt, long long ob, long long oh, long long ot, void* stream) {
  if (B * H == 0) return 0;
  Bwd q;
  q.r = r;
  q.k = k;
  q.v = v;
  q.w = w;
  q.dy = dy;
  q.u = (const float*)u;
  q.s0 = (const float*)s0;
  q.dsT = (const float*)dsT;
  q.dr = dr;
  q.dk = dk;
  q.dv = dv;
  q.dw = dw;
  q.du_part = (float*)du_part;
  q.ds0 = (float*)ds0;
  q.ckpt = (float*)ckpt;
  q.states = (float*)states;
  q.H = H;
  q.T = Tn;
  q.sb = sb;
  q.sh = sh;
  q.st = st;
  q.gb = gb;
  q.gh = gh;
  q.gt = gt;
  q.ob = ob;
  q.oh = oh;
  q.ot = ot;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_n<float>(q, B, N, (float*)du, s);
  if (dtype == 1) return dispatch_n<bf16>(q, B, N, (float*)du, s);
  return (int)cudaErrorInvalidValue;
}
