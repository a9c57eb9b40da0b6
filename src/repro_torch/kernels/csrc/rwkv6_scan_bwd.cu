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
// bf16 route (the model's): the transpose of the forward's two-level
// chunked form, on the tensor cores, all chunks in parallel: chunks of LC
// = 64 tokens, sub-chunks of SUB = 16.  Every decay is a product of w's in
// (0, 1], as in the recurrence: no exponential, no clamp, and no division
// to undo a step.  Four kernels a call:
//   1. `rwkv6_scan_bwd_state_kernel`, per (b, h, chunk): the chunk's state
//      from zero, (k . prod_{tau>t} w)^T v, its local adjoint of the state
//      entering it, (r . prod_{tau<t} w)^T dy, and its total decay, the
//      decayed k and r walked per key channel and cut into two pieces.
//   2. `rwkv6_scan_bwd_pass_kernel`, one thread per 4 state values of a
//      (b, h): S_0 entering every chunk from s0, then, backwards from dsT,
//      the adjoint G_L at every chunk's end, and ds0; each written in place
//      of its input as two bf16 pieces.
//   3. `rwkv6_scan_bwd_chunk_kernel`, per (b, h, sub-chunk i): with g_j a
//      sub-chunk's total decay, pre_t and post_t the products of w before
//      and after t inside its sub-chunk, kloc = k . post, qloc = r . pre:
//      - the state F_i entering sub-chunk i and the adjoint H_i at its end,
//        F <- g_j . F + kloc_j^T v_j over the chunk's sub-chunks j < i from
//        S_0, H <- g_j . H + qloc_j^T dy_j over j > i from G_L, a warp
//        taking 16 x 16 tiles of both, in f32 accumulators;
//      - dv = kloc_i H_i + A^T dy_i, A the forward's diagonal tile
//        (A[s,t] = sum_n r_s k_t prod_{t<tau<s} w, the bonus sum_n r u k on
//        its diagonal), and the tiles dy_i F_i^T and v_i H_i^T;
//      - per key channel n, a walk over the sub-chunk's 16 tokens with
//        A'[s,t] = dy_s . v_t:
//          dr_t = pre_t (dy F^T)_t + sum_{s<t} A'[t,s] k_s prod_{s<tau<t} w
//          dk_t = post_t (v H^T)_t + sum_{s>t} A'[s,t] r_s prod_{t<tau<s} w
//        (each with its bonus term), and dw directly,
//          dw_t = sum_m G_t[n,m] S_{t-1}[n,m] = pre_t post_t <H_i, F_i>_n
//               + post_t sum_{s<t} k_s prod_{s<tau<t} w (v H^T)_s
//               + sum_{s>t} r_s prod_{t<tau<s} w ((dy F^T)_s pre_t + E_t[s]),
//          E_t[s] = sum_{s'<t} A'[s,s'] k_s' prod_{s'<tau<t} w,
//        E carried along t and the sums over s > t by Horner's rule, all
//        products of w.  The log-space route (w dw as a reverse cumulative
//        sum of r dr - k dk) subtracts large terms and is not taken.
//      A block loads its chunk's r, k, w, v and dy and decays k and r for
//      every sub-chunk, and so holds one sub-chunk's work (T / 16 blocks a
//      (b, h)) in about 106 KB of shared memory.
//   4. `rwkv6_scan_bwd_du_kernel` (shared with the f32 route), du: the
//      per-(b, h, sub-chunk) partials summed over b and the sub-chunks in
//      order.
// - Products: `mma.sync.m16n8k16` (bf16 in, f32 accumulators), operands by
//   `ldmatrix` from XOR-swizzled bf16 tiles, as in csrc/rwkv6_scan.cu.
//   Each f32 operand (the decayed k and r, the states, A) is held as its
//   two pieces hi = bf16(x) and lo = bf16(x - hi), side by side in its
//   tile, and multiplied as hi.hi + lo.hi + hi.lo (two f32 operands) or
//   hi.v + lo.v (v, dy exact in bf16).
// - Copies: r, k, w, v and dy by `cp.async` (16 bytes) where the pointers
//   and strides allow it; the boundary states, stored as groups of four hi
//   then four lo, are unpacked into their tiles.
// - Determinism: no atomics; every output element has one writer, and
//   every sum runs in a fixed order.
// Bound: bytes.  Per token and head the function reads r, k, v, w, dy and
// writes dr, dk, dv, dw (18N bytes in bf16); its products, about twice the
// forward's with the split, are far below the bf16 ridge.  The kernels also
// move the chunk states (four [N,N] f32 a chunk) and read a chunk's tiles
// once for each of its four sub-chunks (mostly from L2).
//
// f32 route (tests only; N in {16, 32, 64}): `rwkv6_scan_bwd_kernel`, the
// exact recurrence.
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
// In f32 the function is about 14 N^2 flops a token and head on the CUDA
// cores (the states once, 3N^2, and the walk back's sums and G update,
// 11N^2), far past its bytes; this kernel runs about 20 N^2 (the states
// twice, G twice), in a sequential walk of one block per (b, h): 2N
// threads a block, each with a chain of N dependent FMAs a token.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int L = 32;   // tokens a chunk: the checkpoint interval

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

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

// du[h][n] = the per-(b, h, piece) partials, part [B, H, npiece, N],
// summed over b and the pieces in order (f32: one piece, the whole
// sequence; bf16: its sub-chunks)
__global__ void rwkv6_scan_bwd_du_kernel(const float* __restrict__ part,
                                         float* __restrict__ du, int B,
                                         int H, int N, int npiece) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * N) return;
  const int h = i / N, n = i % N;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int s = 0; s < npiece; ++s)
      acc += part[(((size_t)b * H + h) * npiece + s) * N + n];
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
      q.du_part, du, B, q.H, N, 1);
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


// ------------------------------------------------------------ bf16 route

constexpr int LC = 64;          // tokens a chunk
constexpr int SUB = 16;         // tokens a sub-chunk (one mma row tile)
constexpr int NS = LC / SUB;    // sub-chunks a chunk
constexpr int NT1 = 128;        // threads of the state kernel (4 warps)
constexpr int NT3 = 256;        // threads of the chunk kernel (8 warps)
// floats between the diagonal tile's four partial sums ([SUB][SUB] each;
// the 8 more put the quarters on different banks)
constexpr int AD_Q = SUB * SUB + 8;

// 16-byte chunks in a shared-memory row of COLS bf16 columns, rounded up
// to 8 so that the XOR swizzle stays inside the row
template <int COLS>
__host__ __device__ constexpr int pitch() {
  return (COLS / 8 + 7) & ~7;
}
template <int COLS>
__host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return rows * pitch<COLS>() * 16;
}
// byte offset of chunk ch of row r in a swizzled tile
template <int COLS>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return (uint32_t)(r * pitch<COLS>() + (ch ^ (r & 7))) * 16u;
}
// byte offset of element (r, col) in a swizzled tile
template <int COLS>
__device__ __forceinline__ uint32_t swe(int r, int col) {
  return swz<COLS>(r, col / 8) + 2 * (col % 8);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// dynamic shared memory, its start rounded up to 256 bytes (the XOR
// addressing needs it; SMEM_SLACK more bytes are asked for)
constexpr uint32_t SMEM_SLACK = 256;

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
// the same, transposed
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

__device__ __forceinline__ float bf(const bf16* p) {
  return __bfloat162float(*p);
}

// one value as its two pieces at byte offsets hi and lo of a tile
__device__ __forceinline__ void put2(uint8_t* t, uint32_t hi, uint32_t lo,
                                     float x) {
  const bf16 h = __float2bfloat16_rn(x);
  *reinterpret_cast<bf16*>(t + hi) = h;
  *reinterpret_cast<bf16*>(t + lo) =
      __float2bfloat16_rn(x - __bfloat162float(h));
}

// four f32 values as pieces: four hi, then four lo
__device__ __forceinline__ float4 pieces(float4 v) {
  uint4 o;
  split2(v.x, v.y, &o.x, &o.z);
  split2(v.z, v.w, &o.y, &o.w);
  return *reinterpret_cast<float4*>(&o);
}

// Lane addresses of ldmatrix patterns in a swizzled tile of COLS columns:
// the A operand (rows r0 .. r0+15, 16 columns from chunk ch0); the B
// operand of two n-tiles from rows = n (r0 ..) x k (chunks ch0, ch0 + 1),
// which with .trans is also the A operand of columns ch0, ch0 + 1 x rows =
// k; the B operand from rows = k (r0 ..) x two n-tiles of columns (.trans).
template <int COLS>
__device__ __forceinline__ uint32_t at_a(int r0, int ch0, int lane) {
  return swz<COLS>(r0 + (lane & 15), ch0 + (lane >> 4));
}
template <int COLS>
__device__ __forceinline__ uint32_t at_bn(int r0, int ch0, int lane) {
  return swz<COLS>(r0 + (lane & 7) + ((lane >> 4) << 3),
                   ch0 + ((lane >> 3) & 1));
}
template <int COLS>
__device__ __forceinline__ uint32_t at_bk(int r0, int ch0, int lane) {
  return swz<COLS>(r0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                   ch0 + (lane >> 4));
}

struct Chunked {
  const bf16 *r, *k, *v, *w, *dy;
  const float *u, *s0, *dsT;
  bf16 *dr, *dk, *dv, *dw;
  float *du, *ds0;
  float* states;    // [B*H, nc, N, N]: chunk states, then S_0 as pieces
  float* adj;       // [B*H, nc, N, N]: local adjoints, then G_L as pieces
  float* dec;       // [B*H, nc, N]: each chunk's total decay
  float* du_part;   // [B*H, nsub, N]
  int H, T, nc, nsub;
  int vec, vec_dy;  // 16-byte tile loads of r, k, v, w and of dy
  long long sb, sh, st, gb, gh, gt, ob, oh, ot;
};

// rows [t0, t0 + LC) of a [T,N] bf16 slice (row stride ld) into a tile of
// LC rows at byte offset dst, swizzled or plain ([LC][N]); rows past T are
// zeros
template <int N, int NTH>
__device__ __forceinline__ void load_rows(uint32_t base, uint8_t* gbase,
                                          uint32_t dst, const bf16* src,
                                          long long ld, int nv, bool vec,
                                          bool swizzled) {
  constexpr int CH = N / 8;
  for (int i = threadIdx.x; i < LC * CH; i += NTH) {
    const int row = i / CH, ch = i % CH;
    const uint32_t d = dst + (swizzled ? swz<N>(row, ch)
                                       : (uint32_t)(row * N + ch * 8) * 2);
    const bool ok = row < nv;
    const bf16* s = src + row * ld + ch * 8;
    if (vec) {
      cp_async16(base + d, ok ? s : src, ok);
    } else {
      bf16* g = reinterpret_cast<bf16*>(gbase + d);
      for (int u = 0; u < 8; ++u) g[u] = ok ? s[u] : __float2bfloat16_rn(0.f);
    }
  }
}

// 1. Per (b, h, chunk): dS = (k . prod_{tau>t} w)^T v, the local adjoint
// (r . prod_{tau<t} w)^T dy and the total decay.  Warp w owns key channels
// 16 w .. 16 w + 15 of both products.
template <int N>
struct StateLay {
  static constexpr uint32_t PL = LC * N * 2;            // a plain tile
  static constexpr uint32_t R = 0, K = R + PL, W = K + PL;
  static constexpr uint32_t V = W + PL, DY = V + tile_bytes<N>(LC);
  // k and r decayed, [LC][hi N | lo N] each
  static constexpr uint32_t KE = DY + tile_bytes<N>(LC);
  static constexpr uint32_t QD = KE + tile_bytes<2 * N>(LC);
  static constexpr uint32_t BYTES = QD + tile_bytes<2 * N>(LC);
};
template <int N>
__global__ void __launch_bounds__(NT1) rwkv6_scan_bwd_state_kernel(Chunked q) {
  using Y = StateLay<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 255u) & ~255u;
  uint8_t* gb = smem_raw + (base - smem_u32(smem_raw));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, ci = blockIdx.y;
  const int b = bh / q.H, h = bh % q.H;
  const int t0 = ci * LC, nv = min(LC, q.T - t0);
  const long long off = b * q.sb + h * q.sh + (long long)t0 * q.st;
  load_rows<N, NT1>(base, gb, Y::R, q.r + off, q.st, nv, q.vec, false);
  load_rows<N, NT1>(base, gb, Y::K, q.k + off, q.st, nv, q.vec, false);
  load_rows<N, NT1>(base, gb, Y::W, q.w + off, q.st, nv, q.vec, false);
  load_rows<N, NT1>(base, gb, Y::V, q.v + off, q.st, nv, q.vec, true);
  load_rows<N, NT1>(base, gb, Y::DY,
                    q.dy + b * q.gb + h * q.gh + (long long)t0 * q.gt, q.gt,
                    nv, q.vec_dy, true);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  // per key channel: r decayed from the chunk's start (and the total
  // decay), k decayed to its end; rows past T decay by nothing
  const bf16* sr = reinterpret_cast<const bf16*>(gb + Y::R);
  const bf16* sk = reinterpret_cast<const bf16*>(gb + Y::K);
  const bf16* sw = reinterpret_cast<const bf16*>(gb + Y::W);
  for (int p = tid; p < 2 * N; p += NT1) {
    const int n = p % N;
    if (p < N) {
      float pre = 1.f;
      for (int t = 0; t < LC; ++t) {
        put2(gb + Y::QD, swe<2 * N>(t, n), swe<2 * N>(t, N + n),
             bf(sr + t * N + n) * pre);
        pre *= t < nv ? bf(sw + t * N + n) : 1.f;
      }
      q.dec[((size_t)bh * q.nc + ci) * N + n] = pre;
    } else {
      float post = 1.f;
      for (int t = LC - 1; t >= 0; --t) {
        put2(gb + Y::KE, swe<2 * N>(t, n), swe<2 * N>(t, N + n),
             bf(sk + t * N + n) * post);
        post *= t < nv ? bf(sw + t * N + n) : 1.f;
      }
    }
  }
  __syncthreads();
  if (16 * warp >= N) return;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const uint32_t a_t = base + (pass ? Y::QD : Y::KE);
    const uint32_t b_t = base + (pass ? Y::DY : Y::V);
    float acc[N / 8][4];
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < LC / 16; ++ks) {
      uint32_t ah[4], al[4];
      ldsm4t(ah, a_t + at_bn<2 * N>(16 * ks, 2 * warp, lane));
      ldsm4t(al, a_t + at_bn<2 * N>(16 * ks, N / 8 + 2 * warp, lane));
#pragma unroll
      for (int mt = 0; mt < N / 16; ++mt) {
        uint32_t bb[4];
        ldsm4t(bb, b_t + at_bk<N>(16 * ks, 2 * mt, lane));
        mma(acc[2 * mt], ah, bb[0], bb[1]);
        mma(acc[2 * mt], al, bb[0], bb[1]);
        mma(acc[2 * mt + 1], ah, bb[2], bb[3]);
        mma(acc[2 * mt + 1], al, bb[2], bb[3]);
      }
    }
    float* out = (pass ? q.adj : q.states) + ((size_t)bh * q.nc + ci) * N * N;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 16 * warp + g + 8 * e;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
        *reinterpret_cast<float2*>(out + (size_t)n * N + 8 * nt + 2 * tq) =
            make_float2(acc[nt][2 * e], acc[nt][2 * e + 1]);
    }
  }
}

// 2. S_0[c] = Dall[c-1] S_0[c-1] + dS[c-1] from s0 (or zeros), then
// G_L[c] = Dall[c+1] G_L[c+1] + (local adjoint)[c+1] from dsT (or zeros),
// ds0 = Dall[0] G_L[0] + (local adjoint)[0], the decays by rows; in f32,
// written in place of the value read as pieces.  One thread per 4
// consecutive values of one (b, h)'s state (all in one row), the loads of
// KC chunks issued together.
constexpr int KC = 8;
__global__ void rwkv6_scan_bwd_pass_kernel(float* __restrict__ states,
                                           float* __restrict__ adj,
                                           const float* __restrict__ dec,
                                           const float* __restrict__ s0,
                                           const float* __restrict__ dsT,
                                           float* __restrict__ ds0, int BH,
                                           int N, int nc) {
  const int nn4 = N * N / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)BH * nn4) return;
  const int bh = (int)(i / nn4), e = (int)(i % nn4), row = e / (N / 4);
  const float* dp = dec + (size_t)bh * nc * N + row;
  float4* sp = reinterpret_cast<float4*>(states) + (size_t)bh * nc * nn4 + e;
  float4* ap = reinterpret_cast<float4*>(adj) + (size_t)bh * nc * nn4 + e;
  float4 v = s0 ? reinterpret_cast<const float4*>(s0)[i]
                : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += KC) {
    float4 sc[KC];
    float dc[KC];
#pragma unroll
    for (int u = 0; u < KC; ++u)
      if (c0 + u < nc) {
        sc[u] = sp[(size_t)(c0 + u) * nn4];
        dc[u] = dp[(size_t)(c0 + u) * N];
      }
#pragma unroll
    for (int u = 0; u < KC; ++u)
      if (c0 + u < nc) {
        sp[(size_t)(c0 + u) * nn4] = pieces(v);
        v = make_float4(fmaf(dc[u], v.x, sc[u].x), fmaf(dc[u], v.y, sc[u].y),
                        fmaf(dc[u], v.z, sc[u].z), fmaf(dc[u], v.w, sc[u].w));
      }
  }
  v = dsT ? reinterpret_cast<const float4*>(dsT)[i]
          : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = nc - 1; c0 >= 0; c0 -= KC) {
    float4 sc[KC];
    float dc[KC];
#pragma unroll
    for (int u = 0; u < KC; ++u)
      if (c0 - u >= 0) {
        sc[u] = ap[(size_t)(c0 - u) * nn4];
        dc[u] = dp[(size_t)(c0 - u) * N];
      }
#pragma unroll
    for (int u = 0; u < KC; ++u)
      if (c0 - u >= 0) {
        ap[(size_t)(c0 - u) * nn4] = pieces(v);
        v = make_float4(fmaf(dc[u], v.x, sc[u].x), fmaf(dc[u], v.y, sc[u].y),
                        fmaf(dc[u], v.z, sc[u].z), fmaf(dc[u], v.w, sc[u].w));
      }
  }
  if (ds0) reinterpret_cast<float4*>(ds0)[i] = v;
}

// 3. Per (b, h, sub-chunk).  Shared memory, byte offsets from the
// 256-aligned base.
template <int N>
struct ChunkLay {
  static constexpr uint32_t PL = LC * N * 2;           // a plain tile
  static constexpr uint32_t TW = tile_bytes<2 * N>(LC);
  // the chunk's r, k, w, plain [LC][N]; v and dy swizzled
  static constexpr uint32_t R = 0, K = R + PL, W = K + PL;
  static constexpr uint32_t V = W + PL, DY = V + tile_bytes<N>(LC);
  // [LC][hi N | lo N]: kloc in the rows of sub-chunks j <= i, qloc in
  // those of j > i
  static constexpr uint32_t LOC = DY + tile_bytes<N>(LC);
  // F_i and H_i, [N][hi N | lo N] each
  static constexpr uint32_t F = LOC + TW;
  static constexpr uint32_t H = F + tile_bytes<2 * N>(N);
  // the diagonal tile A[s][t] as an A operand's pieces, [SUB][hi 16 | lo 16]
  static constexpr uint32_t AT = H + tile_bytes<2 * N>(N);
  // f32: g [NS][N], u [N], <H, F> partials [N/16][N], dy F^T and v H^T
  // [SUB][N] each, A' [SUB][SUB + 1], A's partials [4][AD_Q]
  static constexpr uint32_t G = AT + tile_bytes<32>(SUB);
  static constexpr uint32_t U = G + NS * N * 4;
  static constexpr uint32_t CP = U + N * 4;
  static constexpr uint32_t DF = CP + (N / 16) * N * 4;
  static constexpr uint32_t VH = DF + SUB * N * 4;
  static constexpr uint32_t AP = VH + SUB * N * 4;
  static constexpr uint32_t AD = AP + SUB * (SUB + 1) * 4;
  static constexpr uint32_t BYTES = AD + 4 * AD_Q * 4;
};

template <int N>
__global__ void __launch_bounds__(NT3, 2) rwkv6_scan_bwd_chunk_kernel(Chunked q) {
  using Y = ChunkLay<N>;
  constexpr int KS = N / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 255u) & ~255u;
  uint8_t* gb = smem_raw + (base - smem_u32(smem_raw));
  const bf16* sr = reinterpret_cast<const bf16*>(gb + Y::R);
  const bf16* sk = reinterpret_cast<const bf16*>(gb + Y::K);
  const bf16* sw = reinterpret_cast<const bf16*>(gb + Y::W);
  float* sg = reinterpret_cast<float*>(gb + Y::G);
  float* su = reinterpret_cast<float*>(gb + Y::U);
  float* scp = reinterpret_cast<float*>(gb + Y::CP);
  float* sdf = reinterpret_cast<float*>(gb + Y::DF);
  float* svh = reinterpret_cast<float*>(gb + Y::VH);
  float* sap = reinterpret_cast<float*>(gb + Y::AP);
  float* sad = reinterpret_cast<float*>(gb + Y::AD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, sub = blockIdx.y;
  const int ci = sub / NS, i = sub % NS;
  const int b = bh / q.H, h = bh % q.H;
  const int t0 = ci * LC, nv = min(LC, q.T - t0);
  const long long off = b * q.sb + h * q.sh + (long long)t0 * q.st;
  load_rows<N, NT3>(base, gb, Y::R, q.r + off, q.st, nv, q.vec, false);
  load_rows<N, NT3>(base, gb, Y::K, q.k + off, q.st, nv, q.vec, false);
  load_rows<N, NT3>(base, gb, Y::W, q.w + off, q.st, nv, q.vec, false);
  load_rows<N, NT3>(base, gb, Y::V, q.v + off, q.st, nv, q.vec, true);
  load_rows<N, NT3>(base, gb, Y::DY,
                    q.dy + b * q.gb + h * q.gh + (long long)t0 * q.gt, q.gt,
                    nv, q.vec_dy, true);
  cp_commit();
  for (int n = tid; n < N; n += NT3) su[n] = q.u[h * N + n];
  cp_wait_all();
  __syncthreads();

  // 1a. per (sub-chunk j, key channel n), a walk over its 16 tokens: g_j,
  // and kloc = k . prod_{tau>t} w (j <= i) or qloc = r . prod_{tau<t} w
  // (j > i), as pieces; rows past T decay by nothing
  for (int p = tid; p < NS * N; p += NT3) {
    const int j = p / N, n = p % N, r0 = SUB * j;
    float wv[SUB], tot = 1.f;
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      wv[t] = r0 + t < nv ? bf(sw + (r0 + t) * N + n) : 1.f;
      tot *= wv[t];
    }
    sg[j * N + n] = tot;
    if (j > i) {
      float pre = 1.f;
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        put2(gb + Y::LOC, swe<2 * N>(r0 + t, n), swe<2 * N>(r0 + t, N + n),
             bf(sr + (r0 + t) * N + n) * pre);
        pre *= wv[t];
      }
    } else {
      float post = 1.f;
#pragma unroll
      for (int t = SUB - 1; t >= 0; --t) {
        put2(gb + Y::LOC, swe<2 * N>(r0 + t, n), swe<2 * N>(r0 + t, N + n),
             bf(sk + (r0 + t) * N + n) * post);
        post *= wv[t];
      }
    }
  }
  // 1b. sub-chunk i's diagonal tile A[t][s] = sum_n r_t k_s prod_{s<tau<t}
  // w for s < t, as four partial sums (a quarter of the key channels each),
  // and the bonus sum_n r_t u k_t at s = t (csrc/rwkv6_scan.cu's walk):
  // warps 0-3 take roles 0-3.  Warp 4: A'[t][s] = dy_t . v_s.
  const int r0 = SUB * i;
  if (warp < 4) {
    constexpr int CPL = N / 4, C4 = N / 16;   // channels a lane, blocks
    const int wc = warp, gp = lane >> 2, qn = lane & 3;
    if (wc < 3) {
      const int s = (wc == 1 ? 8 : 0) + gp;     // 15: no column
      const int t_lo = wc == 0 ? 1 : 9, t_hi = wc == 0 ? 9 : SUB;
      float kd[CPL];
#pragma unroll
      for (int c4 = 0; c4 < C4; ++c4) {
        const uint2 x = *reinterpret_cast<const uint2*>(
            sk + (r0 + min(s, SUB - 1)) * N + 16 * c4 + 4 * qn);
        const float2 a = unpack_bf16(x.x), e = unpack_bf16(x.y);
        kd[4 * c4] = a.x;
        kd[4 * c4 + 1] = a.y;
        kd[4 * c4 + 2] = e.x;
        kd[4 * c4 + 3] = e.y;
      }
      if (wc == 2)                              // k_s prod_{s<tau<9} w
        for (int t = 1; t < 9; ++t)
#pragma unroll
          for (int c4 = 0; c4 < C4; ++c4) {
            const uint2 xw = *reinterpret_cast<const uint2*>(
                sw + (r0 + t) * N + 16 * c4 + 4 * qn);
            const float2 wa = unpack_bf16(xw.x), wb = unpack_bf16(xw.y);
            const float wv[4] = {wa.x, wa.y, wb.x, wb.y};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (s < t) kd[4 * c4 + e] *= wv[e];
          }
      for (int t = t_lo; t < t_hi; ++t) {
        float acc[C4];
#pragma unroll
        for (int c4 = 0; c4 < C4; ++c4) {
          const int o = (r0 + t) * N + 16 * c4 + 4 * qn;
          const uint2 xr = *reinterpret_cast<const uint2*>(sr + o);
          const uint2 xw = *reinterpret_cast<const uint2*>(sw + o);
          const float2 ra = unpack_bf16(xr.x), rb = unpack_bf16(xr.y);
          const float2 wa = unpack_bf16(xw.x), wb = unpack_bf16(xw.y);
          const float rv[4] = {ra.x, ra.y, rb.x, rb.y};
          const float wv[4] = {wa.x, wa.y, wb.x, wb.y};
          acc[c4] = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = 4 * c4 + e;
            acc[c4] = fmaf(rv[e], kd[jj], acc[c4]);
            if (s < t) kd[jj] *= wv[e];
          }
        }
#pragma unroll
        for (int c4 = 1; c4 < C4; ++c4) acc[0] += acc[c4];
        if (s < t) sad[qn * AD_Q + t * SUB + s] = acc[0];
      }
    } else {
      // two lanes a row, each over half the channels in pairs, the pairs
      // rotated by the row so that the 16 rows fall on different banks
      constexpr int PH = N / 4;     // channel pairs a half
      const int t = lane >> 1, half = lane & 1;
      const uint32_t* rw = reinterpret_cast<const uint32_t*>(sr + (r0 + t) * N);
      const uint32_t* kw = reinterpret_cast<const uint32_t*>(sk + (r0 + t) * N);
      float bonus = 0.f;
#pragma unroll
      for (int jj = 0; jj < PH; ++jj) {
        const int x = half * PH + (jj + t) % PH;
        const float2 rv = unpack_bf16(rw[x]), kv = unpack_bf16(kw[x]);
        bonus = fmaf(rv.x * su[2 * x], kv.x, bonus);
        bonus = fmaf(rv.y * su[2 * x + 1], kv.y, bonus);
      }
      bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
      sad[(2 * half) * AD_Q + t * (SUB + 1)] = half ? 0.f : bonus;
      sad[(2 * half + 1) * AD_Q + t * (SUB + 1)] = 0.f;
    }
  } else if (warp == 4) {
    float acc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4], bb[4];
      ldsm4(a, base + Y::DY + at_a<N>(r0, 2 * ks, lane));
      ldsm4(bb, base + Y::V + at_bn<N>(r0, 2 * ks, lane));
      mma(acc[0], a, bb[0], bb[1]);
      mma(acc[1], a, bb[2], bb[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sap[(g + 8 * (e >> 1)) * (SUB + 1) + 8 * nt + 2 * tq + (e & 1)] =
            acc[nt][e];
  }
  __syncthreads();

  // 2a. the diagonal tile's partials added, zero above the diagonal, as
  // the A operand's two pieces; a thread per (row, pair of columns)
  for (int e = tid; e < SUB * SUB / 2; e += NT3) {
    const int t = e / (SUB / 2), s = 2 * (e % (SUB / 2));
    const float* ad = sad + t * SUB + s;
    float v[2];
#pragma unroll
    for (int z = 0; z < 2; ++z)
      v[z] = s + z <= t ? (ad[z] + ad[AD_Q + z]) +
                              (ad[2 * AD_Q + z] + ad[3 * AD_Q + z])
                        : 0.f;
    uint32_t hi, lo;
    split2(v[0], v[1], &hi, &lo);
    *reinterpret_cast<uint32_t*>(gb + Y::AT + swz<32>(t, s / 8) + 2 * (s % 8)) =
        hi;
    *reinterpret_cast<uint32_t*>(gb + Y::AT + swz<32>(t, 2 + s / 8) +
                                 2 * (s % 8)) = lo;
  }
  // 2b. F_i and H_i, one 16 x 16 tile (rows rt, columns ct) of each per
  // job, and the tile's share of <H_i, F_i> by rows
  {
    const size_t so = ((size_t)bh * q.nc + ci) * N * N;
    for (int jb = warp; jb < KS * KS; jb += NT3 / 32) {
      const int rt = jb / KS, ct = jb % KS;
      float fa[2][4], ha[2][4];
      // the boundary states' values at this lane's places, from pieces
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 16 * rt + g + 8 * e, m = 16 * ct + 8 * nt + 2 * tq;
          const size_t grp = (so + (size_t)n * N + m) / 4 * 4;
          const int pos = m % 4;
          const uint32_t* sgrp = reinterpret_cast<const uint32_t*>(q.states + grp);
          const uint32_t* agrp = reinterpret_cast<const uint32_t*>(q.adj + grp);
          const float2 shi = unpack_bf16(sgrp[pos / 2]);
          const float2 slo = unpack_bf16(sgrp[2 + pos / 2]);
          const float2 ghi = unpack_bf16(agrp[pos / 2]);
          const float2 glo = unpack_bf16(agrp[2 + pos / 2]);
          fa[nt][2 * e] = shi.x + slo.x;
          fa[nt][2 * e + 1] = shi.y + slo.y;
          ha[nt][2 * e] = ghi.x + glo.x;
          ha[nt][2 * e + 1] = ghi.y + glo.y;
        }
      const int n0 = 16 * rt + g;
      // F <- g_j . F + kloc_j^T v_j, j < i
      for (int j = 0; j < i; ++j) {
        const float f0 = sg[j * N + n0], f1 = sg[j * N + n0 + 8];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          fa[nt][0] *= f0;
          fa[nt][1] *= f0;
          fa[nt][2] *= f1;
          fa[nt][3] *= f1;
        }
        uint32_t ah[4], al[4], bb[4];
        ldsm4t(ah, base + Y::LOC + at_bn<2 * N>(SUB * j, 2 * rt, lane));
        ldsm4t(al, base + Y::LOC + at_bn<2 * N>(SUB * j, N / 8 + 2 * rt, lane));
        ldsm4t(bb, base + Y::V + at_bk<N>(SUB * j, 2 * ct, lane));
        mma(fa[0], ah, bb[0], bb[1]);
        mma(fa[0], al, bb[0], bb[1]);
        mma(fa[1], ah, bb[2], bb[3]);
        mma(fa[1], al, bb[2], bb[3]);
      }
      // H <- g_j . H + qloc_j^T dy_j, j > i
      for (int j = NS - 1; j > i; --j) {
        const float f0 = sg[j * N + n0], f1 = sg[j * N + n0 + 8];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          ha[nt][0] *= f0;
          ha[nt][1] *= f0;
          ha[nt][2] *= f1;
          ha[nt][3] *= f1;
        }
        uint32_t ah[4], al[4], bb[4];
        ldsm4t(ah, base + Y::LOC + at_bn<2 * N>(SUB * j, 2 * rt, lane));
        ldsm4t(al, base + Y::LOC + at_bn<2 * N>(SUB * j, N / 8 + 2 * rt, lane));
        ldsm4t(bb, base + Y::DY + at_bk<N>(SUB * j, 2 * ct, lane));
        mma(ha[0], ah, bb[0], bb[1]);
        mma(ha[0], al, bb[0], bb[1]);
        mma(ha[1], ah, bb[2], bb[3]);
        mma(ha[1], al, bb[2], bb[3]);
      }
      // <H, F> over this tile's columns, by rows (a quad holds a row)
      float c[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        c[e] = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          c[e] = fmaf(ha[nt][2 * e], fa[nt][2 * e], c[e]);
          c[e] = fmaf(ha[nt][2 * e + 1], fa[nt][2 * e + 1], c[e]);
        }
        c[e] += __shfl_xor_sync(0xffffffffu, c[e], 1);
        c[e] += __shfl_xor_sync(0xffffffffu, c[e], 2);
        if (tq == 0) scp[ct * N + n0 + 8 * e] = c[e];
      }
      // F and H as pieces
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * e, ch = 2 * ct + nt;
          uint32_t hi, lo;
          split2(fa[nt][2 * e], fa[nt][2 * e + 1], &hi, &lo);
          *reinterpret_cast<uint32_t*>(gb + Y::F + swz<2 * N>(n, ch) + 4 * tq) = hi;
          *reinterpret_cast<uint32_t*>(gb + Y::F + swz<2 * N>(n, N / 8 + ch) +
                                       4 * tq) = lo;
          split2(ha[nt][2 * e], ha[nt][2 * e + 1], &hi, &lo);
          *reinterpret_cast<uint32_t*>(gb + Y::H + swz<2 * N>(n, ch) + 4 * tq) = hi;
          *reinterpret_cast<uint32_t*>(gb + Y::H + swz<2 * N>(n, N / 8 + ch) +
                                       4 * tq) = lo;
        }
    }
  }
  __syncthreads();

  // 3. dy_i F_i^T and v_i H_i^T into shared memory (f32), and dv_i =
  // kloc_i H_i + A^T dy_i to the output; a 16-column tile a job
  for (int jb = warp; jb < 3 * KS; jb += NT3 / 32) {
    const int kind = jb / KS, ct = jb % KS;
    float acc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    if (kind < 2) {
      const uint32_t a_t = base + (kind ? Y::V : Y::DY);
      const uint32_t s_t = base + (kind ? Y::H : Y::F);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4], bh_[4], bl[4];
        ldsm4(a, a_t + at_a<N>(r0, 2 * ks, lane));
        ldsm4(bh_, s_t + at_bn<2 * N>(16 * ct, 2 * ks, lane));
        ldsm4(bl, s_t + at_bn<2 * N>(16 * ct, N / 8 + 2 * ks, lane));
        mma(acc[0], a, bh_[0], bh_[1]);
        mma(acc[0], a, bl[0], bl[1]);
        mma(acc[1], a, bh_[2], bh_[3]);
        mma(acc[1], a, bl[2], bl[3]);
      }
      float* o = kind ? svh : sdf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(o + (g + 8 * e) * N + 16 * ct + 8 * nt +
                                     2 * tq) =
              make_float2(acc[nt][2 * e], acc[nt][2 * e + 1]);
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[4], al[4], bh_[4], bl[4];
        ldsm4(ah, base + Y::LOC + at_a<2 * N>(r0, 2 * ks, lane));
        ldsm4(al, base + Y::LOC + at_a<2 * N>(r0, N / 8 + 2 * ks, lane));
        ldsm4t(bh_, base + Y::H + at_bk<2 * N>(16 * ks, 2 * ct, lane));
        ldsm4t(bl, base + Y::H + at_bk<2 * N>(16 * ks, N / 8 + 2 * ct, lane));
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma(acc[nt], ah, bh_[2 * nt], bh_[2 * nt + 1]);
          mma(acc[nt], al, bh_[2 * nt], bh_[2 * nt + 1]);
          mma(acc[nt], ah, bl[2 * nt], bl[2 * nt + 1]);
        }
      }
      {  // A^T as the A operand: .trans of the [s][t] tile
        uint32_t ah[4], al[4], bb[4];
        ldsm4t(ah, base + Y::AT + at_bn<32>(0, 0, lane));
        ldsm4t(al, base + Y::AT + at_bn<32>(0, 2, lane));
        ldsm4t(bb, base + Y::DY + at_bk<N>(r0, 2 * ct, lane));
        mma(acc[0], ah, bb[0], bb[1]);
        mma(acc[0], al, bb[0], bb[1]);
        mma(acc[1], ah, bb[2], bb[3]);
        mma(acc[1], al, bb[2], bb[3]);
      }
      bf16* dvp = q.dv + b * q.ob + h * q.oh + 16 * ct;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + g + 8 * e;
        if (row >= nv) continue;
        bf16* o = dvp + (long long)(t0 + row) * q.ot;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int m = 8 * nt + 2 * tq;
          o[m] = __float2bfloat16_rn(acc[nt][2 * e]);
          o[m + 1] = __float2bfloat16_rn(acc[nt][2 * e + 1]);
        }
      }
    }
  }
  __syncthreads();

  // 4. per key channel n, the walk over the sub-chunk's tokens: dr, dk,
  // dw and the partial of du
  for (int n = tid; n < N; n += NT3) {
    float rv[SUB], wv[SUB], post[SUB], e_[SUB];
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      const int row = r0 + t;
      rv[t] = bf(sr + row * N + n);
      wv[t] = row < nv ? bf(sw + row * N + n) : 1.f;
      e_[t] = 0.f;
    }
    float run = 1.f;
#pragma unroll
    for (int t = SUB - 1; t >= 0; --t) {
      post[t] = run;
      run *= wv[t];
    }
    float cn = 0.f;
#pragma unroll
    for (int ct = 0; ct < KS; ++ct) cn += scp[ct * N + n];
    const float un = su[n];
    float pre = 1.f, bv = 0.f, du = 0.f;
    const long long o = b * q.ob + h * q.oh + n;
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      const float kt = bf(sk + (r0 + t) * N + n);
      float acc_w = 0.f, acc_k = 0.f;
#pragma unroll
      for (int s = SUB - 1; s > t; --s) {
        acc_w = fmaf(rv[s], fmaf(pre, sdf[s * N + n], e_[s]), wv[s] * acc_w);
        acc_k = fmaf(rv[s], sap[s * (SUB + 1) + t], wv[s] * acc_k);
      }
      const float vdy = sap[t * (SUB + 1) + t];
      const float dr = fmaf(un * kt, vdy, fmaf(pre, sdf[t * N + n], e_[t]));
      const float dk =
          fmaf(un * rv[t], vdy, fmaf(post[t], svh[t * N + n], acc_k));
      const float dw = fmaf(pre * post[t], cn, fmaf(post[t], bv, acc_w));
      du = fmaf(rv[t] * kt, vdy, du);
      const int row = r0 + t;
      if (row < nv) {
        const long long p = o + (long long)(t0 + row) * q.ot;
        q.dr[p] = __float2bfloat16_rn(dr);
        q.dk[p] = __float2bfloat16_rn(dk);
        q.dw[p] = __float2bfloat16_rn(dw);
      }
#pragma unroll
      for (int s = t + 1; s < SUB; ++s)
        e_[s] = fmaf(wv[t], e_[s], sap[s * (SUB + 1) + t] * kt);
      bv = fmaf(wv[t], bv, kt * svh[t * N + n]);
      pre *= wv[t];
    }
    q.du_part[((size_t)bh * q.nsub + sub) * N + n] = du;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <int N>
int launch_chunked(const Chunked& q, int B, cudaStream_t st) {
  const int BH = B * q.H;
  cudaError_t err;
  if (q.nc > 0) {
    auto k1 = rwkv6_scan_bwd_state_kernel<N>;
    const int s1 = (int)(StateLay<N>::BYTES + SMEM_SLACK);
    err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               s1);
    if (err != cudaSuccess) return (int)err;
    k1<<<dim3(BH, q.nc), NT1, s1, st>>>(q);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const long long n4 = (long long)BH * N * N / 4;
  rwkv6_scan_bwd_pass_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
      q.states, q.adj, q.dec, q.s0, q.dsT, q.ds0, BH, N, q.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (q.nsub > 0) {
    auto k3 = rwkv6_scan_bwd_chunk_kernel<N>;
    const int s3 = (int)(ChunkLay<N>::BYTES + SMEM_SLACK);
    err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               s3);
    if (err != cudaSuccess) return (int)err;
    k3<<<dim3(BH, q.nsub), NT3, s3, st>>>(q);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int hn = q.H * N;
  rwkv6_scan_bwd_du_kernel<<<(hn + 255) / 256, 256, 0, st>>>(
      q.du_part, q.du, B, q.H, N, q.nsub);
  return (int)cudaGetLastError();
}
}  // namespace

// Tokens between the f32 route's checkpoints, and a chunk of the bf16
// route: the wrapper sizes the scratch below with them.
extern "C" int rwkv6_scan_bwd_chunk() { return L; }
extern "C" int rwkv6_scan_bwd_bf16_chunk() { return LC; }

// r, k, v, w [B,H,T,N] in f32 (dtype 0) or bf16 (dtype 1), element strides
// (sb, sh, st), unit stride along N; dy the same with strides (gb, gh, gt);
// u [H,N] f32; s0, dsT [B,H,N,N] f32 or null.  Writes dr, dk, dv, dw (the
// inputs' dtype, strides (ob, oh, ot)), du [H,N] f32 and, if not null, ds0
// [B,H,N,N] f32.  N in {16, 32, 64}.  f32 scratch buffers, nc =
// ceil(T / rwkv6_scan_bwd_chunk()) in f32 and ceil(T / rwkv6_scan_bwd_bf16_chunk())
// in bf16:
// - f32: ckpt [B*H, nc, N, N], states [B*H, L, N, N] (a thread keeps a row
//   of G and of S in registers: at 128, 256 floats, it would spill),
//   du_part [B,H,N];
// - bf16: states and adjoints [B*H, nc, N, N], decays [B*H, nc, N],
//   du_part [B*H, ceil(T / 16), N].
// Two kernels in f32, four in bf16; returns the first failing launch's
// cudaError_t.
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* dy, const void* u, const void* s0, const void* dsT, void* dr,
    void* dk, void* dv, void* dw, void* du, void* ds0, void* const* scratch,
    int B, int H, int Tn, int N, int dtype, long long sb, long long sh,
    long long st, long long gb, long long gh, long long gt, long long ob,
    long long oh, long long ot, void* stream) {
  if (B * H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (N != 16 && N != 32 && N != 64) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    Chunked q;
    q.r = (const bf16*)r;
    q.k = (const bf16*)k;
    q.v = (const bf16*)v;
    q.w = (const bf16*)w;
    q.dy = (const bf16*)dy;
    q.u = (const float*)u;
    q.s0 = (const float*)s0;
    q.dsT = (const float*)dsT;
    q.dr = (bf16*)dr;
    q.dk = (bf16*)dk;
    q.dv = (bf16*)dv;
    q.dw = (bf16*)dw;
    q.du = (float*)du;
    q.ds0 = (float*)ds0;
    q.states = (float*)scratch[0];
    q.adj = (float*)scratch[1];
    q.dec = (float*)scratch[2];
    q.du_part = (float*)scratch[3];
    q.H = H;
    q.T = Tn;
    q.nc = (Tn + LC - 1) / LC;
    q.nsub = (Tn + SUB - 1) / SUB;
    if (q.nc > 65535 || q.nsub > 65535) return (int)cudaErrorInvalidValue;
    q.sb = sb;
    q.sh = sh;
    q.st = st;
    q.gb = gb;
    q.gh = gh;
    q.gt = gt;
    q.ob = ob;
    q.oh = oh;
    q.ot = ot;
    q.vec = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
            sb % 8 == 0 && sh % 8 == 0 && st % 8 == 0;
    q.vec_dy = aligned16(dy) && gb % 8 == 0 && gh % 8 == 0 && gt % 8 == 0;
    switch (N) {
      case 16: return launch_chunked<16>(q, B, s);
      case 32: return launch_chunked<32>(q, B, s);
      default: return launch_chunked<64>(q, B, s);
    }
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
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
  q.du_part = (float*)scratch[2];
  q.ds0 = (float*)ds0;
  q.ckpt = (float*)scratch[0];
  q.states = (float*)scratch[1];
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
  return dispatch_n<float>(q, B, N, (float*)du, s);
}
