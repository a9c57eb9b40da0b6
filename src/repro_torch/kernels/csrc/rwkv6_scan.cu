// RWKV6 WKV scan for Hopper: the recurrence, per (batch, head),
//     y_t = r_t^T (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T,
// with S an [N,N] f32 state (key channel n, value channel m) and a
// data-dependent decay w_t in (0, 1] per key channel.  f32 inside; y is
// written in the inputs' dtype, sT in f32.  Any T (0 included).
//
// Replaces `_kernel` / `rwkv6_pallas`
// (src/repro/kernels/rwkv6_scan/rwkv6_scan.py:20 / :59).  The TPU kernel
// walks chunks on a sequential grid axis with S in VMEM and turns each
// chunk into MXU matmuls by factoring the decay as
// exp(la_prev) * exp(min(-la, 30)), with la the cumulative log decay from
// the chunk's start.  That is wrong once a chunk's cumulative decay falls
// below e^-30, which the model's decays (down to 0.0113 a token) reach in
// about 7 tokens; without the clamp exp(-la) overflows f32 past e^88.
//
// bf16 route (the model's): the same chunked form on the tensor cores,
// cut so that no decay factor is ever larger than 1 (the secondary
// chunking of Gated Linear Attention, Yang et al., arXiv:2312.06635).  One
// block of sixteen warps per (b, h, MB value columns), MB = min(N, 64) (32
// at N 128, for shared memory): the columns of S evolve independently, so
// the split is exact (128 blocks at rwkv6-1.6b's [4,32,T,64]).  The block
// walks T in chunks of L = 64 tokens (the loop replaces the sequential grid
// axis) and keeps its [N, MB] slice of S in f32 registers as mma
// accumulators.  A chunk is four sub-chunks of SUB = 16 tokens.  With g a
// sub-chunk's total decay (the product of its w):
//   qloc_t = r_t prod_{tau<t} w_tau,   kloc_s = k_s prod_{tau>s} w_tau,
//   y_i  = (qloc_i . Gpre_i) S + sum_{j<i} A_ij V_j + A_ii V_i,
//   A_ij = (qloc_i . G_ij) kloc_j^T  (j < i),
//   A_ii[t,s] = sum_n r_t k_s prod_{s<tau<t} w_tau  (s < t),
//   A_ii[t,t] = sum_n r_t u k_t,
//   S <- diag(Gall) S + sum_j diag(Gpost_j) (kloc_j^T V_j),
// where Gpre_i, G_ij, Gpost_j and Gall are products of the sub-chunks' g
// before i, between j and i, after j and over all four.  Every decay is a
// product of factors w in (0, 1], as in the recurrence itself: there is no
// exponential, so nothing is clamped and nothing overflows, and a term
// only underflows where its true value is below f32's range.
// Per chunk, three intervals between barriers, each spread over all
// sixteen warps (warp = sub-chunk i + 4 x column group or role):
//   1. two threads per (sub-chunk, key channel) walk the sub-chunk's
//      halves: qloc (f32), kloc (as its two bf16 pieces) and g; and, from
//      the raw tiles alone, the warps of sub-chunk i compute its diagonal
//      tile (roles 0-2 its columns s < 8 and s >= 8, role 3 the bonus), as
//      f32 partial sums;
//   2. q_state = qloc . Gpre and the summed diagonal tiles are written as
//      the two pieces of A operands; six warps compute A_ij, one pair each;
//      every warp (i, column group) updates its share of the state, as
//      diag(Gall) S + sum_j diag(Gpost_j) (kloc_j^T V_j), the decays of
//      the rows applied to each product; the next chunk's r, k, w load;
//   3. warp (i, column group) computes y = q_state S + sum_j A_ij V_j (the
//      diagonal tile at j = i), all operands by ldmatrix, stores y, and
//      writes its part of S into the other of two S buffers.
// - Products: `mma.sync.m16n8k16` (bf16 in, f32 accumulators), operands
//   by `ldmatrix` (.trans where the product runs along the tile's rows)
//   from XOR-swizzled bf16 tiles, except the A_ij operand qloc . G_ij,
//   which is scaled and cut in registers.  Each f32 operand (the decayed r
//   and k, A, S) is cut into hi = bf16(x) and lo = bf16(x - hi), the two
//   pieces side by side in its tile, and multiplied as hi.hi + lo.hi +
//   hi.lo (two f32 operands) or hi.v + lo.v (v is exact in bf16), about
//   2^-16 relative a term, as csrc/mamba2_ssd.cu does.
// - Copies: every tile by `cp.async` (16 bytes, zeros past the end of T)
//   where the pointers and strides allow it, else element by element; the
//   next chunk's r, k, w load during intervals 2 and 3 of this one, and v
//   is double-buffered.
// - Determinism: no atomics; every output element has one writer.
// Bound: bytes.  Per token and head the function reads r, k, v, w and
// writes y (10N bytes in bf16); the products come to about 15 N^2 flops a
// token and head with the split, far below the bf16 ridge.  What holds
// the kernel above that bound is the chunk walk: a block's intervals run
// one after another, 16 chunks at T 1024, one block an SM, each interval
// bound by its slowest warp and by shared-memory traffic (PERF.md has the
// measured cost of each part).
//
// f32 route (tests only): `rwkv6_scan_fma_kernel`, the exact recurrence,
// one block per (b, h) and one thread per value channel m holding column m
// of S in registers; its y[m] is one dependent FMA chain per token.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------- f32 route

constexpr int kRun = 32;   // tokens staged in shared memory per pass

// One block per (b, h), blockDim.x == N.  r/k/v/w are [B,H,T,N] with
// element strides (sb, sh, st) and unit stride along N; y has strides
// (yb, yh, yt).  u [H,N], s0/sT [B,H,N,N] contiguous; s0 may be null.
template <int N>
__global__ void __launch_bounds__(N)
rwkv6_scan_fma_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ s0, float* __restrict__ y,
                      float* __restrict__ sT, int H, int Tn, long long sb,
                      long long sh, long long st, long long yb, long long yh,
                      long long yt) {
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
  const float* rp = r + b * sb + h * sh;
  const float* kp = k + b * sb + h * sh;
  const float* vp = v + b * sb + h * sh;
  const float* wp = w + b * sb + h * sh;
  float* yp = y + b * yb + h * yh;

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
      const float rv = rp[off], kv = kp[off];
      sr[i] = rv;
      sk[i] = kv;
      sw[i] = wp[off];
      sv[i] = vp[off];
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
      yp[(long long)(t0 + tt) * yt + m] = fmaf(bonus, vm, acc);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) sT[((size_t)bh * N + n) * N + m] = S[n];
}

template <int N>
int launch_fma(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* s0, void* y, void* sT, int B, int H,
               int Tn, long long sb, long long sh, long long st, long long yb,
               long long yh, long long yt, cudaStream_t stream) {
  auto kern = rwkv6_scan_fma_kernel<N>;
  const int smem = (5 * kRun + 1) * N * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * H, N, smem, stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (const float*)s0, (float*)y, (float*)sT, H, Tn, sb, sh,
      st, yb, yh, yt);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16 route

constexpr int L = 64;          // tokens a chunk
constexpr int SUB = 16;        // tokens a sub-chunk (one mma row tile)
constexpr int NS = L / SUB;    // sub-chunks a chunk
constexpr int NW = 4 * NS;     // warps: (sub-chunk, column group or role)
constexpr int NT = 32 * NW;    // threads a block
constexpr int NPAIR = NS * (NS - 1) / 2;   // sub-chunk pairs j < i
// floats between a diagonal tile's four partial sums ([SUB][SUB] each; the
// 8 more put the quarters on different banks)
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

// Shared-memory layout of a block, byte offsets from the 256-aligned base.
// Swizzled bf16 tiles keep each f32 operand of the products as its two
// pieces side by side (hi columns, then lo columns), ready for ldmatrix.
template <int N>
struct Lay {
  // value columns a block (32 at N 128, to fit shared memory)
  static constexpr int MB = N <= 64 ? N : 32;
  static constexpr int WC = 16;                // value columns a warp
  static constexpr int NCH = MB / WC;          // column groups (1, 2 or 4)
  static constexpr int KS = N / 16;            // k-steps over key channels
  static constexpr int RPW = KS > NS ? KS / NS : 1;   // S row tiles a warp
  static constexpr int QP = N + 8;             // f32 row pitch of qloc
  // v, [L][stage 0 MB | stage 1 MB]
  static constexpr uint32_t V = 0;
  // S, two buffers (read at chunk c from c & 1, written to the other),
  // each [N][hi MB | lo MB]
  static constexpr uint32_t S = V + tile_bytes<2 * MB>(L);
  static constexpr uint32_t SB = tile_bytes<2 * MB>(N);
  // raw r, k, w of the chunk, bf16 [L][N] each, one after another
  static constexpr uint32_t R = S + 2 * SB;
  // qloc, f32 [L][QP]
  static constexpr uint32_t Q = R + 3 * L * N * 2;
  // kloc and q_state = qloc . Gpre, each [L][hi N | lo N]
  static constexpr uint32_t KT = Q + L * QP * 4;
  static constexpr uint32_t QS = KT + tile_bytes<2 * N>(L);
  // f32 [NS + 1][N]: each sub-chunk's decay g, then u
  static constexpr uint32_t G = QS + tile_bytes<2 * N>(L);
  // each sub-chunk's diagonal tile as four partial sums, f32 [4][AD_Q]
  static constexpr uint32_t AD = G + (NS + 1) * N * 4;
  // the A operands of A V: A_ij for the pairs j < i (pair i(i-1)/2 + j),
  // then the diagonal tiles, each [SUB][hi 16 | lo 16]
  static constexpr uint32_t AT = AD + NS * 4 * AD_Q * 4;
  static constexpr uint32_t ATB = tile_bytes<32>(SUB);
  static constexpr uint32_t BYTES = AT + (NPAIR + NS) * ATB;
  static_assert(BYTES + SMEM_SLACK <= 232448, "shared memory");
};

struct Rwkv {
  const bf16 *r, *k, *v, *w;
  const float *u, *s0;
  bf16* y;
  float* sT;
  int H, T;
  long long sb, sh, st, yb, yh, yt;
  int vec, vec_y;   // 16-byte tile loads; 4-byte pair stores of y
};

// Chunk c's rows of r, k, w (all N channels) and, into stage vs, v (the
// block's MB columns) into shared memory; rows past T are zeros.
template <int N>
__device__ __forceinline__ void load_chunk(const Rwkv& q, uint8_t* gbase,
                                           uint32_t base, long long off,
                                           int m0, int c, int vs) {
  using Y = Lay<N>;
  constexpr int CH = N / 8, CV = Y::MB / 8;
  const int t0 = c * L, nv = min(L, q.T - t0);
  for (int i = threadIdx.x; i < 3 * L * CH; i += NT) {
    const int x = i / (L * CH), e = i % (L * CH);
    const int row = e / CH, ch = e % CH;
    // r, k and w tiles lie one after another
    const uint32_t d = Y::R + (uint32_t)((x * L + row) * N + ch * 8) * 2;
    const bf16* src = (x == 0 ? q.r : x == 1 ? q.k : q.w) + off;
    const bf16* s = src + (long long)(t0 + row) * q.st + ch * 8;
    const bool ok = row < nv;
    if (q.vec) {
      cp_async16(base + d, ok ? s : src, ok);
    } else {
      bf16* g = reinterpret_cast<bf16*>(gbase + d);
      for (int u = 0; u < 8; ++u) g[u] = ok ? s[u] : __float2bfloat16_rn(0.f);
    }
  }
  const bf16* vp = q.v + off + m0;
  for (int i = threadIdx.x; i < L * CV; i += NT) {
    const int row = i / CV, ch = i % CV;
    const uint32_t d = Y::V + swz<2 * Y::MB>(row, vs * CV + ch);
    const bf16* s = vp + (long long)(t0 + row) * q.st + ch * 8;
    const bool ok = row < nv;
    if (q.vec) {
      cp_async16(base + d, ok ? s : vp, ok);
    } else {
      bf16* g = reinterpret_cast<bf16*>(gbase + d);
      for (int u = 0; u < 8; ++u) g[u] = ok ? s[u] : __float2bfloat16_rn(0.f);
    }
  }
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

// acc[16 x 16] += A[16 x 16] V[rows v0 .. v0+15, the 16 columns from chunk
// vc of the v tile], A as its two bf16 pieces (ah, al)
template <int N>
__device__ __forceinline__ void times_v(float (&acc)[2][4],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], uint32_t vt,
                                        int v0, int vc, int lane) {
  uint32_t b[4];
  ldsm4t(b, vt + at_bk<2 * Lay<N>::MB>(v0, vc, lane));
  mma(acc[0], ah, b[0], b[1]);
  mma(acc[0], al, b[0], b[1]);
  mma(acc[1], ah, b[2], b[3]);
  mma(acc[1], al, b[2], b[3]);
}

template <int N>
__global__ void __launch_bounds__(NT, 1) rwkv6_scan_chunk_kernel(Rwkv q) {
  using Y = Lay<N>;
  constexpr int MB = Y::MB, KS = Y::KS, QP = Y::QP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 255u) & ~255u;
  uint8_t* gb = smem_raw + (base - smem_u32(smem_raw));
  const bf16* sr = reinterpret_cast<const bf16*>(gb + Y::R);
  const bf16* sk = sr + L * N;
  const bf16* sw = sk + L * N;
  float* ql = reinterpret_cast<float*>(gb + Y::Q);
  float* gt = reinterpret_cast<float*>(gb + Y::G);     // g, then u
  float* ad_all = reinterpret_cast<float*>(gb + Y::AD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  // warp roles: sub-chunk wi; column group wc of y and S (active while
  // wc < NCH), and role wc in the diagonal tiles
  const int wi = warp & (NS - 1), wc = warp / NS;
  const int c0 = wc * Y::WC;           // the warp's first value column
  const int bh = blockIdx.x, m0 = blockIdx.y * MB;
  const int b = bh / q.H, h = bh % q.H;
  const long long off = b * q.sb + h * q.sh;
  const int nc = (q.T + L - 1) / L;
  const bool cols = wc < Y::NCH;

  for (int n = tid; n < N; n += NT) gt[NS * N + n] = q.u[h * N + n];
  if (nc > 0) load_chunk<N>(q, gb, base, off, m0, 0, 0);
  cp_commit();

  // this warp's rows of S (row tiles wi, wi + NS, ...) and columns
  // c0 .. c0 + 16
  float sacc[Y::RPW][2][4];
#pragma unroll
  for (int rp = 0; rp < Y::RPW; ++rp)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * (wi + NS * rp) + g + 8 * (e >> 1);
        const int m = m0 + c0 + 8 * nt + 2 * tq + (e & 1);
        sacc[rp][nt][e] = q.s0 && cols && n < N
                              ? q.s0[((size_t)bh * N + n) * N + m] : 0.f;
      }
  // S into buffer sb as its two pieces, for the next chunk's y_state
  auto store_state = [&](int sb) {
#pragma unroll
    for (int rp = 0; rp < Y::RPW; ++rp) {
      const int n0 = 16 * (wi + NS * rp);
      if (n0 >= N || !cols) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + g + 8 * e, ch = c0 / 8 + nt;
          uint32_t hi, lo;
          split2(sacc[rp][nt][2 * e], sacc[rp][nt][2 * e + 1], &hi, &lo);
          uint8_t* t = gb + Y::S + sb * Y::SB;
          *reinterpret_cast<uint32_t*>(t + swz<2 * MB>(n, ch) + 4 * tq) = hi;
          *reinterpret_cast<uint32_t*>(t + swz<2 * MB>(n, MB / 8 + ch) +
                                       4 * tq) = lo;
        }
    }
  };
  store_state(0);

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L, nv = min(L, q.T - t0);
    const int vc = (c & 1) * (MB / 8) + c0 / 8;   // the warp's v columns
    const uint32_t vt = base + Y::V;
    cp_wait_all();
    __syncthreads();

    // 1a. qloc, kloc and g by a walk over each sub-chunk, by products of
    // w: qloc_t = r_t prod_{tau<t} w_tau, kloc_s = k_s prod_{tau>s} w_tau
    // and g = prod w, within the sub-chunk.  Two threads (adjacent lanes)
    // per (sub-chunk, key channel), one for each half of its 16 tokens,
    // the halves' products exchanged by shuffle.  kloc goes straight into
    // its two pieces.
    for (int p2 = tid; p2 < 2 * NS * N; p2 += NT) {
      const int p = p2 >> 1, hf = p2 & 1;
      const int i = p / N, n = p % N, row0 = SUB * i + 8 * hf;
      float wv[8], tot = 1.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        // rows past T decay by nothing (their r, k and v are zeros)
        const int row = row0 + t;
        wv[t] = row < nv ? bf(sw + row * N + n) : 1.f;
        tot *= wv[t];
      }
      const float other = __shfl_xor_sync(0xffffffffu, tot, 1);
      float pre = hf ? other : 1.f;            // prod of w before the row
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int row = row0 + t;
        ql[row * QP + n] = bf(sr + row * N + n) * pre;
        pre *= wv[t];
      }
      if (hf) gt[i * N + n] = pre;
      float post = hf ? 1.f : other;           // prod of w after the row
#pragma unroll
      for (int t = 7; t >= 0; --t) {
        const int row = row0 + t;
        const float x = bf(sk + row * N + n) * post;
        post *= wv[t];
        const bf16 hi = __float2bfloat16_rn(x);
        const bf16 lo = __float2bfloat16_rn(x - __bfloat162float(hi));
        *reinterpret_cast<bf16*>(gb + Y::KT + swz<2 * N>(row, n / 8) +
                                 2 * (n % 8)) = hi;
        *reinterpret_cast<bf16*>(gb + Y::KT + swz<2 * N>(row, N / 8 + n / 8) +
                                 2 * (n % 8)) = lo;
      }
    }

    // 1b. sub-chunk wi's diagonal tile (it needs only the raw tiles), as
    // four partial sums (a quarter of the key channels each): sum_n r_t k_s
    // prod_{s<tau<t} w_tau for s < t.  Lanes 4 gp .. 4 gp + 3 own column
    // s and carry k_s prod w along t, one accumulator a block of 4
    // channels; the warp walks t for all its lanes together, so that each
    // row of r and w is a broadcast load.  Role 0 takes s = gp for t <= 8,
    // role 2 the same columns for t > 8 (first carrying k_s over t <= 8
    // by products alone), role 1 s = 8 + gp; role 3 puts the bonus
    // sum_n r_t u k_t at s = t (two lanes a row).
    {
      constexpr int CPL = N / 4, C4 = N / 16;   // channels a lane, blocks
      float* ad = ad_all + wi * 4 * AD_Q;
      const int gp = lane >> 2, qn = lane & 3;
      const int r0 = SUB * wi;
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
              const int j = 4 * c4 + e;
              acc[c4] = fmaf(rv[e], kd[j], acc[c4]);
              if (s < t) kd[j] *= wv[e];
            }
          }
#pragma unroll
          for (int c4 = 1; c4 < C4; ++c4) acc[0] += acc[c4];
          if (s < t) ad[qn * AD_Q + t * SUB + s] = acc[0];
        }
      } else {
        // two lanes a row, each over half the channels in pairs, the pairs
        // rotated by the row so that the 16 rows fall on different banks
        constexpr int PH = N / 4;     // channel pairs a half
        const int t = lane >> 1, half = lane & 1;
        const float* uu = gt + NS * N;
        const uint32_t* rw =
            reinterpret_cast<const uint32_t*>(sr + (r0 + t) * N);
        const uint32_t* kw =
            reinterpret_cast<const uint32_t*>(sk + (r0 + t) * N);
        float bonus = 0.f;
#pragma unroll
        for (int j = 0; j < PH; ++j) {
          const int x = half * PH + (j + t) % PH;
          const float2 rv = unpack_bf16(rw[x]), kv = unpack_bf16(kw[x]);
          bonus = fmaf(rv.x * uu[2 * x], kv.x, bonus);
          bonus = fmaf(rv.y * uu[2 * x + 1], kv.y, bonus);
        }
        bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
        ad[(2 * half) * AD_Q + t * (SUB + 1)] = half ? 0.f : bonus;
        ad[(2 * half + 1) * AD_Q + t * (SUB + 1)] = 0.f;
      }
    }
    __syncthreads();
    // r, k and w of this chunk are read: the next chunk's load starts
    if (c + 1 < nc) load_chunk<N>(q, gb, base, off, m0, c + 1, (c + 1) & 1);
    cp_commit();

    // 2a. q_state = qloc . Gpre (the decay from the chunk's start), as its
    // two pieces, 8 key channels a thread of the warps that compute no
    // A_ij (as is 2b)
    constexpr int NT2 = 32 * (NW - NPAIR);
    for (int e = tid; e < L * N / 8 && tid < NT2; e += NT2) {
      const int t = e / (N / 8), ch = e % (N / 8);
      float x[8];
#pragma unroll
      for (int z = 0; z < 2; ++z) {
        const float4 v = *reinterpret_cast<const float4*>(
            ql + t * QP + 8 * ch + 4 * z);
        x[4 * z] = v.x;
        x[4 * z + 1] = v.y;
        x[4 * z + 2] = v.z;
        x[4 * z + 3] = v.w;
      }
      for (int l = 0; l < t / SUB; ++l)
#pragma unroll
        for (int z = 0; z < 2; ++z) {
          const float4 f = *reinterpret_cast<const float4*>(
              gt + l * N + 8 * ch + 4 * z);
          x[4 * z] *= f.x;
          x[4 * z + 1] *= f.y;
          x[4 * z + 2] *= f.z;
          x[4 * z + 3] *= f.w;
        }
      uint4 hi, lo;
      split2(x[0], x[1], &hi.x, &lo.x);
      split2(x[2], x[3], &hi.y, &lo.y);
      split2(x[4], x[5], &hi.z, &lo.z);
      split2(x[6], x[7], &hi.w, &lo.w);
      *reinterpret_cast<uint4*>(gb + Y::QS + swz<2 * N>(t, ch)) = hi;
      *reinterpret_cast<uint4*>(gb + Y::QS + swz<2 * N>(t, N / 8 + ch)) = lo;
    }
    // 2b. the diagonal tiles' four partials added, zero above the
    // diagonal, as the A operands' two pieces; a thread per (sub-chunk,
    // row, pair of columns)
    for (int e = tid; e < NS * SUB * SUB / 2 && tid < NT2; e += NT2) {
      const int i = e / (SUB * SUB / 2), t = (e / (SUB / 2)) % SUB;
      const int s = 2 * (e % (SUB / 2));
      const float* ad = ad_all + i * 4 * AD_Q + t * SUB + s;
      float v[2];
#pragma unroll
      for (int z = 0; z < 2; ++z)
        v[z] = s + z <= t ? (ad[z] + ad[AD_Q + z]) +
                                (ad[2 * AD_Q + z] + ad[3 * AD_Q + z])
                          : 0.f;
      uint32_t hi, lo;
      split2(v[0], v[1], &hi, &lo);
      uint8_t* at = gb + Y::AT + (NPAIR + i) * Y::ATB;
      *reinterpret_cast<uint32_t*>(at + swz<32>(t, s / 8) + 2 * (s % 8)) = hi;
      *reinterpret_cast<uint32_t*>(at + swz<32>(t, 2 + s / 8) + 2 * (s % 8)) =
          lo;
    }
    // 2c. A_ij = (qloc_i . G_ij) kloc_j^T for the pairs j < i, one warp a
    // pair (the last NPAIR warps), kloc_j from its two pieces
    if (warp >= NW - NPAIR) {
      const int pr = warp - (NW - NPAIR);
      const int i = pr < 1 ? 1 : pr < 3 ? 2 : 3;  // pr = i (i - 1) / 2 + j
      const int j = pr - i * (i - 1) / 2;
      // G_ij at this lane's columns of each k-step, computed up front where
      // the registers allow (KS <= 4); the products in two accumulator sets
      // (even and odd k-steps), added at the end
      float2 fij[4][2];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) fij[ks][hh] = make_float2(1.f, 1.f);
      if (KS <= 4)
        for (int l = j + 1; l < i; ++l)
#pragma unroll
          for (int ks = 0; ks < (KS < 4 ? KS : 4); ++ks)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float2 x = *reinterpret_cast<const float2*>(
                  gt + l * N + 16 * ks + 2 * tq + 8 * hh);
              fij[ks][hh].x *= x.x;
              fij[ks][hh].y *= x.y;
            }
      float a[2][2][4];
#pragma unroll
      for (int z = 0; z < 2; ++z)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[z][nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[4], al[4];
        const int cc = 16 * ks + 2 * tq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {  // columns cc + 8 hh, scaled by G_ij
          float2 f = KS <= 4 ? fij[ks & 3][hh] : make_float2(1.f, 1.f);
          if (KS > 4)
            for (int l = j + 1; l < i; ++l) {
              const float2 x =
                  *reinterpret_cast<const float2*>(gt + l * N + cc + 8 * hh);
              f.x *= x.x;
              f.y *= x.y;
            }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float2 x = *reinterpret_cast<const float2*>(
                ql + (SUB * i + g + 8 * e) * QP + cc + 8 * hh);
            split2(x.x * f.x, x.y * f.y, &ah[2 * hh + e], &al[2 * hh + e]);
          }
        }
        uint32_t bh[4], bl[4];
        ldsm4(bh, base + Y::KT + at_bn<2 * N>(SUB * j, 2 * ks, lane));
        ldsm4(bl, base + Y::KT + at_bn<2 * N>(SUB * j, N / 8 + 2 * ks, lane));
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float (&c)[4] = a[ks & 1][nt];
          mma(c, ah, bh[2 * nt], bh[2 * nt + 1]);
          mma(c, al, bh[2 * nt], bh[2 * nt + 1]);
          mma(c, ah, bl[2 * nt], bl[2 * nt + 1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[0][nt][e] += a[1][nt][e];
      uint8_t* at = gb + Y::AT + pr * Y::ATB;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t hi, lo;
          split2(a[0][nt][2 * e], a[0][nt][2 * e + 1], &hi, &lo);
          *reinterpret_cast<uint32_t*>(at + swz<32>(g + 8 * e, nt) + 4 * tq) =
              hi;
          *reinterpret_cast<uint32_t*>(at + swz<32>(g + 8 * e, 2 + nt) +
                                       4 * tq) = lo;
        }
    }
    // 2d. S <- diag(Gall) S + sum_j diag(Gpost_j) (kloc_j^T V_j), this
    // warp's rows and columns: kloc_j^T from its two pieces (ldmatrix.trans
    // of the [s][n] tile), the decay of the rows applied to each product
#pragma unroll
    for (int rp = 0; rp < Y::RPW; ++rp) {
      const int rt = wi + NS * rp, n0 = 16 * rt + g;
      if (n0 >= N || !cols) continue;
      float f0 = 1.f, f1 = 1.f;                 // Gall at rows n0, n0 + 8
#pragma unroll
      for (int l = 0; l < NS; ++l) {
        f0 *= gt[l * N + n0];
        f1 *= gt[l * N + n0 + 8];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        sacc[rp][nt][0] *= f0;
        sacc[rp][nt][1] *= f0;
        sacc[rp][nt][2] *= f1;
        sacc[rp][nt][3] *= f1;
      }
      float p0 = 1.f, p1 = 1.f;                 // Gpost_j, j from the last
#pragma unroll
      for (int j = NS - 1; j >= 0; --j) {
        uint32_t ah[4], al[4];
        ldsm4t(ah, base + Y::KT + at_bn<2 * N>(SUB * j, 2 * rt, lane));
        ldsm4t(al, base + Y::KT + at_bn<2 * N>(SUB * j, N / 8 + 2 * rt, lane));
        float pa[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) pa[nt][e] = 0.f;
        times_v<N>(pa, ah, al, vt, SUB * j, vc, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          sacc[rp][nt][0] = fmaf(p0, pa[nt][0], sacc[rp][nt][0]);
          sacc[rp][nt][1] = fmaf(p0, pa[nt][1], sacc[rp][nt][1]);
          sacc[rp][nt][2] = fmaf(p1, pa[nt][2], sacc[rp][nt][2]);
          sacc[rp][nt][3] = fmaf(p1, pa[nt][3], sacc[rp][nt][3]);
        }
        p0 *= gt[j * N + n0];
        p1 *= gt[j * N + n0 + 8];
      }
    }
    __syncthreads();

    // 3. y of sub-chunk wi, columns c0 .. c0 + 16: q_state S (S from buffer
    // c & 1), A_ij V_j for the earlier sub-chunks and the diagonal tile
    // times V_i; then S into the other buffer
    if (cols) {
      const int i = wi, r0 = SUB * i;
      const uint32_t sbuf = base + Y::S + (c & 1) * Y::SB;
      float yacc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[4], al[4], sh[4], sl[4];
        ldsm4(ah, base + Y::QS + at_a<2 * N>(r0, 2 * ks, lane));
        ldsm4(al, base + Y::QS + at_a<2 * N>(r0, N / 8 + 2 * ks, lane));
        ldsm4t(sh, sbuf + at_bk<2 * MB>(16 * ks, c0 / 8, lane));
        ldsm4t(sl, sbuf + at_bk<2 * MB>(16 * ks, MB / 8 + c0 / 8, lane));
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma(yacc[nt], ah, sh[2 * nt], sh[2 * nt + 1]);
          mma(yacc[nt], al, sh[2 * nt], sh[2 * nt + 1]);
          mma(yacc[nt], ah, sl[2 * nt], sl[2 * nt + 1]);
        }
      }
      for (int j = 0; j <= i; ++j) {
        // A_ij, or the diagonal tile at j = i
        const uint32_t at =
            base + Y::AT + (j < i ? i * (i - 1) / 2 + j : NPAIR + i) * Y::ATB;
        uint32_t ah[4], al[4];
        ldsm4(ah, at + at_a<32>(0, 0, lane));
        ldsm4(al, at + at_a<32>(0, 2, lane));
        times_v<N>(yacc, ah, al, vt, SUB * j, vc, lane);
      }
      // y, rounded once, in the inputs' layout
      bf16* yb = q.y + b * q.yb + h * q.yh + m0 + c0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + g + 8 * e;
        if (row >= nv) continue;
        bf16* yr = yb + (long long)(t0 + row) * q.yt;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int m = 8 * nt + 2 * tq;
          const float v0 = yacc[nt][2 * e], v1 = yacc[nt][2 * e + 1];
          if (q.vec_y) {
            *reinterpret_cast<uint32_t*>(yr + m) = pack_bf16(v0, v1);
          } else {
            yr[m] = __float2bfloat16_rn(v0);
            yr[m + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
    store_state((c + 1) & 1);
  }

#pragma unroll
  for (int rp = 0; rp < Y::RPW; ++rp) {
    const int n0 = 16 * (wi + NS * rp) + g;
    if (n0 >= N || !cols) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(q.sT + ((size_t)bh * N + n0 + 8 * e) * N +
                                   m0 + c0 + 8 * nt + 2 * tq) =
            make_float2(sacc[rp][nt][2 * e], sacc[rp][nt][2 * e + 1]);
  }
}

template <int N>
int launch_chunk(const Rwkv& q, int B, cudaStream_t stream) {
  auto kern = rwkv6_scan_chunk_kernel<N>;
  const int smem = (int)(Lay<N>::BYTES + SMEM_SLACK);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B * q.H, N / Lay<N>::MB), NT, smem, stream>>>(q);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// r, k, v, w [B,H,T,N] in f32 (dtype 0) or bf16 (dtype 1), element strides
// (sb, sh, st), unit stride along N; u [H,N] f32; s0 [B,H,N,N] f32 or null;
// y [B,H,T,N] in the inputs' dtype with strides (yb, yh, yt); sT [B,H,N,N]
// f32.  N in {16, 32, 64, 128}.  f32 runs the exact recurrence, bf16 the
// chunked form.  Returns the launch's cudaError_t.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* y, void* sT, int B, int H, int Tn,
                                 int N, int dtype, long long sb, long long sh,
                                 long long st, long long yb, long long yh,
                                 long long yt, void* stream) {
  if (B * H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    switch (N) {
      case 16: return launch_fma<16>(r, k, v, w, u, s0, y, sT, B, H, Tn, sb,
                                     sh, st, yb, yh, yt, s);
      case 32: return launch_fma<32>(r, k, v, w, u, s0, y, sT, B, H, Tn, sb,
                                     sh, st, yb, yh, yt, s);
      case 64: return launch_fma<64>(r, k, v, w, u, s0, y, sT, B, H, Tn, sb,
                                     sh, st, yb, yh, yt, s);
      case 128: return launch_fma<128>(r, k, v, w, u, s0, y, sT, B, H, Tn,
                                       sb, sh, st, yb, yh, yt, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  Rwkv q;
  q.r = (const bf16*)r;
  q.k = (const bf16*)k;
  q.v = (const bf16*)v;
  q.w = (const bf16*)w;
  q.u = (const float*)u;
  q.s0 = (const float*)s0;
  q.y = (bf16*)y;
  q.sT = (float*)sT;
  q.H = H;
  q.T = Tn;
  q.sb = sb;
  q.sh = sh;
  q.st = st;
  q.yb = yb;
  q.yh = yh;
  q.yt = yt;
  q.vec = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
          sb % 8 == 0 && sh % 8 == 0 && st % 8 == 0;
  q.vec_y = ((uintptr_t)y & 3u) == 0 && yb % 2 == 0 && yh % 2 == 0 &&
            yt % 2 == 0;
  switch (N) {
    case 16: return launch_chunk<16>(q, B, s);
    case 32: return launch_chunk<32>(q, B, s);
    case 64: return launch_chunk<64>(q, B, s);
    case 128: return launch_chunk<128>(q, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
