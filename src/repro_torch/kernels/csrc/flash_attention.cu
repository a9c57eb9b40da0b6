// Flash attention for Hopper: a blocked online-softmax forward that also
// writes each row's log-sum-exp, and a backward that recomputes the
// probabilities tile by tile.
//
// The forward replaces `_kernel` / `flash_attention_pallas`
// (src/repro/kernels/flash_attention/flash_attention.py:22 / :58).  The TPU
// kernel keeps a (bq x hd) query tile and the whole K and V of its head in
// VMEM and walks KV tiles on a loop with the (m, l, acc) carry; it asserts
// Sq % bq == 0 and Sk % bk == 0.  Here a block owns 64 query rows of one
// (batch, head) and loops over 64-row KV tiles, so any Sq, Sk works: rows
// and keys past the end load as zeros and are masked.  The reference has no
// backward kernel (JAX differentiates its chunked jnp form); the backward
// here is a recomputing one, in three launches: a prep pass (each row's
// delta_i = sum_d dO·O, and in bf16 the scaled q), then dK and dV with one
// block per KV tile (a single writer per row: it loops over the query
// tiles that see it), then dQ with one block per query tile.  No atomics
// are used, so the gradients are the same bits in every run.  The price is
// seven products per visible (q, k) pair and head dim where the minimal
// backward does five: S and dP are computed in both kernels.
//
// delta is summed from O in f32, before its rounding to the output dtype:
// the bf16 forward writes that f32 copy of O beside its output when a
// backward will follow (the autograd Function asks for it).  With O
// rounded to bf16, each row of dS keeps a residue of O's rounding, which
// dS·K multiplies by the keys' common component: on gemma3-1b's layer
// inputs (one KV head) that moved dq 1.2e-2 from the exact gradients,
// against 1.1e-3 with the f32 O (chip_smoke.py, delta_residue).
//
// bf16 route (the model's): the tensor cores.
// - Products: `mma.sync.m16n8k16` (bf16 in, f32 accumulators in
//   registers) with operands from `ldmatrix`; 4 warps, each owning 16 rows
//   of the block's 64.  `wgmma` would reach a higher rate, but it needs its
//   operands in the exact layouts its shared-memory descriptors encode and
//   can be checked only on the card; the synchronous form was taken as the
//   first tensor-core design.
// - Tiles: Q, K, V (and dO) are bf16 in shared memory, each row's 16-byte
//   chunks XOR-swizzled by (row & 7) (the 128-byte swizzle), so the eight
//   row addresses of an `ldmatrix` hit eight distinct bank groups.  A row
//   holds HDP = 64, 112, 128 or 256 columns (hd % 8 == 0, zero-padded up
//   to HDP), so zamba2's hd 112 takes 7 k-steps, not 8; the row pitch is
//   rounded up to 8 chunks so that the swizzle stays inside the row.
// - Head dim 256 (gemma3-1b): a warp's 16 x 256 f32 accumulator alone is
//   128 registers a thread, so what the narrower kernels hold in registers
//   does not fit in 255 beside it.  The forward re-loads the warp's Q
//   fragments from shared memory at every k-step (`ldmatrix`, as K's)
//   instead of holding all 16 for the whole loop (64 more registers).  The
//   dK/dV kernel would hold two such accumulators (256 registers), so its
//   grid has a third axis of two column halves: each block recomputes P^T
//   and dS^T over the whole head dim and accumulates one half of dK and
//   dV's columns (six products per visible pair where one block would do
//   four; nine in the whole backward, seven at the narrower heads).  The
//   dQ kernel holds its one accumulator.  The tiles are 512-byte rows: the
//   forward's shared memory is Q 32 KB + 2 stages x (K + V) 128 KB, the dQ
//   kernel's 192 KB, one block an SM.
// - Copies: KV tiles (query and dO tiles in the dK/dV kernel) are double
//   buffered with `cp.async`: tile j + 1 loads while tile j is multiplied,
//   with one barrier per tile for the hand-over of the buffers.
// - Online softmax on the accumulator fragments: a thread holds two rows
//   of S, the four threads of a quad a whole row; the row max by two
//   shuffles, the row sum kept per thread and summed over the quad once at
//   the end.  P goes from the S fragments straight into the A operand of
//   P·V.  The mask is applied only on tiles that straddle it; tiles no row
//   can see are skipped.  Query tiles start longest causal rows first.
// f32 route: the first design, f32 FMAs out of shared memory in 4x4
// register tiles (the `*_fma_kernel`s), any hd <= 128 (its backward's f32
// tiles would not fit in shared memory at 256; wider heads raise).  Tensor
// cores would make it TF32; it stays as a second check of the masks on the
// card.
//
// Numerics follow the plain version (models/attention.py
// chunked_attention): q is scaled by 1/sqrt(hd) and rounded to its dtype,
// logits, the softmax statistics and accumulators are f32, the
// probabilities are rounded to V's dtype where they meet V (and dO, for
// dV), and the output is rounded once to q's dtype.  The straight-through
// gradient of q's rounding is the scale, so dq = scale * dS K.  On the bf16
// route dS is rounded to bf16 where it meets K and q (the tensor cores'
// operand type); the f32 route keeps it in f32.  One difference stays: the
// plain version's bf16 P takes P's gradient through a plain cast, as the
// reference's does, so each row's rounding residue reaches the running max
// and lands on the row's argmax key; here the max is a constant, as in the
// exact softmax gradient, so dK can sit nearer the f32 result than the
// plain version's (chip_smoke.py holds it to an f32 oracle where so).
//
// Masks: key j of query row i (absolute position q_offset + i) is visible
// when j < Sk, i < Sq, (not causal or j <= q_offset + i) and (window <= 0
// or j > q_offset + i - window).
//
// Layout: q, o [B,Sq,H,hd], k, v [B,Sk,H,hd] contiguous (the model's
// layout, so no transpose is made on either side); lse and delta
// [B,H,Sq] f32.
//
// Bound: at training shapes (Sq = Sk = 1024, hd 64, causal; and gemma3-1b's
// Sq = Sk = 2048, hd 256, window 1024) the function does 4·hd operations
// per visible (q, k) pair in the forward and 10 in the backward, against
// 8·S·hd bytes per head: far above the bf16 ridge (about 295 operations a
// byte), so it is bound by the tensor cores' rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // key rows per tile
constexpr float LOG2E = 1.4426950408889634f;

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

// whether some pair of the tile [i0, i0 + ni) x [j0, j0 + nj) is masked
__device__ __forceinline__ bool straddles(const Shape& p, int i0, int ni,
                                          int j0, int nj) {
  const int first = p.q_offset + i0, last = first + ni - 1;
  return j0 + nj > p.Sk || i0 + ni > p.Sq ||
         (p.causal && j0 + nj - 1 > first) ||
         (p.window > 0 && j0 <= last - p.window);
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

// ------------------------------------------------------------ bf16 route

constexpr int MT = 128;           // threads per block: 4 warps x 16 rows

// 16-byte chunks in a shared-memory row of HDP columns (a multiple of 8,
// so that the XOR swizzle stays inside the row)
template <int HDP>
__host__ __device__ constexpr int pitch() {
  return (HDP / 8 + 7) & ~7;
}
template <int HDP>
__host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return (uint32_t)rows * pitch<HDP>() * 16;
}
// byte offset of chunk c of row r in a swizzled tile
template <int HDP>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * pitch<HDP>() + (c ^ (r & 7))) * 16u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// asynchronous copy of 16 (4) bytes; zeros when !ok (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
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
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// The A operand of a 16x16 step from two neighbouring 16x8 accumulator
// tiles (columns 16 kk .. 16 kk + 15), rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Byte offsets, at k-step 0, of a lane's row address in the three
// `ldmatrix` patterns of a swizzled tile:
// - a: the A operand, 16 rows x the 16 columns of a k-step;
// - bn: the B operand from rows = n, two 8-wide n-tiles (16 rows) x a
//   k-step (registers 0-1: n-tile 0, 2-3: n-tile 1);
// - bk: the B operand from rows = k (16 rows) x two 8-wide n-tiles of
//   columns, with .trans (registers 0-1: n-tile 2 dp, 2-3: 2 dp + 1).
// Every row a lane addresses has (row & 7) == (lane & 7), and chunk 2 ks + b
// (b = 0, 1) swizzles to (b ^ (row & 7)) ^ 2 ks.  Tiles start on 512-byte
// boundaries and rows are 128, 256 or 512 bytes, so the address at k-step
// ks is the k-step-0 address XOR 32 ks: one logic operation, shared by the
// n-tiles (which add immediates), and no table of addresses held in
// registers.
struct Lanes {
  uint32_t a, bn, bk;
};
template <int HDP>
__device__ __forceinline__ Lanes lane_offsets(int lane) {
  static_assert(pitch<HDP>() == 8 || pitch<HDP>() == 16 ||
                    pitch<HDP>() == 32,
                "row bytes");
  const int x = lane & 7;
  return {swz<HDP>(lane & 15, lane >> 4),
          swz<HDP>(x + ((lane >> 4) << 3), (lane >> 3) & 1),
          swz<HDP>(x + (((lane >> 3) & 1) << 3), lane >> 4)};
}
template <int HDP>
__host__ __device__ constexpr uint32_t row_bytes() {
  return pitch<HDP>() * 16;
}

// acc[N/8][4] (16 rows x N columns) += A · B^T over HDP columns; a: the a
// address of A's 16 rows, b: the bn address of B's N rows
template <int HDP, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks) {
    uint32_t af[4];
    ldsm4(af, a ^ (32u * ks));
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf[4];
      ldsm4(bf, (b ^ (32u * ks)) + np * 16 * row_bytes<HDP>());
      mma(acc[2 * np], af, bf[0], bf[1]);
      mma(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// out[N/8][4] (16 rows x N columns) += P · B, P (16 rows x K) given as f32
// accumulator fragments and rounded to bf16; b: the bk address of B's K
// rows, XOR 32 c0 / 16 for B's columns c0 .. c0 + N (c0 a multiple of N,
// a power of two)
template <int HDP, int K, int N = HDP>
__device__ __forceinline__ void mma_pb(float (&out)[N / 8][4],
                                       const float (&pf)[K / 8][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    acc_to_a(af, pf[2 * kk], pf[2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < N / 16; ++dp) {
      uint32_t bf[4];
      ldsm4t(bf, (b ^ (32u * dp)) + kk * 16 * row_bytes<HDP>());
      mma(out[2 * dp], af, bf[0], bf[1]);
      mma(out[2 * dp + 1], af, bf[2], bf[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// rows [row0, row0 + ROWS) of one head of a [B,S,H,hd] tensor into a
// swizzled [ROWS, HDP] bf16 tile, by asynchronous copies; rows past S and
// columns past hd are zeros
template <int HDP, int ROWS>
__device__ __forceinline__ void load_async(uint32_t dst, const bf16* head,
                                           int row0, int S, const Shape& p) {
  constexpr int NCH = HDP / 8;
  const size_t stride = (size_t)p.H * p.hd;
  for (int i = threadIdx.x; i < ROWS * NCH; i += MT) {
    const int r = i / NCH, c = i % NCH, s = row0 + r;
    const bool ok = s < S && c * 8 < p.hd;
    cp_async16(dst + swz<HDP>(r, c),
               ok ? head + (size_t)s * stride + c * 8 : head, ok);
  }
}

__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// store a warp's 16 rows (row0 ..) x N accumulator (columns col0 ..),
// times mul, as bf16 or f32
template <int N, typename T>
__device__ __forceinline__ void store_rows(T* head, int row0, int S,
                                           const float (&acc)[N / 8][4],
                                           const float (&mul)[2],
                                           const Shape& p, int lane,
                                           int col0 = 0) {
  const size_t stride = (size_t)p.H * p.hd;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const int col = col0 + nt * 8;
    if (col >= p.hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = row0 + g + 8 * r;
      if (s < S)
        store2(head + (size_t)s * stride + col + 2 * t,
               acc[nt][2 * r] * mul[r], acc[nt][2 * r + 1] * mul[r]);
    }
  }
}

// dynamic shared memory, its start rounded up to 512 bytes (the XOR
// addressing above needs it; SMEM_SLACK more bytes are asked for)
constexpr uint32_t SMEM_SLACK = 512;
__device__ __forceinline__ uint32_t smem_base(const uint8_t* smem) {
  return (smem_u32(smem) + 511u) & ~511u;
}

template <int HDP>
constexpr size_t fwd_mma_smem() {
  return SMEM_SLACK + tile_bytes<HDP>(BQ) + 4 * tile_bytes<HDP>(BK);
}

template <int HDP>
__global__ void __launch_bounds__(MT)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ o32, float* __restrict__ lse,
                     Shape p) {
  constexpr int NCH = HDP / 8, KS = HDP / 16;
  constexpr uint32_t TB = tile_bytes<HDP>(BK), RB = row_bytes<HDP>();
  extern __shared__ uint8_t smem[];
  const uint32_t Qs = smem_base(smem);
  uint8_t* q_tile = smem + (Qs - smem_u32(smem));
  const uint32_t KVs = Qs + tile_bytes<HDP>(BQ);   // [2 stages][K, V]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Lanes ln = lane_offsets<HDP>(lane);
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  const size_t stride = (size_t)p.H * p.hd;
  const bf16* qh = q + ((size_t)b * p.Sq * p.H + h) * p.hd;
  const bf16* kh = k + ((size_t)b * p.Sk * p.H + h) * p.hd;
  const bf16* vh = v + ((size_t)b * p.Sk * p.H + h) * p.hd;

  int k_begin, k_end;
  key_range(p, q0, &k_begin, &k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  if (n_tiles > 0) {
    load_async<HDP, BK>(KVs, kh, k_begin, p.Sk, p);
    load_async<HDP, BK>(KVs + TB, vh, k_begin, p.Sk, p);
  }
  cp_commit();
  // q * scale rounded to bf16 (the plain version's scaled q), then this
  // warp's 16 rows into A fragments, held for the whole loop
  for (int i = tid; i < BQ * NCH; i += MT) {
    const int r = i / NCH, c = i % NCH, s = q0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (s < p.Sq && c * 8 < p.hd) {
      x = *reinterpret_cast<const uint4*>(qh + (size_t)s * stride + c * 8);
      bf16* e = reinterpret_cast<bf16*>(&x);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        e[u] = __float2bfloat16_rn(__bfloat162float(e[u]) * p.scale);
    }
    *reinterpret_cast<uint4*>(q_tile + swz<HDP>(r, c)) = x;
  }
  __syncthreads();
  // up to hd 128 the warp's Q fragments stay in registers for the whole
  // loop; at 256 they are re-loaded at each k-step (see the note above)
  constexpr bool HOLD_Q = HDP <= 128;
  uint32_t qf[HOLD_Q ? KS : 1][4];
  const uint32_t qa = Qs + 16 * warp * RB + ln.a;
  if constexpr (HOLD_Q) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldsm4(qf[ks], qa ^ (32u * ks));
  }

  const int row_a = q0 + 16 * warp + g;    // this thread's rows: +0, +8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[HDP / 8][4];
  zero(acc);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * BK;
    cp_wait_all();
    __syncthreads();     // tile j is in; every warp is done with tile j - 1
    if (j + 1 < n_tiles) {
      const uint32_t nb = KVs + ((j + 1) & 1) * 2 * TB;
      load_async<HDP, BK>(nb, kh, k0 + BK, p.Sk, p);
      load_async<HDP, BK>(nb + TB, vh, k0 + BK, p.Sk, p);
    }
    cp_commit();
    const uint32_t Kt = KVs + (j & 1) * 2 * TB, Vt = Kt + TB;

    float s[BK / 8][4];
    zero(s);
    if constexpr (HOLD_Q) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t bf[4];
          ldsm4(bf, ((Kt + ln.bn) ^ (32u * ks)) + np * 16 * RB);
          mma(s[2 * np], qf[ks], bf[0], bf[1]);
          mma(s[2 * np + 1], qf[ks], bf[2], bf[3]);
        }
    } else {
      mma_abt<HDP, BK>(s, qa, Kt + ln.bn);
    }
    if (straddles(p, q0, BQ, k0, BK)) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(p, row_a + 8 * (e >> 1), k0 + 8 * nt + 2 * t + (e & 1)))
            s[nt][e] = -INFINITY;
    }
    // online softmax: a row's max over its quad; rows with nothing
    // visible yet keep m = -inf and p = 0
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      ml[r] = (mx[r] == -INFINITY ? 0.f : mx[r]) * LOG2E;
      const float corr = exp2f(fmaf(m[r], LOG2E, -ml[r]));
      m[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int nt = 0; nt < HDP / 8; ++nt) {
        acc[nt][2 * r] *= corr;
        acc[nt][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(fmaf(s[nt][e], LOG2E, -ml[e >> 1]));
        l[e >> 1] += s[nt][e];
      }
    mma_pb<HDP, BK>(acc, s, Vt + ln.bk);   // P rounded to bf16 meets V
  }
  cp_wait_all();
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int i = row_a + 8 * r;
    if (t == 0 && i < p.Sq)
      lse[(size_t)bh * p.Sq + i] = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  const size_t ooff = ((size_t)b * p.Sq * p.H + h) * p.hd;
  store_rows<HDP>(o + ooff, q0 + 16 * warp, p.Sq, acc, inv, p, lane);
  // the unrounded O, for the backward's delta
  if (o32 != nullptr)
    store_rows<HDP>(o32 + ooff, q0 + 16 * warp, p.Sq, acc, inv, p, lane);
}

// Query rows per step of the dK/dV kernel and keys per step of the dQ
// kernel: 64, or 32 at wide heads, so that the two HDP-wide accumulators
// (dK and dV) or the one (dQ) and two S-sized tiles fit in registers
template <int HDP>
__host__ __device__ constexpr int bwd_step() {
  return HDP <= 64 ? 64 : 32;
}
// column halves of dK and dV (the dK/dV grid's z axis): two at hd 256
template <int HDP>
__host__ __device__ constexpr int dkdv_parts() {
  return HDP <= 128 ? 1 : 2;
}
template <int HDP>
constexpr size_t dkdv_mma_smem() {
  return SMEM_SLACK + 2 * tile_bytes<HDP>(BK) +
         4 * tile_bytes<HDP>(bwd_step<HDP>()) +
         4 * bwd_step<HDP>() * sizeof(float);
}

// dK, dV of one KV tile (columns: part blockIdx.z of dkdv_parts): the block
// loops over the query tiles that see it; warp w owns keys 16 w .. 16 w +
// 15.  qs is the scaled q (the prep pass's).
// Both backward kernels set their register ceiling to the maximum: under
// __launch_bounds__ alone ptxas caps them at 168 registers (three blocks an
// SM) and spills a few bytes.
template <int HDP>
__global__ void __maxnreg__(255)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ qs,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          Shape p) {
  constexpr int QB = bwd_step<HDP>(), NC = HDP / dkdv_parts<HDP>();
  constexpr uint32_t TQ = tile_bytes<HDP>(QB), RB = row_bytes<HDP>();
  extern __shared__ uint8_t smem[];
  const uint32_t Ks = smem_base(smem), Vs = Ks + tile_bytes<HDP>(BK);
  // this block's columns c0 .. c0 + NC of dK and dV, and the XOR that moves
  // a bk address to them (NC / 16 k-steps of 32 bytes each)
  const int c0 = blockIdx.z * NC;
  const uint32_t cx = 32u * (c0 / 16);
  const uint32_t QGs = Vs + tile_bytes<HDP>(BK);    // [2 stages][q_s, dO]
  const uint32_t stats_s = QGs + 4 * TQ;            // [2 stages][lse, delta]
  const float* stats =
      reinterpret_cast<const float*>(smem + (stats_s - smem_u32(smem)));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Lanes ln = lane_offsets<HDP>(lane);
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * BK;   // causal: the first tiles see the most
  const size_t qoff = ((size_t)b * p.Sq * p.H + h) * p.hd;
  const size_t koff = ((size_t)b * p.Sk * p.H + h) * p.hd;
  const bf16* qh = qs + qoff;
  const bf16* gh = dout + qoff;
  const float* lse_h = lse + (size_t)bh * p.Sq;
  const float* dl_h = delta + (size_t)bh * p.Sq;

  // query rows that can see a key of [k0, k0 + BK): absolute position
  // >= k0 (causal) and < k0 + BK - 1 + window (window)
  int q_lo = 0, q_hi = p.Sq;
  if (p.causal) q_lo = max(0, k0 - p.q_offset);
  if (p.window > 0) q_hi = min(p.Sq, k0 + BK - 1 + p.window - p.q_offset);
  const int q_begin = (q_lo / QB) * QB;
  const int n_tiles = q_hi > q_begin ? (q_hi - q_begin + QB - 1) / QB : 0;

  load_async<HDP, BK>(Ks, k + koff, k0, p.Sk, p);
  load_async<HDP, BK>(Vs, v + koff, k0, p.Sk, p);
  auto load_q = [&](int stage, int q0) {
    const uint32_t dst = QGs + stage * 2 * TQ;
    load_async<HDP, QB>(dst, qh, q0, p.Sq, p);
    load_async<HDP, QB>(dst + TQ, gh, q0, p.Sq, p);
    if (tid < 2 * QB) {
      const int s = q0 + tid % QB;
      const float* src = tid < QB ? lse_h : dl_h;
      cp_async4(stats_s + (stage * 2 * QB + tid) * 4,
                s < p.Sq ? src + s : src, s < p.Sq);
    }
  };
  if (n_tiles > 0) load_q(0, q_begin);
  cp_commit();

  const uint32_t ka = Ks + 16 * warp * RB + ln.a;
  const uint32_t va = Vs + 16 * warp * RB + ln.a;
  const int key_a = k0 + 16 * warp + g;    // this thread's keys: +0, +8
  float dka[NC / 8][4], dva[NC / 8][4];
  zero(dka);
  zero(dva);
  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_begin + j * QB;
    cp_wait_all();
    __syncthreads();
    if (j + 1 < n_tiles) load_q((j + 1) & 1, q0 + QB);
    cp_commit();
    const uint32_t Qt = QGs + (j & 1) * 2 * TQ, Gt = Qt + TQ;
    const float* lse_t = stats + (j & 1) * 2 * QB;
    const float* dl_t = lse_t + QB;

    // P^T = exp(K q_s^T - lse): this warp's 16 keys x QB queries
    float pt[QB / 8][4];
    zero(pt);
    mma_abt<HDP, QB>(pt, ka, Qt + ln.bn);
    const bool mask = straddles(p, q0, QB, k0, BK);
#pragma unroll
    for (int nt = 0; nt < QB / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nt + 2 * t + (e & 1);
        float x = exp2f(fmaf(pt[nt][e], LOG2E, -lse_t[c] * LOG2E));
        if (mask && !visible(p, q0 + c, key_a + 8 * (e >> 1))) x = 0.f;
        pt[nt][e] = x;
      }
    mma_pb<HDP, QB, NC>(dva, pt, (Gt + ln.bk) ^ cx);   // dV += P^T dO
    // dS^T = P^T (V dO^T - delta), rounded to bf16 where it meets q_s
    float ds[QB / 8][4];
    zero(ds);
    mma_abt<HDP, QB>(ds, va, Gt + ln.bn);
#pragma unroll
    for (int nt = 0; nt < QB / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nt][e] = pt[nt][e] * (ds[nt][e] - dl_t[8 * nt + 2 * t + (e & 1)]);
    mma_pb<HDP, QB, NC>(dka, ds, (Qt + ln.bk) ^ cx);   // dK += dS^T q_s
  }
  cp_wait_all();
  const float one[2] = {1.f, 1.f};
  store_rows<NC>(dk + koff, k0 + 16 * warp, p.Sk, dka, one, p, lane, c0);
  store_rows<NC>(dv + koff, k0 + 16 * warp, p.Sk, dva, one, p, lane, c0);
}

template <int HDP>
constexpr size_t dq_mma_smem() {
  return SMEM_SLACK + 2 * tile_bytes<HDP>(BQ) + 4 * tile_bytes<HDP>(BK);
}

// dQ of one query tile: the block loops over the KV tiles it sees, in
// steps of bwd_step keys
template <int HDP>
__global__ void __maxnreg__(255)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ qs,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, Shape p) {
  constexpr int KB = bwd_step<HDP>();
  constexpr uint32_t TB = tile_bytes<HDP>(BK), RB = row_bytes<HDP>();
  extern __shared__ uint8_t smem[];
  const uint32_t Qs = smem_base(smem), Gs = Qs + tile_bytes<HDP>(BQ);
  const uint32_t KVs = Gs + tile_bytes<HDP>(BQ);    // [2 stages][K, V]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Lanes ln = lane_offsets<HDP>(lane);
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  const size_t qoff = ((size_t)b * p.Sq * p.H + h) * p.hd;
  const bf16* kh = k + ((size_t)b * p.Sk * p.H + h) * p.hd;
  const bf16* vh = v + ((size_t)b * p.Sk * p.H + h) * p.hd;

  int k_begin, k_end;
  key_range(p, q0, &k_begin, &k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  load_async<HDP, BQ>(Qs, qs + qoff, q0, p.Sq, p);
  load_async<HDP, BQ>(Gs, dout + qoff, q0, p.Sq, p);
  if (n_tiles > 0) {
    load_async<HDP, BK>(KVs, kh, k_begin, p.Sk, p);
    load_async<HDP, BK>(KVs + TB, vh, k_begin, p.Sk, p);
  }
  cp_commit();

  const uint32_t qa = Qs + 16 * warp * RB + ln.a;
  const uint32_t ga = Gs + 16 * warp * RB + ln.a;
  const int row_a = q0 + 16 * warp + g;    // this thread's rows: +0, +8
  float lse_l[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row_a + 8 * r;
    lse_l[r] = i < p.Sq ? lse[(size_t)bh * p.Sq + i] * LOG2E : 0.f;
    dl[r] = i < p.Sq ? delta[(size_t)bh * p.Sq + i] : 0.f;
  }
  float dqa[HDP / 8][4];
  zero(dqa);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * BK;
    cp_wait_all();
    __syncthreads();
    if (j + 1 < n_tiles) {
      const uint32_t nb = KVs + ((j + 1) & 1) * 2 * TB;
      load_async<HDP, BK>(nb, kh, k0 + BK, p.Sk, p);
      load_async<HDP, BK>(nb + TB, vh, k0 + BK, p.Sk, p);
    }
    cp_commit();
    const bool mask = straddles(p, q0, BQ, k0, BK);
#pragma unroll 1
    for (int kb = 0; kb < BK; kb += KB) {
      const uint32_t Kt = KVs + (j & 1) * 2 * TB + kb * RB, Vt = Kt + TB;
      // P = exp(q_s K^T - lse): this warp's 16 rows x KB keys
      float pr[KB / 8][4];
      zero(pr);
      mma_abt<HDP, KB>(pr, qa, Kt + ln.bn);
#pragma unroll
      for (int nt = 0; nt < KB / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = exp2f(fmaf(pr[nt][e], LOG2E, -lse_l[e >> 1]));
          if (mask && !visible(p, row_a + 8 * (e >> 1),
                               k0 + kb + 8 * nt + 2 * t + (e & 1)))
            x = 0.f;
          pr[nt][e] = x;
        }
      // dS = P (dO V^T - delta), rounded to bf16 where it meets K
      float ds[KB / 8][4];
      zero(ds);
      mma_abt<HDP, KB>(ds, ga, Vt + ln.bn);
#pragma unroll
      for (int nt = 0; nt < KB / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[nt][e] = pr[nt][e] * (ds[nt][e] - dl[e >> 1]);
      mma_pb<HDP, KB>(dqa, ds, Kt + ln.bk);   // dQ += dS K
    }
  }
  cp_wait_all();
  const float scale[2] = {p.scale, p.scale};
  store_rows<HDP>(dq + qoff, q0 + 16 * warp, p.Sq, dqa, scale, p, lane);
}

// ------------------------------------------------------------- f32 route

constexpr int NT = 256;           // threads per block
constexpr int SLD = BK + 1;       // row stride of a [BQ, BK] score tile
constexpr float NEG_INF = -1e30f;

// rows [row0, row0 + 64) of one head of a [B,S,H,hd] tensor into a
// [64, HDP+1] f32 tile; with SCALE the values are multiplied by p.scale
template <int HDP, bool SCALE>
__device__ __forceinline__ void load_tile(float* dst, const float* head,
                                          int row0, int S, const Shape& p) {
  const size_t stride = (size_t)p.H * p.hd;
  for (int i = threadIdx.x; i < 64 * HDP; i += NT) {
    const int r = i / HDP, d = i % HDP, s = row0 + r;
    float x = 0.f;
    if (s < S && d < p.hd) {
      x = head[(size_t)s * stride + d];
      if (SCALE) x *= p.scale;
    }
    dst[r * (HDP + 1) + d] = x;
  }
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
constexpr size_t fwd_fma_smem() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (HDP + 1) + BQ * SLD +
                          2 * BQ);
}

template <int HDP>
__global__ void __launch_bounds__(NT)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Shape p) {
  constexpr int LD = HDP + 1, NC = HDP / 16;
  extern __shared__ float smem_f[];
  float* Qs = smem_f;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ss = Vs + BK * LD;
  float* corr_s = Ss + BQ * SLD;
  float* l_s = corr_s + BQ;

  const int tid = threadIdx.x, q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const size_t stride = (size_t)p.H * p.hd;
  const float* qh = q + ((size_t)b * p.Sq * p.H + h) * p.hd;
  const float* kh = k + ((size_t)b * p.Sk * p.H + h) * p.hd;
  const float* vh = v + ((size_t)b * p.Sk * p.H + h) * p.hd;
  float* oh = o + ((size_t)b * p.Sq * p.H + h) * p.hd;

  load_tile<HDP, true>(Qs, qh, q0, p.Sq, p);
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
    load_tile<HDP, false>(Ks, kh, k0, p.Sk, p);
    load_tile<HDP, false>(Vs, vh, k0, p.Sk, p);
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
        Ss[sr * SLD + c] = e;
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
      if (d < p.hd) oh[(size_t)s * stride + d] = acc[i][c] / l;
    }
  }
}

template <int HDP>
constexpr size_t bwd_fma_smem() {
  return sizeof(float) * ((size_t)4 * 64 * (HDP + 1) + 2 * BQ * SLD + 2 * BQ);
}

// P into Ps, if not null, and dS into dSs for one (query tile q0, KV tile
// k0) pair; Qs holds the scaled q, dOs dO, Ks/Vs the KV tile, lse_s and
// d_s the rows' log-sum-exp and delta
template <int HDP>
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
      if (Ps != nullptr) Ps[r * SLD + c] = pr;
      dSs[r * SLD + c] = pr * (dp[i][j] - d_s[r]);
    }
}

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
template <int HDP>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_fma_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          Shape p) {
  constexpr int LD = HDP + 1, NC = HDP / 16;
  extern __shared__ float smem_f[];
  float* Ks = smem_f;
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
  const float* qh = q + ((size_t)b * p.Sq * p.H + h) * p.hd;
  const float* gh = dout + ((size_t)b * p.Sq * p.H + h) * p.hd;
  const size_t koff = ((size_t)b * p.Sk * p.H + h) * p.hd;
  load_tile<HDP, false>(Ks, k + koff, k0, p.Sk, p);
  load_tile<HDP, false>(Vs, v + koff, k0, p.Sk, p);

  const int tr = tid >> 4, tc = tid & 15;
  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.f;

  int q_lo = 0, q_hi = p.Sq;
  if (p.causal) q_lo = max(0, k0 - p.q_offset);
  if (p.window > 0) q_hi = min(p.Sq, k0 + BK - 1 + p.window - p.q_offset);
  for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
    __syncthreads();            // the last tile's readers are done
    load_tile<HDP, true>(Qs, qh, q0, p.Sq, p);
    load_tile<HDP, false>(dOs, gh, q0, p.Sq, p);
    load_rows_stats(p, bh, q0, lse, delta, lse_s, d_s);
    __syncthreads();
    probs_tile<HDP>(p, q0, k0, Qs, dOs, Ks, Vs, lse_s, d_s, Ps, dSs, tr, tc);
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
        dk[koff + (size_t)j * stride + d] = dka[i][c];
        dv[koff + (size_t)j * stride + d] = dva[i][c];
      }
    }
  }
}

// dQ of one query tile: the block loops over the KV tiles it sees
template <int HDP>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_fma_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, Shape p) {
  constexpr int LD = HDP + 1, NC = HDP / 16;
  extern __shared__ float smem_f[];
  float* Qs = smem_f;
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
  const float* kh = k + ((size_t)b * p.Sk * p.H + h) * p.hd;
  const float* vh = v + ((size_t)b * p.Sk * p.H + h) * p.hd;
  load_tile<HDP, true>(Qs, q + qoff, q0, p.Sq, p);
  load_tile<HDP, false>(dOs, dout + qoff, q0, p.Sq, p);
  load_rows_stats(p, bh, q0, lse, delta, lse_s, d_s);

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
    load_tile<HDP, false>(Ks, kh, k0, p.Sk, p);
    load_tile<HDP, false>(Vs, vh, k0, p.Sk, p);
    __syncthreads();
    probs_tile<HDP>(p, q0, k0, Qs, dOs, Ks, Vs, lse_s, d_s, nullptr, dSs,
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
      if (d < p.hd) dq[qoff + (size_t)s * stride + d] = dqa[i][c] * p.scale;
    }
  }
}

// ------------------------------------------------------ both routes, host

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_f32(float x, bf16* y) {
  *y = __float2bfloat16_rn(x);
}

// delta[b,h,s] = sum_d dO·O, one warp per row, O in f32 (the forward's
// unrounded output); with qs, also the scaled q rounded to its dtype (the
// operand of the bf16 backward's products)
template <typename T>
__global__ void flash_bwd_prep_kernel(const float* __restrict__ o,
                                      const T* __restrict__ dout,
                                      const T* __restrict__ q,
                                      float* __restrict__ delta,
                                      T* __restrict__ qs, Shape p) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= p.B * p.H * p.Sq) return;     // uniform within the warp
  const int s = row % p.Sq, bh = row / p.Sq, b = bh / p.H, h = bh % p.H;
  const size_t off = (((size_t)b * p.Sq + s) * p.H + h) * p.hd;
  float acc = 0.f;
  for (int d = lane; d < p.hd; d += 32) {
    acc = fmaf(o[off + d], to_f32(dout[off + d]), acc);
    if (qs != nullptr) from_f32(to_f32(q[off + d]) * p.scale, qs + off + d);
  }
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[(size_t)bh * p.Sq + s] = acc;
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

template <int HDP>
int fwd_mma(const void* q, const void* k, const void* v, void* o, void* o32,
            void* lse, const Shape& p, cudaStream_t st) {
  static bool smem_set = false;
  const size_t smem = fwd_mma_smem<HDP>();
  cudaError_t e = allow_smem(flash_fwd_mma_kernel<HDP>, smem, &smem_set);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  flash_fwd_mma_kernel<HDP><<<grid, MT, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)o32,
      (float*)lse, p);
  return (int)cudaGetLastError();
}

template <int HDP>
int fwd_fma(const void* q, const void* k, const void* v, void* o, void* lse,
            const Shape& p, cudaStream_t st) {
  static bool smem_set = false;
  const size_t smem = fwd_fma_smem<HDP>();
  cudaError_t e = allow_smem(flash_fwd_fma_kernel<HDP>, smem, &smem_set);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_fma_kernel<HDP><<<grid, NT, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, p);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_prep(const void* o, const void* dout, const void* q, void* delta,
             void* qs, const Shape& p, cudaStream_t st) {
  const int rows = p.B * p.H * p.Sq;
  flash_bwd_prep_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(
      (const float*)o, (const T*)dout, (const T*)q, (float*)delta, (T*)qs,
      p);
  return (int)cudaGetLastError();
}

template <int HDP>
int bwd_mma(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const void* lse, void* delta, void* qs,
            void* dq, void* dk, void* dv, const Shape& p, cudaStream_t st) {
  cudaError_t e = (cudaError_t)bwd_prep<bf16>(o, dout, q, delta, qs, p, st);
  if (e != cudaSuccess) return (int)e;
  static bool dkdv_set = false, dq_set = false;
  e = allow_smem(flash_bwd_dkdv_mma_kernel<HDP>, dkdv_mma_smem<HDP>(),
                 &dkdv_set);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_bwd_dq_mma_kernel<HDP>, dq_mma_smem<HDP>(), &dq_set);
  if (e != cudaSuccess) return (int)e;
  dim3 gk(p.B * p.H, (p.Sk + BK - 1) / BK, dkdv_parts<HDP>());
  flash_bwd_dkdv_mma_kernel<HDP><<<gk, MT, dkdv_mma_smem<HDP>(), st>>>(
      (const bf16*)qs, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gq(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  flash_bwd_dq_mma_kernel<HDP><<<gq, MT, dq_mma_smem<HDP>(), st>>>(
      (const bf16*)qs, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, p);
  return (int)cudaGetLastError();
}

template <int HDP>
int bwd_fma(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const void* lse, void* delta, void* dq,
            void* dk, void* dv, const Shape& p, cudaStream_t st) {
  cudaError_t e =
      (cudaError_t)bwd_prep<float>(o, dout, q, delta, nullptr, p, st);
  if (e != cudaSuccess) return (int)e;
  static bool dkdv_set = false, dq_set = false;
  const size_t smem = bwd_fma_smem<HDP>();
  e = allow_smem(flash_bwd_dkdv_fma_kernel<HDP>, smem, &dkdv_set);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_bwd_dq_fma_kernel<HDP>, smem, &dq_set);
  if (e != cudaSuccess) return (int)e;
  dim3 gk((p.Sk + BK - 1) / BK, p.B * p.H);
  flash_bwd_dkdv_fma_kernel<HDP><<<gk, NT, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gq((p.Sq + BQ - 1) / BQ, p.B * p.H);
  flash_bwd_dq_fma_kernel<HDP><<<gq, NT, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, p);
  return (int)cudaGetLastError();
}

// hd: any of 1..128 for f32; a multiple of 8 up to 256 for bf16.  The grid
// holds B*H and the tile count on its axes (65535 blocks at most on y).
bool bad_shape(int B, int H, int Sq, int Sk, int hd, int dtype) {
  if (hd < 1 || hd > (dtype == 1 ? 256 : 128) || (dtype == 1 && hd % 8 != 0))
    return true;
  if (dtype == 0) return B * H > 65535;
  return (Sq + BQ - 1) / BQ > 65535 || (Sk + BK - 1) / BK > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o share it).  q [B,Sq,H,hd],
// k/v [B,Sk,H,hd] -> o [B,Sq,H,hd], lse [B,H,Sq] f32, and in bf16, where
// o32 is not null, O before its rounding, [B,Sq,H,hd] f32 (the backward's
// o; the f32 route's o is that already, and o32 must be null).  window <= 0
// means none.  bf16 pointers must be 16-byte aligned.  Returns the
// launch's cudaError_t.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* o32, void* lse, int B, int H,
                                int Sq, int Sk, int hd, int causal,
                                int window, int q_offset, float scale,
                                int dtype, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if ((dtype != 0 && dtype != 1) || bad_shape(B, H, Sq, Sk, hd, dtype) ||
      (dtype == 0 && o32 != nullptr))
    return (int)cudaErrorInvalidValue;
  const Shape p = make_shape(B, H, Sq, Sk, hd, causal, window, q_offset,
                             scale);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return hd <= 64 ? fwd_fma<64>(q, k, v, o, lse, p, st)
                    : fwd_fma<128>(q, k, v, o, lse, p, st);
  if (hd <= 64) return fwd_mma<64>(q, k, v, o, o32, lse, p, st);
  if (hd <= 112) return fwd_mma<112>(q, k, v, o, o32, lse, p, st);
  if (hd <= 128) return fwd_mma<128>(q, k, v, o, o32, lse, p, st);
  return fwd_mma<256>(q, k, v, o, o32, lse, p, st);
}

// The backward of flash_fwd_launch: dO [B,Sq,H,hd] and the forward's lse
// and unrounded O (o: [B,Sq,H,hd] f32 in both dtypes, the bf16 forward's
// o32) -> dq [B,Sq,H,hd], dk/dv [B,Sk,H,hd] (every element written; rows
// no query sees get zeros); delta is [B,H,Sq] f32 scratch, qs scratch
// shaped like q (bf16 only; null for f32).
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* delta, void* qs,
                                void* dq, void* dk, void* dv, int B, int H,
                                int Sq, int Sk, int hd, int causal,
                                int window, int q_offset, float scale,
                                int dtype, void* stream) {
  if (B == 0 || H == 0 || (Sq == 0 && Sk == 0)) return 0;
  if ((dtype != 0 && dtype != 1) || bad_shape(B, H, Sq, Sk, hd, dtype) ||
      (dtype == 1 && qs == nullptr))
    return (int)cudaErrorInvalidValue;
  const Shape p = make_shape(B, H, Sq, Sk, hd, causal, window, q_offset,
                             scale);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return hd <= 64
               ? bwd_fma<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, st)
               : bwd_fma<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, p,
                              st);
  if (hd <= 64)
    return bwd_mma<64>(q, k, v, o, dout, lse, delta, qs, dq, dk, dv, p, st);
  if (hd <= 112)
    return bwd_mma<112>(q, k, v, o, dout, lse, delta, qs, dq, dk, dv, p, st);
  if (hd <= 128)
    return bwd_mma<128>(q, k, v, o, dout, lse, delta, qs, dq, dk, dv, p, st);
  return bwd_mma<256>(q, k, v, o, dout, lse, delta, qs, dq, dk, dv, p, st);
}
