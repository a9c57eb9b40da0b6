// Mamba2 SSD scan for Hopper: the exact recurrence, per (batch, head),
//     h <- exp(dt_t a) h + (dt_t x_t) B_t^T,   y_t = h C_t + D x_t,
// with h a [P,N] f32 state (head channel p, state channel n); B and C are
// shared by all heads (one group).  f32 inside; y is written once in x's
// dtype, hT in f32.  Any T (0 included).
//
// Replaces `_kernel` / `mamba2_pallas`
// (src/repro/kernels/mamba2_ssd/mamba2_ssd.py:17 / :52).  The TPU kernel
// walks chunks of Q tokens on a sequential grid axis with h in VMEM and
// turns each chunk into a decay-masked [Q,Q] attention plus two MXU
// matmuls.  Mamba2's decay is one scalar per head and step, so that chunked
// form is exact up to rounding.
//
// bf16 route (the model's): the chunked form on the tensor cores, with the
// chunks in parallel, in the three passes of the SSD decomposition (Dao and
// Gu, "Transformers are SSMs", 2024, section 6).  Chunks hold Q = 64
// tokens; la is the cumulative sum of dt a inside a chunk, taken from the
// chunk's start, so that the differences la_t - la_s below lose little to
// cancellation (|dt a| reaches ~16 a step at the model's dt).
//   1. `mamba2_ssd_state_kernel`, one block per (b, h, chunk, 64 head
//      channels): the chunk's state from a zero start,
//      S_c = (x . dt . exp(la_Q - la))^T B, a [P,Q]·[Q,N] product, and its
//      total decay exp(la_Q), into f32 scratch that the wrapper allocates.
//   2. `mamba2_ssd_pass_kernel`, one thread per 4 state values of a
//      (b, h): the state entering each chunk,
//      h_in[c] = exp(la_Q[c-1]) h_in[c-1] + S_{c-1} from h0 (or zeros),
//      carried in f32 and written as the two bf16 pieces that pass 3
//      multiplies; the last one is hT.
//   3. `mamba2_ssd_scan_kernel`, one block per (b, h, chunk, 64 head
//      channels), warp w owning the chunk's tokens 16 w .. 16 w + 15:
//      y = exp(la) . (C h_in^T) + ((C B^T) . L . dt) x + D x, with
//      L[t,s] = exp(la_t - la_s) on s <= t; above the diagonal the
//      exponent is set to -inf before exp, so exp never sees a large
//      positive argument, and the warp skips the key tiles it cannot see.
// Tensor cores without losing the f32 operands: every product has one
// operand that arrives in bf16 (x, B or C) and one computed in f32 (the
// weighted x of pass 1, the weighted C B^T and the entering state of pass
// 3).  The f32 one is cut into hi = bf16(v) and lo = bf16(v - hi) and
// multiplied twice, hi w + lo w, with f32 accumulators: about 17 bits of
// v, 2^-17 relative per term; a third piece was not needed (PERF.md).
// C B^T is a single product of bf16 values, exact per term.
// - Products: `mma.sync.m16n8k16` (bf16 in, f32 accumulators in
//   registers) with operands from `ldmatrix` (`.trans` where the product
//   runs along the tile's rows), as in csrc/flash_attention.cu.  `wgmma`
//   was not taken: the passes are bound by bytes (below), and the
//   synchronous form keeps each warp's fragments where the split and the
//   causal mask can reach them.
// - Tiles: bf16 in shared memory, each row's 16-byte chunks XOR-swizzled
//   by (row & 7); rows of 128 or 256 bytes, tiles on 256-byte boundaries,
//   so a k-step's address is the first one XOR 32 ks.  P is cut into tiles
//   of 64 head channels and N padded to the row: any P <= 1024, N in
//   {16, 32, 64, 128}.
// - Copies: every tile by `cp.async` (16 bytes, zeros past the end of T or
//   P) where the pointers and strides allow it, else element by element.
//   A block handles one chunk of one head and does not loop, so there is
//   nothing to double-buffer; several blocks an SM overlap one another's
//   loads with their products (the scan pass asks for five, which holds it
//   at 96 registers).
// - Determinism: no atomics; each output element has one writer, so a
//   rerun gives the same bits.
// - Chunk length: 128 tokens halves the chunk states' bytes but doubles
//   the causal key work of pass 3; on the card the two came out even, and
//   64 keeps pass 3 to one group of keys.
// Bound: bytes.  At zamba2's [2,112,1024,64] bf16, x is read twice and y
// written once (29 MB each), and the chunk states cross device memory four
// times (59 MB each: S written and read, h_in written and read); the
// products come to about 10 GFLOP with the split, well below the bf16
// ridge.  The function's own bound (inputs read once, y and hT written
// once: 64 MB, 0.019 ms) leaves out the chunk states.
//
// f32 route (tests only): the first kernel, `mamba2_ssd_fma_kernel`, one
// block per (b, h) and one thread per head channel p holding row p of h in
// registers, walking all T tokens in order; its y = h.C is one dependent
// FMA chain per token.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Strides {
  long long xb, xh, xt;   // x [B,H,T,P], unit stride along P
  long long db, dh, dt;   // dt [B,H,T]
  long long cb, ct;       // B and C [B,T,N], unit stride along N
  long long yb, yh, yt;   // y [B,H,T,P], unit stride along P
};
static_assert(sizeof(Strides) == 11 * sizeof(long long), "packed strides");

// ------------------------------------------------------------- f32 route

constexpr int kRun = 32;   // tokens staged in shared memory per pass

// One block per (b, h), blockDim.x == P.  a, d [H] f32; h0/hT [B,H,P,N]
// contiguous f32; h0 may be null.  B, C, dt and exp(dt a) of a run of
// tokens are staged in shared memory as f32 and read by broadcast.
template <int N>
__global__ void mamba2_ssd_fma_kernel(const float* __restrict__ x,
                                      const float* __restrict__ dt,
                                      const float* __restrict__ a,
                                      const float* __restrict__ bm,
                                      const float* __restrict__ c,
                                      const float* __restrict__ d,
                                      const float* __restrict__ h0,
                                      float* __restrict__ y,
                                      float* __restrict__ hT, int H, int Tn,
                                      int P, Strides s) {
  extern __shared__ float fsmem[];
  float* sB = fsmem;                // [kRun][N]
  float* sC = sB + kRun * N;        // [kRun][N]
  float* sdt = sC + kRun * N;       // [kRun] dt
  float* sdec = sdt + kRun;         // [kRun] exp(dt a)
  float* sx = sdec + kRun;          // [kRun][P]
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int p = threadIdx.x;
  const float* xp = x + b * s.xb + h * s.xh;
  const float* dtp = dt + b * s.db + h * s.dh;
  const float* bp = bm + b * s.cb;
  const float* cp = c + b * s.cb;
  float* yp = y + b * s.yb + h * s.yh;
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
      sB[i] = bp[off];
      sC[i] = cp[off];
    }
    for (int i = p; i < run; i += P) {
      const float dv = dtp[(long long)(t0 + i) * s.dt];
      sdt[i] = dv;
      sdec[i] = expf(dv * ah);
    }
    for (int tt = 0; tt < run; ++tt)
      sx[tt * P + p] = xp[(long long)(t0 + tt) * s.xt + p];
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
      yp[(long long)(t0 + tt) * s.yt + p] = acc + dh * xv;
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) hT[((size_t)bh * P + p) * N + n] = hs[n];
}

template <int N>
int launch_fma(const void* x, const void* dt, const void* a, const void* bm,
               const void* c, const void* d, const void* h0, void* y,
               void* hT, int B, int H, int Tn, int P, const Strides& s,
               cudaStream_t stream) {
  auto kern = mamba2_ssd_fma_kernel<N>;
  const int smem = (kRun * (2 * N + 2 + P)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * H, P, smem, stream>>>(
      (const float*)x, (const float*)dt, (const float*)a, (const float*)bm,
      (const float*)c, (const float*)d, (const float*)h0, (float*)y,
      (float*)hT, H, Tn, P, s);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16 route

constexpr int Q = 64;      // tokens per chunk
constexpr int PT = 64;     // head channels per block
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

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
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

struct Ssd {
  const bf16* x;
  const float* dt;
  const float* a;
  const bf16* bm;
  const bf16* c;
  const float* d;
  float* hs;       // [B,H,nc,P,N] f32: S_c, from pass 1
  float* dec;      // [B,H,nc] f32: exp(la_Q) of each chunk
  bf16* hin;       // [B,H,nc,2,P,N]: h_in[c] as hi and lo, from pass 2
  bf16* y;
  int H, T, P, nc;
  int vec_x, vec_bc, vec_y;   // 16-byte loads of x, of B and C; pair stores
  Strides s;
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

// Pass 1: S_c[p, n] = sum_s x[s, p] w[s] B[s, n], w = dt exp(la_Q - la),
// and exp(la_Q).  Warp w owns head channels 16 w .. 16 w + 15 of the tile.
template <int N>
constexpr size_t state_smem() {
  return SMEM_SLACK + tile_bytes<PT>(Q) + tile_bytes<N>(Q) + 3 * Q * 4;
}
template <int N>
__global__ void __launch_bounds__(NT) mamba2_ssd_state_kernel(Ssd q) {
  constexpr uint32_t RBX = row_bytes<PT>(), RBN = row_bytes<N>();
  extern __shared__ uint8_t smem[];
  const uint32_t Xs = smem_base(smem), Bs = Xs + tile_bytes<PT>(Q);
  uint8_t* gX = smem + (Xs - smem_u32(smem));
  uint8_t* gB = gX + tile_bytes<PT>(Q);
  float* sdt = reinterpret_cast<float*>(gB + tile_bytes<N>(Q));
  float* sla = sdt + Q;
  float* sw = sla + Q;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, ci = blockIdx.y, p0 = blockIdx.z * PT;
  const int b = bh / q.H, h = bh % q.H;
  const int t0 = ci * Q, nv = min(Q, q.T - t0), np_ = min(PT, q.P - p0);
  const Strides& s = q.s;
  load_tile<PT>(Xs, gX, q.x + b * s.xb + h * s.xh + t0 * s.xt + p0, s.xt,
                Q, nv, np_, q.vec_x);
  load_tile<N>(Bs, gB, q.bm + b * s.cb + t0 * s.ct, s.ct, Q, nv, N,
               q.vec_bc);
  cp_commit();
  chunk_decay(sdt, sla, q.dt + b * s.db + h * s.dh, s.dt, t0, nv, q.a[h]);
  __syncthreads();
  if (tid < Q) sw[tid] = sdt[tid] * expf(sla[Q - 1] - sla[tid]);
  if (tid == 0 && blockIdx.z == 0)
    q.dec[(size_t)bh * q.nc + ci] = expf(sla[Q - 1]);
  cp_wait_all();
  __syncthreads();
  if (16 * warp >= np_) return;

  float acc[N / 8][4];
  zero(acc);
  // x^T as the A operand: .trans over rows s, columns p = 16 warp ..
  const uint32_t xa = Xs + lane_bn<PT>(lane, 2 * warp);
  const uint32_t bk = Bs + lane_bk<N>(lane);
#pragma unroll
  for (int ks = 0; ks < Q / 16; ++ks) {
    uint32_t xf[4], hi[4], lo[4];
    ldsm4t(xf, xa + ks * 16 * RBX);
#pragma unroll
    for (int i = 0; i < 4; ++i) {       // (p = g + 8 (i & 1), s = ...)
      const int sj = 16 * ks + 2 * t + 8 * (i >> 1);
      const float2 v = unpack_bf16(xf[i]);
      split2(v.x * sw[sj], v.y * sw[sj + 1], &hi[i], &lo[i]);
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
  float* out = q.hs + ((size_t)bh * q.nc + ci) * q.P * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = p0 + 16 * warp + g + 8 * r;
    if (p < q.P)
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
        *reinterpret_cast<float2*>(out + (size_t)p * N + 8 * nt + 2 * t) =
            make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
  }
}

// Pass 2: h_in[c] = exp(la_Q[c-1]) h_in[c-1] + S_{c-1}, carried in f32
// and written as its two bf16 pieces (the operands of pass 3); one thread
// per 4 consecutive state values of one (b, h), the loads of KC chunks
// issued together.
constexpr int KC = 8;
__global__ void mamba2_ssd_pass_kernel(const float* __restrict__ hs,
                                       const float* __restrict__ dec,
                                       const float* __restrict__ h0,
                                       bf16* __restrict__ hin,
                                       float* __restrict__ hT, int BH,
                                       int PN4, int nc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)BH * PN4) return;
  const int bh = (int)(i / PN4), e = (int)(i % PN4);
  float4 h = h0 ? reinterpret_cast<const float4*>(h0)[i]
                : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* sp =
      reinterpret_cast<const float4*>(hs) + (size_t)bh * nc * PN4 + e;
  uint2* op = reinterpret_cast<uint2*>(hin) + (size_t)bh * nc * 2 * PN4 + e;
  const float* dp = dec + (size_t)bh * nc;
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
        uint2 hi, lo;
        split2(h.x, h.y, &hi.x, &lo.x);
        split2(h.z, h.w, &hi.y, &lo.y);
        op[(size_t)(c0 + u) * 2 * PN4] = hi;
        op[(size_t)(c0 + u) * 2 * PN4 + PN4] = lo;
        h = make_float4(fmaf(dc[u], h.x, sc[u].x), fmaf(dc[u], h.y, sc[u].y),
                        fmaf(dc[u], h.z, sc[u].z), fmaf(dc[u], h.w, sc[u].w));
      }
  }
  reinterpret_cast<float4*>(hT)[i] = h;
}

// Pass 3: y = exp(la) . (C h_in^T) + ((C B^T) . L . dt) x + D x.  Warp w
// owns the chunk's tokens 16 w .. 16 w + 15.
template <int N>
constexpr size_t scan_smem() {
  return SMEM_SLACK + tile_bytes<PT>(Q) + 2 * tile_bytes<N>(Q) +
         2 * tile_bytes<N>(PT) + 2 * Q * 4;
}
template <int N>
__global__ void __launch_bounds__(NT, 5) mamba2_ssd_scan_kernel(Ssd q) {
  constexpr uint32_t RBX = row_bytes<PT>(), RBN = row_bytes<N>();
  constexpr uint32_t TN = tile_bytes<N>(Q), TH = tile_bytes<N>(PT);
  extern __shared__ uint8_t smem[];
  const uint32_t Xs = smem_base(smem), Cs = Xs + tile_bytes<PT>(Q);
  const uint32_t Bs = Cs + TN, Hh = Bs + TN, Hl = Hh + TH;
  uint8_t* gX = smem + (Xs - smem_u32(smem));
  uint8_t* gC = gX + (Cs - Xs);
  uint8_t* gB = gX + (Bs - Xs);
  uint8_t* gHh = gX + (Hh - Xs);
  uint8_t* gHl = gX + (Hl - Xs);
  float* sdt = reinterpret_cast<float*>(gHl + TH);
  float* sla = sdt + Q;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, ci = blockIdx.y, p0 = blockIdx.z * PT;
  const int b = bh / q.H, h = bh % q.H;
  const int t0 = ci * Q, nv = min(Q, q.T - t0), np_ = min(PT, q.P - p0);
  const Strides& s = q.s;
  load_tile<PT>(Xs, gX, q.x + b * s.xb + h * s.xh + t0 * s.xt + p0, s.xt,
                Q, nv, np_, q.vec_x);
  load_tile<N>(Cs, gC, q.c + b * s.cb + t0 * s.ct, s.ct, Q, nv, N,
               q.vec_bc);
  load_tile<N>(Bs, gB, q.bm + b * s.cb + t0 * s.ct, s.ct, Q, nv, N,
               q.vec_bc);
  // the entering state's rows p0 .. p0 + 63 (zeros past P), hi and lo
  const bf16* hin = q.hin + ((size_t)bh * q.nc + ci) * 2 * q.P * N + p0 * N;
  load_tile<N>(Hh, gHh, hin, N, PT, np_, N, true);
  load_tile<N>(Hl, gHl, hin + (size_t)q.P * N, N, PT, np_, N, true);
  cp_commit();
  chunk_decay(sdt, sla, q.dt + b * s.db + h * s.dh, s.dt, t0, nv, q.a[h]);
  cp_wait_all();
  __syncthreads();
  const int row0 = 16 * warp;
  if (row0 >= nv) return;

  // C h_in^T (hi and lo)
  float acc[PT / 8][4];
  zero(acc);
  const uint32_t ca = Cs + row0 * RBN + lane_a<N>(lane);
  const uint32_t bn = lane_bn<N>(lane);
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t af[4];
    ldsm4(af, ca ^ (32u * ks));
#pragma unroll
    for (int np = 0; np < PT / 16; ++np) {
      uint32_t bf[4];
      ldsm4(bf, ((Hh + bn) ^ (32u * ks)) + np * 16 * RBN);
      mma(acc[2 * np], af, bf[0], bf[1]);
      mma(acc[2 * np + 1], af, bf[2], bf[3]);
      ldsm4(bf, ((Hl + bn) ^ (32u * ks)) + np * 16 * RBN);
      mma(acc[2 * np], af, bf[0], bf[1]);
      mma(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
  // this thread's tokens: row0 + g and row0 + g + 8
  float la_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    la_r[r] = sla[row0 + g + 8 * r];
    const float e = expf(la_r[r]);
#pragma unroll
    for (int nt = 0; nt < PT / 8; ++nt) {
      acc[nt][2 * r] *= e;
      acc[nt][2 * r + 1] *= e;
    }
  }
  // C B^T on the 16-key tiles this warp can see, then (C B^T) . L . dt
  // (hi and lo) times x
  float cb[Q / 8][4];
  zero(cb);
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t af[4];
    ldsm4(af, ca ^ (32u * ks));
#pragma unroll
    for (int np = 0; np < Q / 16; ++np) {
      if (np > warp) continue;
      uint32_t bf[4];
      ldsm4(bf, ((Bs + bn) ^ (32u * ks)) + np * 16 * RBN);
      mma(cb[2 * np], af, bf[0], bf[1]);
      mma(cb[2 * np + 1], af, bf[2], bf[3]);
    }
  }
  const uint32_t xk = Xs + lane_bk<PT>(lane);
#pragma unroll
  for (int kk = 0; kk < Q / 16; ++kk) {
    if (kk > warp) continue;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // a[i]: row g + 8 (i & 1), col 8 (i >> 1)
      const int nt = 2 * kk + (i >> 1), r = i & 1;
      const int tt = row0 + g + 8 * r;
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int sj = 8 * nt + 2 * t + u;
        v[u] = cb[nt][2 * r + u] *
               expf(sj <= tt ? la_r[r] - sla[sj] : -INFINITY) * sdt[sj];
      }
      split2(v[0], v[1], &hi[i], &lo[i]);
    }
#pragma unroll
    for (int dp = 0; dp < PT / 16; ++dp) {
      uint32_t bf[4];
      ldsm4t(bf, (xk ^ (32u * dp)) + kk * 16 * RBX);
      mma(acc[2 * dp], hi, bf[0], bf[1]);
      mma(acc[2 * dp], lo, bf[0], bf[1]);
      mma(acc[2 * dp + 1], hi, bf[2], bf[3]);
      mma(acc[2 * dp + 1], lo, bf[2], bf[3]);
    }
  }
  // + D x, rounded once, stored in x's layout
  const float dh = q.d[h];
  bf16* yb = q.y + b * s.yb + h * s.yh + p0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tt = row0 + g + 8 * r;
    if (tt >= nv) continue;
    bf16* yr = yb + (long long)(t0 + tt) * s.yt;
#pragma unroll
    for (int nt = 0; nt < PT / 8; ++nt) {
      const int p = 8 * nt + 2 * t;
      if (p >= np_) continue;
      const float2 xv = unpack_bf16(
          *reinterpret_cast<const uint32_t*>(gX + swz<PT>(tt, nt) + 4 * t));
      const float v0 = acc[nt][2 * r] + dh * xv.x;
      const float v1 = acc[nt][2 * r + 1] + dh * xv.y;
      if (q.vec_y && p + 1 < np_) {
        *reinterpret_cast<uint32_t*>(yr + p) = pack_bf16(v0, v1);
      } else {
        yr[p] = __float2bfloat16_rn(v0);
        if (p + 1 < np_) yr[p + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <int N>
int launch_ssd(const Ssd& q, const float* h0, float* hT, int B,
               cudaStream_t st) {
  const int BH = B * q.H;
  const dim3 grid(BH, q.nc, (q.P + PT - 1) / PT);
  cudaError_t err;
  if (q.nc > 0) {
    auto k1 = mamba2_ssd_state_kernel<N>;
    err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)state_smem<N>());
    if (err != cudaSuccess) return (int)err;
    k1<<<grid, NT, state_smem<N>(), st>>>(q);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int pn4 = q.P * N / 4;
  const long long n4 = (long long)BH * pn4;
  const int threads = 256;
  mamba2_ssd_pass_kernel<<<(unsigned)((n4 + threads - 1) / threads), threads,
                           0, st>>>(q.hs, q.dec, h0, q.hin, hT, BH, pn4,
                                    q.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (q.nc > 0) {
    auto k3 = mamba2_ssd_scan_kernel<N>;
    err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)scan_smem<N>());
    if (err != cudaSuccess) return (int)err;
    k3<<<grid, NT, scan_smem<N>(), st>>>(q);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Tokens per chunk of the bf16 route, by which the caller sizes the
// scratch below.
extern "C" int mamba2_ssd_chunk(void) { return Q; }

// x [B,H,T,P] and B/C [B,T,N] in f32 (dtype 0) or bf16 (dtype 1); dt
// [B,H,T] f32; a, d [H] f32; h0 [B,H,P,N] f32 or null; y [B,H,T,P] in x's
// dtype; hT [B,H,P,N] f32.  Element strides in `strides`, in the order of
// the Strides struct (11 values).  N in {16, 32, 64, 128}, P <= 1024.  The
// bf16 route takes scratch: states [B,H,nc,P,N] f32, decays [B,H,nc] f32
// and entering states [B,H,nc,2,P,N] bf16, nc = ceil(T / Q), Q as
// `mamba2_ssd_chunk` reports it.  Returns the first refused launch's
// cudaError_t, or 0.
extern "C" int mamba2_ssd_launch(const void* x, const void* dt, const void* a,
                                 const void* bm, const void* c, const void* d,
                                 const void* h0, void* y, void* hT,
                                 void* states, void* decays, void* entering,
                                 int B, int H,
                                 int Tn, int P, int N, int dtype,
                                 const long long* strides, void* stream) {
  if (B * H == 0) return 0;
  if (P < 1 || P > 1024) return (int)cudaErrorInvalidValue;
  Strides s;
  memcpy(&s, strides, sizeof(s));
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    switch (N) {
      case 16: return launch_fma<16>(x, dt, a, bm, c, d, h0, y, hT, B, H, Tn,
                                     P, s, st);
      case 32: return launch_fma<32>(x, dt, a, bm, c, d, h0, y, hT, B, H, Tn,
                                     P, s, st);
      case 64: return launch_fma<64>(x, dt, a, bm, c, d, h0, y, hT, B, H, Tn,
                                     P, s, st);
      case 128: return launch_fma<128>(x, dt, a, bm, c, d, h0, y, hT, B, H,
                                       Tn, P, s, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  Ssd q;
  q.x = (const bf16*)x;
  q.dt = (const float*)dt;
  q.a = (const float*)a;
  q.bm = (const bf16*)bm;
  q.c = (const bf16*)c;
  q.d = (const float*)d;
  q.hs = (float*)states;
  q.dec = (float*)decays;
  q.hin = (bf16*)entering;
  q.y = (bf16*)y;
  q.H = H;
  q.T = Tn;
  q.P = P;
  q.nc = (Tn + Q - 1) / Q;
  if (q.nc > 65535) return (int)cudaErrorInvalidValue;
  q.vec_x = P % 8 == 0 && aligned16(x) && s.xb % 8 == 0 && s.xh % 8 == 0 &&
            s.xt % 8 == 0;
  q.vec_bc = aligned16(bm) && aligned16(c) && s.cb % 8 == 0 &&
             s.ct % 8 == 0;
  q.vec_y = ((uintptr_t)y & 3u) == 0 && s.yb % 2 == 0 && s.yh % 2 == 0 &&
            s.yt % 2 == 0;
  q.s = s;
  const float* h0f = (const float*)h0;
  float* hTf = (float*)hT;
  switch (N) {
    case 16: return launch_ssd<16>(q, h0f, hTf, B, st);
    case 32: return launch_ssd<32>(q, h0f, hTf, B, st);
    case 64: return launch_ssd<64>(q, h0f, hTf, B, st);
    case 128: return launch_ssd<128>(q, h0f, hTf, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
