// Split-KV decode attention for GQA: one new query token per row against
// the row's K/V cache, each row at its own position.
//
// It replaces no TPU kernel: the reference's `decode_attention`
// (src/repro/models/attention.py:84) is plain jnp.  It was added because
// the port's plain version (models/attention.py `decode_attention`) repeats
// K and V to every query head, casts the whole `max_len` cache to f32 and
// masks afterwards, so a row pays for every position of the cache, at
// every query head, four bytes an element, whatever its context.
//
// Bound: bytes.  A row at context c reads c x KH x hd elements of K and of
// V (bf16: 2 bytes each, fp8: 1); the products do about 2 x rep operations
// a byte (rep = H / KH query heads a KV head), far below the card's ridge
// (about 295 operations a byte in bf16).  What the design does about it:
// - Each K and V element is read once, in its stored dtype, for all `rep`
//   query heads of its KV head: a block owns one (row, KV head, split of
//   CHUNK keys) and holds the rep heads' queries as the 16 rows of an
//   `mma.sync.m16n8k16` tile (rep > 16: a grid axis of head groups).
// - Only the row's visible keys are read: each block reads its row's
//   `pos` on the device, a block whose split holds no visible key exits
//   at once, and keys outside the visible range are zero-filled by the
//   copies, not read.  The grid, (splits, KH x head groups, B), depends
//   only on the shapes, so the launch can be captured in a CUDA graph and
//   replayed as the positions move.
// - Copies are 16 bytes a thread, coalesced along hd, `cp.async` double
//   buffered per warp: each of the 4 warps walks its own 16-key sub-tiles
//   of the split (sub-tile i goes to warp i % 4) with its own online
//   softmax, so no block barrier sits in the loop.  An fp8 cache is loaded
//   8 bytes a thread and dequantized to bf16 in registers on its way into
//   shared memory (exactly: every e4m3 and e5m2 value is a bf16 value).
// - The block's 4 warps are combined in shared memory, in warp order, and
//   the split's (m, l, acc) written as f32 scratch; a second kernel merges
//   a row's splits by log-sum-exp, in split order, into [B,1,H,hd].  No
//   atomics: a row's output depends only on its own q, cache and pos, not
//   on the batch height, the other rows, or a graph replay against an
//   eager launch.
//
// Numerics, as the plain version: q is scaled by 1/sqrt(hd) and rounded to
// bf16; logits, max and sum are f32; the probabilities are rounded to bf16
// (unnormalised, as models/attention.py `chunked_attention` and the flash
// kernel round them) before they meet V; P·V accumulates in f32; the output
// is rounded once to bf16.  A row with no visible key (only a position
// outside the cache can give one) reads zeros, where the plain version
// averages V.
//
// Masks, as the plain version's: key j of a row at position pos is visible
// when j <= pos; with a window w, also j > pos - w; with `rolling` (a ring
// of S entries) every entry once pos + 1 >= S.
//
// Layout: q, o [B,1,H,hd] bf16; k, v [B,S,KH,hd] (bf16 or fp8); pos [B]
// int64; scratch: acc [B,H,NS,hd] and (m, l) [B,H,NS,2], f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 4, MT = 32 * WARPS;   // threads a block
constexpr int SUB = 16;                      // keys a warp step
constexpr float LOG2E = 1.4426950408889634f;

struct Shape {
  int B, H, KH, rep, S, hd, window, rolling, chunk, kv;
  float scale;
};

// the visible keys [lo, hi) of a row at position pos
__device__ __forceinline__ void key_range(const Shape& p, long long pos,
                                          int* lo, int* hi) {
  long long a = 0, b = pos + 1;
  if (p.rolling) {
    if (pos + 1 >= p.S) b = p.S;
  } else if (p.window > 0) {
    a = pos - p.window + 1;
  }
  a = a < 0 ? 0 : (a > p.S ? p.S : a);
  b = b < 0 ? 0 : (b > p.S ? p.S : b);
  *lo = (int)a;
  *hi = (int)b;
}

// 16-byte chunks in a shared-memory row of HDP columns (a multiple of 8,
// so that the XOR swizzle stays inside the row)
template <int HDP>
__host__ __device__ constexpr int pitch() {
  return (HDP / 8 + 7) & ~7;
}
template <int HDP>
__host__ __device__ constexpr uint32_t row_bytes() {
  return pitch<HDP>() * 16;
}
// byte offset of chunk c of row r in a swizzled tile
template <int HDP>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * pitch<HDP>() + (c ^ (r & 7))) * 16u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
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
// every copy group but the newest has landed
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// one fp8 value (kv 1: e4m3fn, 2: e5m2) as a float, exactly: its exponent
// and mantissa bits placed in a float's, rescaled by the bias difference
// (subnormals come out right through the float's own subnormals)
__device__ __forceinline__ float fp8_value(uint32_t b, int kv) {
  const uint32_t sign = (b & 0x80u) << 24;
  if (kv == 1) {               // no infinities; 0x7f and 0xff are NaN
    if ((b & 0x7fu) == 0x7fu) return __uint_as_float(sign | 0x7fc00000u);
    return __uint_as_float(sign | ((b & 0x7fu) << 20)) * 0x1p120f;
  }
  if ((b & 0x7cu) == 0x7cu)    // e5m2's top exponent: inf or NaN
    return __uint_as_float(sign | ((b & 3u) ? 0x7fc00000u : 0x7f800000u));
  return __uint_as_float(sign | ((b & 0x7fu) << 21)) * 0x1p112f;
}

// eight fp8 values (8 bytes) as eight bf16 (16 bytes)
__device__ __forceinline__ uint4 fp8x8_to_bf16(uint2 raw, int kv) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = i < 2 ? raw.x : raw.y;
    const int sh = 16 * (i & 1);
    w[i] = pack_bf16(fp8_value((word >> sh) & 0xffu, kv),
                     fp8_value((word >> (sh + 8)) & 0xffu, kv));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Byte offsets, at k-step 0, of a lane's row address in the three
// `ldmatrix` patterns of a swizzled tile (as in flash_attention.cu):
// - a: the A operand, 16 rows x the 16 columns of a k-step;
// - bn: the B operand from rows = n, two 8-wide n-tiles (16 rows) x a
//   k-step (registers 0-1: n-tile 0, 2-3: n-tile 1);
// - bk: the B operand from rows = k (16 rows) x two 8-wide n-tiles of
//   columns, with .trans (registers 0-1: n-tile 2 dp, 2-3: 2 dp + 1).
// Tiles start on 512-byte boundaries and rows are 128, 256 or 512 bytes,
// so the address at k-step ks is the k-step-0 address XOR 32 ks.
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

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// keys [k0, k0 + SUB) of one KV head into a swizzled [SUB, HDP] bf16 tile,
// by the calling warp; keys outside [a0, a1) and columns past hd are zeros
// and are not read.  `head` points at key 0 of the head, `stride` is the
// bytes from one key to the next.
template <int HDP>
__device__ __forceinline__ void load_sub(uint32_t dst, uint8_t* dst_ptr,
                                         const uint8_t* head, size_t stride,
                                         int k0, int a0, int a1,
                                         const Shape& p, int lane) {
  constexpr int NCH = HDP / 8;
  const size_t esz = p.kv == 0 ? 2 : 1;
  for (int i = lane; i < SUB * NCH; i += 32) {
    const int r = i / NCH, c = i % NCH, key = k0 + r;
    const bool ok = key >= a0 && key < a1 && c * 8 < p.hd;
    const uint8_t* src = head + (size_t)key * stride + (size_t)c * 8 * esz;
    if (p.kv == 0) {
      cp_async16(dst + swz<HDP>(r, c), ok ? src : head, ok);
    } else {
      uint2 raw = {0u, 0u};
      if (ok) raw = *reinterpret_cast<const uint2*>(src);
      *reinterpret_cast<uint4*>(dst_ptr + swz<HDP>(r, c)) =
          fp8x8_to_bf16(raw, p.kv);
    }
  }
}

// dynamic shared memory, its start rounded up to 512 bytes (the XOR
// addressing above needs it; SMEM_SLACK more bytes are asked for)
constexpr uint32_t SMEM_SLACK = 512;
__device__ __forceinline__ uint32_t smem_base(const uint8_t* smem) {
  return (smem_u32(smem) + 511u) & ~511u;
}

// the Q tile (16 rows), then each warp's two stages of K and V sub-tiles,
// then each warp's (m, l) of 16 rows
template <int HDP>
__host__ __device__ constexpr uint32_t q_bytes() {
  return 16 * row_bytes<HDP>();
}
template <int HDP>
__host__ __device__ constexpr uint32_t warp_bytes() {
  return 4 * SUB * row_bytes<HDP>();
}
template <int HDP>
constexpr size_t attn_smem() {
  return SMEM_SLACK + q_bytes<HDP>() + WARPS * warp_bytes<HDP>() +
         WARPS * 16 * 2 * sizeof(float);
}

template <int HDP>
__global__ void __launch_bounds__(MT)
decode_attn_kernel(const bf16* __restrict__ q, const uint8_t* __restrict__ k,
                   const uint8_t* __restrict__ v,
                   const long long* __restrict__ pos,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   Shape p) {
  constexpr int NCH = HDP / 8, KS = HDP / 16, NT = HDP / 8;
  constexpr uint32_t RB = row_bytes<HDP>(), TB = SUB * RB;
  extern __shared__ uint8_t smem[];
  const uint32_t Qs = smem_base(smem);
  uint8_t* base = smem + (Qs - smem_u32(smem));    // Qs as a pointer

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, NS = gridDim.x;
  const int groups = (p.rep + 15) / 16;
  const int kh = blockIdx.y / groups, hg = blockIdx.y % groups;
  const int b = blockIdx.z;
  int lo, hi;
  key_range(p, pos[b], &lo, &hi);
  const int c0 = split * p.chunk;
  const int a0 = max(lo, c0), a1 = min(hi, c0 + p.chunk);
  if (a0 >= a1) return;            // nothing visible: the merge skips it
  const int rows = min(16, p.rep - 16 * hg);   // query heads of the tile
  const int h0 = kh * p.rep + 16 * hg;         // the first one

  // this warp's sub-tiles: i0 + warp, i0 + warp + WARPS, ... below i1
  const int i0 = (a0 - c0) / SUB, i1 = (a1 - c0 + SUB - 1) / SUB;
  const int n_sub = i1 - i0 > warp ? (i1 - i0 - warp + WARPS - 1) / WARPS : 0;
  const size_t esz = p.kv == 0 ? 2 : 1;
  const size_t stride = (size_t)p.KH * p.hd * esz;
  const size_t head_off = ((size_t)b * p.S * p.KH + kh) * p.hd * esz;
  const uint8_t* kh_ptr = k + head_off;
  const uint8_t* vh_ptr = v + head_off;
  const uint32_t area = Qs + q_bytes<HDP>() + warp * warp_bytes<HDP>();
  uint8_t* area_ptr = base + (area - Qs);
  if (n_sub > 0) {
    const int k0 = c0 + (i0 + warp) * SUB;
    load_sub<HDP>(area, area_ptr, kh_ptr, stride, k0, a0, a1, p, lane);
    load_sub<HDP>(area + TB, area_ptr + TB, vh_ptr, stride, k0, a0, a1, p,
                  lane);
  }
  cp_commit();

  // q * scale rounded to bf16 (the plain version's scaled q); rows past
  // the group's heads are zeros
  for (int i = tid; i < 16 * NCH; i += MT) {
    const int r = i / NCH, c = i % NCH;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && c * 8 < p.hd) {
      x = *reinterpret_cast<const uint4*>(
          q + ((size_t)b * p.H + h0 + r) * p.hd + c * 8);
      bf16* e = reinterpret_cast<bf16*>(&x);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        e[u] = __float2bfloat16_rn(__bfloat162float(e[u]) * p.scale);
    }
    *reinterpret_cast<uint4*>(base + swz<HDP>(r, c)) = x;
  }
  __syncthreads();
  const Lanes ln = lane_offsets<HDP>(lane);
  // up to hd 128 the Q fragments stay in registers for the whole loop; at
  // 256 they are re-loaded at each k-step (the accumulator alone is 128
  // registers a thread)
  constexpr bool HOLD_Q = HDP <= 128;
  uint32_t qf[HOLD_Q ? KS : 1][4];
  if constexpr (HOLD_Q) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldsm4(qf[ks], (Qs + ln.a) ^ (32u * ks));
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT][4];
  zero(acc);
  for (int n = 0; n < n_sub; ++n) {
    const int k0 = c0 + (i0 + warp + WARPS * n) * SUB;
    if (n + 1 < n_sub) {
      const uint32_t nb = (n + 1) & 1 ? 2 * TB : 0;
      const int k1 = k0 + WARPS * SUB;
      load_sub<HDP>(area + nb, area_ptr + nb, kh_ptr, stride, k1, a0, a1, p,
                    lane);
      load_sub<HDP>(area + nb + TB, area_ptr + nb + TB, vh_ptr, stride, k1,
                    a0, a1, p, lane);
    }
    cp_commit();
    cp_wait1();
    __syncwarp();          // every lane's copies of sub-tile n are in
    const uint32_t Kt = area + (n & 1 ? 2 * TB : 0), Vt = Kt + TB;

    float s[2][4];
    zero(s);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bf[4];
      ldsm4(bf, (Kt + ln.bn) ^ (32u * ks));
      if constexpr (HOLD_Q) {
        mma(s[0], qf[ks], bf[0], bf[1]);
        mma(s[1], qf[ks], bf[2], bf[3]);
      } else {
        uint32_t af[4];
        ldsm4(af, (Qs + ln.a) ^ (32u * ks));
        mma(s[0], af, bf[0], bf[1]);
        mma(s[1], af, bf[2], bf[3]);
      }
    }
    if (k0 < a0 || k0 + SUB > a1) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * nt + 2 * t + (e & 1);
          if (key < a0 || key >= a1) s[nt][e] = -INFINITY;
        }
    }
    // online softmax: a row's max over its quad (every sub-tile holds a
    // visible key, so the max is finite)
    float mx[2] = {m[0], m[1]}, ml[2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      ml[r] = mx[r] * LOG2E;
      const float corr = exp2f(fmaf(m[r], LOG2E, -ml[r]));
      m[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[nt][2 * r] *= corr;
        acc[nt][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(fmaf(s[nt][e], LOG2E, -ml[e >> 1]));
        l[e >> 1] += s[nt][e];
      }
    // P (16 heads x 16 keys), rounded to bf16, times V (16 keys x HDP)
    uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                      pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int dp = 0; dp < HDP / 16; ++dp) {
      uint32_t bf[4];
      ldsm4t(bf, (Vt + ln.bk) ^ (32u * dp));
      mma(acc[2 * dp], pa, bf[0], bf[1]);
      mma(acc[2 * dp + 1], pa, bf[2], bf[3]);
    }
    __syncwarp();          // done with this stage before it is refilled
  }
  cp_wait_all();
  __syncwarp();

  // the warp's (m, l, acc) into shared memory: acc as f32 [16][HDP] over
  // its own stages, (m, l) after every warp's area
  float* accs = reinterpret_cast<float*>(area_ptr);
  float* mls = reinterpret_cast<float*>(
      base + q_bytes<HDP>() + WARPS * warp_bytes<HDP>());
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (t == 0) {
      mls[(warp * 16 + g + 8 * r) * 2] = m[r];
      mls[(warp * 16 + g + 8 * r) * 2 + 1] = l[r];
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      accs[(g + 8 * (e >> 1)) * HDP + nt * 8 + 2 * t + (e & 1)] = acc[nt][e];
  __syncthreads();

  // the split's (m, l, acc): the warps combined in warp order (a warp
  // with no sub-tile has m = -inf and weighs 0)
  const size_t row0 = ((size_t)b * p.H + h0) * NS + split;
  for (int i = tid; i < rows * p.hd; i += MT) {
    const int r = i / p.hd, c = i % p.hd;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, mls[(w * 16 + r) * 2]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f((mls[(w * 16 + r) * 2] - mm) * LOG2E);
      ll += mls[(w * 16 + r) * 2 + 1] * wt;
      const float* wa = reinterpret_cast<const float*>(
          base + q_bytes<HDP>() + w * warp_bytes<HDP>());
      aa += wa[r * HDP + c] * wt;
    }
    const size_t at = row0 + (size_t)r * NS;
    part_acc[at * p.hd + c] = aa;
    if (c == 0) {
      part_ml[at * 2] = mm;
      part_ml[at * 2 + 1] = ll;
    }
  }
}

// One block a (head, row): the row's splits that hold visible keys, merged
// by log-sum-exp in split order, into o [B,1,H,hd] bf16
__global__ void __launch_bounds__(MT)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml,
                    const long long* __restrict__ pos, bf16* __restrict__ o,
                    Shape p, int NS) {
  const int h = blockIdx.x, b = blockIdx.y;
  int lo, hi;
  key_range(p, pos[b], &lo, &hi);
  const int s0 = lo / p.chunk, s1 = hi > lo ? (hi - 1) / p.chunk + 1 : s0;
  const size_t row = ((size_t)b * p.H + h) * NS;
  const float* ml = part_ml + row * 2;
  float mm = -INFINITY;
  for (int s = s0; s < s1; ++s) mm = fmaxf(mm, ml[2 * s]);
  float ll = 0.f;
  for (int s = s0; s < s1; ++s)
    ll += ml[2 * s + 1] * exp2f((ml[2 * s] - mm) * LOG2E);
  const float inv = 1.f / fmaxf(ll, 1e-30f);
  for (int c = threadIdx.x; c < p.hd; c += blockDim.x) {
    float aa = 0.f;
    for (int s = s0; s < s1; ++s)
      aa += part_acc[(row + s) * p.hd + c] *
            exp2f((ml[2 * s] - mm) * LOG2E);
    o[((size_t)b * p.H + h) * p.hd + c] = __float2bfloat16_rn(aa * inv);
  }
}

// Allow `kernel` `bytes` of dynamic shared memory (above the default 48
// KB), once per kernel and device: the first launch on a device sets it,
// before any graph capture.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* o, void* part, const Shape& p, cudaStream_t st) {
  static bool smem_set[64] = {};
  const size_t smem = attn_smem<HDP>();
  cudaError_t e = allow_smem(decode_attn_kernel<HDP>, smem, smem_set);
  if (e != cudaSuccess) return (int)e;
  const int NS = (p.S + p.chunk - 1) / p.chunk;
  float* part_acc = (float*)part;
  float* part_ml = part_acc + (size_t)p.B * p.H * NS * p.hd;
  dim3 grid(NS, p.KH * ((p.rep + 15) / 16), p.B);
  decode_attn_kernel<HDP><<<grid, MT, smem, st>>>(
      (const bf16*)q, (const uint8_t*)k, (const uint8_t*)v,
      (const long long*)pos, part_acc, part_ml, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_merge_kernel<<<dim3(p.H, p.B), MT, 0, st>>>(
      part_acc, part_ml, (const long long*)pos, (bf16*)o, p, NS);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,1,H,hd] bf16, k/v [B,S,KH,hd] (kv_dtype 0: bf16, 1: float8_e4m3fn,
// 2: float8_e5m2), pos [B] int64 on the device -> o [B,1,H,hd] bf16.
// part: f32 scratch of B*H*ceil(S/chunk)*(hd + 2) floats.  hd a multiple
// of 8 up to 256; H a multiple of KH; chunk a multiple of 64.  window <= 0
// means none.  Pointers 16-byte aligned.  Returns the launch's
// cudaError_t.
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const void* pos, void* o, void* part, int B,
                                  int H, int KH, int S, int hd, int window,
                                  int rolling, int chunk, int kv_dtype,
                                  float scale, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (KH < 1 || H % KH != 0 || S < 1 || hd < 8 || hd > 256 || hd % 8 != 0 ||
      chunk < 64 || chunk % 64 != 0 || kv_dtype < 0 || kv_dtype > 2 ||
      B > 65535 || H > 65535 || KH * ((H / KH + 15) / 16) > 65535)
    return (int)cudaErrorInvalidValue;
  Shape p;
  p.B = B; p.H = H; p.KH = KH; p.rep = H / KH; p.S = S; p.hd = hd;
  p.window = window; p.rolling = rolling; p.chunk = chunk; p.kv = kv_dtype;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd <= 16) return launch<16>(q, k, v, pos, o, part, p, st);
  if (hd <= 64) return launch<64>(q, k, v, pos, o, part, p, st);
  if (hd <= 128) return launch<128>(q, k, v, pos, o, part, p, st);
  return launch<256>(q, k, v, pos, o, part, p, st);
}
