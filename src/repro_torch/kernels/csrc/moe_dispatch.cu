// Fused MoE dispatch and combine for Hopper, over a leading group dimension
// (one MoE group per serving slot, or one group for a whole batch).
//
// dispatch replaces `_dispatch_kernel` / `dispatch_pallas`
// (src/repro/kernels/moe_dispatch/moe_dispatch.py:38 / :98): the stable
// in-slot rank, the capacity mask, the bucketed store and the routed/kept
// counts per slot.  The TPU kernel carries the rank base across a
// sequential grid and scatters with a one-hot MXU matmul.  Here a group's
// flat T·k assignments (in t·k + j order) are cut into tiles of TILE, and
// the work spreads over a grid of (group, tile, 128-byte slice of D) blocks
// in two passes:
//   A. `dispatch_hist_kernel`, one block per (group, tile): the tile's
//      histogram of keys into scratch [G, tiles, S+1] (the key is the slot,
//      or S for an invalid assignment or a slot outside [0, S)).
//   B. `dispatch_scatter_kernel`, one block per (group, tile, slice): the
//      tile's base per key is the sum of the earlier tiles' histograms, and
//      routed is the sum over all of them (kept = min(routed, C)).  Inside
//      the tile, thread i holds assignment i; warp w adds the counts of
//      warps 0..w-1 (an exclusive prefix over per-warp histograms), and a
//      lane the number of lanes below it with its key (`__match_any_sync`
//      under the lanes below, `__popc`).  That sum is exactly the
//      stable-argsort rank.  Then each kept assignment writes its own
//      buffer row's slice, w·v[tok] (one f32 product rounded once), 16
//      bytes a lane with 8 rows of a warp in flight, and the block zeroes
//      the slice of its share of the rows [kept[s], C) of every slot.
// A group of at most one tile (serving's T·k of 2..16) skips pass A: its
// one tile's counts are the group's, so one launch of pass B does all.
// Every output has one writer (rank/keep and the counts by the slice-0
// blocks), nothing is decided by atomics (a per-warp histogram row is
// written by the one leader lane of each key), so a rerun gives the same
// bits.  The single-block kernel this replaces ranked a whole group on one
// SM, 32 assignments at a time, and wrote the whole buffer from there.
//
// combine replaces `_combine_kernel` / `combine_pallas` (:78 / :129):
// y[t] = sum_j w·keep·buf[slot, rank], the k terms added in j order in f32
// and rounded once (no FMA contraction), one warp per token row: the row's
// routing in one coalesced round, then all k gathers of a lane in flight
// together, 16 bytes each.
//
// Bound: bytes.  Dispatch reads v once and writes the whole [S,C,D]
// buffer; combine reads k rows per token and writes y.  Neither does more
// than a few operations per byte.  At serving shapes (T·k of 2..16 per
// group) both are launch-bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

constexpr int TILE = 256;            // assignments a tile, one a thread
constexpr int NW = TILE / 32;        // warps a block
constexpr int PIECES = 8;            // 16-byte pieces of a row a block writes
constexpr unsigned FULL = 0xffffffffu;

struct Dispatch {
  const int32_t* slot;
  const int32_t* valid;
  int32_t* hist;      // [G, tiles, S+1] per-tile key counts (pass A)
  int N, S, tiles;    // assignments a group, slots, tiles a group
};

// This thread's assignment (tile blockIdx.y, thread i) of group blockIdx.x:
// its flat index, key (-1 past the group's end) and whether it is valid;
// then the warp's count of the key into wh[warp][key] by the key's lowest
// lane, and the number of lanes below with the same key.  wh must be zero.
__device__ __forceinline__ int tile_keys(const Dispatch& q, int* wh,
                                         int* key, bool* vld, int* below) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.y * TILE + threadIdx.x;
  *key = -1;
  *vld = false;
  if (i < q.N) {
    const size_t a = (size_t)blockIdx.x * q.N + i;
    const int s = q.slot[a];
    // a slot outside [0, S) counts as invalid rather than indexing out of
    // bounds (routing never produces one)
    *vld = q.valid[a] != 0 && s >= 0 && s < q.S;
    *key = *vld ? s : q.S;
  }
  const unsigned mask = __match_any_sync(FULL, *key);
  *below = __popc(mask & ((1u << lane) - 1u));
  if (*key >= 0 && lane == __ffs(mask) - 1)
    wh[warp * (q.S + 1) + *key] = __popc(mask);
  return i;
}

__device__ __forceinline__ void zero_ints(int* p, int n) {
  for (int i = threadIdx.x; i < n; i += TILE) p[i] = 0;
}

// Pass A: hist[g, tile, key] = the tile's count of key.
__global__ void __launch_bounds__(TILE) dispatch_hist_kernel(Dispatch q) {
  extern __shared__ int wh[];        // [NW][S+1]
  const int K1 = q.S + 1;
  zero_ints(wh, NW * K1);
  __syncthreads();
  int key, below;
  bool vld;
  tile_keys(q, wh, &key, &vld, &below);
  __syncthreads();
  int32_t* out = q.hist + ((size_t)blockIdx.x * q.tiles + blockIdx.y) * K1;
  for (int k = threadIdx.x; k < K1; k += TILE) {
    int n = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) n += wh[w * K1 + k];
    out[k] = n;
  }
}

// Pass B.  Shared memory: wh [NW][S+1] (per-warp counts, then each warp's
// base per key), tot [S+1] (the group's counts; tot[s] then min(., C)).
template <typename T>
__global__ void __launch_bounds__(TILE)
dispatch_scatter_kernel(Dispatch q, const T* __restrict__ v,
                        const float* __restrict__ w, T* __restrict__ buf,
                        int32_t* __restrict__ rank_out,
                        int32_t* __restrict__ keep_out,
                        int32_t* __restrict__ routed,
                        int32_t* __restrict__ kept, int Tn, int K, int D,
                        int C, int vec) {
  constexpr int V = (int)(sizeof(uint4) / sizeof(T));   // elements a piece
  extern __shared__ int smem[];
  const int K1 = q.S + 1;
  int* wh = smem;
  int* tot = wh + NW * K1;
  const int g = blockIdx.x, tile = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  zero_ints(wh, NW * K1);
  __syncthreads();
  int key, below;
  bool vld;
  const int i = tile_keys(q, wh, &key, &vld, &below);
  __syncthreads();

  // per key: the earlier tiles' counts (the tile's base) and all tiles'
  // (one warp a key, lanes over the tiles), then the exclusive prefix over
  // the warps of this tile, by the key's lane 0
  for (int k = warp; k < K1; k += NW) {
    int pre = 0, all = 0;
    if (q.tiles > 1) {
      const int32_t* h = q.hist + (size_t)g * q.tiles * K1 + k;
      for (int t = lane; t < q.tiles; t += 32) {
        const int n = h[(size_t)t * K1];
        all += n;
        pre += t < tile ? n : 0;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        pre += __shfl_xor_sync(FULL, pre, off);
        all += __shfl_xor_sync(FULL, all, off);
      }
    }
    if (lane == 0) {
      int run = pre;
      for (int ww = 0; ww < NW; ++ww) {
        const int n = wh[ww * K1 + k];
        wh[ww * K1 + k] = run;
        run += n;
      }
      // one tile: its own counts are the group's
      tot[k] = q.tiles > 1 ? all : run;
    }
  }
  __syncthreads();

  const int rk = key >= 0 ? wh[warp * K1 + key] + below : 0;
  const bool kp = vld && rk < C;
  const size_t a = (size_t)g * q.N + i;
  if (blockIdx.z == 0) {
    if (i < q.N) {
      rank_out[a] = vld ? rk : 0;
      keep_out[a] = kp ? 1 : 0;
    }
    if (tile == 0)
      for (int s = threadIdx.x; s < q.S; s += TILE) {
        routed[(size_t)g * q.S + s] = tot[s];
        kept[(size_t)g * q.S + s] = min(tot[s], C);
      }
  }

  // this block's slice of a row: pieces z*PIECES .. of 16 bytes (V
  // elements); lane & 7 owns one, so 8 lanes cover the slice of a row and
  // a warp 4 rows at a time
  const int sub = lane >> 3;
  const int p0 = (blockIdx.z * PIECES + (lane & 7)) * V;   // first element
  const bool pin = p0 < D;
  T* out = buf + (size_t)g * q.S * C * D;

  // kept rows: the warp's 32 assignments, 8 rounds of 4 rows, all loads
  // issued before the first store
  const long long my_dst = kp ? ((long long)key * C + rk) * D : -1;
  const long long my_src = ((long long)g * Tn + i / K) * D;
  const float my_w = kp ? w[a] : 0.f;
  if (__ballot_sync(FULL, kp)) {
    long long dst[8];
    float wk[8];
    uint4 val[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = 4 * u + sub;
      dst[u] = __shfl_sync(FULL, my_dst, j);
      const long long src = __shfl_sync(FULL, my_src, j);
      wk[u] = __shfl_sync(FULL, my_w, j);
      val[u] = make_uint4(0u, 0u, 0u, 0u);
      if (dst[u] >= 0 && pin) {
        if (vec) {
          val[u] = *reinterpret_cast<const uint4*>(v + src + p0);
        } else {
          T* e = reinterpret_cast<T*>(&val[u]);
          for (int x = 0; x < V && p0 + x < D; ++x) e[x] = v[src + p0 + x];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (dst[u] < 0 || !pin) continue;
      T* e = reinterpret_cast<T*>(&val[u]);
#pragma unroll
      for (int x = 0; x < V; ++x)
        e[x] = from_f32<T>(__fmul_rn(wk[u], to_f32(e[x])));
      if (vec) {
        *reinterpret_cast<uint4*>(out + dst[u] + p0) = val[u];
      } else {
        for (int x = 0; x < V && p0 + x < D; ++x) out[dst[u] + p0 + x] = e[x];
      }
    }
  }

  // empty rows: this tile's share of the S·C rows, zeroed where the row
  // index is at or past its slot's kept count
  const int rows = q.S * C;
  const int per = (rows + q.tiles - 1) / q.tiles;
  const int r1 = min(rows, (tile + 1) * per);
  for (int r = tile * per + warp * 4 + sub; r < r1; r += NW * 4) {
    const int s = r / C;
    if (r - s * C < min(tot[s], C) || !pin) continue;
    T* d = out + (size_t)r * D + p0;
    if (vec) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (int x = 0; x < V && p0 + x < D; ++x) d[x] = from_f32<T>(0.f);
    }
  }
}

// One warp per token row, CW rows a block.  Lanes 0..k-1 load the row's
// routing in one round and shuffles hand each term to every lane; each lane
// then owns 16-byte pieces of the row (8 bf16 or 4 f32 of D), issues the
// loads of all its terms (KB at a time) before the first add, adds them in
// j order and stores 16 bytes.  The buffer is read through its strides
// (sg, ss, sc elements between groups, slots and rows; unit stride along
// D), so a permuted view needs no copy.  Rows that do not start on 16-byte
// boundaries take the same loop element by element.
constexpr int CW = 4;     // token rows (warps) per block
constexpr int KB = 8;     // terms in flight per lane

template <typename T>
__global__ void __launch_bounds__(32 * CW)
combine_kernel(const T* __restrict__ buf, const float* __restrict__ w,
               const int32_t* __restrict__ slot,
               const int32_t* __restrict__ rank,
               const int32_t* __restrict__ keep, T* __restrict__ y, int rows,
               int Tn, int K, int D, long long sg, long long ss, long long sc,
               int vec) {
  constexpr int V = (int)(sizeof(uint4) / sizeof(T));
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * CW + (threadIdx.x >> 5);   // g * Tn + t
  if (row >= rows) return;
  const T* b = buf + (row / Tn) * sg;
  const size_t a0 = (size_t)row * K;
  T* yr = y + (size_t)row * D;

  // term j of the row: the element offset of its buffer row (-1 if not
  // kept) and its weight; j < 32 from lane j by shuffle, later j from
  // memory (K > 32 never occurs in the models)
  long long src_l = -1;
  float w_l = 0.f;
  if (lane < K) {
    const size_t a = a0 + lane;
    const int kp = keep[a], sl = slot[a], rk = rank[a];
    const float wa = w[a];
    if (kp) {
      src_l = sl * ss + rk * sc;
      w_l = wa;
    }
  }
  auto term = [&](int j, long long* src, float* wj) {
    if (j < 32) {
      *src = __shfl_sync(0xffffffffu, src_l, j);
      *wj = __shfl_sync(0xffffffffu, w_l, j);
    } else {
      const size_t a = a0 + j;
      *src = keep[a] ? slot[a] * ss + rank[a] * sc : -1;
      *wj = w[a];
    }
  };

  if (vec) {
    const int nv = D / V;
    for (int i0 = 0; i0 < nv; i0 += 32) {     // warp-uniform trip count
      const int i = i0 + lane;
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      for (int j0 = 0; j0 < K; j0 += KB) {
        uint4 r[KB];
        float wk[KB];
        bool on[KB];
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          long long src = -1;
          wk[u] = 0.f;
          if (j0 + u < K) term(j0 + u, &src, &wk[u]);
          on[u] = src >= 0;
          r[u] = on[u] && i < nv
                     ? *reinterpret_cast<const uint4*>(b + src + (size_t)i * V)
                     : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          if (!on[u]) continue;
          const T* e = reinterpret_cast<const T*>(&r[u]);
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[v] = __fadd_rn(acc[v], __fmul_rn(wk[u], to_f32(e[v])));
        }
      }
      if (i < nv) {
        uint4 o;
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int v = 0; v < V; ++v) oe[v] = from_f32<T>(acc[v]);
        *reinterpret_cast<uint4*>(yr + (size_t)i * V) = o;
      }
    }
  } else {
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int d = d0 + lane;
      float acc = 0.f;
      for (int j0 = 0; j0 < K; j0 += KB) {
        float r[KB], wk[KB];
        bool on[KB];
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          long long src = -1;
          wk[u] = 0.f;
          if (j0 + u < K) term(j0 + u, &src, &wk[u]);
          on[u] = src >= 0;
          r[u] = on[u] && d < D ? to_f32(b[src + d]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < KB; ++u)
          if (on[u]) acc = __fadd_rn(acc, __fmul_rn(wk[u], r[u]));
      }
      if (d < D) yr[d] = from_f32<T>(acc);
    }
  }
}

}  // namespace

// Assignments a tile: the wrapper sizes the pass-A scratch with it.
extern "C" int moe_dispatch_tile(void) { return TILE; }

// dtype: 0 = float32, 1 = bfloat16 (v and buf share it).
// v [G,T,D], w [G,T,K] f32, slot/valid [G,T,K] i32 -> buf [G,S,C,D],
// rank/keep [G,T,K] i32, routed/kept [G,S] i32; hist is [G, tiles, S+1]
// i32 scratch, tiles = ceil(T·K / TILE) (at least 1; unused for one tile).
// Returns the first refused launch's cudaError_t, or 0.
extern "C" int moe_dispatch_launch(const void* v, const void* w,
                                   const void* slot, const void* valid,
                                   void* buf, void* rank, void* keep,
                                   void* routed, void* kept, void* hist,
                                   int G, int T, int K, int D, int S, int C,
                                   int dtype, void* stream) {
  if (G == 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Dispatch q;
  q.slot = (const int32_t*)slot;
  q.valid = (const int32_t*)valid;
  q.hist = (int32_t*)hist;
  q.N = T * K;
  q.S = S;
  q.tiles = q.N > 0 ? (q.N + TILE - 1) / TILE : 1;
  const size_t es = dtype == 0 ? 4 : 2;
  const int vlen = (int)(16 / es);
  const int slices = (((D + vlen - 1) / vlen) + PIECES - 1) / PIECES;
  const size_t smem_a = sizeof(int) * (size_t)NW * (S + 1);
  const size_t smem_b = smem_a + sizeof(int) * (size_t)(S + 1);
  if (smem_b > 48 * 1024 || q.tiles > 65535 || slices > 65535 || D < 1)
    return (int)cudaErrorInvalidValue;
  // 16-byte pieces when every row starts on a 16-byte boundary
  const int vec = (D * es) % 16 == 0 && ((uintptr_t)v & 15u) == 0 &&
                  ((uintptr_t)buf & 15u) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (q.tiles > 1) {
    dispatch_hist_kernel<<<dim3(G, q.tiles), TILE, smem_a, st>>>(q);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(G, q.tiles, slices);
  int32_t *rk = (int32_t*)rank, *kp = (int32_t*)keep;
  int32_t *ro = (int32_t*)routed, *ke = (int32_t*)kept;
  if (dtype == 0)
    dispatch_scatter_kernel<float><<<grid, TILE, smem_b, st>>>(
        q, (const float*)v, (const float*)w, (float*)buf, rk, kp, ro, ke, T,
        K, D, C, vec);
  else
    dispatch_scatter_kernel<__nv_bfloat16><<<grid, TILE, smem_b, st>>>(
        q, (const __nv_bfloat16*)v, (const float*)w, (__nv_bfloat16*)buf, rk,
        kp, ro, ke, T, K, D, C, vec);
  return (int)cudaGetLastError();
}

// buf [G,S,C,D] (element strides sg, ss, sc, unit stride along D), w
// [G,T,K] f32, slot/rank/keep [G,T,K] i32 -> y [G,T,D] contiguous.
extern "C" int moe_combine_launch(const void* buf, const void* w,
                                  const void* slot, const void* rank,
                                  const void* keep, void* y, int G, int T,
                                  int K, int D, long long sg, long long ss,
                                  long long sc, int dtype, void* stream) {
  const int rows = G * T;
  if (rows == 0) return 0;
  const int blocks = (rows + CW - 1) / CW;
  const int v = dtype == 0 ? 4 : 8;          // elements in 16 bytes
  // 16-byte pieces when every buffer and output row starts on a 16-byte
  // boundary
  const int vec = D % v == 0 && sg % v == 0 && ss % v == 0 && sc % v == 0 &&
                  ((uintptr_t)buf & 15u) == 0 && ((uintptr_t)y & 15u) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* wf = (const float*)w;
  const int32_t* sl = (const int32_t*)slot;
  const int32_t* rk = (const int32_t*)rank;
  const int32_t* kp = (const int32_t*)keep;
  if (dtype == 0)
    combine_kernel<float><<<blocks, 32 * CW, 0, st>>>(
        (const float*)buf, wf, sl, rk, kp, (float*)y, rows, T, K, D, sg, ss,
        sc, vec);
  else if (dtype == 1)
    combine_kernel<__nv_bfloat16><<<blocks, 32 * CW, 0, st>>>(
        (const __nv_bfloat16*)buf, wf, sl, rk, kp, (__nv_bfloat16*)y, rows,
        T, K, D, sg, ss, sc, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
