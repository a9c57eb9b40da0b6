// Fused MoE gating for Hopper: row softmax over E experts, top-k as k
// rounds of (max, lowest-index argmax, mask), renormalized weights, int32
// expert ids, and the per-group load histogram phi.
//
// Replaces the TPU kernel `_kernel` / `gating_pallas`
// (src/repro/kernels/moe_gating/moe_gating.py:18 / :48).  The TPU kernel
// carries phi in a VMEM output across a sequential grid; blocks here run in
// any order, in one launch, and every count of phi has exactly one writer:
//
// * each block builds the histogram of its own rows in shared memory, one
//   row of E bins per group it touches;
// * a group that lies wholly inside the block is stored straight to
//   `counts` (every serving shape: T = 1, one block covers many groups);
// * a group spread over several blocks (training: G = 1, T = 4096) stores
//   one partial histogram per block into `partials`, then takes a ticket
//   from the counter of its first block; the block that draws the last
//   ticket sums the partials, stores `counts` and puts the counter back to
//   0, so the next launch (or graph replay) finds every counter at 0.
//
// `counts` needs no zeroing and no atomic decides a value in device memory.
// `tickets` and `partials` are scratch that the wrapper allocates once per
// device (tickets zeroed once); they assume one stream at a time: two
// launches that overlap on two streams would share the counters.
//
// Bound: bytes (E f32 logits in, 2k words out per token; ~E·k compares),
// but at every shape the models use the time is one launch plus the
// latency of a row's dependent steps.  So a row is spread over lanes: 16
// lanes a row for E <= 16 (the models' E = 16: two rows a warp, one logit
// a lane), a warp a row up to E = 128 (E/32 logits a lane); each row is one
// exp and one division a lane and 2 + 2k shuffle trees of log2(lanes)
// steps.  A block holds the lanes of up to 32 rows (512 threads at
// E <= 16, 1024 above) and takes as many passes as keep the grid at one
// block an SM, so that a group spread over blocks takes at most 132
// tickets and its last block sums at most 132 partials.
//
// Arithmetic matches the plain torch version (kernels/moe_gating/ref.py)
// operation for operation: no FMA contraction (__fsub_rn/__fdiv_rn), ties
// to the lowest expert index, chosen entries masked with -1.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 8;
constexpr int kMaxE = 128;
constexpr int kMaxThreads = 1024;
constexpr int kRowsPass = 32;     // rows a block takes a pass, at most
constexpr int kMaxBlocks = 132;   // one block an SM: blocks take more passes
                                  // before the grid grows past this
constexpr int kMaxSmem = 48 * 1024;

// Lanes that hold one row: 16 for E <= 16 (two rows a warp), else 32.
__host__ __device__ inline int lanes_per_row(int E) {
  return E <= 16 ? 16 : 32;
}

// The launch's shape: threads a block (every row's lanes, in whole warps,
// for up to kRowsPass rows) and rows a block (threads / lanes a pass, in as
// few passes as keep the grid at kMaxBlocks blocks).
struct Shape {
  int threads, R, blocks;
};

inline Shape launch_shape(int rows, int E) {
  const int lanes = lanes_per_row(E);
  int threads = (rows * lanes + 31) / 32 * 32;
  threads = threads < kRowsPass * lanes ? threads : kRowsPass * lanes;
  const int per_pass = threads / lanes;
  const int passes = (rows + per_pass * kMaxBlocks - 1) /
                     (per_pass * kMaxBlocks);
  Shape sh;
  sh.threads = threads;
  sh.R = per_pass * (passes > 1 ? passes : 1);
  sh.blocks = (rows + sh.R - 1) / sh.R;
  return sh;
}

// The groups that a block's rows [row0, row0 + R) touch: g_first and ng.
struct Span {
  int row0, R, g_first, ng;
};

__device__ inline Span block_span(int rows, int T, int R) {
  Span s;
  s.row0 = blockIdx.x * R;
  s.R = R;
  const int row_end = min(rows, s.row0 + R);
  s.g_first = s.row0 / T;
  s.ng = (row_end - 1) / T - s.g_first + 1;
  return s;
}

__device__ inline bool whole_in_block(const Span& s, int g, int T) {
  return g * T >= s.row0 && g * T + T <= s.row0 + s.R;
}

// Store the block's histogram `hist` [ng][E] (shared, complete): whole
// groups to `counts`, partial ones through the partials and tickets.
__device__ void store_counts(const int* hist, int32_t* __restrict__ counts,
                             int* tickets, int* partials, const Span& s,
                             int T, int E) {
  __shared__ int last[2];
  __shared__ int red[kMaxThreads];
  const int tid = threadIdx.x;
  for (int i = tid; i < s.ng * E; i += blockDim.x) {
    const int gl = i / E, e = i - gl * E, g = s.g_first + gl;
    if (whole_in_block(s, g, T))
      counts[(size_t)g * E + e] = hist[i];
    else  // only the first and the last group can cross the block's edge
      partials[((size_t)blockIdx.x * 2 + (gl == 0 ? 0 : 1)) * E + e] =
          hist[i];
  }
  const int g_ends[2] = {s.g_first, s.g_first + s.ng - 1};
  const bool part[2] = {!whole_in_block(s, g_ends[0], T),
                        s.ng > 1 && !whole_in_block(s, g_ends[1], T)};
  if (!part[0] && !part[1]) return;                   // uniform per block
  // the block's partials before its tickets, and the tickets before the
  // last block's loads: a fence in one thread after the block's barrier,
  // as cooperative groups' grid barrier orders a block's writes
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    for (int j = 0; j < 2; ++j) {
      if (!part[j]) continue;
      const int g = g_ends[j];
      const int b_lo = g * T / s.R, b_hi = (g * T + T - 1) / s.R;
      last[j] = atomicAdd(&tickets[b_lo], 1) == b_hi - b_lo;
    }
    __threadfence();
  }
  __syncthreads();
  // the last block sums the group's partials: thread (slice, e) adds
  // every slices-th block's from L2, then a tree over the slices
  const int slices = blockDim.x / E, sl = tid / E;
  int top = 1;
  while (2 * top < slices) top *= 2;
  for (int j = 0; j < 2; ++j) {
    if (!part[j] || !last[j]) continue;              // uniform per block
    const int g = g_ends[j];
    const int b_lo = g * T / s.R, b_hi = (g * T + T - 1) / s.R;
    if (sl < slices) {
      const int e = tid - sl * E;
      int sum = 0;
#pragma unroll 4
      for (int b = b_lo + sl; b <= b_hi; b += slices) {
        // group g is block b's first group (side 0) or its last (side 1)
        const int side = g == b * s.R / T ? 0 : 1;
        sum += __ldcg(&partials[((size_t)b * 2 + side) * E + e]);
      }
      red[tid] = sum;
    }
    __syncthreads();
    for (int st = top; st > 0; st >>= 1) {
      if (sl < st && sl + st < slices) red[tid] += red[tid + st * E];
      __syncthreads();
    }
    if (tid < E) counts[(size_t)g * E + tid] = red[tid];
    if (tid == 0) tickets[b_lo] = 0;    // ready for the next launch
    __syncthreads();
  }
}

// LANES lanes a row (a warp holds 32 / LANES rows), PER_LANE experts a
// lane: E <= LANES * PER_LANE.  All 32 lanes of a warp run every shuffle;
// a lane past the last row computes on -inf and stores nothing.
template <int LANES, int PER_LANE>
__global__ void __launch_bounds__(kMaxThreads)
gating_kernel(const float* __restrict__ logits, float* __restrict__ w_out,
              int32_t* __restrict__ e_out, int32_t* __restrict__ counts,
              int* tickets, int* partials, int rows, int T, int E, int K,
              int R) {
  extern __shared__ int hist[];
  const Span s = block_span(rows, T, R);
  const int tid = threadIdx.x, lane = tid % LANES;
  for (int i = tid; i < s.ng * E; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const int per_pass = blockDim.x / LANES;
  for (int rr = tid / LANES; rr < R; rr += per_pass) {
    const int row = s.row0 + rr;
    const bool valid = row < rows;
    const float* x = logits + (size_t)row * E;
    float v[PER_LANE];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int e = lane + LANES * i;
      v[i] = valid && e < E ? x[e] : -INFINITY;
      m = fmaxf(m, v[i]);
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int e = lane + LANES * i;
      v[i] = e < E ? expf(__fsub_rn(v[i], m)) : 0.f;
      sum = __fadd_rn(sum, v[i]);
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int e = lane + LANES * i;
      // padding can never win: masked experts hold -1, padding -inf
      v[i] = e < E ? __fdiv_rn(v[i], sum) : -INFINITY;
    }

    // k rounds; lane r keeps round r's weight and expert
    float tot = 0.f, my_w = 0.f;
    int my_e = 0;
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      if (r < K) {
        float bv = -INFINITY;
        int bi = 0x7fffffff;
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i)
          if (v[i] > bv) { bv = v[i]; bi = lane + LANES * i; }
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
        }
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i)
          if (lane + LANES * i == bi) v[i] = -1.f;
        tot = __fadd_rn(tot, bv);
        if (lane == r) { my_w = bv; my_e = bi; }
      }
    }
    if (valid && lane < K) {
      tot = fmaxf(tot, 1e-9f);
      w_out[(size_t)row * K + lane] = __fdiv_rn(my_w, tot);
      e_out[(size_t)row * K + lane] = my_e;
      atomicAdd(&hist[(row / T - s.g_first) * E + my_e], 1);
    }
  }
  __syncthreads();
  store_counts(hist, counts, tickets, partials, s, T, E);
}

}  // namespace

// The most blocks of one launch: the wrapper sizes the scratch from it
// (that many tickets, and 2 · that · 128 partials).
extern "C" int moe_gating_max_blocks() { return kMaxBlocks; }

// logits [G,T,E] f32, w [G,T,K] f32, e [G,T,K] i32, counts [G,E] i32 (any
// contents: every count is written); tickets [max blocks] i32, all 0, and
// partials [2 · max blocks · 128] i32, scratch.  Returns the launch's
// cudaError_t.
extern "C" int moe_gating_launch(const void* logits, void* w, void* e,
                                 void* counts, void* tickets, void* partials,
                                 int G, int T, int E, int K, void* stream) {
  if (K < 1 || K > kMaxK || K > E || E > kMaxE || T < 1 || G < 1)
    return (int)cudaErrorInvalidValue;
  const int rows = G * T;
  const Shape sh = launch_shape(rows, E);
  const int R = sh.R;
  const int ng_max = (R - 1) / T + 2 < R ? (R - 1) / T + 2 : R;  // groups
                                                  // a block can touch
  const size_t smem = (size_t)ng_max * E * sizeof(int);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;  // huge G, tiny T
  const dim3 grid(sh.blocks), block(sh.threads);
  cudaStream_t st = (cudaStream_t)stream;
  const float* x = (const float*)logits;
  float* wo = (float*)w;
  int32_t* eo = (int32_t*)e;
  int32_t* co = (int32_t*)counts;
  int* tk = (int*)tickets;
  int* pt = (int*)partials;
  if (E <= 16)
    gating_kernel<16, 1><<<grid, block, smem, st>>>(x, wo, eo, co, tk, pt,
                                                    rows, T, E, K, R);
  else if (E <= 32)
    gating_kernel<32, 1><<<grid, block, smem, st>>>(x, wo, eo, co, tk, pt,
                                                    rows, T, E, K, R);
  else if (E <= 64)
    gating_kernel<32, 2><<<grid, block, smem, st>>>(x, wo, eo, co, tk, pt,
                                                    rows, T, E, K, R);
  else
    gating_kernel<32, 4><<<grid, block, smem, st>>>(x, wo, eo, co, tk, pt,
                                                    rows, T, E, K, R);
  return (int)cudaGetLastError();
}
