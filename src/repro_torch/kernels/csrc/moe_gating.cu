// Fused MoE gating for Hopper: row softmax over E experts, top-k as k
// rounds of (max, lowest-index argmax, mask), renormalized weights, int32
// expert ids, and the per-group load histogram phi.
//
// Replaces the TPU kernel `_kernel` / `gating_pallas`
// (src/repro/kernels/moe_gating/moe_gating.py:18 / :48).  The TPU kernel
// carries phi in a VMEM output across a sequential grid; blocks here run in
// any order, so phi is built with integer atomics into a zeroed [G,E] output
// (exact, order-free).
//
// Bound: bytes.  Each token reads E f32 logits and writes 2k words; the
// arithmetic is ~E·k compares.  One warp per token keeps the row in
// registers (ceil(E/32) values per lane) and every reduction in warp
// shuffles, so the kernel reads each logit once and touches no shared
// memory.  At serving shapes (tens of tokens) it is launch-bound.
//
// Arithmetic matches the plain torch version (kernels/moe_gating/ref.py)
// operation for operation: no FMA contraction (__fsub_rn/__fdiv_rn), ties
// to the lowest expert index, chosen entries masked with -1.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 8;

template <int PER_LANE>
__global__ void gating_kernel(const float* __restrict__ logits,
                              float* __restrict__ w_out,
                              int32_t* __restrict__ e_out,
                              int32_t* __restrict__ counts,
                              int rows, int T, int E, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;                    // whole warp exits together
  const float* x = logits + (size_t)row * E;

  float v[PER_LANE];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int e = lane + 32 * i;
    v[i] = e < E ? x[e] : -INFINITY;
    m = fmaxf(m, v[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int e = lane + 32 * i;
    v[i] = e < E ? expf(__fsub_rn(v[i], m)) : 0.f;
    s = __fadd_rn(s, v[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int e = lane + 32 * i;
    // padding lanes can never win: masked experts hold -1, padding -inf
    v[i] = e < E ? __fdiv_rn(v[i], s) : -INFINITY;
  }

  float ws[kMaxK];
  int es[kMaxK];
  for (int r = 0; r < K; ++r) {
    // lane-local best; ascending i keeps the lowest index on ties
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      if (v[i] > bv) { bv = v[i]; bi = lane + 32 * i; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      if (lane + 32 * i == bi) v[i] = -1.f;
    ws[r] = bv;
    es[r] = bi;
  }

  if (lane == 0) {
    float tot = 0.f;
    for (int r = 0; r < K; ++r) tot = __fadd_rn(tot, ws[r]);
    tot = fmaxf(tot, 1e-9f);
    int32_t* cnt = counts + (size_t)(row / T) * E;
    for (int r = 0; r < K; ++r) {
      w_out[(size_t)row * K + r] = __fdiv_rn(ws[r], tot);
      e_out[(size_t)row * K + r] = es[r];
      atomicAdd(cnt + es[r], 1);
    }
  }
}

}  // namespace

// logits [G,T,E] f32, w [G,T,K] f32, e [G,T,K] i32, counts [G,E] i32 (the
// caller zeroes counts).  Returns the launch's cudaError_t.
extern "C" int moe_gating_launch(const void* logits, void* w, void* e,
                                 void* counts, int G, int T, int E, int K,
                                 void* stream) {
  if (K < 1 || K > kMaxK || K > E || E > 128) return (int)cudaErrorInvalidValue;
  const int rows = G * T;
  if (rows == 0) return 0;
  const int warps = 4;
  const dim3 grid((rows + warps - 1) / warps), block(32 * warps);
  cudaStream_t st = (cudaStream_t)stream;
  const float* x = (const float*)logits;
  float* wo = (float*)w;
  int32_t* eo = (int32_t*)e;
  int32_t* co = (int32_t*)counts;
  if (E <= 32)
    gating_kernel<1><<<grid, block, 0, st>>>(x, wo, eo, co, rows, T, E, K);
  else if (E <= 64)
    gating_kernel<2><<<grid, block, 0, st>>>(x, wo, eo, co, rows, T, E, K);
  else
    gating_kernel<4><<<grid, block, 0, st>>>(x, wo, eo, co, rows, T, E, K);
  return (int)cudaGetLastError();
}
