// CPU emulation of the CUDA subset the port's kernels use, for running a
// csrc/*.cu kernel on the CPU at a small size before its first call on the
// card (prep.py rewrites the source to include this header).  Each CUDA
// thread is one std::thread and a grid's blocks run one after another;
// __syncthreads is a block-wide std::barrier; the warp-synchronous
// operations (shuffles, ldmatrix .x4 and .x4.trans, mma.sync.m16n8k16
// bf16 with f32 accumulators) exchange their operands through a per-warp
// buffer between two warp-wide barriers, and __syncwarp is one such
// barrier; cp.async is a plain copy.  A thread that returns drops out of
// its barriers, as an exited CUDA thread does.  Shared memory is one
// buffer a block, 256-aligned, its "shared addresses" offsets into it.
// Timing means nothing here.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>
#include <cstdio>
#include <cstdlib>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline __nv_bfloat16 __float2bfloat16(float f) { return __float2bfloat16_rn(f); }
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.x << 16; float f; memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {__bfloat162float(v.x), __bfloat162float(v.y)};
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename F> inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int v) {
  return v <= 232448 ? 0 : 1;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }

// ---- per-thread state
struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> wbar;
  std::vector<uint8_t> smem;
  uint8_t* sbase;
  // warp exchange: [warp][lane][8 words]
  std::vector<uint64_t> xch;
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline thread_local EmuBlock* emu_blk;
#define emu_smem (emu_blk->sbase)

inline size_t __cvta_generic_to_shared(const void* p) {
  return (size_t)((const uint8_t*)p - emu_blk->sbase);
}
inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }
inline int emu_lane() { return (int)(threadIdx.x & 31); }
inline int emu_warp() { return (int)(threadIdx.x >> 5); }
inline uint64_t* emu_x(int lane) { return &emu_blk->xch[((size_t)emu_warp() * 32 + lane) * 8]; }
inline void emu_wsync() { emu_blk->wbar[emu_warp()]->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_wsync(); }

inline float __shfl_xor_sync(unsigned, float v, int m) {
  float* me = (float*)emu_x(emu_lane()); me[0] = v; emu_wsync();
  float r = ((float*)emu_x(emu_lane() ^ m))[0]; emu_wsync(); return r;
}
inline float __shfl_up_sync(unsigned, float v, int d) {
  float* me = (float*)emu_x(emu_lane()); me[0] = v; emu_wsync();
  int src = emu_lane() - d; float r = src >= 0 ? ((float*)emu_x(src))[0] : v;
  emu_wsync(); return r;
}
inline float __shfl_sync(unsigned, float v, int s) {
  float* me = (float*)emu_x(emu_lane()); me[0] = v; emu_wsync();
  float r = ((float*)emu_x(s & 31))[0]; emu_wsync(); return r;
}

inline void cp_async16(uint32_t dst, const void* src, bool ok) {
  if (ok) memcpy(emu_blk->sbase + dst, src, 16); else memset(emu_blk->sbase + dst, 0, 16);
}
inline void cp_commit() {}
inline void cp_wait_all() {}
inline void cp_wait1() {}

inline uint16_t emu_h(uint32_t addr, int col) {
  uint16_t v; memcpy(&v, emu_blk->sbase + addr + 2 * col, 2); return v;
}
inline void emu_ldsm(uint32_t (&r)[4], uint32_t addr, bool trans) {
  uint64_t* me = emu_x(emu_lane()); me[0] = addr; emu_wsync();
  const int l = emu_lane();
  for (int i = 0; i < 4; ++i) {
    uint16_t e0, e1;
    if (!trans) {
      uint32_t ra = (uint32_t)emu_x(8 * i + l / 4)[0];
      e0 = emu_h(ra, 2 * (l % 4)); e1 = emu_h(ra, 2 * (l % 4) + 1);
    } else {
      uint32_t r0 = (uint32_t)emu_x(8 * i + 2 * (l % 4))[0];
      uint32_t r1 = (uint32_t)emu_x(8 * i + 2 * (l % 4) + 1)[0];
      e0 = emu_h(r0, l / 4); e1 = emu_h(r1, l / 4);
    }
    r[i] = (uint32_t)e0 | ((uint32_t)e1 << 16);
  }
  emu_wsync();
}
inline void ldsm4(uint32_t (&r)[4], uint32_t addr) { emu_ldsm(r, addr, false); }
inline void ldsm4t(uint32_t (&r)[4], uint32_t addr) { emu_ldsm(r, addr, true); }
inline float emu_bf(uint32_t w, int hi) {
  __nv_bfloat16 b{(uint16_t)(hi ? w >> 16 : w & 0xffff)}; return __bfloat162float(b);
}
inline void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  uint64_t* me = emu_x(emu_lane());
  for (int i = 0; i < 4; ++i) me[i] = a[i];
  me[4] = b0; me[5] = b1; emu_wsync();
  const int l = emu_lane(), g = l / 4, t = l % 4;
  auto A = [&](int row, int k) {     // A[row][k]
    int gg = row % 8, hi = row / 8, kk = k % 8, kh = k / 8;
    int lane = gg * 4 + kk / 2;
    uint32_t w = (uint32_t)emu_x(lane)[hi + 2 * kh];
    return emu_bf(w, kk & 1);
  };
  auto B = [&](int k, int n) {       // B[k][n]
    int kh = k / 8, kk = k % 8;
    int lane = n * 4 + kk / 2;
    uint32_t w = (uint32_t)emu_x(lane)[4 + kh];
    return emu_bf(w, kk & 1);
  };
  float out[4];
  for (int e = 0; e < 4; ++e) {
    int row = g + 8 * (e / 2), col = 2 * t + (e & 1);
    float s = c[e];
    for (int k = 0; k < 16; ++k) s += A(row, k) * B(k, col);
    out[e] = s;
  }
  emu_wsync();
  for (int e = 0; e < 4; ++e) c[e] = out[e];
}

template <typename F>
inline void emu_launch(dim3 g, dim3 b, size_t smem, cudaStream_t, F f) {
  gridDim = g; blockDim = b;
  const unsigned nt = b.x * b.y * b.z;
  for (unsigned bz = 0; bz < g.z; ++bz)
  for (unsigned by = 0; by < g.y; ++by)
  for (unsigned bx = 0; bx < g.x; ++bx) {
    EmuBlock blk;
    blk.bar = std::make_unique<std::barrier<>>(nt);
    const unsigned nw = (nt + 31) / 32;
    for (unsigned w = 0; w < nw; ++w)
      blk.wbar.push_back(std::make_unique<std::barrier<>>(std::min(32u, nt - 32 * w)));
    blk.smem.assign(smem + 512, 0xCD);
    blk.sbase = (uint8_t*)(((uintptr_t)blk.smem.data() + 255) & ~(uintptr_t)255);
    blk.xch.assign((size_t)nw * 32 * 8, 0);
    std::vector<std::thread> ths;
    for (unsigned i = 0; i < nt; ++i)
      ths.emplace_back([&, i] {
        threadIdx = dim3(i); blockIdx = dim3(bx, by, bz); emu_blk = &blk;
        f();
        blk.wbar[i / 32]->arrive_and_drop();
        blk.bar->arrive_and_drop();
      });
    for (auto& t : ths) t.join();
  }
}
