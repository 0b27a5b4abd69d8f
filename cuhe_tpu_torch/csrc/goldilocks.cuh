// Goldilocks arithmetic, P = 2^64 - 2^32 + 1, on native 64-bit words.
//
// Replaces the uint32-pair VPU arithmetic of cuhe_tpu/ops/modp.py (the TPU
// has no 64-bit integer unit; the card has one, emulated from 32-bit
// multiply-adds).  The folds are those of the original CUDA library
// (ModP.h _add_modP/_sub_modP/_mul_modP): 2^64 = 2^32 - 1 and 2^96 = -1
// (mod P).  Every function takes canonical inputs (< P; gl_mul any 64-bit
// inputs) and returns a canonical value.
#pragma once

#include <cstdint>

#define GL_P 0xFFFFFFFF00000001ull
#define GL_EPS 0xFFFFFFFFull  // 2^64 mod P

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += GL_EPS;  // carry: 2^64 = 2^32 - 1; cannot carry again
  if (s >= GL_P) s -= GL_P;
  return s;
}

__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) d -= GL_EPS;  // borrow: adding P is subtracting 2^32 - 1
  return d;
}

// (lo + hi * 2^64) mod P
__device__ __forceinline__ uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
  const uint64_t hl = hi & 0xFFFFFFFFull, hh = hi >> 32;
  uint64_t t = lo - hh;               // lo - hh * 2^96
  if (lo < hh) t -= GL_EPS;
  const uint64_t u = hl * GL_EPS;     // hl * 2^64 = hl * (2^32 - 1)
  uint64_t r = t + u;
  if (r < t) r += GL_EPS;
  if (r >= GL_P) r -= GL_P;
  return r;
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce128(a * b, __umul64hi(a, b));
}

// Read-only-cache load of a 64-bit table entry.
__device__ __forceinline__ uint64_t ldg64(const uint64_t* p) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ uint64_t gl_load(const uint32_t* lo,
                                            const uint32_t* hi, size_t i) {
  return (uint64_t)lo[i] | ((uint64_t)hi[i] << 32);
}

__device__ __forceinline__ void gl_store(uint32_t* lo, uint32_t* hi, size_t i,
                                         uint64_t v) {
  lo[i] = (uint32_t)v;
  hi[i] = (uint32_t)(v >> 32);
}
