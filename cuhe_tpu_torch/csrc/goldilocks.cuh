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

// Adds, subtracts and the 128-bit fold run as carry chains on 32-bit halves
// (inline PTX): the carry and borrow flags replace the 64-bit compares and
// selects a compiler emits for the same C (on an H100 the passes of ntt.cu
// ran faster so; PERF.md, section 6).

// a + b - P is a + (b + 2^32 - 1) - 2^64, and b + 2^32 - 1 does not carry
// for b < P: the sum carries exactly when a + b >= P, and then it is the
// result; otherwise the result is the sum minus 2^32 - 1.
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint32_t r0, r1;
  asm("{\n\t.reg .u32 t0, t1, m, z;\n\t"
      "mov.u32 z, 0;\n\t"
      "add.cc.u32 t0, %4, 0xFFFFFFFF;\n\t"
      "addc.u32 t1, %5, 0;\n\t"
      "add.cc.u32 %0, %2, t0;\n\t"
      "addc.cc.u32 %1, %3, t1;\n\t"
      "addc.u32 m, z, 0xFFFFFFFF;\n\t"  // carry - 1: 0 or 2^32 - 1
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.u32 %1, %1, 0;\n\t}"
      : "=&r"(r0), "=&r"(r1)
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b),
        "r"((uint32_t)(b >> 32)));
  return ((uint64_t)r1 << 32) | r0;
}

// a - b, and on a borrow minus 2^32 - 1 (adding P).
__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint32_t d0, d1;
  asm("{\n\t.reg .u32 bw, z;\n\t"
      "mov.u32 z, 0;\n\t"
      "sub.cc.u32 %0, %2, %4;\n\t"
      "subc.cc.u32 %1, %3, %5;\n\t"
      "subc.u32 bw, z, 0;\n\t"  // -borrow: 0 or 2^32 - 1
      "sub.cc.u32 %0, %0, bw;\n\t"
      "subc.u32 %1, %1, 0;\n\t}"
      : "=&r"(d0), "=&r"(d1)
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b),
        "r"((uint32_t)(b >> 32)));
  return ((uint64_t)d1 << 32) | d0;
}

// (lo + hi * 2^64) mod P
__device__ __forceinline__ uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
  // t = lo - hh (hh * 2^96 = -hh), on a borrow t - (2^32 - 1); u = hl (2^32
  // - 1) = hl 2^64; r = t + u, on a carry r + 2^32 - 1; then r - P where the
  // trial r + 2^32 - 1 carries (r >= P)
  uint32_t r0, r1, x0, x1, k;
  asm("{\n\t.reg .u32 u0, u1, z;\n\t"
      "mov.u32 z, 0;\n\t"
      "sub.cc.u32 %0, %5, %8;\n\t"
      "subc.cc.u32 %1, %6, 0;\n\t"
      "subc.u32 %4, z, 0;\n\t"
      "sub.cc.u32 %0, %0, %4;\n\t"
      "subc.u32 %1, %1, 0;\n\t"
      "sub.cc.u32 u0, z, %7;\n\t"
      "subc.u32 u1, %7, 0;\n\t"
      "add.cc.u32 %0, %0, u0;\n\t"
      "addc.cc.u32 %1, %1, u1;\n\t"
      "addc.u32 %4, z, 0;\n\t"
      "sub.u32 %4, z, %4;\n\t"
      "add.cc.u32 %0, %0, %4;\n\t"
      "addc.u32 %1, %1, 0;\n\t"
      "add.cc.u32 %2, %0, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 %3, %1, 0;\n\t"
      "addc.u32 %4, z, 0;\n\t}"
      : "=&r"(r0), "=&r"(r1), "=&r"(x0), "=&r"(x1), "=&r"(k)
      : "r"((uint32_t)lo), "r"((uint32_t)(lo >> 32)), "r"((uint32_t)hi),
        "r"((uint32_t)(hi >> 32)));
  return k ? ((uint64_t)x1 << 32) | x0 : ((uint64_t)r1 << 32) | r0;
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce128(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t gl_neg(uint64_t a) {
  return a ? GL_P - a : 0;
}

// a * 2^s for 0 <= s < 64: the 128-bit shift, folded.
__device__ __forceinline__ uint64_t gl_shl(uint64_t a, int s) {
  return gl_reduce128(a << s, (a >> 1) >> (63 - s));
}

// a * 2^(64 + r) for canonical a and 0 <= r < 32: with a 2^r = [w0, w1, w2]
// in 32-bit words (w2 < 2^r), 2^64 = 2^32 - 1 and 2^128 = -2^32 give
// w0 2^32 - (w2 2^32 + w0 + w1), a difference of two canonical words.
__device__ __forceinline__ uint64_t gl_shl64(uint64_t a, int r) {
  const uint64_t lo = a << r, w2 = (a >> 1) >> (63 - r);
  const uint64_t w0 = lo & 0xFFFFFFFFull, w1 = lo >> 32;
  return gl_sub(w0 << 32, (w2 << 32) + w0 + w1);
}

// a * 2^s for canonical a and 0 <= s < 192 (2 has order 192 mod P:
// 2^96 = -1), with shifts and folds only; where s is known at compile time
// the branches fold away.
__device__ __forceinline__ uint64_t gl_mul_pow2(uint64_t a, int s) {
  if (s >= 96) {
    a = gl_neg(a);
    s -= 96;
  }
  if (s >= 64) return gl_shl64(a, s - 64);
  return s ? gl_shl(a, s) : a;
}

// x mod p for p < 2^32 by Barrett with mu = floor((2^64 - 1) / p): the
// quotient estimate umulhi(x, mu) is floor(x / p) or one less, so one
// conditional subtract makes the remainder exact.
__device__ __forceinline__ uint32_t mod_p32(uint64_t x, uint64_t p,
                                            uint64_t mu) {
  const uint64_t r = x - __umul64hi(x, mu) * p;
  return (uint32_t)(r >= p ? r - p : r);
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
