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

// Lazy accumulation (csrc/relin.cu): a sum of products kept unreduced and
// folded once.  Each product of x, y < 2^64 splits into 32 x 32-bit partial
// products, x0 y0 + x1 y1 2^64 (even) and (x0 y1 + x1 y0) 2^32 (odd), and
// each part has its own accumulator of 64-bit words, so that every partial
// product is one wide multiply (IMAD.WIDE.U32) added to an aligned pair of
// registers, with no moves between two alignments of one accumulator.
// After c products on an initial value below 2^64 the even words e0..e4
// hold below 2^64 + c 2^128 and the odd words o0..o2 (at 2^32) below c 2^65:
// exact for fewer than 2^31 products, where o2 < 2c fits its word and the
// value stays below 2^160.
struct gl_acc {
  uint64_t e01, e23, o01;  // words 0-1 and 2-3 of the even part, 0-1 of odd
  uint32_t e4, o2;
};

__device__ __forceinline__ gl_acc gl_acc_init(uint64_t v) {
  return gl_acc{v, 0, 0, 0, 0};
}

// a += x * y: four wide multiplies, three 64-bit adds, three carries caught
// (these instruction forms measured fastest on an H100; PERF.md,
// section 6).
__device__ __forceinline__ void gl_acc_mac(gl_acc& a, uint64_t x,
                                           uint64_t y) {
  asm("{\n\t.reg .u64 t0, t1;\n\t"
      "mul.wide.u32 t0, %5, %7;\n\t"
      "mul.wide.u32 t1, %6, %8;\n\t"
      "add.cc.u64 %0, %0, t0;\n\t"
      "addc.cc.u64 %1, %1, t1;\n\t"
      "addc.u32 %3, %3, 0;\n\t"
      "mad.wide.u32 t0, %5, %8, 0;\n\t"
      "add.cc.u64 %2, %2, t0;\n\t"
      "addc.u32 %4, %4, 0;\n\t"
      "mad.wide.u32 t1, %6, %7, 0;\n\t"
      "add.cc.u64 %2, %2, t1;\n\t"
      "addc.u32 %4, %4, 0;\n\t}"
      : "+l"(a.e01), "+l"(a.e23), "+l"(a.o01), "+r"(a.e4), "+r"(a.o2)
      : "r"((uint32_t)x), "r"((uint32_t)(x >> 32)), "r"((uint32_t)y),
        "r"((uint32_t)(y >> 32)));
}

// The accumulated value mod P: the odd part added at word 1, giving five
// words r0..r4 below 2^160, then r0 + r1 2^32 + r2 2^64 + r3 2^96 folded by
// gl_reduce128 and r4 2^128 = -r4 2^32 (mod P), where r4 2^32 < P.
__device__ __forceinline__ uint64_t gl_acc_reduce(const gl_acc& a) {
  uint32_t r1, r2, r3, r4;
  asm("add.cc.u32 %0, %4, %8;\n\t"
      "addc.cc.u32 %1, %5, %9;\n\t"
      "addc.cc.u32 %2, %6, %10;\n\t"
      "addc.u32 %3, %7, 0;"
      : "=r"(r1), "=r"(r2), "=r"(r3), "=r"(r4)
      : "r"((uint32_t)(a.e01 >> 32)), "r"((uint32_t)a.e23),
        "r"((uint32_t)(a.e23 >> 32)), "r"(a.e4), "r"((uint32_t)a.o01),
        "r"((uint32_t)(a.o01 >> 32)), "r"(a.o2));
  const uint64_t v = gl_reduce128(((uint64_t)r1 << 32) | (uint32_t)a.e01,
                                  ((uint64_t)r3 << 32) | r2);
  return gl_sub(v, (uint64_t)r4 << 32);
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
