// The elementwise Z_P / CRT layer of the gate step: the Z_P pair product
// and sum, Barrett's combine, the modulus switch and the CRT add.
//
// Replaces work that has no Pallas kernel in the JAX package: XLA fuses it
// inside the step's jit (cuhe_tpu/parallel/mesh.py:220-238) and the
// per-level conversions' (cuhe_tpu/context.py:161-286) from
//   cuhe_tpu/ops/modp.py::mul_modp          (:188)   -> zp_binary_kernel
//   cuhe_tpu/ops/modp.py::add_modp          (:152)   -> zp_binary_kernel
//   cuhe_tpu/ops/barrett.py::barrett_reduce (:61-77) -> barrett_combine_kernel
//   cuhe_tpu/ops/pointwise.py::mod_switch   (:75)    -> mod_switch_kernel
//   cuhe_tpu/ops/pointwise.py::crt_add      (:38)    -> crt_add_kernel
// The TPU has no 64-bit integer unit, so the JAX package emulates each Z_P
// product with 16-bit limbs; the card multiplies 64-bit words
// (goldilocks.cuh gl_mul) and reduces residues mod p < 2^32 by Barrett with
// mu = floor((2^64 - 1) / p) (mod_p32).
//
// What bounds them: bytes.  Each reads its operands once and writes its
// output once with a few integer operations per word, far below the card's
// operation rate.  So each thread moves 16-byte words (four coefficients)
// of neighbouring addresses, there is one pass per function, and nothing is
// read that the output does not need: Barrett's combine reads only the
// coefficients below n/2 of its three inputs, and the high-half subtrahend
// c1 only where the high range [mod_len, 2 mod_len) meets them.  The front
// ends (ops/pointwise.py, ops/barrett.py) check shapes, dtypes, contiguity
// and 16-byte alignment, and that the last dimension is a multiple of 4.

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ uint4 ld4(const uint32_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void st4(uint32_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ uint32_t& at(uint4& v, int e) {
  return (&v.x)[e];
}

// (a - b) mod p for residues a, b < p (barrett_sub_1/2/mc, Base.cu:927-1001)
__device__ __forceinline__ uint32_t crt_sub(uint32_t a, uint32_t b,
                                            uint32_t p) {
  return a < b ? a + p - b : a - b;
}

// ---- K1 / K6: out = a * b (K1) or a + b (K6) mod P on (lo, hi) word
// planes; b repeats every b_quads quads (b broadcast over a's leading
// dimensions).  K6 takes canonical words (gl_add) ----
enum class ZpOp { kMul, kAdd };

template <ZpOp kOp>
__global__ void __launch_bounds__(kThreads)
zp_binary_kernel(const uint32_t* __restrict__ a_lo,
                 const uint32_t* __restrict__ a_hi,
                 const uint32_t* __restrict__ b_lo,
                 const uint32_t* __restrict__ b_hi,
                 uint32_t* __restrict__ o_lo, uint32_t* __restrict__ o_hi,
                 uint32_t quads, uint32_t b_quads) {
  const uint32_t q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= quads) return;
  const uint32_t j = q < b_quads ? q : q % b_quads;
  const uint4 al = ld4(a_lo + 4 * (size_t)q), ah = ld4(a_hi + 4 * (size_t)q);
  const uint4 bl = ld4(b_lo + 4 * (size_t)j), bh = ld4(b_hi + 4 * (size_t)j);
  uint4 rl, rh;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint64_t a = (uint64_t)(&al.x)[e] | ((uint64_t)(&ah.x)[e] << 32);
    const uint64_t b = (uint64_t)(&bl.x)[e] | ((uint64_t)(&bh.x)[e] << 32);
    const uint64_t r = kOp == ZpOp::kMul ? gl_mul(a, b) : gl_add(a, b);
    at(rl, e) = (uint32_t)r;
    at(rh, e) = (uint32_t)(r >> 32);
  }
  st4(o_lo + 4 * (size_t)q, rl);
  st4(o_hi + 4 * (size_t)q, rh);
}

// ---- K2: Barrett's steps 4-6 (cuhe_tpu/ops/barrett.py:61-77) on rows of
// n residues; out holds the first n/2 of each row ----
//   src = f - c1 on [mod_len, 2 mod_len) (mod p), then src - c2;
//   where t = src[mod_len] > 0, src - m_crt on [0, mod_len - 1).
// c1's low mod_len coefficients, which the reference zeroes first, are
// never read: the high range starts at mod_len.  Every block of a row
// computes t itself from three loads at index mod_len (in the high range);
// the m_crt words are loaded beside the others, not after t (the table is
// small and stays in L2), so that a row waits for one round of loads.
__global__ void __launch_bounds__(kThreads)
barrett_combine_kernel(const uint32_t* __restrict__ f,
                       const uint32_t* __restrict__ c1,
                       const uint32_t* __restrict__ c2,
                       const uint32_t* __restrict__ m_crt,
                       const uint32_t* __restrict__ primes,
                       uint32_t* __restrict__ out, int rows, int pnum, int n,
                       int mod_len) {
  const int half = n / 2;
  const int j0 = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (j0 >= half) return;
  const bool high = j0 + 3 >= mod_len && j0 < 2 * mod_len;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int plane = row % pnum;
    const uint32_t p = primes[plane];
    const size_t base = (size_t)row * n;
    const uint32_t t = crt_sub(
        crt_sub(f[base + mod_len], c1[base + mod_len], p), c2[base + mod_len],
        p);
    const uint4 fv = ld4(f + base + j0), c2v = ld4(c2 + base + j0);
    const uint4 c1v = high ? ld4(c1 + base + j0) : make_uint4(0, 0, 0, 0);
    const uint4 mv = j0 < mod_len - 1 ? ld4(m_crt + (size_t)plane * half + j0)
                                      : make_uint4(0, 0, 0, 0);
    const bool corr = t > 0;
    uint4 r;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + e;
      uint32_t s = (&fv.x)[e];
      if (j >= mod_len && j < 2 * mod_len) s = crt_sub(s, (&c1v.x)[e], p);
      s = crt_sub(s, (&c2v.x)[e], p);
      if (corr && j < mod_len - 1) s = crt_sub(s, (&mv.x)[e], p);
      at(r, e) = s;
    }
    st4(out + (size_t)row * half + j0, r);
  }
}

// ---- K3: the modulus switch dropping prime p_t (Base.cu:1112-1138) ----
// Per column, the dropped residue d is moved by -/+ ep p_t (ep = d mod
// mod_msg, the centered branch above (p_t - 1) / 2) so that it becomes
// divisible by mod_msg; then each kept plane gives (x_i - d) p_t^-1 mod p_i.
// The difference is signed: it is reduced exactly, as Python's % (the
// divisor's sign) gives it.  A thread owns four columns of one row and runs
// over the kept planes, four at a time (their loads in flight together);
// the planes' p_i, p_t^-1 and Barrett mu_i are staged in shared memory once
// per block.
__device__ __forceinline__ uint32_t mod_signed(int64_t v, uint32_t p,
                                               uint64_t mu) {
  if (v >= 0) return mod_p32((uint64_t)v, p, mu);
  const uint32_t r = mod_p32((uint64_t)(-v), p, mu);
  return r ? p - r : 0;
}

__global__ void __launch_bounds__(kThreads)
mod_switch_kernel(const uint32_t* __restrict__ crt,
                  const uint32_t* __restrict__ dropped,
                  const uint32_t* __restrict__ primes,
                  const uint32_t* __restrict__ invp,
                  uint32_t* __restrict__ out, int rows, int planes_in, int k,
                  int len, long long dropped_stride, int mod_msg) {
  extern __shared__ uint64_t s_mu[];  // [k] mu_i, then [k] p_i | inv_i << 32
  uint64_t* s_pi = s_mu + k;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const uint32_t p = primes[i];
    s_mu[i] = ~0ull / p;
    s_pi[i] = (uint64_t)p | ((uint64_t)invp[i] << 32);
  }
  __syncthreads();
  const int j0 = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (j0 >= len) return;
  const int64_t pt = primes[k];
  const int64_t centre = (pt - 1) / 2;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint4 dv = ld4(dropped + row * dropped_stride + j0);
    int64_t d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t v = (&dv.x)[e];
      const int64_t ep = (int64_t)((&dv.x)[e] % (uint32_t)mod_msg);
      d[e] = ep == 0 ? v : v > centre ? v - ep * pt : v + ep * pt;
    }
    const uint32_t* x = crt + (size_t)row * planes_in * len + j0;
    uint32_t* o = out + (size_t)row * k * len + j0;
    auto plane = [&](int i, const uint4& xv) {
      const uint64_t pi = s_pi[i], mu = s_mu[i];
      const uint32_t p = (uint32_t)pi, inv = (uint32_t)(pi >> 32);
      uint4 r;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t diff = mod_signed((int64_t)(&xv.x)[e] - d[e], p, mu);
        at(r, e) = mod_p32((uint64_t)diff * inv, p, mu);
      }
      st4(o + (size_t)i * len, r);
    };
    int i = 0;
    for (; i + 4 <= k; i += 4) {
      uint4 xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) xv[u] = ld4(x + (size_t)(i + u) * len);
#pragma unroll
      for (int u = 0; u < 4; ++u) plane(i + u, xv[u]);
    }
    for (; i < k; ++i) plane(i, ld4(x + (size_t)i * len));
  }
}

// ---- K4: (x + y) mod p_i per plane (Base.cu:1078-1085) ----
__global__ void __launch_bounds__(kThreads)
crt_add_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
               const uint32_t* __restrict__ primes, uint32_t* __restrict__ out,
               int rows, int pnum, int len) {
  const int j0 = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (j0 >= len) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint64_t p = primes[row % pnum];
    const uint4 xv = ld4(x + (size_t)row * len + j0);
    const uint4 yv = ld4(y + (size_t)row * len + j0);
    uint4 r;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint64_t s = (uint64_t)(&xv.x)[e] + (&yv.x)[e];
      at(r, e) = (uint32_t)(s >= p ? s - p : s);
    }
    st4(out + (size_t)row * len + j0, r);
  }
}

dim3 row_grid(int len4, int rows) {
  return dim3((len4 + kThreads - 1) / kThreads,
              rows < kMaxGridY ? rows : kMaxGridY);
}

template <ZpOp kOp>
int zp_binary(const uint32_t* a_lo, const uint32_t* a_hi, const uint32_t* b_lo,
              const uint32_t* b_hi, uint32_t* o_lo, uint32_t* o_hi, int count,
              int b_count, cudaStream_t stream) {
  if (count <= 0 || b_count <= 0 || count % 4 || b_count % 4 ||
      count % b_count)
    return (int)cudaErrorInvalidValue;
  const uint32_t quads = count / 4;
  zp_binary_kernel<kOp><<<(quads + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(a_lo, a_hi, b_lo, b_hi, o_lo, o_hi, quads,
                                    b_count / 4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a_lo, a_hi, out: u32 [count]; b_lo, b_hi: u32 [b_count], count a
// multiple of b_count, both multiples of 4.
int cuhe_zp_mul(const uint32_t* a_lo, const uint32_t* a_hi,
                const uint32_t* b_lo, const uint32_t* b_hi, uint32_t* o_lo,
                uint32_t* o_hi, int count, int b_count, cudaStream_t stream) {
  return zp_binary<ZpOp::kMul>(a_lo, a_hi, b_lo, b_hi, o_lo, o_hi, count,
                               b_count, stream);
}

// As cuhe_zp_mul, the sum of canonical words.
int cuhe_zp_add(const uint32_t* a_lo, const uint32_t* a_hi,
                const uint32_t* b_lo, const uint32_t* b_hi, uint32_t* o_lo,
                uint32_t* o_hi, int count, int b_count, cudaStream_t stream) {
  return zp_binary<ZpOp::kAdd>(a_lo, a_hi, b_lo, b_hi, o_lo, o_hi, count,
                               b_count, stream);
}

// f, c1, c2: u32 [rows, n]; m_crt: u32 [pnum, n/2]; primes: u32 [pnum];
// out: u32 [rows, n/2]; row r is plane r % pnum.
int cuhe_barrett_combine(const uint32_t* f, const uint32_t* c1,
                         const uint32_t* c2, const uint32_t* m_crt,
                         const uint32_t* primes, uint32_t* out, int rows,
                         int pnum, int n, int mod_len, cudaStream_t stream) {
  if (rows <= 0 || pnum <= 0 || n % 8 || mod_len < 1 || mod_len >= n ||
      2 * mod_len > n)
    return (int)cudaErrorInvalidValue;
  barrett_combine_kernel<<<row_grid(n / 8, rows), kThreads, 0, stream>>>(
      f, c1, c2, m_crt, primes, out, rows, pnum, n, mod_len);
  return (int)cudaGetLastError();
}

// crt: u32 [rows, planes_in, len], whose first k planes are kept;
// dropped: u32 rows of len at a stride of dropped_stride words; primes:
// u32 [k + 1], the kept planes' then p_t; invp: u32 [k]; out: u32
// [rows, k, len].
int cuhe_mod_switch(const uint32_t* crt, const uint32_t* dropped,
                    const uint32_t* primes, const uint32_t* invp,
                    uint32_t* out, int rows, int planes_in, int k, int len,
                    int dropped_stride, int mod_msg, cudaStream_t stream) {
  if (rows <= 0 || k <= 0 || planes_in < k || len % 4 || len <= 0 ||
      dropped_stride % 4 || mod_msg < 1)
    return (int)cudaErrorInvalidValue;
  mod_switch_kernel<<<row_grid(len / 4, rows), kThreads, 16 * k, stream>>>(
      crt, dropped, primes, invp, out, rows, planes_in, k, len,
      dropped_stride, mod_msg);
  return (int)cudaGetLastError();
}

// x, y, out: u32 [rows, len]; primes: u32 [pnum], row r is plane r % pnum.
int cuhe_crt_add(const uint32_t* x, const uint32_t* y, const uint32_t* primes,
                 uint32_t* out, int rows, int pnum, int len,
                 cudaStream_t stream) {
  if (rows <= 0 || pnum <= 0 || len % 4 || len <= 0)
    return (int)cudaErrorInvalidValue;
  crt_add_kernel<<<row_grid(len / 4, rows), kThreads, 0, stream>>>(
      x, y, primes, out, rows, pnum, len);
  return (int)cudaGetLastError();
}

}  // extern "C"
