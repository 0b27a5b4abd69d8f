// Elementwise CRT-domain work outside the gate step: RAW words to CRT
// residues (K5), the plaintext and constant ops on CRT residues (K7), and
// the crt-sharded ICRT's split of a partial into 16-bit halves and its
// combine after the all-reduce (K8).
//
// Replaces work that has no Pallas kernel in the JAX package: XLA fuses it
// inside the jits of the per-level conversions, the gates and the sharded
// step, from
//   cuhe_tpu/ops/crt.py::crt_from_raw          (:26)  -> crt_from_raw_kernel
//   cuhe_tpu/ops/pointwise.py::crt_add_nx1     (:52)  -> crt_scalar_kernel
//   cuhe_tpu/ops/pointwise.py::crt_add_int     (:45),
//     ::crt_mul_int (:66), cuhe_tpu/models/prince.py add_rc (:148) and
//     the S-box's cnot (:260)                         -> crt_scalar_kernel
//   cuhe_tpu/ops/crt.py::icrt_psum_combine     (:165) -> icrt_split16_kernel
//                                                      icrt_combine16_kernel
// Residues mod p < 2^32 are reduced by Barrett with mu = floor((2^64 - 1) /
// p) (goldilocks.cuh mod_p32, exact for any 64-bit value), each mu computed
// once per block with one division.  The front ends (ops/crt.py,
// ops/pointwise.py) check shapes, dtypes, contiguity and alignment.

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kMaxWords = 32;  // ops/crt.py MAX_WORDS

__device__ __forceinline__ uint4 ld4(const uint32_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void st4(uint32_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ uint32_t& at(uint4& v, int e) {
  return (&v.x)[e];
}

int grid_y(int rows) { return rows < kMaxGridY ? rows : kMaxGridY; }

// ---- K5: RAW [rows, words, len] -> CRT [rows, pnum, len] ----
// Horner from the top word, r = (r 2^32 + w) mod p (cuhe_tpu/ops/
// crt.py:38-46).  A thread owns one coefficient of one row and the
// residues of a block of up to PB primes (blockIdx.z) in registers: it
// reads each of its words once and reduces it into every residue, so the
// primes' reductions are independent work between two loads.  The primes
// and their mu are read from shared memory as broadcasts.
template <int PB>
__global__ void __launch_bounds__(kThreads)
crt_from_raw_kernel(const uint32_t* __restrict__ raw,
                    const uint32_t* __restrict__ primes,
                    uint32_t* __restrict__ out, int rows, int words, int pnum,
                    int len) {
  __shared__ uint64_t s_mu[PB];
  __shared__ uint32_t s_p[PB];
  const int p0 = blockIdx.z * PB;
  const int np = pnum - p0 < PB ? pnum - p0 : PB;
  for (int i = threadIdx.x; i < np; i += kThreads) {
    const uint32_t p = primes[p0 + i];
    s_p[i] = p;
    s_mu[i] = ~0ull / p;
  }
  __syncthreads();
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= len) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint32_t* x = raw + (size_t)row * words * len + j;
    uint32_t r[PB];
    uint32_t w = x[(size_t)(words - 1) * len];
#pragma unroll
    for (int i = 0; i < PB; ++i)
      if (i < np) r[i] = mod_p32(w, s_p[i], s_mu[i]);
    for (int k = words - 2; k >= 0; --k) {
      w = x[(size_t)k * len];
#pragma unroll
      for (int i = 0; i < PB; ++i)
        if (i < np)
          r[i] = mod_p32(((uint64_t)r[i] << 32) | w, s_p[i], s_mu[i]);
    }
    uint32_t* o = out + ((size_t)row * pnum + p0) * len + j;
#pragma unroll
    for (int i = 0; i < PB; ++i)
      if (i < np) o[(size_t)i * len] = r[i];
  }
}

// ---- K7: one pass over CRT residues [rows, len], row r of plane r % pnum,
// that writes the whole output ----
//   kAddPoly   (crt_add_nx1): out = (x + s[j]) mod p for a u32 polynomial
//              s [len] not reduced mod any p: the exact 33-bit sum, reduced;
//   kAddCoeff0 (crt_add_int, and one value per leading row: PRINCE's round
//              constants): coefficient 0 gets (x_0 + c) mod p, c = a or
//              c_rows[r / pnum], exact in 64 bits, which equals the JAX
//              package's (x_0 + a mod p) mod p;
//   kMulCoeff0 (crt_mul_int): coefficient 0 gets (x_0 a) mod p;
// and the other coefficients of the coefficient-0 modes are copied.
enum ScalarMode { kAddPoly = 0, kAddCoeff0 = 1, kMulCoeff0 = 2 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
crt_scalar_kernel(const uint32_t* __restrict__ x,
                  const uint32_t* __restrict__ s,
                  const uint32_t* __restrict__ c_rows,
                  const uint32_t* __restrict__ primes,
                  uint32_t* __restrict__ out, int rows, int pnum, int len,
                  uint32_t a) {
  extern __shared__ uint64_t s_mu[];  // [pnum], kAddPoly only
  if (kMode == kAddPoly) {
    for (int i = threadIdx.x; i < pnum; i += kThreads)
      s_mu[i] = ~0ull / primes[i];
    __syncthreads();
  }
  const int j0 = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (j0 >= len) return;
  uint4 sv = make_uint4(0, 0, 0, 0);
  if (kMode == kAddPoly) sv = ld4(s + j0);
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int plane = row % pnum;
    uint4 v = ld4(x + (size_t)row * len + j0);
    if (kMode == kAddPoly) {
      const uint64_t p = primes[plane], mu = s_mu[plane];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        at(v, e) = mod_p32((uint64_t)at(v, e) + at(sv, e), p, mu);
    } else if (j0 == 0) {
      const uint64_t p = primes[plane], mu = ~0ull / p;
      if (kMode == kMulCoeff0)
        v.x = mod_p32((uint64_t)v.x * a, p, mu);
      else
        v.x = mod_p32((uint64_t)v.x + (c_rows ? c_rows[row / pnum] : a), p,
                      mu);
    }
    st4(out + (size_t)row * len + j0, v);
  }
}

// ---- K8: the crt-sharded ICRT around its all-reduce (cuhe_tpu/ops/
// crt.py:165-215) ----
// Split: each u32 word of a partial -> its low and high 16-bit halves as
// int32 (the all-reduce sums them, no collective takes u32).
__global__ void __launch_bounds__(kThreads)
icrt_split16_kernel(const uint32_t* __restrict__ x, int32_t* __restrict__ lo,
                    int32_t* __restrict__ hi, int count) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < count;
       i += gridDim.x * kThreads) {
    const uint32_t v = x[i];
    lo[i] = (int32_t)(v & 0xFFFFu);
    hi[i] = (int32_t)(v >> 16);
  }
}

// Combine: the summed halves [rows, words, len] rippled into words, value =
// sum_w (lo_w + 2^16 hi_w) 2^(32 w), then M subtracted where the value is
// at least M, at most max(1, n_shards - 1) times (the sum of n_shards
// partials in [0, M) is below n_shards M): the plain version's conditional
// subtracts, stopped at the first that subtracts nothing, after which the
// rest subtract nothing either.  One thread owns one coefficient's words in
// registers; the arithmetic is the plain version's int64 arithmetic on the
// int32 sums, so any input gives its output bit for bit.
__global__ void __launch_bounds__(kThreads)
icrt_combine16_kernel(const int32_t* __restrict__ lo16,
                      const int32_t* __restrict__ hi16,
                      const uint32_t* __restrict__ m_words,
                      uint32_t* __restrict__ out, int rows, int words, int len,
                      int n_shards) {
  __shared__ uint32_t s_m[kMaxWords];
  for (int i = threadIdx.x; i < words; i += kThreads) s_m[i] = m_words[i];
  __syncthreads();
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= len) return;
  const int rounds = n_shards > 2 ? n_shards - 1 : 1;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t base = (size_t)row * words * len + j;
    int64_t s[kMaxWords];
    int64_t carry = 0;
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      if (w < words) {
        const int64_t t = (int64_t)lo16[base + (size_t)w * len] +
                          ((int64_t)hi16[base + (size_t)w * len] << 16) +
                          carry;
        s[w] = t & 0xFFFFFFFFll;
        carry = t >> 32;
      }
    }
    int64_t top = carry;
    for (int it = 0; it < rounds; ++it) {
      bool ge = top > 0, eq = true;
#pragma unroll
      for (int w = kMaxWords - 1; w >= 0; --w) {
        if (w < words) {
          const int64_t m = s_m[w];
          ge = ge || (eq && s[w] > m);
          eq = eq && s[w] == m;
        }
      }
      if (!(ge || eq)) break;
      int64_t borrow = 0;
#pragma unroll
      for (int w = 0; w < kMaxWords; ++w) {
        if (w < words) {
          const int64_t d = s[w] - (int64_t)s_m[w] - borrow;
          borrow = d < 0;
          s[w] = d & 0xFFFFFFFFll;
        }
      }
      top -= borrow;
    }
    uint32_t* o = out + (size_t)row * words * len + j;
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w)
      if (w < words) o[(size_t)w * len] = (uint32_t)s[w];
  }
}

template <int PB>
void launch_crt_from_raw(const uint32_t* raw, const uint32_t* primes,
                         uint32_t* out, int rows, int words, int pnum, int len,
                         cudaStream_t stream) {
  const dim3 grid((len + kThreads - 1) / kThreads, grid_y(rows),
                  (pnum + PB - 1) / PB);
  crt_from_raw_kernel<PB><<<grid, kThreads, 0, stream>>>(raw, primes, out,
                                                         rows, words, pnum,
                                                         len);
}

}  // namespace

extern "C" {

// raw: u32 [rows, words, len]; primes: u32 [pnum]; out: u32 [rows, pnum,
// len]; 1 <= words <= 32.
int cuhe_crt_from_raw(const uint32_t* raw, const uint32_t* primes,
                      uint32_t* out, int rows, int words, int pnum, int len,
                      cudaStream_t stream) {
  if (rows <= 0 || words < 1 || words > kMaxWords || pnum <= 0 || len <= 0 ||
      (pnum + 31) / 32 > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  // the smallest register block that holds every prime; past 32, blocks of
  // 32 (each reads the words again)
  if (pnum <= 8)
    launch_crt_from_raw<8>(raw, primes, out, rows, words, pnum, len, stream);
  else if (pnum <= 16)
    launch_crt_from_raw<16>(raw, primes, out, rows, words, pnum, len, stream);
  else
    launch_crt_from_raw<32>(raw, primes, out, rows, words, pnum, len, stream);
  return (int)cudaGetLastError();
}

// x, out: u32 [rows, len], row r of plane r % pnum; primes: u32 [pnum];
// mode 0: s u32 [len]; mode 1: c_rows u32 [rows / pnum] or null (then the
// value a); mode 2: the value a.  a is a u32 passed as its int bit pattern.
int cuhe_crt_scalar(const uint32_t* x, const uint32_t* s,
                    const uint32_t* c_rows, const uint32_t* primes,
                    uint32_t* out, int rows, int pnum, int len, int mode,
                    int a, cudaStream_t stream) {
  if (rows <= 0 || pnum <= 0 || pnum > 4096 || rows % pnum || len <= 0 ||
      len % 4 || mode < kAddPoly || mode > kMulCoeff0 ||
      (mode == kAddPoly && s == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((len / 4 + kThreads - 1) / kThreads, grid_y(rows));
  const uint32_t ua = (uint32_t)a;
  if (mode == kAddPoly)
    crt_scalar_kernel<kAddPoly><<<grid, kThreads, 8 * pnum, stream>>>(
        x, s, c_rows, primes, out, rows, pnum, len, ua);
  else if (mode == kAddCoeff0)
    crt_scalar_kernel<kAddCoeff0><<<grid, kThreads, 0, stream>>>(
        x, s, c_rows, primes, out, rows, pnum, len, ua);
  else
    crt_scalar_kernel<kMulCoeff0><<<grid, kThreads, 0, stream>>>(
        x, s, c_rows, primes, out, rows, pnum, len, ua);
  return (int)cudaGetLastError();
}

// x: u32 [count]; out: int32 [2, count], the low halves then the high.
int cuhe_icrt_split16(const uint32_t* x, int32_t* out, int count,
                      cudaStream_t stream) {
  if (count <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (count + kThreads - 1) / kThreads;
  icrt_split16_kernel<<<blocks < 65536 ? blocks : 65536, kThreads, 0,
                        stream>>>(x, out, out + count, count);
  return (int)cudaGetLastError();
}

// lo16, hi16: int32 [rows, words, len]; m_words: u32 [words]; out: u32
// [rows, words, len]; 1 <= words <= 32.
int cuhe_icrt_combine16(const int32_t* lo16, const int32_t* hi16,
                        const uint32_t* m_words, uint32_t* out, int rows,
                        int words, int len, int n_shards,
                        cudaStream_t stream) {
  if (rows <= 0 || words < 1 || words > kMaxWords || len <= 0 ||
      n_shards < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((len + kThreads - 1) / kThreads, grid_y(rows));
  icrt_combine16_kernel<<<grid, kThreads, 0, stream>>>(
      lo16, hi16, m_words, out, rows, words, len, n_shards);
  return (int)cudaGetLastError();
}

}  // extern "C"
