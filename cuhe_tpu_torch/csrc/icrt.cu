// Inverse CRT of residue planes to RAW multiword coefficients.
//
// Replaces the TPU kernel cuhe_tpu/ops/crt.py::icrt_to_raw_fused (B3), which
// ran the per-coefficient chain in VMEM with every per-prime constant baked
// into the program.  Here one thread owns one coefficient and walks the
// primes:
//   y   = x_i * b_i mod p_i
//   s  += y * (M / p_i)            multiword, words + 1 accumulator words
//   s  -= M   if s >= M            (leq_M, Base.cu:845-856)
// so s stays below M and the result is the unique value in [0, M).  The
// per-level constants (p_i, b_i, the words of M/p_i and of M) come in as
// small device arrays, read by every thread through the read-only cache.
//
// What bounds it: each coefficient reads pnum residues and writes `words`
// words, and needs pnum * (words + 1) 32x32 multiply-adds, so the function's
// least time is set by device memory.  This kernel also compares and
// subtracts M over the words after every prime, which keeps the accumulator
// at words + 1 words in registers (the word loops are unrolled to kMaxWords
// with guards) at the cost of integer work the function does not need.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxWords = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
icrt_kernel(const uint32_t* __restrict__ crt, uint32_t* __restrict__ out,
            const uint32_t* __restrict__ primes,
            const uint32_t* __restrict__ bi,
            const uint32_t* __restrict__ mi_words,
            const uint32_t* __restrict__ m_words, int pnum, int words,
            int len) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= len) return;
  const size_t b = blockIdx.y;
  uint32_t s[kMaxWords + 1];
#pragma unroll
  for (int w = 0; w <= kMaxWords; ++w) s[w] = 0;

  const uint32_t* x = crt + b * pnum * len + col;
  for (int i = 0; i < pnum; ++i) {
    const uint64_t p = __ldg(primes + i);
    const uint64_t y = ((uint64_t)x[(size_t)i * len] * __ldg(bi + i)) % p;
    const uint32_t* mi = mi_words + (size_t)i * words;
    uint64_t carry = 0;
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      if (w < words) {
        const uint64_t t = (uint64_t)s[w] + y * __ldg(mi + w) + carry;
        s[w] = (uint32_t)t;
        carry = t >> 32;
      }
    }
#pragma unroll
    for (int w = 0; w <= kMaxWords; ++w) {
      if (w == words) s[w] += (uint32_t)carry;
    }
    // s >= M ?  (M has `words` words; s has one more)
    bool ge = false, eq = true;
#pragma unroll
    for (int w = kMaxWords; w >= 0; --w) {
      if (w <= words && eq) {
        const uint32_t m = w < words ? __ldg(m_words + w) : 0u;
        if (s[w] != m) {
          ge = s[w] > m;
          eq = false;
        }
      }
    }
    if (ge || eq) {
      uint64_t borrow = 0;
#pragma unroll
      for (int w = 0; w <= kMaxWords; ++w) {
        if (w <= words) {
          const uint32_t m = w < words ? __ldg(m_words + w) : 0u;
          const uint64_t d = (uint64_t)s[w] - m - borrow;
          s[w] = (uint32_t)d;
          borrow = d >> 63;
        }
      }
    }
  }
  uint32_t* o = out + b * words * len + col;
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    if (w < words) o[(size_t)w * len] = s[w];
  }
}

}  // namespace

extern "C" {

// crt: u32 [batch, pnum, len] -> out: u32 [batch, words, len];
// primes, bi: u32 [pnum]; mi_words: u32 [pnum, words]; m_words: u32 [words].
int cuhe_icrt(const uint32_t* crt, uint32_t* out, const uint32_t* primes,
              const uint32_t* bi, const uint32_t* mi_words,
              const uint32_t* m_words, int batch, int pnum, int words, int len,
              cudaStream_t stream) {
  if (words < 1 || words > kMaxWords) return (int)cudaErrorInvalidValue;
  const dim3 grid((len + kThreads - 1) / kThreads, batch);
  icrt_kernel<<<grid, kThreads, 0, stream>>>(crt, out, primes, bi, mi_words,
                                             m_words, pnum, words, len);
  return (int)cudaGetLastError();
}

}  // extern "C"
