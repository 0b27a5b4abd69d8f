// Inverse CRT of residue planes to RAW multiword coefficients.
//
// Replaces the TPU kernel cuhe_tpu/ops/crt.py::icrt_to_raw_fused (B3), which
// ran the per-coefficient chain in VMEM with every per-prime constant baked
// into the program.  Here one thread owns one coefficient:
//   y_i = x_i * b_i mod p_i                       (Barrett, mod_p32)
//   s   = sum_i y_i * (M / p_i)                   multiword, no reduction
//   x   = s - k M,  k = floor(s / M) < pnum       one reduction at the end
// and x is the unique value in [0, M), bit for bit the value of the
// reference's chain, which brings s below M after every prime (leq_M,
// Base.cu:845-856): both are s mod M.
//
// What bounds it: the 32 x 32 -> 64-bit multiply-adds, pnum * words per
// coefficient (25 x 20 at PRINCE level 0); its bytes (pnum residues in,
// `words` words out) take less time on an H100.  So the kernel runs nothing
// else it can avoid:
//   * the word loops are exact: the kernel is instantiated at widths W of 4,
//     8, .., 40 words, the smallest W >= words runs, and M/p_i and M are
//     zero-padded to W words in shared memory;
//   * the per-level constants (p_i, b_i, the Barrett mu_i, computed with one
//     division per prime and block, the words of M/p_i and of M) are staged
//     in shared memory once per block, and read as broadcasts;
//   * s < pnum M fits W + 1 words, so nothing is compared or subtracted
//     while it accumulates; k is estimated in floating point from the top
//     words of s and of M, which puts it within one of floor(s / M), and one
//     conditional add or subtract of M after the multiword s - k M fixes it.
// Tensor cores are not used: the work is a few hundred multiply-adds per
// coefficient with a carry chain between words.

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int kMaxWords = 40;
constexpr int kThreads = 256;

// Shared memory of a block: M/p_i [pnum][W], M [W] (u32), mu_i [pnum]
// (u64), p_i, b_i [pnum] (u32).
__host__ __device__ constexpr int smem_bytes(int w, int pnum) {
  return (pnum * w + w) * 4 + pnum * 16;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
icrt_kernel(const uint32_t* __restrict__ crt, uint32_t* __restrict__ out,
            const uint32_t* __restrict__ primes,
            const uint32_t* __restrict__ bi,
            const uint32_t* __restrict__ mi_words,
            const uint32_t* __restrict__ m_words, int pnum, int words,
            int len) {
  extern __shared__ uint4 smem4[];
  uint32_t* s_mi = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* s_m = s_mi + pnum * W;
  uint64_t* s_mu = reinterpret_cast<uint64_t*>(s_m + W);  // W % 4 == 0
  uint32_t* s_p = reinterpret_cast<uint32_t*>(s_mu + pnum);
  uint32_t* s_b = s_p + pnum;
  __shared__ int s_top;       // index of M's top nonzero word
  __shared__ double s_mtop;   // M / 2^(32 s_top), from its top two words

  for (int i = threadIdx.x; i < pnum * W; i += kThreads) {
    const int r = i / W, w = i - r * W;
    s_mi[i] = w < words ? mi_words[r * words + w] : 0u;
  }
  for (int w = threadIdx.x; w < W; w += kThreads) {
    s_m[w] = w < words ? m_words[w] : 0u;
  }
  for (int i = threadIdx.x; i < pnum; i += kThreads) {
    const uint32_t p = primes[i];
    s_p[i] = p;
    s_b[i] = bi[i];
    s_mu[i] = ~0ull / p;
  }
  if (threadIdx.x == 0) {
    int top = 0;
    for (int w = 0; w < words; ++w) top = m_words[w] ? w : top;
    s_top = top;
    s_mtop = (double)m_words[top] +
             (top ? (double)m_words[top - 1] * 0x1p-32 : 0.0);
  }
  __syncthreads();

  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= len) return;
  const size_t b = blockIdx.y;

  uint32_t s[W + 1];
#pragma unroll
  for (int w = 0; w <= W; ++w) s[w] = 0;
  const uint32_t* x = crt + b * pnum * len + col;
  uint32_t xn = x[0];  // the next prime's residue, loaded one prime ahead
#pragma unroll 1
  for (int i = 0; i < pnum; ++i) {
    const uint32_t xi = xn;
    if (i + 1 < pnum) xn = x[(size_t)(i + 1) * len];
    const uint32_t y = mod_p32((uint64_t)xi * s_b[i], s_p[i], s_mu[i]);
    const uint4* mi = reinterpret_cast<const uint4*>(s_mi + i * W);
    uint32_t carry = 0;
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 m4 = mi[q];
      const uint32_t m[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint64_t t = (uint64_t)y * m[r] + s[4 * q + r] + carry;
        s[4 * q + r] = (uint32_t)t;
        carry = (uint32_t)(t >> 32);
      }
    }
    s[W] += carry;
  }

  // k = floor(s / M) or one off: s and M scaled by 2^(32 top), s from its
  // words top + 1 .. top - 1 (s < pnum M < 2^(32 (top + 2))), M from two
  // words; both err by under 2^-32 of a unit and M / 2^(32 top) >= 1.
  const int top = s_top;
  double sd = 0.0;
#pragma unroll
  for (int w = 0; w <= W; ++w) {
    const int e = w - top;
    if (e == 1) sd += (double)s[w] * 0x1p32;
    if (e == 0) sd += (double)s[w];
    if (e == -1) sd += (double)s[w] * 0x1p-32;
  }
  const uint32_t k = (uint32_t)(sd / s_mtop);

  // s -= k M, over W + 1 words; the result lies in [-M, 2M)
  {
    uint32_t carry = 0, borrow = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t km = (uint64_t)k * s_m[w] + carry;
      carry = (uint32_t)(km >> 32);
      const uint64_t d = (uint64_t)s[w] - (uint32_t)km - borrow;
      s[w] = (uint32_t)d;
      borrow = (uint32_t)(d >> 63);
    }
    s[W] -= carry + borrow;
  }
  if ((int32_t)s[W] < 0) {  // k was one too large: add M
    uint32_t carry = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t t = (uint64_t)s[w] + s_m[w] + carry;
      s[w] = (uint32_t)t;
      carry = (uint32_t)(t >> 32);
    }
  } else {  // k was one too small where s - k M >= M: subtract M
    uint32_t d[W], borrow = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t t = (uint64_t)s[w] - s_m[w] - borrow;
      d[w] = (uint32_t)t;
      borrow = (uint32_t)(t >> 63);
    }
    if (s[W] || !borrow) {
#pragma unroll
      for (int w = 0; w < W; ++w) s[w] = d[w];
    }
  }

  uint32_t* o = out + b * words * len + col;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (w < words) o[(size_t)w * len] = s[w];
  }
}

template <int W>
cudaError_t launch(const uint32_t* crt, uint32_t* out, const uint32_t* primes,
                   const uint32_t* bi, const uint32_t* mi_words,
                   const uint32_t* m_words, int batch, int pnum, int words,
                   int len, cudaStream_t stream, int* occ) {
  const int smem = smem_bytes(W, pnum);
  if (occ) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      occ, icrt_kernel<W>, kThreads, smem);
  const dim3 grid((len + kThreads - 1) / kThreads, batch);
  icrt_kernel<W><<<grid, kThreads, smem, stream>>>(
      crt, out, primes, bi, mi_words, m_words, pnum, words, len);
  return cudaGetLastError();
}

// Run (or, with occ set, query the occupancy of) the instantiation of the
// smallest width W >= words.
cudaError_t dispatch(const uint32_t* crt, uint32_t* out,
                     const uint32_t* primes, const uint32_t* bi,
                     const uint32_t* mi_words, const uint32_t* m_words,
                     int batch, int pnum, int words, int len,
                     cudaStream_t stream, int* occ = nullptr) {
  if (words < 1 || words > kMaxWords || pnum < 1 ||
      smem_bytes((words + 3) & ~3, pnum) > 48 * 1024)
    return cudaErrorInvalidValue;
#define CUHE_ICRT_WIDTH(w)                                                  \
  case w:                                                                   \
    return launch<w>(crt, out, primes, bi, mi_words, m_words, batch, pnum, \
                     words, len, stream, occ);
  switch ((words + 3) & ~3) {
    CUHE_ICRT_WIDTH(4)
    CUHE_ICRT_WIDTH(8)
    CUHE_ICRT_WIDTH(12)
    CUHE_ICRT_WIDTH(16)
    CUHE_ICRT_WIDTH(20)
    CUHE_ICRT_WIDTH(24)
    CUHE_ICRT_WIDTH(28)
    CUHE_ICRT_WIDTH(32)
    CUHE_ICRT_WIDTH(36)
    CUHE_ICRT_WIDTH(40)
  }
#undef CUHE_ICRT_WIDTH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// crt: u32 [batch, pnum, len] -> out: u32 [batch, words, len];
// primes, bi: u32 [pnum]; mi_words: u32 [pnum, words]; m_words: u32 [words].
int cuhe_icrt(const uint32_t* crt, uint32_t* out, const uint32_t* primes,
              const uint32_t* bi, const uint32_t* mi_words,
              const uint32_t* m_words, int batch, int pnum, int words, int len,
              cudaStream_t stream) {
  return (int)dispatch(crt, out, primes, bi, mi_words, m_words, batch, pnum,
                       words, len, stream);
}

// Resident blocks per SM of the kernel at this word count and pnum, or
// minus a CUDA error.
int cuhe_icrt_blocks_per_sm(int pnum, int words, cudaStream_t) {
  int occ = 0;
  const cudaError_t e = dispatch(nullptr, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, 1, pnum, words, 1, nullptr, &occ);
  return e == cudaSuccess ? occ : -(int)e;
}

}  // extern "C"
