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
// K7's residues mod p < 2^32 are reduced by Barrett with mu = floor((2^64
// - 1) / p) (goldilocks.cuh mod_p32, exact for any 64-bit value), each mu
// computed once per block with one division.  K5 reduces a dot product of
// the coefficient's bit chunks with per-prime constants by one 2/1 division
// (`div_2by1`); K8's combine replaces its conditional subtracts of M with
// one quotient estimate.  K5 and K8's combine are instantiated at every
// word count 1..32, so a coefficient's words live in registers.  The front
// ends (ops/crt.py, ops/pointwise.py) check shapes, dtypes, contiguity and
// alignment.
//
// What bounds them on an H100: K5, the multiply-adds (N per coefficient
// and prime against the bound's one per word, N / W = 1.2 at 20 words);
// K7, K8 the bytes, each word read and written once.

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
// A coefficient of W words is cut into N chunks of B bits, chunk k its bits
// [kB, kB + B), the widest B with N 2^B <= 2^32 (B = 27 and N = 24 at W =
// 20).  Its residue mod p is then a dot product with per-prime constants,
//   x = sum_k chunk_k 2^(kB) == sum_k chunk_k c_k  (mod p),
//   c_k = (2^(kB) mod p) 2^s,  d = p 2^s with 2^31 <= d < 2^32,
// accumulated in 64 bits: each term is below 2^B d, so the sum S is below
// N 2^B d <= 2^32 d < 2^64, a product of two u32 plus a u64 is one
// IMAD.WIDE.U32, and nothing is reduced until the end.  S = (x mod p) 2^s
// (mod d) and S < 2^32 d, so one 2/1 division by the normalized d
// (`div_2by1`: one wide multiply by its reciprocal, one narrow multiply,
// two compares) and a shift give x mod p exactly, for any 2 <= p < 2^32.
// Per (coefficient, prime): N wide multiply-adds against the W of the bound
// (one 32 x 32-bit product per word), where Horner from the top word took
// W 64-bit Barrett reductions, each a 64 x 64-bit high product.
//
// A thread owns two coefficients of one row (one past 24 words): it loads
// their W words once (coalesced across the warp), cuts them into N chunks
// in registers (W is a template parameter, so every shift is a constant),
// then loops over the primes, reads each prime's constants from shared
// memory as warp-wide broadcasts, once for both coefficients, and writes
// each residue once, coalesced.  A block builds the
// constants of its primes (up to kPrimeBlock, blockIdx.z; PRINCE's 25 are
// one block) in a prologue, one thread per prime, by N - 1 steps of
// c_(k+1) = div_2by1(c_k 2^B): no host table and no second launch.
constexpr int kPrimeBlock = 128;

__host__ __device__ constexpr int raw_chunks(int w, int b) {
  return (32 * w + b - 1) / b;
}

__host__ __device__ constexpr int raw_chunk_bits(int w) {
  int b = 32;
  while ((long long)raw_chunks(w, b) << b > (1ll << 32)) --b;
  return b;
}

// u32 per prime in shared memory: the N constants, padded to a multiple of
// 4, then d, v, s and a zero (16-byte aligned, read as uint4).
__host__ __device__ constexpr int raw_table_stride(int w) {
  return ((raw_chunks(w, raw_chunk_bits(w)) + 3) & ~3) + 4;
}

// u = q d + r for a normalized d (2^31 <= d < 2^32) and u < 2^32 d, with
// v = floor((2^64 - 1) / d) - 2^32: Moller and Granlund's 2/1 division
// ("Improved division by invariant integers", 2011, Algorithm 4).  v u1 + u
// does not overflow 64 bits.  Returns r; q where asked.
__device__ __forceinline__ uint32_t div_2by1(uint64_t u, uint32_t d,
                                             uint32_t v,
                                             uint32_t* q = nullptr) {
  const uint32_t u0 = (uint32_t)u;
  const uint64_t e = (uint64_t)v * (uint32_t)(u >> 32) + u;
  uint32_t q1 = (uint32_t)(e >> 32) + 1;
  uint32_t r = u0 - q1 * d;
  if (r > (uint32_t)e) {
    --q1;
    r += d;
  }
  if (r >= d) {
    ++q1;
    r -= d;
  }
  if (q) *q = q1;
  return r;
}

// acc + a b in one IMAD.WIDE.U32: ptxas turns the same sum written in C++
// into the wide multiply plus an add of a zero high word per term.
__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint32_t b,
                                             uint64_t acc) {
#ifdef __CUDA_ARCH__
  uint64_t r;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(acc));
  return r;
#else
  return acc + (uint64_t)a * b;
#endif
}

// Prime p's constants at t (raw_table_stride(W) words).  p < 2 writes a
// table that gives 0 (x mod 1).
template <int W>
__device__ void raw_table_prime(uint32_t p, uint32_t* t) {
  constexpr int B = raw_chunk_bits(W), N = raw_chunks(W, B);
  constexpr int S = raw_table_stride(W);
  const int s = p < 2 ? 0 : __clz(p);
  const uint32_t d = p < 2 ? 1u << 31 : p << s;
  const uint32_t v = (uint32_t)(~0ull / d);  // floor(..) - 2^32: its low word
  uint32_t c = p < 2 ? 0 : 1u << s;
  t[0] = c;
  for (int k = 1; k < N; ++k) {
    c = div_2by1((uint64_t)c << B, d, v);
    t[k] = c;
  }
  for (int k = N; k < S - 4; ++k) t[k] = 0;
  t[S - 4] = d;
  t[S - 3] = v;
  t[S - 2] = (uint32_t)s;
  t[S - 1] = 0;
}

// Chunk k (bits [kB, kB + B)) of the W words w; k is a constant after
// unrolling.
template <int W, int B>
__device__ __forceinline__ uint32_t raw_chunk(const uint32_t (&w)[W],
                                              int k) {
  const int bit = k * B, q = bit / 32, off = bit % 32;
  uint32_t c = w[q] >> off;
  if (off + B > 32 && q + 1 < W) c |= w[q + 1] << (32 - off);
  return B == 32 ? c : c & ((1u << (B & 31)) - 1);
}

// Coefficients a thread owns (kThreads apart, so each load and store
// stays coalesced): two share every constant read and the loop's overhead;
// past 24 words their chunks would take too many registers.
__host__ __device__ constexpr int raw_coefs(int w) { return w <= 24 ? 2 : 1; }

template <int W>
__global__ void __launch_bounds__(kThreads, 3)
crt_from_raw_kernel(const uint32_t* __restrict__ raw,
                    const uint32_t* __restrict__ primes,
                    uint32_t* __restrict__ out, int rows, int pnum, int len) {
  constexpr int B = raw_chunk_bits(W), N = raw_chunks(W, B);
  constexpr int S = raw_table_stride(W), C = raw_coefs(W);
  extern __shared__ uint4 s_tab4[];
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(s_tab4);
  const int p0 = blockIdx.z * kPrimeBlock;
  const int np = pnum - p0 < kPrimeBlock ? pnum - p0 : kPrimeBlock;
  for (int i = threadIdx.x; i < np; i += kThreads)
    raw_table_prime<W>(primes[p0 + i], s_tab + i * S);
  __syncthreads();
  const int j = blockIdx.x * kThreads * C + threadIdx.x;
  if (j >= len) return;
  bool in[C];
#pragma unroll
  for (int e = 0; e < C; ++e) in[e] = j + e * kThreads < len;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint32_t* x = raw + (size_t)row * W * len + j;
    uint32_t c[C][N];
#pragma unroll
    for (int e = 0; e < C; ++e) {
      uint32_t w[W];
#pragma unroll
      for (int k = 0; k < W; ++k)
        w[k] = in[e] ? x[(size_t)k * len + e * kThreads] : 0u;
#pragma unroll
      for (int k = 0; k < N; ++k) c[e][k] = raw_chunk<W, B>(w, k);
    }
    uint32_t* o = out + ((size_t)row * pnum + p0) * len + j;
    const uint4* t = reinterpret_cast<const uint4*>(s_tab);
#pragma unroll 1
    for (int i = 0; i < np; ++i, o += len, t += S / 4) {
      uint64_t a0[C], a1[C];  // two chains each; their sum is below 2^32 d
#pragma unroll
      for (int e = 0; e < C; ++e) a0[e] = a1[e] = 0;
#pragma unroll
      for (int k = 0; k < N; k += 4) {
        const uint4 cv = t[k / 4];
#pragma unroll
        for (int e = 0; e < C; ++e) {
          a0[e] = mad_wide(c[e][k], cv.x, a0[e]);
          if (k + 1 < N) a1[e] = mad_wide(c[e][k + 1], cv.y, a1[e]);
          if (k + 2 < N) a0[e] = mad_wide(c[e][k + 2], cv.z, a0[e]);
          if (k + 3 < N) a1[e] = mad_wide(c[e][k + 3], cv.w, a1[e]);
        }
      }
      const uint4 dv = t[S / 4 - 1];
#pragma unroll
      for (int e = 0; e < C; ++e)
        if (in[e])
          o[e * kThreads] = div_2by1(a0[e] + a1[e], dv.x, dv.y) >> dv.z;
    }
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

// Combine: the summed halves [rows, W, len] rippled into words, T = sum_w
// (lo_w + 2^16 hi_w) 2^(32 w) = top 2^(32 W) + s (top the signed carry out
// of the last word, |top| <= 2^15 + 1), then the plain version's rounds =
// max(1, n_shards - 1) conditional subtracts of M, each taken where top > 0
// or s >= M.  Their result is s - k M mod 2^(32 W) with
//   k = min(floor(T' / M), rounds),  T' = max(top, 0) 2^(32 W) + s
// (for top < 0 a subtract leaves top alone, so only s counts), and k comes
// from a quotient estimate instead of up to 32766 rounds:
//   * with L the bit length of M, M_t = floor(M 2^32 / 2^L), its top 32 bits
//     (2^31 <= M_t < 2^32), and T_t = floor(T' 2^32 / 2^L) saturated at 2^48,
//     the estimate q = floor(T_t / (M_t + 1)) (one 2/1 division by the
//     block's reciprocal) is floor(T' / M) or one less while T_t < 2^48, and
//     T_t >= 2^48 means floor(T' / M) >= 2^16 > rounds;
//   * k = min(q, rounds); one pass subtracts k M from (top, s); where k <
//     rounds and what is left is still at least M, one more subtract.
// M = 0 (L = 0) subtracts nothing, as the plain version.  The words are u32
// with a 32-bit carry chain; only the ripple's sum and the estimate are 64
// bits wide.  W is a template parameter, so every word is a register; a
// thread owns one coefficient and loads its 2 W halves at once, and the
// launch bounds keep the registers at 64 (up to 24 words: 4 blocks an SM).
template <int W>
__global__ void __launch_bounds__(kThreads, W <= 24 ? 4 : 2)
icrt_combine16_kernel(const int32_t* __restrict__ lo16,
                      const int32_t* __restrict__ hi16,
                      const uint32_t* __restrict__ m_words,
                      uint32_t* __restrict__ out, int rows, int len,
                      int rounds) {
  __shared__ uint32_t s_m[W];
  __shared__ uint32_t s_est[3];  // L, M_t + 1, its reciprocal
  for (int i = threadIdx.x; i < W; i += kThreads) s_m[i] = m_words[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int top = W - 1;
    while (top > 0 && !s_m[top]) --top;
    const int lead = 32 - __clz(s_m[top]);  // bits of M's top word, 0..32
    const int L = s_m[top] ? 32 * top + lead : 0;
    uint32_t mt = 0;
    if (L) {
      mt = s_m[top] << (32 - lead);
      if (top && lead < 32) mt |= s_m[top - 1] >> lead;
    }
    s_est[0] = (uint32_t)L;
    s_est[1] = mt + 1;  // 0 for M_t = 2^32 - 1: a divisor of 2^32
    s_est[2] = mt + 1 ? (uint32_t)(~0ull / (mt + 1)) : 0;
  }
  __syncthreads();
  const int L = (int)s_est[0];
  const uint32_t md = s_est[1], mv = s_est[2];
  const int wi = L / 32, sh = L % 32;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= len) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t base = (size_t)row * W * len + j;
    const int32_t* pl = lo16 + base;
    const int32_t* ph = hi16 + base;
    int32_t lo[W], hi[W];
#pragma unroll
    for (int w = 0; w < W; ++w, pl += len, ph += len) {
      lo[w] = *pl;
      hi[w] = *ph;
    }
    uint32_t s[W];
    int32_t carry = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int64_t t = (int64_t)lo[w] + (int64_t)hi[w] * 65536 + carry;
      s[w] = (uint32_t)t;
      carry = (int32_t)(t >> 32);
    }
    const uint32_t top = carry > 0 ? (uint32_t)carry : 0u;
    // the window of T' 2^32 at bit L: words e[wi], e[wi + 1], e[wi + 2] of
    // e = (0, s[0], .., s[W - 1], top, 0), and whether a higher one is set
    uint32_t x0 = 0, x1 = 0, x2 = 0, above = 0;
#pragma unroll
    for (int i = 1; i <= W + 1; ++i) {
      const uint32_t e = i <= W ? s[i - 1] : top;
      x0 = i == wi ? e : x0;
      x1 = i == wi + 1 ? e : x1;
      x2 = i == wi + 2 ? e : x2;
      above |= i > wi + 2 ? e : 0u;
    }
    const uint64_t a = ((uint64_t)x2 << 32) | x1;
    uint32_t k = 0;
    if (L) {
      if (above || (a >> (16 + sh))) {
        k = (uint32_t)rounds;
      } else {
        // T_t < 2^48, so T_t / (M_t + 1) is a 2/1 division (or a shift)
        const uint64_t tt = (a << (32 - sh)) | (x0 >> sh);
        uint32_t q = (uint32_t)(tt >> 32);
        if (md) div_2by1(tt, md, mv, &q);
        k = q < (uint32_t)rounds ? q : (uint32_t)rounds;
      }
    }
    // (top', s) = T' - k M
    uint32_t pc = 0, borrow = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t p = (uint64_t)k * s_m[w] + pc;
      pc = (uint32_t)(p >> 32);
      const uint64_t d = (uint64_t)s[w] - (uint32_t)p - borrow;
      s[w] = (uint32_t)d;
      borrow = (uint32_t)(d >> 63);
    }
    const int64_t rest = (int64_t)top - pc - borrow;
    if (k < (uint32_t)rounds) {  // k may be one short: subtract M once more
      borrow = 0;                // where (rest, s) >= M
#pragma unroll
      for (int w = 0; w < W; ++w)
        borrow = (uint32_t)(((uint64_t)s[w] - s_m[w] - borrow) >> 63);
      if (rest > 0 || !borrow) {
        borrow = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const uint64_t t = (uint64_t)s[w] - s_m[w] - borrow;
          s[w] = (uint32_t)t;
          borrow = (uint32_t)(t >> 63);
        }
      }
    }
    uint32_t* o = out + base;
#pragma unroll
    for (int w = 0; w < W; ++w, o += len) *o = s[w];
  }
}

// Every width 1..32 of K5 and K8 (kMaxWords, ops/crt.py MAX_WORDS).
#define CUHE_CRT_WIDTHS(X)                                                   \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)      \
  X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24) X(25)   \
  X(26) X(27) X(28) X(29) X(30) X(31) X(32)

// Launch K5 at `words`.
cudaError_t crt_from_raw_dispatch(const uint32_t* raw, const uint32_t* primes,
                                  uint32_t* out, int rows, int words,
                                  int pnum, int len, cudaStream_t stream) {
  const int np = pnum < kPrimeBlock ? pnum : kPrimeBlock;
#define CUHE_K5_WIDTH(w)                                                    \
  case w: {                                                                 \
    const int span = kThreads * raw_coefs(w);                               \
    const dim3 grid((len + span - 1) / span, grid_y(rows),                  \
                    (pnum + kPrimeBlock - 1) / kPrimeBlock);                \
    crt_from_raw_kernel<w><<<grid, kThreads,                                \
                             (size_t)np * raw_table_stride(w) * 4,          \
                             stream>>>(raw, primes, out, rows, pnum, len);   \
    return cudaGetLastError();                                              \
  }
  switch (words) { CUHE_CRT_WIDTHS(CUHE_K5_WIDTH) }
#undef CUHE_K5_WIDTH
  return cudaErrorInvalidValue;
}

// Launch K8's combine at `words`.
cudaError_t icrt_combine16_dispatch(const int32_t* lo16, const int32_t* hi16,
                                    const uint32_t* m_words, uint32_t* out,
                                    int rows, int words, int len, int rounds,
                                    cudaStream_t stream) {
  const dim3 grid((len + kThreads - 1) / kThreads, grid_y(rows));
#define CUHE_K8_WIDTH(w)                                                    \
  case w:                                                                   \
    icrt_combine16_kernel<w><<<grid, kThreads, 0, stream>>>(                \
        lo16, hi16, m_words, out, rows, len, rounds);                       \
    return cudaGetLastError();
  switch (words) { CUHE_CRT_WIDTHS(CUHE_K8_WIDTH) }
#undef CUHE_K8_WIDTH
  return cudaErrorInvalidValue;
}

#undef CUHE_CRT_WIDTHS

}  // namespace

extern "C" {

// raw: u32 [rows, words, len]; primes: u32 [pnum]; out: u32 [rows, pnum,
// len]; 1 <= words <= 32.
int cuhe_crt_from_raw(const uint32_t* raw, const uint32_t* primes,
                      uint32_t* out, int rows, int words, int pnum, int len,
                      cudaStream_t stream) {
  if (rows <= 0 || words < 1 || words > kMaxWords || pnum <= 0 || len <= 0 ||
      (pnum + kPrimeBlock - 1) / kPrimeBlock > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  return (int)crt_from_raw_dispatch(raw, primes, out, rows, words, pnum, len,
                                    stream);
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
// [rows, words, len]; 1 <= words <= 32, 1 <= n_shards < 2^15.
int cuhe_icrt_combine16(const int32_t* lo16, const int32_t* hi16,
                        const uint32_t* m_words, uint32_t* out, int rows,
                        int words, int len, int n_shards,
                        cudaStream_t stream) {
  if (rows <= 0 || words < 1 || words > kMaxWords || len <= 0 ||
      n_shards < 1 || n_shards >= 1 << 15)
    return (int)cudaErrorInvalidValue;
  return (int)icrt_combine16_dispatch(lo16, hi16, m_words, out, rows, words,
                                      len, n_shards > 2 ? n_shards - 1 : 1,
                                      stream);
}

}  // extern "C"
