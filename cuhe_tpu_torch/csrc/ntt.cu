// Forward and inverse length-n NTT over Z_P, P = 2^64 - 2^32 + 1.
//
// Replaces the TPU kernels
//   cuhe_tpu/ops/ntt_kernels.py::_fwd_call        (forward, B1)
//   cuhe_tpu/ops/ntt_kernels.py::_fwd_digits_call (windowed-digit forward, B6)
//   cuhe_tpu/ops/ntt_kernels.py::_inv_call        (inverse + mod-p epilogue, B2)
// which evaluate each four-step stage as int8 digit matmuls on the MXU.  The
// card has native 64-bit integer multiplies, so here each stage is a
// radix-2 butterfly network over Goldilocks words in shared memory.
//
// Four-step with the JAX package's factorization n = n1 * n2
// (ntt_kernels._FACTORS): coefficient j = j1 * n2 + j2, NTT index
// k = k1 + n1 * k2, and
//   forward: B[k1,j2] = sum_j1 x[j1,j2] w^(n2 j1 k1)   (column pass, j1 < n1/2)
//            C = B * w^(k1 j2)
//            D[k1,k2] = sum_j2 C[k1,j2] w^(n1 j2 k2)   (row pass)
// so D lands at k1 * n2 + k2: the mat-linear layout, with no transpose.
//   inverse: A[k1,t2] = sum_k2 X[k1,k2] w^-(n1 k2 t2) (row pass), * w^-(k1 t2)
//            Y[t1,t2] = n^-1 sum_k1 A[k1,t2] w^-(n2 k1 t1) (column pass),
//            then mod p of the transform, at natural index t1 * n2 + t2.
//
// What bounds it: the function moves 10 to 12 bytes per coefficient and
// needs fewer than two 64x64->128 products per coefficient (radix-64
// passes, whose inner DFTs need only shifts because every 64th root of unity
// mod P is a power of two), so its least time is set by device memory.  This
// simple kernel does (log2 n)/2 generic Goldilocks butterflies per
// coefficient instead, so its own integer work holds it above that.  It
// keeps every stage's data in shared memory (one 32 KB tile per block, so 7
// blocks fit an SM) and touches device memory once per pass: two reads and
// two writes of each coefficient per transform.  Twiddles come from one
// power table per direction (w^e, e < n), read through the read-only cache.
//
// Stop points.  Each pass takes a compile-time STOP (enum Stop below); the
// transforms instantiate kFull, and the per-pass probes
// (cuhe_tpu_torch/probes/ablate.py, the counterparts of the TPU stage
// ablations scripts/tpu_probe_inv_ablate.py and tpu_probe_fwd32_ablate.py)
// launch the same kernels stopped earlier, so a probe times exactly the code
// the transforms run, up to its stop point.

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLogTile = 12;  // 4096 words = 32 KB of shared memory per block
constexpr int kSmemBytes = (1 << kLogTile) * 8;

// Where a pass stops.  kIo: load and store only (with the load's bit-reversal
// permutation).  kNoEpilogue: the pass's DFTs without its epilogue, which is
// the twiddle multiply of the forward column and inverse row passes and the
// mod p of the inverse column pass (whose n^-1 multiply stays).  kFull: the
// whole pass.
enum Stop { kIo = 0, kNoEpilogue = 1, kFull = 2 };

__device__ __forceinline__ int bitrev(int v, int bits) {
  return (int)(__brev((unsigned)v) >> (32 - bits));
}

// In-place radix-2 DIT over 2^logcnt sequences of length L = 2^logL held in
// shared memory; element i of sequence c is at s[i * si + c * sc].  Input in
// bit-reversed order, output in natural order.  pw[e] = w^e for the length-n
// root (n = 2^logn), so the stage of length len uses root pw[n / len].
// CNT_FAST: neighbouring threads take neighbouring sequences (column tiles,
// sc = 1); otherwise neighbouring butterflies of one sequence (rows, si = 1).
template <bool CNT_FAST>
__device__ void smem_dft(uint64_t* s, int logL, int logcnt, int si, int sc,
                         const uint64_t* __restrict__ pw, int logn) {
  const int nbf = 1 << (logL - 1 + logcnt);
  const int bmask = (1 << (logL - 1)) - 1;
  const int cmask = (1 << logcnt) - 1;
  for (int lg = 1; lg <= logL; ++lg) {
    const int half = 1 << (lg - 1);
    for (int t = threadIdx.x; t < nbf; t += blockDim.x) {
      int c, b;
      if (CNT_FAST) {
        c = t & cmask;
        b = t >> logcnt;
      } else {
        b = t & bmask;
        c = t >> (logL - 1);
      }
      const int j = b & (half - 1);
      const int i0 = ((b >> (lg - 1)) << lg) + j;
      uint64_t* p0 = s + i0 * si + c * sc;
      uint64_t* p1 = p0 + half * si;
      const uint64_t u = *p0;
      const uint64_t v = gl_mul(*p1, ldg64(pw + ((size_t)j << (logn - lg))));
      *p0 = gl_add(u, v);
      *p1 = gl_sub(u, v);
    }
    __syncthreads();
  }
}

// Forward column pass for transform blockIdx.x and the column tile
// blockIdx.y: length-n1 DFTs over j1 (rows j1 >= n1/2 are zero), times
// w^(k1 j2), stored at [k1, j2] of the output planes.
// DIGIT: the input is the w-bit window at bit w * (j0 + digit) of RAW words
// [batch, w32, n/2] (ntt_1_*_ext_block semantics: planes past the top word
// read zero, no high-word bits at shift 0); transform = digit * batch + b.
template <bool DIGIT, int STOP>
__global__ void __launch_bounds__(kThreads)
fwd_cols(const uint32_t* __restrict__ x, uint32_t* __restrict__ out_lo,
         uint32_t* __restrict__ out_hi, const uint64_t* __restrict__ pw,
         int logn1, int logn2, int batch, int w32, int w, int j0) {
  extern __shared__ uint64_t s[];
  const int logtc = kLogTile - logn1;
  const int tc = 1 << logtc;
  const int n1 = 1 << logn1, n2 = 1 << logn2, logn = logn1 + logn2;
  const size_t n = (size_t)1 << logn, half = n >> 1;
  const int t = blockIdx.x;
  const int c0 = blockIdx.y << logtc;

  const uint32_t* src = nullptr;
  const uint32_t* src_hi = nullptr;
  int sh = 0;
  uint32_t mask = 0xFFFFFFFFu;
  if (DIGIT) {
    const int b = t % batch, digit = t / batch;
    const int bit = w * (j0 + digit);
    const int k = bit >> 5;
    sh = bit & 31;
    mask = w < 32 ? (1u << w) - 1u : 0xFFFFFFFFu;
    if (k < w32) src = x + ((size_t)b * w32 + k) * half;
    if (sh && k + 1 < w32) src_hi = x + ((size_t)b * w32 + k + 1) * half;
  } else {
    src = x + (size_t)t * half;
  }

  for (int idx = threadIdx.x; idx < (n1 << logtc); idx += blockDim.x) {
    const int r = idx >> logtc, cc = idx & (tc - 1);
    uint64_t v = 0;
    if (r < (n1 >> 1)) {
      const size_t off = (size_t)r * n2 + c0 + cc;
      if (DIGIT) {
        uint32_t val = src ? src[off] >> sh : 0u;
        if (src_hi) val |= src_hi[off] << (32 - sh);
        v = val & mask;
      } else {
        v = src[off];
      }
    }
    s[(bitrev(r, logn1) << logtc) + cc] = v;
  }
  __syncthreads();
  if constexpr (STOP != kIo) smem_dft<true>(s, logn1, logtc, tc, 1, pw, logn);

  const size_t ob = (size_t)t * n;
  for (int idx = threadIdx.x; idx < (n1 << logtc); idx += blockDim.x) {
    const int k1 = idx >> logtc, j2 = c0 + (idx & (tc - 1));
    uint64_t v = s[idx];
    if constexpr (STOP == kFull)
      v = gl_mul(v, ldg64(pw + ((k1 * j2) & (n - 1))));
    gl_store(out_lo, out_hi, ob + (size_t)k1 * n2 + j2, v);
  }
}

// Row pass over 4096 / n2 consecutive rows (tile blockIdx.y) of transform
// blockIdx.x: length-n2 DFTs along each row.
// !INV: forward stage 2, in place on the planes.
// INV: inverse stage 1 (pw holds w^-e), times w^-(k1 t2), into u64 scratch.
template <bool INV, int STOP>
__global__ void __launch_bounds__(kThreads)
ntt_rows(const uint32_t* in_lo, const uint32_t* in_hi, uint32_t* out_lo,
         uint32_t* out_hi, uint64_t* out64, const uint64_t* __restrict__ pw,
         int logn1, int logn2) {
  extern __shared__ uint64_t s[];
  const int logr = kLogTile - logn2;
  const int n2 = 1 << logn2, logn = logn1 + logn2;
  const size_t n = (size_t)1 << logn;
  const int r0 = blockIdx.y << logr;
  const size_t base = (size_t)blockIdx.x * n + ((size_t)r0 << logn2);

  for (int idx = threadIdx.x; idx < (1 << kLogTile); idx += blockDim.x) {
    const int r = idx >> logn2, j = idx & (n2 - 1);
    s[(r << logn2) + bitrev(j, logn2)] = gl_load(in_lo, in_hi, base + idx);
  }
  __syncthreads();
  if constexpr (STOP != kIo) smem_dft<false>(s, logn2, logr, 1, n2, pw, logn);

  for (int idx = threadIdx.x; idx < (1 << kLogTile); idx += blockDim.x) {
    if (INV) {
      const int k1 = r0 + (idx >> logn2), t2 = idx & (n2 - 1);
      uint64_t v = s[idx];
      if constexpr (STOP == kFull)
        v = gl_mul(v, ldg64(pw + ((k1 * t2) & (n - 1))));
      out64[base + idx] = v;
    } else {
      gl_store(out_lo, out_hi, base + idx, s[idx]);
    }
  }
}

// Inverse column pass: length-n1 DFTs over k1 of the scratch, times n^-1,
// reduced mod p[transform], written at natural index t1 * n2 + t2.
// kNoEpilogue: without the mod p, the canonical value's words into out and
// out_hi.
template <int STOP>
__global__ void __launch_bounds__(kThreads)
inv_cols(const uint64_t* __restrict__ a, uint32_t* __restrict__ out,
         uint32_t* __restrict__ out_hi, const uint32_t* __restrict__ p,
         const uint64_t* __restrict__ pwi, int logn1, int logn2) {
  extern __shared__ uint64_t s[];
  const int logtc = kLogTile - logn1;
  const int tc = 1 << logtc;
  const int n1 = 1 << logn1, n2 = 1 << logn2, logn = logn1 + logn2;
  const size_t n = (size_t)1 << logn;
  const int t = blockIdx.x;
  const int c0 = blockIdx.y << logtc;
  const size_t base = (size_t)t * n;

  for (int idx = threadIdx.x; idx < (n1 << logtc); idx += blockDim.x) {
    const int k1 = idx >> logtc, cc = idx & (tc - 1);
    s[(bitrev(k1, logn1) << logtc) + cc] = a[base + (size_t)k1 * n2 + c0 + cc];
  }
  __syncthreads();
  if constexpr (STOP != kIo) smem_dft<true>(s, logn1, logtc, tc, 1, pwi, logn);

  // n^-1 = P - (P - 1) / n for n a power of two
  const uint64_t ninv = GL_P - ((GL_P - 1) >> logn);
  const uint64_t pt = STOP == kFull ? p[t] : 0;
  for (int idx = threadIdx.x; idx < (n1 << logtc); idx += blockDim.x) {
    const int t1 = idx >> logtc, t2 = c0 + (idx & (tc - 1));
    const size_t o = base + (size_t)t1 * n2 + t2;
    if constexpr (STOP == kFull) {
      out[o] = (uint32_t)(gl_mul(s[idx], ninv) % pt);
    } else {
      gl_store(out, out_hi, o, gl_mul(s[idx], ninv));
    }
  }
}

// One launch of each pass over `count` transforms.
template <bool DIGIT, int STOP>
cudaError_t launch_cols(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                        const uint64_t* pw, int count, int logn1, int logn2,
                        int batch, int w32, int w, int j0,
                        cudaStream_t stream) {
  const dim3 g(count, 1 << (logn2 - (kLogTile - logn1)));
  fwd_cols<DIGIT, STOP><<<g, kThreads, kSmemBytes, stream>>>(
      x, lo, hi, pw, logn1, logn2, batch, w32, w, j0);
  return cudaGetLastError();
}

template <bool INV, int STOP>
cudaError_t launch_rows(const uint32_t* in_lo, const uint32_t* in_hi,
                        uint32_t* out_lo, uint32_t* out_hi, uint64_t* out64,
                        const uint64_t* pw, int count, int logn1, int logn2,
                        cudaStream_t stream) {
  const dim3 g(count, 1 << (logn1 - (kLogTile - logn2)));
  ntt_rows<INV, STOP><<<g, kThreads, kSmemBytes, stream>>>(
      in_lo, in_hi, out_lo, out_hi, out64, pw, logn1, logn2);
  return cudaGetLastError();
}

template <int STOP>
cudaError_t launch_inv_cols(const uint64_t* a, uint32_t* out,
                            uint32_t* out_hi, const uint32_t* p,
                            const uint64_t* pwi, int count, int logn1,
                            int logn2, cudaStream_t stream) {
  const dim3 g(count, 1 << (logn2 - (kLogTile - logn1)));
  inv_cols<STOP><<<g, kThreads, kSmemBytes, stream>>>(a, out, out_hi, p, pwi,
                                                      logn1, logn2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuhe_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x: u32 [count, n/2] -> lo, hi: u32 [count, n] mat-linear.
int cuhe_ntt_fwd(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                 const uint64_t* pw, int count, int logn1, int logn2,
                 cudaStream_t stream) {
  cudaError_t e = launch_cols<false, kFull>(x, lo, hi, pw, count, logn1,
                                            logn2, 1, 0, 0, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_rows<false, kFull>(lo, hi, lo, hi, nullptr, pw, count,
                                        logn1, logn2, stream);
}

// raw: u32 [batch, w32, n/2] -> lo, hi: u32 [c, batch, n] mat-linear NTTs of
// digits j0 .. j0 + c - 1.
int cuhe_ntt_fwd_digits(const uint32_t* raw, uint32_t* lo, uint32_t* hi,
                        const uint64_t* pw, int batch, int w32, int w, int j0,
                        int c, int logn1, int logn2, cudaStream_t stream) {
  const int count = c * batch;
  cudaError_t e = launch_cols<true, kFull>(raw, lo, hi, pw, count, logn1,
                                           logn2, batch, w32, w, j0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_rows<false, kFull>(lo, hi, lo, hi, nullptr, pw, count,
                                        logn1, logn2, stream);
}

// x_lo, x_hi: u32 [count, n] mat-linear; scratch: u64 [count, n];
// p: u32 [count] -> out: u32 [count, n] natural order, mod p.
int cuhe_ntt_inv_modcrt(const uint32_t* x_lo, const uint32_t* x_hi,
                        uint64_t* scratch, uint32_t* out, const uint32_t* p,
                        const uint64_t* pwi, int count, int logn1, int logn2,
                        cudaStream_t stream) {
  cudaError_t e = launch_rows<true, kFull>(x_lo, x_hi, nullptr, nullptr,
                                           scratch, pwi, count, logn1, logn2,
                                           stream);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_inv_cols<kFull>(scratch, out, nullptr, p, pwi, count,
                                     logn1, logn2, stream);
}

// The passes one at a time, for the per-pass probes (probes/ablate.py).
// Forward column pass, x: u32 [count, n/2] -> lo, hi: u32 [count, n] at
// [k1, j2]: load and store only, the DFTs without the twiddle, or the whole
// pass (the first launch of cuhe_ntt_fwd).
int cuhe_ntt_cols_io(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                     const uint64_t* pw, int count, int logn1, int logn2,
                     cudaStream_t stream) {
  return (int)launch_cols<false, kIo>(x, lo, hi, pw, count, logn1, logn2, 1,
                                      0, 0, 0, stream);
}

int cuhe_ntt_cols_notw(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                       const uint64_t* pw, int count, int logn1, int logn2,
                       cudaStream_t stream) {
  return (int)launch_cols<false, kNoEpilogue>(x, lo, hi, pw, count, logn1,
                                              logn2, 1, 0, 0, 0, stream);
}

int cuhe_ntt_cols(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                  const uint64_t* pw, int count, int logn1, int logn2,
                  cudaStream_t stream) {
  return (int)launch_cols<false, kFull>(x, lo, hi, pw, count, logn1, logn2,
                                        1, 0, 0, 0, stream);
}

// Forward row pass (the second launch of cuhe_ntt_fwd), out of place:
// in_lo, in_hi -> out_lo, out_hi, all u32 [count, n].
int cuhe_ntt_rows(const uint32_t* in_lo, const uint32_t* in_hi,
                  uint32_t* out_lo, uint32_t* out_hi, const uint64_t* pw,
                  int count, int logn1, int logn2, cudaStream_t stream) {
  return (int)launch_rows<false, kFull>(in_lo, in_hi, out_lo, out_hi,
                                        nullptr, pw, count, logn1, logn2,
                                        stream);
}

// Inverse row pass, x_lo, x_hi: u32 [count, n] mat-linear -> out: u64
// [count, n]: load and store only, or the whole pass (the first launch of
// cuhe_ntt_inv_modcrt).
int cuhe_ntt_rows_io(const uint32_t* x_lo, const uint32_t* x_hi,
                     uint64_t* out, const uint64_t* pwi, int count, int logn1,
                     int logn2, cudaStream_t stream) {
  return (int)launch_rows<true, kIo>(x_lo, x_hi, nullptr, nullptr, out, pwi,
                                     count, logn1, logn2, stream);
}

int cuhe_ntt_inv_rows(const uint32_t* x_lo, const uint32_t* x_hi,
                      uint64_t* out, const uint64_t* pwi, int count,
                      int logn1, int logn2, cudaStream_t stream) {
  return (int)launch_rows<true, kFull>(x_lo, x_hi, nullptr, nullptr, out, pwi,
                                       count, logn1, logn2, stream);
}

// Inverse column pass, a: u64 [count, n] -> lo, hi: u32 [count, n] without
// the mod p, or out: u32 [count, n] mod p[count] (the second launch of
// cuhe_ntt_inv_modcrt).
int cuhe_ntt_inv_nomod(const uint64_t* a, uint32_t* lo, uint32_t* hi,
                       const uint64_t* pwi, int count, int logn1, int logn2,
                       cudaStream_t stream) {
  return (int)launch_inv_cols<kNoEpilogue>(a, lo, hi, nullptr, pwi, count,
                                           logn1, logn2, stream);
}

int cuhe_ntt_inv_cols(const uint64_t* a, uint32_t* out, const uint32_t* p,
                      const uint64_t* pwi, int count, int logn1, int logn2,
                      cudaStream_t stream) {
  return (int)launch_inv_cols<kFull>(a, out, nullptr, p, pwi, count, logn1,
                                     logn2, stream);
}

}  // extern "C"
