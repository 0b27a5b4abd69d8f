// Forward and inverse length-n NTT over Z_P, P = 2^64 - 2^32 + 1.
//
// Replaces the TPU kernels
//   cuhe_tpu/ops/ntt_kernels.py::_fwd_call        (forward, B1)
//   cuhe_tpu/ops/ntt_kernels.py::_fwd_digits_call (windowed-digit forward, B6)
//   cuhe_tpu/ops/ntt_kernels.py::_inv_call        (inverse + mod-p epilogue, B2)
// which evaluate each four-step stage as int8 digit matmuls on the MXU, the
// TPU having no 64-bit multiplier.  The card has one, so here every stage
// works on whole Goldilocks words in registers.
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
// What bounds it.  The function moves 10 to 12 bytes per coefficient and
// needs under two 64x64->128 products per coefficient, so its least time is
// set by device memory.  What holds it is its load and store and, on top
// of them with little overlap at the 3-6 blocks per SM that registers and
// tiles allow, its integer work: the stop points show the load and store
// at 1.5-2.3x the byte bound and each DFT pass at 1.8-4.2x (PERF.md,
// section 6, on an NVIDIA H100 80GB HBM3 at 700.00 W).  The design cuts the
// integer work as far as it does:
//  * Every pass's length-L DFT (L = n1 or n2, 128 or 256) splits as 16 x M,
//    M = L / 16.  A thread holds one length-16 sub-sequence in registers and
//    runs its DFT as a radix-2 network whose roots are powers of two (every
//    64th root of unity mod P is one: w^(n/64) = 2^3, its inverse 2^189), so
//    each butterfly is an add, a subtract and a shift with the folds
//    2^64 = 2^32 - 1 and 2^96 = -1.  Then the inner twiddle w_L^(a kb): a
//    shift where L/64 divides a kb, else one generic product (0.5 per
//    coefficient at L = 256, 0.25 at 128).  One shared-memory exchange, and
//    a second thread holds a length-M sub-sequence for the second DFT.  The
//    four-step twiddle w^(k1 j2) of the forward column pass and the inverse
//    row pass is applied after the second DFT, each thread's M factors by a
//    recurrence from two table loads (a scattered load per element cost
//    more than the second product); n^-1 = 2^-log2(n) folds into the inner
//    twiddles of the inverse column pass.  The shifts are compile-time and
//    fixed by the direction (kShift64): w^(n/64) = NTT_GEN^1024 = 2^3 at
//    every n, its inverse 2^189; the front ends derive the shift on the
//    host and check it against these before each launch
//    (ops/ntt_kernels.py::check_root_shift).
//  * Column tiles are 32 columns wide, so each warp moves 128-byte
//    segments of a u32 plane (256 of a u64 one) straight between device
//    memory and registers, and a transform's tiles are neighbouring blocks;
//    the row pass moves its tile with 16-byte vector loads and stores on
//    each plane.
//  * The inverse column pass reduces mod p by Barrett (mod_p32), with one
//    division per block for its constant.
//  * The forward transforms run each pass over all their transforms at
//    once: chunks small enough for the intermediate to stay in L2 measured
//    slower (PERF.md, section 6), since the passes are not held by device
//    memory and a small chunk fills the card for about one wave.  Only the
//    inverse runs its passes chunk by chunk, so that its u64 scratch holds
//    one chunk (the front end's, 256 MiB).
// The tensor cores are not used: a 64-bit product is 64 int8 products, so a
// length-16 stage as a dense matrix costs ~2,000 int8 operations per
// coefficient where the shift-only radix-16 DFT costs a few dozen integer
// operations.
//
// Stop points.  Each pass takes a compile-time STOP (enum Stop below); the
// transforms instantiate kFull, and the per-pass probes
// (cuhe_tpu_torch/probes/ablate.py, the counterparts of the TPU stage
// ablations scripts/tpu_probe_inv_ablate.py and tpu_probe_fwd32_ablate.py)
// launch the same kernels stopped earlier, so a probe times exactly the code
// the transforms run, up to its stop point.

#include <cuda_runtime.h>

#include <type_traits>

#include "goldilocks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLogTile = 5;
// column passes: one warp spans the tile; row pass: a warp's lanes are rows
constexpr int kTileCols = 1 << kLogTile;
constexpr int kTileRows = 1 << kLogTile;
// The row tile: kTileRows rows of W words, element j of row r at at(r, j);
// the one word of padding puts a warp's 32 rows in distinct banks.
template <int LOGL>
struct RowTile {
  static constexpr int W = (1 << LOGL) + 1;
  static __device__ __forceinline__ int at(int r, int j) { return r * W + j; }
};

// the most dynamic shared memory any pass asks for (L = 256): the column
// tile 256 x 32 words, the row tile 32 x W words
constexpr int kMaxSmem = kTileRows * RowTile<8>::W * 8;

// Where a pass stops.  kIo: load and store only (with the load's bit-reversal
// permutation).  kNoEpilogue: the pass's DFTs without its epilogue, which is
// the twiddle multiply of the forward column and inverse row passes and the
// mod p of the inverse column pass (whose n^-1 multiply stays).  kFull: the
// whole pass.
enum Stop { kIo = 0, kNoEpilogue = 1, kFull = 2 };

template <int V>
using Int = std::integral_constant<int, V>;

// The shift s with 2^s = w^(n/64) for the forward passes and w^-(n/64) for
// the inverse ones: w^(n/64) = NTT_GEN^(65536/64) = 2^3 mod P at every n.
template <bool INV>
constexpr int kShift64 = INV ? 189 : 3;

__device__ __forceinline__ int bitrev(int v, int bits) {
  return (int)(__brev((unsigned)v) >> (32 - bits));
}

// bitrev(v, bits) for bits <= 4 without a loop, so that it folds to a
// constant where v is one (register indices after unrolling).
__host__ __device__ constexpr int bitrev_c(int v, int bits) {
  return (((v & 1) << 3) | ((v & 2) << 1) | ((v >> 1) & 2) | ((v >> 3) & 1)) >>
         (4 - bits);
}

// One level of a radix-2 DIF network over R words: butterflies of span H
// in blocks of 2H, with the root 2^S of order R.  FIRST_HALF_ZERO: the
// upper half is zero on entry (only at H = R/2).  One loop of constant
// trip count, so that it unrolls and v stays in registers.
template <int R, int S, int H, bool FIRST_HALF_ZERO>
__device__ __forceinline__ void dif_level(uint64_t (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int j = i % H, lo = (i / H) * 2 * H + j;
    const int s = (S * (R / (2 * H)) * j) % 192;
    if (FIRST_HALF_ZERO) {
      v[lo + H] = gl_mul_pow2(v[lo], s);
    } else {
      // (u - t) 2^s = (t - u) 2^(s - 96) for s >= 96: no negation
      const uint64_t u = v[lo], t = v[lo + H];
      v[lo] = gl_add(u, t);
      v[lo + H] = s >= 96 ? gl_mul_pow2(gl_sub(t, u), s - 96)
                          : gl_mul_pow2(gl_sub(u, t), s);
    }
  }
}

// In-place radix-2 DIF DFT of the R = 2^LOGR words v with the root 2^S (an
// R-th root of unity): natural order in, bit-reversed order out.  HALF_ZERO:
// v[R/2 ..] are zero on entry, so the first level is v[i + R/2] = v[i] 2^(S i).
template <int LOGR, int S, bool HALF_ZERO, int H = (1 << LOGR) / 2>
__device__ __forceinline__ void dft_regs(uint64_t (&v)[1 << LOGR]) {
  dif_level<1 << LOGR, S, H, HALF_ZERO && H == (1 << LOGR) / 2>(v);
  if constexpr (H > 1) dft_regs<LOGR, S, HALF_ZERO, H / 2>(v);
}

// x * w_L^(a kb) * 2^extra for the length-L root w_L = w^(n/L), whose power
// w_L^(L/64) is w^(n/64) = 2^S64: w_L^e is the shift S64 e / (L/64) where
// L/64 divides e, else a product with pw[(n/L) e].  a is the same across a
// warp, so the branch is too.
template <int LOGL, int S64>
__device__ __forceinline__ uint64_t inner_twiddle(uint64_t x, int a, int kb,
                                                  const uint64_t* pw, int logn,
                                                  int extra) {
  constexpr int L = 1 << LOGL, SUB = L / 64;
  const int e = (a * kb) & (L - 1);
  if (e & (SUB - 1)) {
    x = gl_mul(x, ldg64(pw + ((size_t)e << (logn - LOGL))));
    return extra ? gl_mul_pow2(x, extra) : x;
  }
  return gl_mul_pow2(x, (S64 * (e / SUB) + extra) % 192);
}

// ---------------------------------------------------------------------------
// column passes
//
// A block takes kTileCols neighbouring columns (of one transform, where a
// transform holds at least that many); the tiles of a transform are
// neighbouring blocks, so the blocks in flight together cover
// whole rows of device memory.  Stage 1: warp task a
// (a < M = L/16) holds, in lane cc, the 16 words [a + M jb, cc] of the
// column, read straight from device memory; it runs the length-16 DFT,
// applies the inner twiddles and writes element kb to shared slot kb M + a.
// Stage 2: warp task kb reads slots kb M + a, a < M, runs the length-M DFT,
// and its element ka is output row kb + 16 ka, stored straight to device
// memory.  kIo: stage 1 writes input row r at the slot of output row
// bitrev(r), stage 2 stores without DFTs.
// ---------------------------------------------------------------------------

// Forward column pass of `count` transforms: length-n1 DFTs over j1 (rows
// j1 >= n1/2 are zero), times w^(k1 j2), stored at [k1, jc] of the output
// planes.  Each transform holds C = 2^logc of the n2 columns, j2 = j2_0 +
// jc for jc < C, as [n1/2, C] in and [n1, C] out: all of them (logc =
// logn2, j2_0 = 0), or the column block of a transform split across
// devices (cuhe_tpu_torch/parallel/mesh.py::ntt_fwd_sharded).  Lane `lane`
// of block `blockIdx.x` takes column g = 32 blockIdx.x + lane of the count
// * C; where C < 32 a tile spans 32 / C transforms, and lanes past the last
// transform load zeros and store nothing.
// DIGIT: the input is the w-bit window at bit w * (j0 + digit) of RAW words
// [batch, w32, n/2] (ntt_1_*_ext_block semantics: planes past the top word
// read zero, no high-word bits at shift 0); transform = digit * batch + b.
template <bool DIGIT, int STOP, int LOGL>
__global__ void __launch_bounds__(kThreads)
fwd_cols(const uint32_t* __restrict__ x, uint32_t* __restrict__ out_lo,
         uint32_t* __restrict__ out_hi, const uint64_t* __restrict__ pw,
         int logn2, int logc, int j2_0, int count, int batch, int w32, int w,
         int j0) {
  constexpr int L = 1 << LOGL, M = L >> 4, LOGM = LOGL - 4;
  constexpr int S64 = kShift64<false>;
  extern __shared__ uint64_t s[];
  const int c = 1 << logc, logn = LOGL + logn2;
  const size_t n = (size_t)1 << logn, half = (size_t)c << (LOGL - 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the lane's transform, its column in the block, and in the transform
  const size_t g = ((size_t)blockIdx.x << kLogTile) + lane;
  const int tr = (int)(g >> logc), jc = (int)(g & (c - 1)), j2 = j2_0 + jc;
  const bool live = tr < count;

  const uint32_t* src = nullptr;
  const uint32_t* src_hi = nullptr;
  int sh = 0;
  uint32_t mask = 0xFFFFFFFFu;
  if (live && DIGIT) {
    const int b = tr % batch, digit = tr / batch;
    const int bit = w * (j0 + digit);
    const int k = bit >> 5;
    sh = bit & 31;
    mask = w < 32 ? (1u << w) - 1u : 0xFFFFFFFFu;
    src = k < w32 ? x + ((size_t)b * w32 + k) * half : nullptr;
    if (sh && k + 1 < w32) src_hi = x + ((size_t)b * w32 + k + 1) * half;
  } else if (live) {
    src = x + tr * half;
  }

  // every task's loads are issued before the first DFT, so a warp has 8 or
  // 16 128-byte loads in flight
  constexpr int TASKS = M / kWarps;
  uint32_t in[TASKS][8];
#pragma unroll
  for (int t = 0; t < TASKS; ++t) {
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const size_t off = (size_t)(warp + t * kWarps + M * jb) * c + jc;
      if (DIGIT) {
        uint32_t val = src ? src[off] >> sh : 0u;
        if (src_hi) val |= src_hi[off] << (32 - sh);
        in[t][jb] = val & mask;
      } else {
        in[t][jb] = src ? src[off] : 0u;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < TASKS; ++t) {
    const int a = warp + t * kWarps;
    uint64_t v[16];
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      v[jb] = in[t][jb];
      v[jb + 8] = 0;
    }
    if constexpr (STOP == kIo) {
#pragma unroll
      for (int jb = 0; jb < 16; ++jb) {
        const int k1 = bitrev(a + M * jb, LOGL);
        s[((k1 & 15) * M + (k1 >> 4)) * kTileCols + lane] = v[jb];
      }
    } else {
      dft_regs<4, 4 * S64 % 192, true>(v);
#pragma unroll
      for (int kb = 0; kb < 16; ++kb)
        s[(kb * M + a) * kTileCols + lane] = inner_twiddle<LOGL, S64>(
            v[bitrev_c(kb, 4)], a, kb, pw, logn, 0);
    }
  }
  __syncthreads();
  // stage 2 reads only the lane's own column: a dead lane is done
  if (!live) return;

  const size_t ob = ((size_t)tr << (LOGL + logc)) + jc;
  for (int kb = warp; kb < 16; kb += kWarps) {
    uint64_t v[M];
#pragma unroll
    for (int a = 0; a < M; ++a) v[a] = s[(kb * M + a) * kTileCols + lane];
    if constexpr (STOP != kIo) dft_regs<LOGM, 64 / M * S64 % 192, false>(v);
    // the four-step twiddle w^(k1 j2) of rows k1 = kb + 16 ka, by the
    // recurrence w^(kb j2) (w^(16 j2))^ka: two loads per task rather than
    // one scattered load per element
    uint64_t tw = 0, step = 0;
    if constexpr (STOP == kFull) {
      tw = ldg64(pw + (((size_t)kb * j2) & (n - 1)));
      step = ldg64(pw + (((size_t)16 * j2) & (n - 1)));
    }
#pragma unroll
    for (int ka = 0; ka < M; ++ka) {
      uint64_t val = v[STOP == kIo ? ka : bitrev_c(ka, LOGM)];
      if constexpr (STOP == kFull) {
        val = gl_mul(val, tw);
        if (ka + 1 < M) tw = gl_mul(tw, step);
      }
      gl_store(out_lo, out_hi, ob + (size_t)(kb + 16 * ka) * c, val);
    }
  }
}

// Inverse column pass of transform tr of the chunk: length-n1 DFTs
// over k1 of the u64 scratch, times n^-1 (folded into the inner twiddles),
// reduced mod p[transform], written at natural index t1 * n2 + t2 (out and
// p offset to the chunk by the launcher).  kNoEpilogue: without the mod p,
// the canonical value's words into out and out_hi.
template <int STOP, int LOGL>
__global__ void __launch_bounds__(kThreads)
inv_cols(const uint64_t* __restrict__ a_in, uint32_t* __restrict__ out,
         uint32_t* __restrict__ out_hi, const uint32_t* __restrict__ p,
         const uint64_t* __restrict__ pwi, int logn2) {
  static_assert(STOP != kIo, "the inverse column pass has no kIo variant");
  constexpr int L = 1 << LOGL, M = L >> 4, LOGM = LOGL - 4;
  constexpr int S64 = kShift64<true>;
  extern __shared__ uint64_t s[];
  __shared__ uint64_t mu_s;
  const int n2 = 1 << logn2, logn = LOGL + logn2;
  const size_t n = (size_t)1 << logn;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // block = transform * (n2 / kTileCols) + column tile
  const int tr = blockIdx.x >> (logn2 - kLogTile);
  const int t2 = ((blockIdx.x << kLogTile) & (n2 - 1)) + lane;
  const size_t base = (size_t)tr * n + t2;
  const int ninv = 192 - logn;  // n^-1 = 2^-log2(n)
  if (STOP == kFull && threadIdx.x == 0) mu_s = ~0ull / p[tr];

  for (int a = warp; a < M; a += kWarps) {
    uint64_t v[16];
#pragma unroll
    for (int jb = 0; jb < 16; ++jb)
      v[jb] = a_in[base + (size_t)(a + M * jb) * n2];
    dft_regs<4, 4 * S64 % 192, false>(v);
#pragma unroll
    for (int kb = 0; kb < 16; ++kb)
      s[(kb * M + a) * kTileCols + lane] = inner_twiddle<LOGL, S64>(
          v[bitrev_c(kb, 4)], a, kb, pwi, logn, ninv);
  }
  __syncthreads();

  const uint64_t pt = STOP == kFull ? p[tr] : 0;
  const uint64_t mu = STOP == kFull ? mu_s : 0;
  for (int kb = warp; kb < 16; kb += kWarps) {
    uint64_t v[M];
#pragma unroll
    for (int a = 0; a < M; ++a) v[a] = s[(kb * M + a) * kTileCols + lane];
    dft_regs<LOGM, 64 / M * S64 % 192, false>(v);
#pragma unroll
    for (int ka = 0; ka < M; ++ka) {
      const size_t o = base + (size_t)(kb + 16 * ka) * n2;
      const uint64_t val = v[bitrev_c(ka, LOGM)];
      if constexpr (STOP == kFull) {
        out[o] = mod_p32(val, pt, mu);
      } else {
        gl_store(out, out_hi, o, val);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// row pass
//
// A block takes kTileRows rows of one transform; row r sits at
// s[r * (L + 1) + j], padded by one word so that a warp's 32 rows fall in
// distinct banks.  The tile is loaded with 16-byte loads on each plane.
// Stage 1: task (a, row) reads positions a + M jb, runs the length-16 DFT
// and writes element kb, after its inner twiddle, back to position a + M kb
// (the positions it read).  Stage 2: task (kb, row) reads positions
// kb M + a, runs the length-M DFT and writes element ka back to kb M + ka,
// so output k sits at (k mod 16) M + k / 16.  The store gathers it with
// 16-byte stores.  kIo: the load writes element j at bitrev(j), and the
// store reads natural positions.
// ---------------------------------------------------------------------------

// !INV: forward stage 2, pair in, pair out (in place in the transforms).
// INV: inverse stage 1 (pw holds w^-e), times w^-(k1 t2), into u64 words.
// The planes are offset to the inverse's chunk by the launcher; out64 is
// indexed from the chunk's first transform.  `rows` rows in all: the last
// tile's rows past them load zeros and store nothing.
template <bool INV, int STOP, int LOGL>
__global__ void __launch_bounds__(kThreads)
ntt_rows(const uint32_t* in_lo, const uint32_t* in_hi, uint32_t* out_lo,
         uint32_t* out_hi, uint64_t* out64, const uint64_t* __restrict__ pw,
         int logn1, int rows) {
  constexpr int L = 1 << LOGL, M = L >> 4, LOGM = LOGL - 4;
  constexpr int S64 = kShift64<INV>;
  using T = RowTile<LOGL>;
  extern __shared__ uint64_t s[];
  const int logn = logn1 + LOGL;
  const size_t n = (size_t)1 << logn;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // block = transform * (n1 / kTileRows) + row tile
  const int r0 = (blockIdx.x << kLogTile) & ((1 << logn1) - 1);
  const size_t base = ((size_t)(blockIdx.x >> (logn1 - kLogTile)) << logn) +
                      ((size_t)r0 << LOGL);
  const int live = rows - (blockIdx.x << kLogTile);  // the tile's rows

  // all of a thread's 16-byte loads are issued before the shared stores
  constexpr int VECS = kTileRows * L / 4 / kThreads;
  uint4 lo[VECS], hi[VECS];
#pragma unroll
  for (int u = 0; u < VECS; ++u) {
    const int i = threadIdx.x + u * kThreads;
    lo[u] = hi[u] = make_uint4(0u, 0u, 0u, 0u);
    if ((i >> (LOGL - 2)) < live) {
      lo[u] = *reinterpret_cast<const uint4*>(in_lo + base + i * 4);
      hi[u] = *reinterpret_cast<const uint4*>(in_hi + base + i * 4);
    }
  }
#pragma unroll
  for (int u = 0; u < VECS; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i >> (LOGL - 2), j = (i & (L / 4 - 1)) * 4;
    const uint32_t l[4] = {lo[u].x, lo[u].y, lo[u].z, lo[u].w};
    const uint32_t h[4] = {hi[u].x, hi[u].y, hi[u].z, hi[u].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pos = STOP == kIo ? bitrev(j + q, LOGL) : j + q;
      s[T::at(r, pos)] = (uint64_t)l[q] | ((uint64_t)h[q] << 32);
    }
  }
  __syncthreads();

  if constexpr (STOP != kIo) {
    for (int a = warp; a < M; a += kWarps) {
      uint64_t v[16];
#pragma unroll
      for (int jb = 0; jb < 16; ++jb) v[jb] = s[T::at(lane, a + M * jb)];
      dft_regs<4, 4 * S64 % 192, false>(v);
#pragma unroll
      for (int kb = 0; kb < 16; ++kb)
        s[T::at(lane, a + M * kb)] = inner_twiddle<LOGL, S64>(
            v[bitrev_c(kb, 4)], a, kb, pw, logn, 0);
    }
    __syncthreads();
    for (int kb = warp; kb < 16; kb += kWarps) {
      uint64_t v[M];
#pragma unroll
      for (int a = 0; a < M; ++a) v[a] = s[T::at(lane, kb * M + a)];
      dft_regs<LOGM, 64 / M * S64 % 192, false>(v);
      // INV: the four-step twiddle w^-(k1 t2) of outputs t2 = kb + 16 ka of
      // row k1, by the recurrence w^-(k1 kb) (w^-(16 k1))^ka
      uint64_t tw = 0, step = 0;
      if constexpr (INV && STOP == kFull) {
        const size_t k1 = r0 + lane;
        tw = ldg64(pw + ((k1 * kb) & (n - 1)));
        step = ldg64(pw + ((k1 * 16) & (n - 1)));
      }
#pragma unroll
      for (int ka = 0; ka < M; ++ka) {
        uint64_t val = v[bitrev_c(ka, LOGM)];
        if constexpr (INV && STOP == kFull) {
          val = gl_mul(val, tw);
          if (ka + 1 < M) tw = gl_mul(tw, step);
        }
        s[T::at(lane, kb * M + ka)] = val;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = threadIdx.x; i < kTileRows * L / 4; i += kThreads) {
    const int r = i >> (LOGL - 2), j = (i & (L / 4 - 1)) * 4;
    if (r >= live) continue;
    uint64_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = j + q;
      v[q] = s[T::at(r, STOP == kIo ? k : (k & 15) * M + (k >> 4))];
    }
    if (INV) {
      ulonglong2* o = reinterpret_cast<ulonglong2*>(out64 + base + i * 4);
      o[0] = make_ulonglong2(v[0], v[1]);
      o[1] = make_ulonglong2(v[2], v[3]);
    } else {
      *reinterpret_cast<uint4*>(out_lo + base + i * 4) =
          make_uint4((uint32_t)v[0], (uint32_t)v[1], (uint32_t)v[2],
                     (uint32_t)v[3]);
      *reinterpret_cast<uint4*>(out_hi + base + i * 4) =
          make_uint4((uint32_t)(v[0] >> 32), (uint32_t)(v[1] >> 32),
                     (uint32_t)(v[2] >> 32), (uint32_t)(v[3] >> 32));
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Raise kernel K's dynamic shared-memory limit to kMaxSmem on the current
// device, once per device (the attribute is set per device).
template <auto K>
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

// Launch kernel K on `blocks` blocks, or, with occ set, write its
// resident blocks per SM at this shared memory size there instead.
template <auto K, typename... A>
cudaError_t run(int blocks, int smem, cudaStream_t stream, int* occ,
                A... args) {
  const cudaError_t attr = allow_smem<K>();
  if (attr != cudaSuccess) return attr;
  if (occ) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, K,
                                                                kThreads, smem);
  K<<<blocks, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Call f(Int<LOGL>) for a pass of length 2^logl, 128 or 256; any other
// length is refused.
template <typename F>
cudaError_t dispatch(int logl, F f) {
  if (logl == 7) return f(Int<7>{});
  if (logl == 8) return f(Int<8>{});
  return cudaErrorInvalidValue;
}

// The column pass over `count` transforms, each holding its columns
// j2_0 .. j2_0 + 2^logc - 1: all n2 of them (logc = logn2, j2_0 = 0), or a
// column block.
template <bool DIGIT, int STOP>
cudaError_t launch_cols(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                        const uint64_t* pw, int count, int logn1, int logn2,
                        int logc, int j2_0, int batch, int w32, int w, int j0,
                        cudaStream_t stream, int* occ = nullptr) {
  if (logc < 0 || logc > logn2 || j2_0 < 0 ||
      j2_0 + (1 << logc) > (1 << logn2))
    return cudaErrorInvalidValue;
  const int smem = (kTileCols << logn1) * 8;
  const int blocks =
      (int)((((long long)count << logc) + kTileCols - 1) >> kLogTile);
  return dispatch(logn1, [&](auto logl) {
    return run<&fwd_cols<DIGIT, STOP, decltype(logl)::value>>(
        blocks, smem, stream, occ, x, lo, hi, pw, logn2, logc, j2_0, count,
        batch, w32, w, j0);
  });
}

// The row pass over `rows` consecutive rows of n2 words: count << logn1
// for whole transforms, or a block of rows.  Only the inverse's twiddle
// depends on the row's k1, which it takes from the row's place in its
// transform of n1 rows, so the inverse takes whole transforms only.
template <bool INV, int STOP>
cudaError_t launch_rows(const uint32_t* in_lo, const uint32_t* in_hi,
                        uint32_t* out_lo, uint32_t* out_hi, uint64_t* out64,
                        const uint64_t* pw, int rows, int logn1, int logn2,
                        cudaStream_t stream, int* occ = nullptr) {
  if (rows < 0 || (INV && (rows & ((1 << logn1) - 1))))
    return cudaErrorInvalidValue;
  const int smem =
      kTileRows * (logn2 == 8 ? RowTile<8>::W : RowTile<7>::W) * 8;
  return dispatch(logn2, [&](auto logl) {
    return run<&ntt_rows<INV, STOP, decltype(logl)::value>>(
        (rows + kTileRows - 1) / kTileRows, smem, stream, occ, in_lo, in_hi,
        out_lo, out_hi, out64, pw, logn1, rows);
  });
}

template <int STOP>
cudaError_t launch_inv_cols(const uint64_t* a, uint32_t* out,
                            uint32_t* out_hi, const uint32_t* p,
                            const uint64_t* pwi, int count, int logn1,
                            int logn2, cudaStream_t stream,
                            int* occ = nullptr) {
  const int smem = (kTileCols << logn1) * 8;
  return dispatch(logn1, [&](auto logl) {
    return run<&inv_cols<STOP, decltype(logl)::value>>(
        count << (logn2 - kLogTile), smem, stream, occ, a, out, out_hi, p,
        pwi, logn2);
  });
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
                                            logn2, logn2, 0, 1, 0, 0, 0,
                                            stream);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_rows<false, kFull>(lo, hi, lo, hi, nullptr, pw,
                                        count << logn1, logn1, logn2, stream);
}

// raw: u32 [batch, w32, n/2] -> lo, hi: u32 [c, batch, n] mat-linear NTTs of
// digits j0 .. j0 + c - 1.
int cuhe_ntt_fwd_digits(const uint32_t* raw, uint32_t* lo, uint32_t* hi,
                        const uint64_t* pw, int batch, int w32, int w, int j0,
                        int c, int logn1, int logn2, cudaStream_t stream) {
  const int count = c * batch;
  cudaError_t e = launch_cols<true, kFull>(raw, lo, hi, pw, count, logn1,
                                           logn2, logn2, 0, batch, w32, w, j0,
                                           stream);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_rows<false, kFull>(lo, hi, lo, hi, nullptr, pw,
                                        count << logn1, logn1, logn2, stream);
}

// x_lo, x_hi: u32 [count, n] mat-linear; scratch: u64 [min(count, chunk), n];
// p: u32 [count] -> out: u32 [count, n] natural order, mod p.  The two
// passes run `chunk` transforms at a time through the scratch.
int cuhe_ntt_inv_modcrt(const uint32_t* x_lo, const uint32_t* x_hi,
                        uint64_t* scratch, uint32_t* out, const uint32_t* p,
                        const uint64_t* pwi, int count, int logn1, int logn2,
                        int chunk, cudaStream_t stream) {
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)1 << (logn1 + logn2);
  for (int t0 = 0; t0 < count; t0 += chunk) {
    const int c = count - t0 < chunk ? count - t0 : chunk;
    cudaError_t e = launch_rows<true, kFull>(x_lo + t0 * n, x_hi + t0 * n,
                                             nullptr, nullptr, scratch, pwi,
                                             c << logn1, logn1, logn2, stream);
    if (e == cudaSuccess)
      e = launch_inv_cols<kFull>(scratch, out + t0 * n, nullptr, p + t0, pwi,
                                 c, logn1, logn2, stream);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The forward column pass on a column block of transforms split across
// devices (cuhe_tpu_torch/parallel/mesh.py::ntt_fwd_sharded), columns
// j2_0 .. j2_0 + 2^logc - 1: x: u32 [count, n1/2, 2^logc] -> lo, hi: u32
// [count, n1, 2^logc], B[k1, j2] w^(k1 j2) with the global j2.  Their row
// pass is cuhe_ntt_rows on the rows of the rank's block.
int cuhe_ntt_fwd_cols_block(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                            const uint64_t* pw, int count, int logn1,
                            int logn2, int logc, int j2_0,
                            cudaStream_t stream) {
  return (int)launch_cols<false, kFull>(x, lo, hi, pw, count, logn1, logn2,
                                        logc, j2_0, 1, 0, 0, 0, stream);
}

// The passes one at a time over all `count` transforms, for the per-pass
// probes (probes/ablate.py).
// Forward column pass, x: u32 [count, n/2] -> lo, hi: u32 [count, n] at
// [k1, j2]: load and store only, the DFTs without the twiddle, or the whole
// pass (the first launch of cuhe_ntt_fwd).
int cuhe_ntt_cols_io(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                     const uint64_t* pw, int count, int logn1, int logn2,
                     cudaStream_t stream) {
  return (int)launch_cols<false, kIo>(x, lo, hi, pw, count, logn1, logn2,
                                      logn2, 0, 1, 0, 0, 0, stream);
}

int cuhe_ntt_cols_notw(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                       const uint64_t* pw, int count, int logn1, int logn2,
                       cudaStream_t stream) {
  return (int)launch_cols<false, kNoEpilogue>(x, lo, hi, pw, count, logn1,
                                              logn2, logn2, 0, 1, 0, 0, 0,
                                              stream);
}

int cuhe_ntt_cols(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                  const uint64_t* pw, int count, int logn1, int logn2,
                  cudaStream_t stream) {
  return (int)launch_cols<false, kFull>(x, lo, hi, pw, count, logn1, logn2,
                                        logn2, 0, 1, 0, 0, 0, stream);
}

// Forward row pass (the second launch of cuhe_ntt_fwd), out of place:
// in_lo, in_hi -> out_lo, out_hi, all u32 [rows, n2]: the n1 rows of each
// transform, or a block of rows (ntt_fwd_sharded).
int cuhe_ntt_rows(const uint32_t* in_lo, const uint32_t* in_hi,
                  uint32_t* out_lo, uint32_t* out_hi, const uint64_t* pw,
                  int rows, int logn1, int logn2, cudaStream_t stream) {
  return (int)launch_rows<false, kFull>(in_lo, in_hi, out_lo, out_hi,
                                        nullptr, pw, rows, logn1, logn2,
                                        stream);
}

// Inverse row pass, x_lo, x_hi: u32 [count, n] mat-linear -> out: u64
// [count, n]: load and store only, or the whole pass (the first launch of
// cuhe_ntt_inv_modcrt).
int cuhe_ntt_rows_io(const uint32_t* x_lo, const uint32_t* x_hi,
                     uint64_t* out, const uint64_t* pwi, int count, int logn1,
                     int logn2, cudaStream_t stream) {
  return (int)launch_rows<true, kIo>(x_lo, x_hi, nullptr, nullptr, out, pwi,
                                     count << logn1, logn1, logn2, stream);
}

int cuhe_ntt_inv_rows(const uint32_t* x_lo, const uint32_t* x_hi,
                      uint64_t* out, const uint64_t* pwi, int count,
                      int logn1, int logn2, cudaStream_t stream) {
  return (int)launch_rows<true, kFull>(x_lo, x_hi, nullptr, nullptr, out, pwi,
                                       count << logn1, logn1, logn2, stream);
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

// Resident blocks per SM of the kernel that pass `pass` launches at this
// shape (0 cols_io, 1 cols_notw, 2 cols, 3 rows, 4 rows_io, 5 inv_rows,
// 6 inv_nomod, 7 inv_cols, 8 the digit column pass), or minus a CUDA error.
int cuhe_ntt_blocks_per_sm(int pass, int logn1, int logn2, cudaStream_t) {
  int occ = 0;
  const int l1 = logn1, l2 = logn2;
  cudaError_t e = cudaErrorInvalidValue;
  switch (pass) {
    case 0:
      e = launch_cols<false, kIo>(0, 0, 0, 0, 0, l1, l2, l2, 0, 1, 0, 0, 0, 0,
                                  &occ);
      break;
    case 1:
      e = launch_cols<false, kNoEpilogue>(0, 0, 0, 0, 0, l1, l2, l2, 0, 1, 0,
                                          0, 0, 0, &occ);
      break;
    case 2:
      e = launch_cols<false, kFull>(0, 0, 0, 0, 0, l1, l2, l2, 0, 1, 0, 0, 0,
                                    0, &occ);
      break;
    case 3:
      e = launch_rows<false, kFull>(0, 0, 0, 0, 0, 0, 0, l1, l2, 0, &occ);
      break;
    case 4:
      e = launch_rows<true, kIo>(0, 0, 0, 0, 0, 0, 0, l1, l2, 0, &occ);
      break;
    case 5:
      e = launch_rows<true, kFull>(0, 0, 0, 0, 0, 0, 0, l1, l2, 0, &occ);
      break;
    case 6:
      e = launch_inv_cols<kNoEpilogue>(0, 0, 0, 0, 0, 0, l1, l2, 0, &occ);
      break;
    case 7:
      e = launch_inv_cols<kFull>(0, 0, 0, 0, 0, 0, l1, l2, 0, &occ);
      break;
    case 8:
      e = launch_cols<true, kFull>(0, 0, 0, 0, 0, l1, l2, l2, 0, 1, 0, 0, 0, 0,
                                   &occ);
      break;
  }
  return e == cudaSuccess ? occ : -(int)e;
}

}  // extern "C"
