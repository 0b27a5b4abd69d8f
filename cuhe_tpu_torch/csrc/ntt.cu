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
//    coefficient at L = 256, 0.25 at 128; the one-pass transforms take a
//    product for every one, which the inverse's runs measured faster).  One
//    shared-memory exchange, and a second thread holds a length-M
//    sub-sequence for the second DFT.  The four-step twiddle w^(k1 j2) of
//    the forward column pass and the inverse row pass is applied after the
//    second DFT, each thread's M factors by a recurrence from two table
//    loads (a scattered load per element cost more than the second
//    product); n^-1 = 2^-log2(n) folds into the inner twiddles of the
//    inverse column pass (into the four-step twiddle's first factor in the
//    one-pass inverse).  The shifts are compile-time and fixed by the
//    direction (kShift64): w^(n/64) = NTT_GEN^1024 = 2^3 at every n, its
//    inverse 2^189; the front ends derive the shift on the host and check
//    it against these before each launch
//    (ops/ntt_kernels.py::check_root_shift).
//  * Column tiles are 32 columns wide, so each warp moves 128-byte
//    segments of a u32 plane (256 of a u64 one) straight between device
//    memory and registers, and a transform's tiles are neighbouring blocks;
//    the row pass moves its tile with 16-byte vector loads and stores on
//    each plane.
//  * The inverse column pass reduces mod p by Barrett (mod_p32), with one
//    division per block for its constant.
//  * Both transforms run in one launch each, a thread-block cluster of K
//    blocks holding one whole transform in its shared memory from the
//    first load to the last store.  The inverse (cluster::inv_cols) moves
//    12 bytes per coefficient (the lo and hi planes in, the residue out)
//    where its two passes moved 28 through a u64 scratch; the forward
//    (cluster::fwd_cols) moves 10 (the u32 coefficients in, the lo and hi
//    planes out) where its two passes moved 26, writing the pair and
//    reading it back between them.  The inverse's block r holds the n1/K
//    rows k1 whose k1 mod (n1/16) lies in its share of the column pass's
//    length-16 sub-DFTs: it runs the row pass on them and the column
//    pass's first stage in its own shared memory, and after one cluster
//    barrier the second stage reads its columns from every block's shared
//    memory (ld.shared::cluster) and stores the residues.  The forward runs
//    the stages in reverse: block r loads its share of the sub-DFTs from
//    device memory, runs their first stage and stores each result into the
//    shared memory of the block that holds its output rows
//    (st.shared::cluster); after one cluster barrier each block runs the
//    column pass's second stage and the row pass on its own n1/K rows and
//    stores them.  Their time is the integer units', as the passes' was:
//    what the one pass saves is the round trip's traffic and a launch, and
//    the blocks an SM holds at once set the rest.  So K is the smallest
//    power of two up to 8 whose blocks fit four to an SM, what the
//    registers hold at 64 a thread (ops/ntt_kernels.py::inv_cluster, for
//    both): 4 at n = 16384 and 8 at 32768, 32 KiB of words a block; 8 at
//    65536, three blocks of 64 KiB.  The inverse's MUL variant takes the
//    Z_P product that feeds an inverse (the gate's AND, Barrett's two
//    table products) at its load: two more planes read and one gl_mul a
//    coefficient, where pointwise.cu's K1 would write the product through
//    device memory for this kernel to read back.  The forward's DIGIT
//    variant takes B6's relinearization digits, w-bit windows of the RAW
//    words, at its load.  The two passes' kernels (fwd_cols, ntt_rows,
//    inv_cols) stay as P3's and P4's stop points of that design
//    (probes/ablate.py), and the forward's for the blocks of a transform
//    split across devices (parallel/mesh.py::ntt_fwd_sharded).
// The tensor cores are not used: a 64-bit product is 64 int8 products, so a
// length-16 stage as a dense matrix costs ~2,000 int8 operations per
// coefficient where the shift-only radix-16 DFT costs a few dozen integer
// operations.
//
// Stop points.  Each pass of the two-pass design takes a compile-time STOP
// (enum Stop below); the transform's blocks across devices instantiate
// kFull, and the per-pass probes (cuhe_tpu_torch/probes/ablate.py, the
// counterparts of the TPU stage ablations scripts/tpu_probe_inv_ablate.py
// and tpu_probe_fwd32_ablate.py) launch the same kernels stopped earlier.

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

// Forward column pass of `count` transforms (P4's stop points, and the
// column blocks of a transform split across devices; whole transforms run
// cluster::fwd_cols): length-n1 DFTs over j1 (rows j1 >= n1/2 are zero),
// times w^(k1 j2), stored at [k1, jc] of the output planes.  Each transform
// holds C = 2^logc of the n2 columns, j2 = j2_0 + jc for jc < C, as
// [n1/2, C] in and [n1, C] out: all of them (logc = logn2, j2_0 = 0), or
// the column block of a transform split across devices
// (cuhe_tpu_torch/parallel/mesh.py::ntt_fwd_sharded).  Lane `lane` of block
// `blockIdx.x` takes column g = 32 blockIdx.x + lane of the count * C; where
// C < 32 a tile spans 32 / C transforms, and lanes past the last transform
// load zeros and store nothing.
template <int STOP, int LOGL>
__global__ void __launch_bounds__(kThreads)
fwd_cols(const uint32_t* __restrict__ x, uint32_t* __restrict__ out_lo,
         uint32_t* __restrict__ out_hi, const uint64_t* __restrict__ pw,
         int logn2, int logc, int j2_0, int count) {
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
  const uint32_t* src = live ? x + tr * half : nullptr;

  // every task's loads are issued before the first DFT, so a warp has 8 or
  // 16 128-byte loads in flight
  constexpr int TASKS = M / kWarps;
  uint32_t in[TASKS][8];
#pragma unroll
  for (int t = 0; t < TASKS; ++t) {
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const size_t off = (size_t)(warp + t * kWarps + M * jb) * c + jc;
      in[t][jb] = src ? src[off] : 0u;
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

// Inverse column pass of transform tr (P3's stop points; the transform
// runs cluster::inv_cols): length-n1 DFTs over k1 of the row pass's u64
// words, times n^-1 (folded into the inner twiddles), reduced mod
// p[transform], written at natural index t1 * n2 + t2.  kNoEpilogue:
// without the mod p, the canonical value's words into out and out_hi.
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

// !INV: forward stage 2, pair in, pair out (P4's stop points, and the row
// blocks of a transform split across devices).  INV: inverse stage 1 (pw
// holds w^-e), times w^-(k1 t2), into u64 words (P3's stop points).
// `rows` rows in all: the last tile's rows past them load zeros and store
// nothing.
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
// the inverse in one pass, in a cluster's shared memory
//
// A cluster of K = 2^LOGK blocks takes one transform; block `rank` holds
// the ROWS = n1/K rows k1 = M1 jb + a, jb < 16, whose a = k1 mod M1 (M1 =
// n1/16) lies in [MK rank, MK (rank + 1)), MK = M1/K: local row jb MK + al
// holds k1 = M1 jb + MK rank + al.  Rows are padded as in the row tile.
//  load:      the rows from the lo and hi planes with 16-byte loads;
//             element j = a2 + M2 jb (M2 = n2/16) goes to position
//             jb + 16 a2 of its row, so that each stage below reads and
//             writes the same positions; with MUL, the same 16 bytes of a
//             second operand's planes too, and the product mod P is stored
//             (the Z_P product that feeds the inverse, pointwise.cu's K1,
//             taken at the load);
//  rows 1:    task (a2, 32 rows): positions 16 a2 .. 16 a2 + 15, the
//             length-16 DFT and the inner twiddles (table_twiddle), back in
//             place;
//  rows 2:    task (kb, 32 rows): positions kb + 16 a, the length-M2 DFT,
//             times n^-1 w^-(k1 t2), element ka back at kb + 16 ka = t2:
//             the row pass's output in natural order;
//  columns 1: task (al, 32 columns): local rows jb MK + al, the length-16
//             DFT of sub-DFT a = MK rank + al and its inner twiddles
//             (table_twiddle), element kb back at local row kb MK + al;
//  cluster barrier;
//  columns 2: task (kb, 32 columns), kb in the block's 16/K: element kb of
//             every sub-DFT a, from local row kb MK + a % MK of block
//             a / MK (ld.shared::cluster), the length-M1 DFT, mod p, and
//             output t1 = kb + 16 ka stored at t1 n2 + t2;
//  cluster barrier: no block leaves while another reads its rows.
// A warp's 32 lanes are 32 rows (rows 1, 2; the odd row length puts them in
// distinct banks) or 32 neighbouring columns (columns 1, 2: 128-byte stores).
// ---------------------------------------------------------------------------

// The second operand of the fused inverse (MUL): u32 lo and hi planes of
// `count` transforms of n words, mat-linear; transform tr of x takes y's
// transform tr % count (y full-shaped, or a [pnum, n] table broadcast over
// x's leading dimensions).  Without MUL it is empty, and, as the kernel's
// last parameter, moves none of the others.
template <bool MUL>
struct MulOperand {
  const uint32_t* lo;
  const uint32_t* hi;
  uint32_t count;
};
template <>
struct MulOperand<false> {};

// The digit window of the forward's DIGIT variant (B6): transform tr =
// digit * batch + b takes the w-bit window at bit w (j0 + digit) of RAW
// words [batch, w32, n/2] (ntt_1_*_ext_block semantics: planes past the top
// word read zero, no high-word bits at shift 0).  Without DIGIT it is empty,
// and, as the kernel's last parameter, moves none of the others.
template <bool DIGIT>
struct DigitWindow {
  int batch, w32, w, j0;
};
template <>
struct DigitWindow<false> {};

namespace cluster {

// Every block of the cluster waits here; the shared stores before it are
// seen by the loads after it, from any block of the cluster.
__device__ __forceinline__ void barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of this block's shared-memory address `addr` in block `rank`
// of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// barrier() in two halves, with no memory ordering: arrive() at the start,
// and wait() before the first store into another block's shared memory,
// which every block of the cluster has then started.
__device__ __forceinline__ void arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ uint64_t load(uint32_t addr) {
  uint64_t v;
  asm volatile("ld.shared::cluster.u64 %0, [%1];"
               : "=l"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void store(uint32_t addr, uint64_t v) {
  asm volatile("st.shared::cluster.u64 [%0], %1;" ::"r"(addr), "l"(v)
               : "memory");
}

// x * w_L^(a kb), w_L = w^(n/L) (w^-(n/L) for the inverse), as one product
// with the table's entry (pw: w^e, or w^-e, e < n).  inner_twiddle takes a
// shift where L/64 divides a kb; with a known only at run time that shift,
// its amount and its branches cost the integer units more than the product
// (PERF.md, section 6).
template <int LOGL, int LOGN>
__device__ __forceinline__ uint64_t table_twiddle(uint64_t x, int a, int kb,
                                                  const uint64_t* pw) {
  if (kb == 0) return x;
  const int e = (a * kb) & ((1 << LOGL) - 1);
  return gl_mul(x, ldg64(pw + ((size_t)e << (LOGN - LOGL))));
}

// x_lo, x_hi: u32 [count, n] mat-linear; p: u32 [count] -> out: u32
// [count, n] natural order, mod p; with MUL, the inverse of x * y mod P
// instead of x's.  grid: count * K blocks in clusters of K, BLOCKS of them
// resident on an SM (the registers' bound is set to match).  Each loop over
// a stage's tasks runs one task at a time (unroll 1): unrolled, it held
// more registers than four blocks an SM leave a thread.
template <bool MUL, int LOGN1, int LOGN2, int LOGK, int BLOCKS>
__global__ void __launch_bounds__(kThreads, BLOCKS)
inv_cols(const uint32_t* __restrict__ x_lo, const uint32_t* __restrict__ x_hi,
         uint32_t* __restrict__ out, const uint32_t* __restrict__ p,
         const uint64_t* __restrict__ pwi, const MulOperand<MUL> y) {
  constexpr int LOGN = LOGN1 + LOGN2, N2 = 1 << LOGN2, K = 1 << LOGK;
  constexpr int LOGM1 = LOGN1 - 4, LOGM2 = LOGN2 - 4;
  constexpr int M1 = 1 << LOGM1, M2 = 1 << LOGM2, MK = M1 / K;
  constexpr int ROWS = 16 * MK, GROUPS = ROWS / kTileRows;
  constexpr int S64 = kShift64<true>;
  constexpr size_t n = (size_t)1 << LOGN;
  static_assert(MK >= 1 && GROUPS >= 1, "a block holds whole warps of rows");
  using T = RowTile<LOGN2>;
  extern __shared__ uint64_t s[];
  __shared__ uint64_t mu_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = blockIdx.x & (K - 1), tr = blockIdx.x >> LOGK;
  const size_t base = (size_t)tr << LOGN;
  if (threadIdx.x == 0) mu_s = ~0ull / p[tr];
  // the transform's row k1 of local row lr
  const auto row_k1 = [rank](int lr) {
    return ((lr / MK) << LOGM1) + MK * rank + lr % MK;
  };

  // 16-byte vector w of a row (of N2 / 4) loads row vector (w % 16) G +
  // w / 16, G = M2 / 4, whose elements j = 4 v + q have jb = w % 16 and a2 =
  // 4 (w / 16) + q: a half warp's 16 lanes store 16 distinct jb, in
  // distinct banks.  Four vectors a plane in flight at a time, two with
  // MUL's four planes: the same 128 bytes a thread, in the same registers.
  constexpr int VECS = ROWS * N2 / 4 / kThreads, BATCH = MUL ? 2 : 4;
  constexpr int G = M2 / 4;
  static_assert(VECS % BATCH == 0, "whole batches of loads");
  size_t y_base = 0;
  if constexpr (MUL) y_base = (size_t)(tr % y.count) << LOGN;
#pragma unroll
  for (int u0 = 0; u0 < VECS; u0 += BATCH) {
    uint4 lo[BATCH], hi[BATCH];
    [[maybe_unused]] uint4 ylo[BATCH], yhi[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = threadIdx.x + (u0 + u) * kThreads;
      const int lr = i >> (LOGN2 - 2), w = i & (N2 / 4 - 1);
      const size_t off = ((size_t)row_k1(lr) << LOGN2) +
                         4 * ((w & 15) * G + (w >> 4));
      lo[u] = *reinterpret_cast<const uint4*>(x_lo + (base + off));
      hi[u] = *reinterpret_cast<const uint4*>(x_hi + (base + off));
      if constexpr (MUL) {
        ylo[u] = __ldg(reinterpret_cast<const uint4*>(y.lo + (y_base + off)));
        yhi[u] = __ldg(reinterpret_cast<const uint4*>(y.hi + (y_base + off)));
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = threadIdx.x + (u0 + u) * kThreads;
      const int lr = i >> (LOGN2 - 2), w = i & (N2 / 4 - 1);
      const int at = T::at(lr, (w & 15) + 64 * (w >> 4));
      const uint32_t l[4] = {lo[u].x, lo[u].y, lo[u].z, lo[u].w};
      const uint32_t h[4] = {hi[u].x, hi[u].y, hi[u].z, hi[u].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint64_t v = (uint64_t)l[q] | ((uint64_t)h[q] << 32);
        if constexpr (MUL)
          v = gl_mul(v, (uint64_t)(&ylo[u].x)[q] |
                            ((uint64_t)(&yhi[u].x)[q] << 32));
        s[at + 16 * q] = v;
      }
    }
  }
  __syncthreads();

  // rows, stage 1
#pragma unroll 1
  for (int t = warp; t < M2 * GROUPS; t += kWarps) {
    const int a2 = t & (M2 - 1), lr = ((t >> LOGM2) << kLogTile) + lane;
    uint64_t v[16];
#pragma unroll
    for (int jb = 0; jb < 16; ++jb) v[jb] = s[T::at(lr, jb + 16 * a2)];
    dft_regs<4, 4 * S64 % 192, false>(v);
#pragma unroll
    for (int kb = 0; kb < 16; ++kb)
      s[T::at(lr, kb + 16 * a2)] =
          table_twiddle<LOGN2, LOGN>(v[bitrev_c(kb, 4)], a2, kb, pwi);
  }
  __syncthreads();

  // rows, stage 2, and the four-step twiddle w^-(k1 t2) of t2 = kb + 16 ka
  // by the recurrence w^-(k1 kb) (w^-(16 k1))^ka, with n^-1 = 2^-log2(n)
  // in its first factor: one shift a task, where the column pass's inner
  // twiddles would take one for each of their products
#pragma unroll 1
  for (int t = warp; t < 16 * GROUPS; t += kWarps) {
    const int kb = t & 15, lr = ((t >> 4) << kLogTile) + lane;
    uint64_t v[M2];
#pragma unroll
    for (int a = 0; a < M2; ++a) v[a] = s[T::at(lr, kb + 16 * a)];
    dft_regs<LOGM2, 64 / M2 * S64 % 192, false>(v);
    const size_t k1 = row_k1(lr);
    uint64_t tw = gl_mul_pow2(ldg64(pwi + ((k1 * kb) & (n - 1))), 192 - LOGN);
    const uint64_t step = ldg64(pwi + ((k1 * 16) & (n - 1)));
#pragma unroll
    for (int ka = 0; ka < M2; ++ka) {
      s[T::at(lr, kb + 16 * ka)] = gl_mul(v[bitrev_c(ka, LOGM2)], tw);
      if (ka + 1 < M2) tw = gl_mul(tw, step);
    }
  }
  __syncthreads();

  // columns, stage 1
  constexpr int TILES = N2 / kTileCols;
#pragma unroll 1
  for (int t = warp; t < MK * TILES; t += kWarps) {
    const int al = t & (MK - 1), t2 = (t / MK) * kTileCols + lane;
    uint64_t v[16];
#pragma unroll
    for (int jb = 0; jb < 16; ++jb) v[jb] = s[T::at(jb * MK + al, t2)];
    dft_regs<4, 4 * S64 % 192, false>(v);
#pragma unroll
    for (int kb = 0; kb < 16; ++kb)
      s[T::at(kb * MK + al, t2)] = table_twiddle<LOGN1, LOGN>(
          v[bitrev_c(kb, 4)], MK * rank + al, kb, pwi);
  }
  barrier();

  // columns, stage 2, from the whole cluster: block r holds sub-DFTs
  // a = MK r .. MK r + MK - 1
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(s);
  const uint64_t pt = p[tr], mu = mu_s;
  constexpr int KB = 16 / K;
#pragma unroll 1
  for (int t = warp; t < KB * TILES; t += kWarps) {
    const int kb = KB * rank + t % KB, t2 = (t / KB) * kTileCols + lane;
    const uint32_t at = 8 * T::at(kb * MK, t2);
    uint64_t v[M1];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const uint32_t peer = map_rank(s0 + at, r);
#pragma unroll
      for (int al = 0; al < MK; ++al)
        v[MK * r + al] = load(peer + 8 * T::W * al);
    }
    dft_regs<LOGM1, 64 / M1 * S64 % 192, false>(v);
#pragma unroll
    for (int ka = 0; ka < M1; ++ka)
      out[base + ((size_t)(kb + 16 * ka) << LOGN2) + t2] =
          mod_p32(v[bitrev_c(ka, LOGM1)], pt, mu);
  }
  barrier();
}

// ---------------------------------------------------------------------------
// the forward in one pass, in a cluster's shared memory
//
// A cluster of K = 2^LOGK blocks takes one transform, as the inverse does,
// and runs the inverse's stages in reverse order.  Block `rank` computes
// the column pass's length-16 sub-DFTs a = k1 mod M1 in [MK rank, MK (rank
// + 1)) (M1 = n1/16, MK = M1/K) and then holds the ROWS = n1/K output rows
// k1 whose k1 mod 16 lies in [KB rank, KB (rank + 1)) (KB = 16/K): local
// row kbl M1 + ka holds k1 = KB rank + kbl + 16 ka.  Rows are padded as in
// the row tile.
//  columns 1: task (al, 32 columns): the 8 nonzero words j1 = a + M1 jb,
//             jb < 8, of sub-DFT a = MK rank + al, loaded straight from
//             device memory (DIGIT: the digit's window of the RAW words),
//             the half-zero length-16 DFT and the inner twiddles
//             (table_twiddle); element kb stored into the shared memory of
//             block kb / KB at its local row (kb mod KB) M1 + a
//             (st.shared::cluster), once every block has started (the
//             arrive at the kernel's start, the wait before the first store);
//  cluster barrier: every store has landed;
//  columns 2: task (kbl, 32 columns): local rows kbl M1 + a, a < M1, the
//             length-M1 DFT, times w^(k1 j2), element ka back at local row
//             kbl M1 + ka;
//  rows 1:    task (a2, 32 rows): elements j2 = a2 + M2 jb (M2 = n2/16),
//             the length-16 DFT and the inner twiddles (table_twiddle),
//             element kb at position 16 a2 + kb;
//  rows 2:    task (kb, 32 rows): positions kb + 16 a, the length-M2 DFT,
//             element ka back at kb + 16 ka = k2: each row in natural order;
//  store:     word k2 of row k1 at k1 n2 + k2, 16-byte stores on each plane.
// Element j2 = a2 + M2 jb of a row sits at position 16 a2 + (jb ^ a2 16/M2)
// (col_at): rows 1 reads the 16 positions it writes, and the 32 neighbouring
// columns of a warp in the column stages fill each bank twice.  A half warp
// of the store reads four words of four rows, which the rows' padding puts in
// distinct banks.  After the second barrier a block touches only its own
// shared memory, so it needs no barrier before it exits.
// ---------------------------------------------------------------------------

// x: u32 [count, n/2] (DIGIT: RAW words [batch, w32, n/2], count = c *
// batch) -> out_lo, out_hi: u32 [count, n] mat-linear.  grid: count * K
// blocks in clusters of K, BLOCKS of them resident on an SM; each stage's
// loop runs one task at a time (unroll 1), as the inverse's.
template <bool DIGIT, int LOGN1, int LOGN2, int LOGK, int BLOCKS>
__global__ void __launch_bounds__(kThreads, BLOCKS)
fwd_cols(const uint32_t* __restrict__ x, uint32_t* __restrict__ out_lo,
         uint32_t* __restrict__ out_hi, const uint64_t* __restrict__ pw,
         const DigitWindow<DIGIT> d) {
  constexpr int LOGN = LOGN1 + LOGN2, N2 = 1 << LOGN2, K = 1 << LOGK;
  constexpr int LOGM1 = LOGN1 - 4, LOGM2 = LOGN2 - 4;
  constexpr int M1 = 1 << LOGM1, M2 = 1 << LOGM2, MK = M1 / K, KB = 16 / K;
  constexpr int ROWS = KB * M1, GROUPS = ROWS / kTileRows;
  constexpr int TILES = N2 / kTileCols;
  constexpr int S64 = kShift64<false>;
  constexpr size_t n = (size_t)1 << LOGN, half = n / 2;
  static_assert(MK >= 1 && KB >= 1 && GROUPS >= 1, "whole warps of rows");
  static_assert(MK * TILES >= kWarps, "a first column task for every warp");
  static_assert(LOGM2 >= 2 && LOGM2 <= 4, "a row of 4 to 16 vectors of 16");
  using T = RowTile<LOGN2>;
  extern __shared__ uint64_t s[];
  arrive();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = blockIdx.x & (K - 1), tr = blockIdx.x >> LOGK;
  // the position of element j2 = a2 + M2 jb in its row
  const auto col_at = [](int j2) {
    const int a2 = j2 & (M2 - 1);
    return 16 * a2 + ((j2 >> LOGM2) ^ (a2 << (4 - LOGM2)));
  };

  // the transform's coefficients [n1/2, n2]; DIGIT: the plane of the
  // window's low bits (none past the top word) and of its high bits (none
  // at shift 0 or past the top word)
  const uint32_t* src = nullptr;
  [[maybe_unused]] const uint32_t* src_hi = nullptr;
  [[maybe_unused]] int sh = 0;
  [[maybe_unused]] uint32_t mask = 0;
  if constexpr (DIGIT) {
    const int b = tr % d.batch, bit = d.w * (d.j0 + tr / d.batch);
    const int k = bit >> 5;
    sh = bit & 31;
    mask = d.w < 32 ? (1u << d.w) - 1u : 0xFFFFFFFFu;
    if (k < d.w32) src = x + ((size_t)b * d.w32 + k) * half;
    if (sh && k + 1 < d.w32) src_hi = x + ((size_t)b * d.w32 + k + 1) * half;
  } else {
    src = x + (size_t)tr * half;
  }

  // columns, stage 1, into the shared memory of the block that holds kb
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(s);
#pragma unroll 1
  for (int t = warp; t < MK * TILES; t += kWarps) {
    const int a = MK * rank + (t & (MK - 1));
    const int j2 = (t / MK) * kTileCols + lane;
    uint64_t v[16];
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const size_t off = ((size_t)(a + M1 * jb) << LOGN2) + j2;
      if constexpr (DIGIT) {
        uint32_t val = src ? src[off] >> sh : 0u;
        if (src_hi) val |= src_hi[off] << (32 - sh);
        v[jb] = val & mask;
      } else {
        v[jb] = src[off];
      }
      v[jb + 8] = 0;
    }
    dft_regs<4, 4 * S64 % 192, true>(v);
    if (t == warp) wait();
    const int at = col_at(j2);
#pragma unroll
    for (int kb = 0; kb < 16; ++kb)
      store(map_rank(s0 + 8 * T::at((kb & (KB - 1)) * M1 + a, at), kb / KB),
            table_twiddle<LOGN1, LOGN>(v[bitrev_c(kb, 4)], a, kb, pw));
  }
  barrier();

  // columns, stage 2, and the four-step twiddle w^(k1 j2) of rows k1 = kb +
  // 16 ka by the recurrence w^(kb j2) (w^(16 j2))^ka
#pragma unroll 1
  for (int t = warp; t < KB * TILES; t += kWarps) {
    const int kbl = t & (KB - 1), j2 = (t / KB) * kTileCols + lane;
    const int at = col_at(j2);
    uint64_t v[M1];
#pragma unroll
    for (int a = 0; a < M1; ++a) v[a] = s[T::at(kbl * M1 + a, at)];
    dft_regs<LOGM1, 64 / M1 * S64 % 192, false>(v);
    const size_t kb = KB * rank + kbl;
    uint64_t tw = ldg64(pw + ((kb * j2) & (n - 1)));
    const uint64_t step = ldg64(pw + (((size_t)16 * j2) & (n - 1)));
#pragma unroll
    for (int ka = 0; ka < M1; ++ka) {
      s[T::at(kbl * M1 + ka, at)] = gl_mul(v[bitrev_c(ka, LOGM1)], tw);
      if (ka + 1 < M1) tw = gl_mul(tw, step);
    }
  }
  __syncthreads();

  // rows, stage 1
#pragma unroll 1
  for (int t = warp; t < M2 * GROUPS; t += kWarps) {
    const int a2 = t & (M2 - 1), lr = ((t >> LOGM2) << kLogTile) + lane;
    const int swz = a2 << (4 - LOGM2);
    uint64_t v[16];
#pragma unroll
    for (int jb = 0; jb < 16; ++jb) v[jb] = s[T::at(lr, 16 * a2 + (jb ^ swz))];
    dft_regs<4, 4 * S64 % 192, false>(v);
#pragma unroll
    for (int kb = 0; kb < 16; ++kb)
      s[T::at(lr, 16 * a2 + kb)] =
          table_twiddle<LOGN2, LOGN>(v[bitrev_c(kb, 4)], a2, kb, pw);
  }
  __syncthreads();

  // rows, stage 2
#pragma unroll 1
  for (int t = warp; t < 16 * GROUPS; t += kWarps) {
    const int kb = t & 15, lr = ((t >> 4) << kLogTile) + lane;
    uint64_t v[M2];
#pragma unroll
    for (int a = 0; a < M2; ++a) v[a] = s[T::at(lr, kb + 16 * a)];
    dft_regs<LOGM2, 64 / M2 * S64 % 192, false>(v);
#pragma unroll
    for (int ka = 0; ka < M2; ++ka)
      s[T::at(lr, kb + 16 * ka)] = v[bitrev_c(ka, LOGM2)];
  }
  __syncthreads();

  // 16-byte vector vec (of N2 / 4) of local row lr: a half warp's 16 lanes
  // take vectors 4 vh .. 4 vh + 3 of rows 4 rh .. 4 rh + 3, a warp two vh
  // of the same rows (128 bytes of each row on each plane)
  constexpr int VECS = ROWS * N2 / 4 / kThreads;
  static_assert(VECS * kThreads == ROWS * N2 / 4, "whole vectors a thread");
  const size_t base = (size_t)tr << LOGN;
#pragma unroll
  for (int u = 0; u < VECS; ++u) {
    const int i = threadIdx.x + u * kThreads, hv = i >> 4;
    const int lr = ((i >> 2) & 3) + 4 * (hv >> LOGM2);
    const int vec = (i & 3) + 4 * (hv & (M2 - 1));
    uint64_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = s[T::at(lr, 4 * vec + q)];
    const int k1 = KB * rank + (lr >> LOGM1) + 16 * (lr & (M1 - 1));
    const size_t o = base + ((size_t)k1 << LOGN2) + 4 * vec;
    *reinterpret_cast<uint4*>(out_lo + o) =
        make_uint4((uint32_t)w[0], (uint32_t)w[1], (uint32_t)w[2],
                   (uint32_t)w[3]);
    *reinterpret_cast<uint4*>(out_hi + o) =
        make_uint4((uint32_t)(w[0] >> 32), (uint32_t)(w[1] >> 32),
                   (uint32_t)(w[2] >> 32), (uint32_t)(w[3] >> 32));
  }
}

}  // namespace cluster

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Raise kernel K's dynamic shared-memory limit to SMEM bytes on the current
// device, once per device (the attribute is set per device).
template <auto K, int SMEM = kMaxSmem>
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM);
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
template <int STOP>
cudaError_t launch_cols(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                        const uint64_t* pw, int count, int logn1, int logn2,
                        int logc, int j2_0, cudaStream_t stream,
                        int* occ = nullptr) {
  if (logc < 0 || logc > logn2 || j2_0 < 0 ||
      j2_0 + (1 << logc) > (1 << logn2))
    return cudaErrorInvalidValue;
  const int smem = (kTileCols << logn1) * 8;
  const int blocks =
      (int)((((long long)count << logc) + kTileCols - 1) >> kLogTile);
  return dispatch(logn1, [&](auto logl) {
    return run<&fwd_cols<STOP, decltype(logl)::value>>(
        blocks, smem, stream, occ, x, lo, hi, pw, logn2, logc, j2_0, count);
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

// Call f(Int<LOGN1>, Int<LOGN2>, Int<LOGK>, Int<BLOCKS>) with the cluster
// size of the one-pass transforms at n = 2^(logn1 + logn2) and their blocks
// per SM (ops/ntt_kernels.py::inv_cluster, inv_cluster_blocks: the forward
// takes the inverse's); any other factorization is refused.
template <typename F>
cudaError_t dispatch_cluster(int logn1, int logn2, F f) {
  if (logn1 == 7 && logn2 == 7)
    return f(Int<7>{}, Int<7>{}, Int<2>{}, Int<4>{});
  if (logn1 == 8 && logn2 == 7)
    return f(Int<8>{}, Int<7>{}, Int<3>{}, Int<4>{});
  if (logn1 == 8 && logn2 == 8)
    return f(Int<8>{}, Int<8>{}, Int<3>{}, Int<3>{});
  return cudaErrorInvalidValue;
}

// What run_cluster writes to *occ where it holds this on entry: the
// clusters the device holds at once, rather than the blocks an SM holds.
constexpr int kActiveClusters = -1;

// Launch kernel KERN over `count` transforms in clusters of 2^LOGK blocks,
// each holding n1/2^LOGK padded rows of n2 words in shared memory; logk
// must be the one the factorization is built for.  With occ set, write its
// resident blocks per SM there instead (or its clusters the device holds at
// once, where *occ is kActiveClusters).
template <auto KERN, int LOGN1, int LOGN2, int LOGK, typename... A>
cudaError_t run_cluster(int count, int logk, cudaStream_t stream, int* occ,
                        A... args) {
  constexpr int smem = (1 << (LOGN1 - LOGK)) * RowTile<LOGN2>::W * 8;
  if (!occ && logk != LOGK) return cudaErrorInvalidValue;
  const cudaError_t attr = allow_smem<KERN, smem>();
  if (attr != cudaSuccess) return attr;
  if (occ && *occ != kActiveClusters)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, KERN, kThreads,
                                                         smem);
  cudaLaunchAttribute dims[1];
  dims[0].id = cudaLaunchAttributeClusterDimension;
  dims[0].val.clusterDim.x = 1 << LOGK;
  dims[0].val.clusterDim.y = 1;
  dims[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(occ ? 1 : count) << LOGK);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = dims;
  cfg.numAttrs = 1;
  if (occ) return cudaOccupancyMaxActiveClusters(occ, KERN, &cfg);
  return cudaLaunchKernelEx(&cfg, KERN, args...);
}

// The one-pass inverse over `count` transforms, in clusters of 2^logk
// blocks.  MUL: of the product with y.
template <bool MUL>
cudaError_t launch_inv_cluster(const uint32_t* x_lo, const uint32_t* x_hi,
                               MulOperand<MUL> y, uint32_t* out,
                               const uint32_t* p, const uint64_t* pwi,
                               int count, int logn1, int logn2, int logk,
                               cudaStream_t stream, int* occ = nullptr) {
  return dispatch_cluster(logn1, logn2, [&](auto l1, auto l2, auto lk,
                                            auto blocks) {
    constexpr int LOGN1 = decltype(l1)::value, LOGN2 = decltype(l2)::value,
                  LOGK = decltype(lk)::value, BLOCKS = decltype(blocks)::value;
    return run_cluster<&cluster::inv_cols<MUL, LOGN1, LOGN2, LOGK, BLOCKS>,
                       LOGN1, LOGN2, LOGK>(count, logk, stream, occ, x_lo,
                                           x_hi, out, p, pwi, y);
  });
}

// The one-pass forward over `count` transforms, in clusters of 2^logk
// blocks.  DIGIT: of the digit windows d of RAW words.
template <bool DIGIT>
cudaError_t launch_fwd_cluster(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                               const uint64_t* pw, DigitWindow<DIGIT> d,
                               int count, int logn1, int logn2, int logk,
                               cudaStream_t stream, int* occ = nullptr) {
  return dispatch_cluster(logn1, logn2, [&](auto l1, auto l2, auto lk,
                                            auto blocks) {
    constexpr int LOGN1 = decltype(l1)::value, LOGN2 = decltype(l2)::value,
                  LOGK = decltype(lk)::value, BLOCKS = decltype(blocks)::value;
    return run_cluster<&cluster::fwd_cols<DIGIT, LOGN1, LOGN2, LOGK, BLOCKS>,
                       LOGN1, LOGN2, LOGK>(count, logk, stream, occ, x, lo,
                                           hi, pw, d);
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

// The occupancy query of the kernel that pass `pass` launches (the ids of
// cuhe_ntt_blocks_per_sm) into *occ.
cudaError_t query_pass(int pass, int l1, int l2, int* occ) {
  cudaError_t e = cudaErrorInvalidValue;
  switch (pass) {
    case 0:
      e = launch_cols<kIo>(0, 0, 0, 0, 0, l1, l2, l2, 0, 0, occ);
      break;
    case 1:
      e = launch_cols<kNoEpilogue>(0, 0, 0, 0, 0, l1, l2, l2, 0, 0, occ);
      break;
    case 2:
      e = launch_cols<kFull>(0, 0, 0, 0, 0, l1, l2, l2, 0, 0, occ);
      break;
    case 3:
      e = launch_rows<false, kFull>(0, 0, 0, 0, 0, 0, 0, l1, l2, 0, occ);
      break;
    case 4:
      e = launch_rows<true, kIo>(0, 0, 0, 0, 0, 0, 0, l1, l2, 0, occ);
      break;
    case 5:
      e = launch_rows<true, kFull>(0, 0, 0, 0, 0, 0, 0, l1, l2, 0, occ);
      break;
    case 6:
      e = launch_inv_cols<kNoEpilogue>(0, 0, 0, 0, 0, 0, l1, l2, 0, occ);
      break;
    case 7:
      e = launch_inv_cols<kFull>(0, 0, 0, 0, 0, 0, l1, l2, 0, occ);
      break;
    case 8:
      e = launch_fwd_cluster(nullptr, nullptr, nullptr, nullptr,
                             DigitWindow<true>{}, 0, l1, l2, 0, 0, occ);
      break;
    case 9:
      e = launch_inv_cluster(nullptr, nullptr, MulOperand<false>{}, nullptr,
                             nullptr, nullptr, 0, l1, l2, 0, 0, occ);
      break;
    case 10:
      e = launch_inv_cluster(nullptr, nullptr, MulOperand<true>{}, nullptr,
                             nullptr, nullptr, 0, l1, l2, 0, 0, occ);
      break;
    case 11:
      e = launch_fwd_cluster(nullptr, nullptr, nullptr, nullptr,
                             DigitWindow<false>{}, 0, l1, l2, 0, 0, occ);
      break;
  }
  return e;
}

}  // namespace

extern "C" {

const char* cuhe_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x: u32 [count, n/2] -> lo, hi: u32 [count, n] mat-linear: one launch, a
// cluster of 2^logk blocks per transform.
int cuhe_ntt_fwd(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                 const uint64_t* pw, int count, int logn1, int logn2,
                 int logk, cudaStream_t stream) {
  return (int)launch_fwd_cluster(x, lo, hi, pw, DigitWindow<false>{}, count,
                                 logn1, logn2, logk, stream);
}

// raw: u32 [batch, w32, n/2] -> lo, hi: u32 [c, batch, n] mat-linear NTTs of
// digits j0 .. j0 + c - 1, in one launch as cuhe_ntt_fwd.
int cuhe_ntt_fwd_digits(const uint32_t* raw, uint32_t* lo, uint32_t* hi,
                        const uint64_t* pw, int batch, int w32, int w, int j0,
                        int c, int logn1, int logn2, int logk,
                        cudaStream_t stream) {
  if (batch < 1 || c < 1 || w < 1 || w > 32 || j0 < 0)
    return (int)cudaErrorInvalidValue;
  const DigitWindow<true> d = {batch, w32, w, j0};
  return (int)launch_fwd_cluster(raw, lo, hi, pw, d, c * batch, logn1, logn2,
                                 logk, stream);
}

// x_lo, x_hi: u32 [count, n] mat-linear; p: u32 [count] -> out: u32
// [count, n] natural order, mod p: one launch, a cluster of 2^logk blocks
// per transform.
int cuhe_ntt_inv_cluster(const uint32_t* x_lo, const uint32_t* x_hi,
                         uint32_t* out, const uint32_t* p, const uint64_t* pwi,
                         int count, int logn1, int logn2, int logk,
                         cudaStream_t stream) {
  return (int)launch_inv_cluster(x_lo, x_hi, MulOperand<false>{}, out, p,
                                 pwi, count, logn1, logn2, logk, stream);
}

// The same of x * y mod P, the product taken at the load: y_lo, y_hi: u32
// [y_count, n] mat-linear, transform t of x times y's t % y_count.
int cuhe_ntt_inv_cluster_mul(const uint32_t* x_lo, const uint32_t* x_hi,
                             const uint32_t* y_lo, const uint32_t* y_hi,
                             uint32_t* out, const uint32_t* p,
                             const uint64_t* pwi, int count, int y_count,
                             int logn1, int logn2, int logk,
                             cudaStream_t stream) {
  if (y_count < 1) return (int)cudaErrorInvalidValue;
  const MulOperand<true> y = {y_lo, y_hi, (uint32_t)y_count};
  return (int)launch_inv_cluster(x_lo, x_hi, y, out, p, pwi, count, logn1,
                                 logn2, logk, stream);
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
  return (int)launch_cols<kFull>(x, lo, hi, pw, count, logn1, logn2, logc,
                                 j2_0, stream);
}

// The passes one at a time over all `count` transforms, for the per-pass
// probes (probes/ablate.py): the two-pass design that the one-pass
// transforms replaced.
// Forward column pass, x: u32 [count, n/2] -> lo, hi: u32 [count, n] at
// [k1, j2]: load and store only, the DFTs without the twiddle, or the whole
// pass.
int cuhe_ntt_cols_io(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                     const uint64_t* pw, int count, int logn1, int logn2,
                     cudaStream_t stream) {
  return (int)launch_cols<kIo>(x, lo, hi, pw, count, logn1, logn2, logn2, 0,
                               stream);
}

int cuhe_ntt_cols_notw(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                       const uint64_t* pw, int count, int logn1, int logn2,
                       cudaStream_t stream) {
  return (int)launch_cols<kNoEpilogue>(x, lo, hi, pw, count, logn1, logn2,
                                       logn2, 0, stream);
}

int cuhe_ntt_cols(const uint32_t* x, uint32_t* lo, uint32_t* hi,
                  const uint64_t* pw, int count, int logn1, int logn2,
                  cudaStream_t stream) {
  return (int)launch_cols<kFull>(x, lo, hi, pw, count, logn1, logn2, logn2,
                                 0, stream);
}

// Forward row pass, out of place:
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
// [count, n]: load and store only, or the whole pass (the first pass of the
// two-pass design).
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
// the mod p, or out: u32 [count, n] mod p[count] (the second pass of the
// two-pass design).
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
// 6 inv_nomod, 7 inv_cols, 8 the one-pass forward of digit windows, 9 the
// one-pass inverse, 10 the one-pass inverse of a product, 11 the one-pass
// forward), or minus a CUDA error.
int cuhe_ntt_blocks_per_sm(int pass, int logn1, int logn2, cudaStream_t) {
  int occ = 0;
  const cudaError_t e = query_pass(pass, logn1, logn2, &occ);
  return e == cudaSuccess ? occ : -(int)e;
}

// Thread-block clusters of the one-pass kernel that pass `pass` (8 to 11
// above) launches at this shape that the device holds at once, or minus a
// CUDA error.
int cuhe_ntt_active_clusters(int pass, int logn1, int logn2, cudaStream_t) {
  if (pass < 8 || pass > 11) return -(int)cudaErrorInvalidValue;
  int occ = kActiveClusters;
  const cudaError_t e = query_pass(pass, logn1, logn2, &occ);
  return e == cudaSuccess ? occ : -(int)e;
}

}  // extern "C"
