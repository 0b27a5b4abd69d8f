// Relinearization multiply-accumulate against the eval keys.
//
// Replaces the contraction half of the TPU kernels
//   cuhe_tpu/ops/ntt_kernels.py::_relin_call   (B4)
//   cuhe_tpu/ops/ntt_kernels.py::_relin_p_call (B5, planes in chunks)
// which accumulate into an output block revisited across a *sequential*
// digit grid axis.  Blocks on the card run in parallel and in no order, so
// the sum over digits is a loop inside each block instead: with the c digit
// NTTs already in device memory (csrc/ntt.cu, digit prologue),
//   out[b, p, k] = prev[b, p, k] + sum_{jj < c} D[jj, b, k] * ek[j0 + jj, p, k]
// mod P.  Eval keys and digit NTTs are both mat-linear, so the contraction is
// pointwise in k: at each position a [batch x c] by [c x pnum] product.
// The gate step runs it once, over all its digits (ops/relin.py).
//
// What bounds it: the 64 x 64 -> 128-bit products, batch * pnum * c * n of
// them (1.05 G per gate step at PRINCE level 0), on the integer multiply-add
// pipe; the bytes (each digit word, eval-key word and output once) take
// under half as long on an H100.  So the design spends as little as it can
// beside the four 32 x 32-bit partial products of each product:
//   * lazy accumulation: each product goes unreduced into an even and an odd
//     accumulator of 64-bit words (goldilocks.cuh gl_acc_mac: four wide
//     multiplies, three adds with carry), and each output is reduced once,
//     after its last digit (gl_acc_reduce).  Exact for fewer than 2^31
//     digits (the front end checks c against LAZY_MAX_DIGITS); the previous
//     partial, where given, starts the accumulator;
//   * each operand word read from device memory once: a block owns kK = 32
//     consecutive positions for a tile of kRB * bg ciphertexts by kRP * pg
//     planes; per digit it stages the digit-NTT and eval-key words of its
//     positions in shared memory with 16-byte cp.async copies, kStages - 1
//     digits ahead, and each thread computes a kRB x kRP register sub-tile
//     at one position, so each staged word feeds kRP (digit) or kRB
//     (eval key) products from registers.  The ciphertext tiles of one run
//     of positions are neighbouring blocks, so the eval-key words they share
//     come from L2;
//   * occupancy over reuse: 2 x 5 outputs a thread (10 accumulators of 8
//     words) and 640 threads a block (8 ciphertexts by 25 planes at PRINCE
//     level 0) ran faster on an H100 than 4 x 5 at 320, which spill or keep
//     fewer warps in flight to cover the multiply-adds' latency.
// SASS per product (cuobjdump, chip_smoke.py phase 1) and times: PERF.md.
// Tensor cores are not used: a 64-bit product mod P splits into 64 int8
// products with a Toeplitz-expanded operand, about 1.3-2.5e11 int8
// operations per PRINCE step; at the 176-179 T op/s the hand-written
// mma.sync route measured on an H100 (PERF.md, section 6) that is no
// faster than the CUDA cores, and wgmma near its peak is a project of its
// own (ROADMAP).

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int kK = 32;       // positions per block: one warp across them
constexpr int kRB = 2;       // ciphertexts per thread
constexpr int kRP = 5;       // planes per thread
constexpr int kStages = 3;   // digits in shared memory: one read, two landing
constexpr int kMaxThreads = 640;

// Where the kK words of a staged row of one plane come from: base + jj *
// stride at digit jj; base is null for a row past the batch or pnum.
struct alignas(16) RowSrc {
  const uint32_t* base;
  long long stride;
};

// The tile of a block of kK x bg x pg threads.
struct Tile {
  int bg, pg;
  __host__ __device__ int tb() const { return kRB * bg; }
  __host__ __device__ int tp() const { return kRP * pg; }
  __host__ __device__ int rows() const { return tb() + tp(); }
  // kStages digits of rows x {lo, hi} x kK words, then the rows' sources
  __host__ __device__ int smem() const {
    return kStages * rows() * 2 * kK * 4 + 2 * rows() * (int)sizeof(RowSrc);
  }
};

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__global__ void __launch_bounds__(kMaxThreads)
relin_mulacc_kernel(const uint32_t* __restrict__ d_lo,
                    const uint32_t* __restrict__ d_hi,
                    const uint32_t* __restrict__ ek_lo,
                    const uint32_t* __restrict__ ek_hi,
                    const uint32_t* __restrict__ prev_lo,
                    const uint32_t* __restrict__ prev_hi,
                    uint32_t* __restrict__ out_lo,
                    uint32_t* __restrict__ out_hi, int batch, int pnum,
                    int pnum_ek, int n, int c, int j0) {
  extern __shared__ uint4 smem4[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem4);
  const Tile t{(int)blockDim.y, (int)blockDim.z};
  const int tb = t.tb(), rows = t.rows();
  const int b0 = blockIdx.x * tb, k0 = blockIdx.y * kK,
            p0 = blockIdx.z * t.tp();
  const int tid = (threadIdx.z * blockDim.y + threadIdx.y) * kK + threadIdx.x;
  const int nthreads = kK * t.bg * t.pg;

  // The source of each staged row and plane: row r < tb is ciphertext
  // b0 + r, row tb + q plane p0 + q; plane 0 the low words, 1 the high.  A
  // row's kK words at digit jj start at base + jj * stride.  Rows past the
  // batch or pnum have no source and are zero-filled.
  RowSrc* src = reinterpret_cast<RowSrc*>(sm + kStages * rows * 2 * kK);
  for (int i = tid; i < 2 * rows; i += nthreads) {
    const int r = i >> 1, hi = i & 1;
    RowSrc d{nullptr, 0};
    if (r < tb) {
      if (b0 + r < batch) {
        d = RowSrc{(hi ? d_hi : d_lo) + (size_t)(b0 + r) * n + k0,
                   (long long)batch * n};
      }
    } else if (p0 + r - tb < pnum) {
      d = RowSrc{(hi ? ek_hi : ek_lo) +
                     ((size_t)j0 * pnum_ek + p0 + r - tb) * n + k0,
                 (long long)pnum_ek * n};
    }
    src[i] = d;
  }
  __syncthreads();

  // Stage digit jj: the rows' words, 16 bytes per copy, in [row][plane][kK].
  auto stage = [&](int jj) {
    uint32_t* st = sm + (jj % kStages) * rows * 2 * kK;
    for (int ch = tid; ch < rows * 16; ch += nthreads) {
      const RowSrc d = src[ch >> 3];
      const int q = (ch & 7) * 4;
      cp_async16(st + ch * 4, d.base ? d.base + jj * d.stride + q : d_lo,
                 d.base != nullptr);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int k = k0 + threadIdx.x;
  const int rb0 = threadIdx.y * kRB, rp0 = tb + threadIdx.z * kRP;
  gl_acc acc[kRB][kRP];
#pragma unroll
  for (int i = 0; i < kRB; ++i) {
#pragma unroll
    for (int q = 0; q < kRP; ++q) {
      const int b = b0 + rb0 + i, p = p0 + threadIdx.z * kRP + q;
      const uint64_t v = (prev_lo && b < batch && p < pnum)
                             ? gl_load(prev_lo, prev_hi,
                                       ((size_t)b * pnum + p) * n + k)
                             : 0;
      acc[i][q] = gl_acc_init(v);
    }
  }

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < c) stage(s);
    else asm volatile("cp.async.commit_group;\n" ::);
  }
#pragma unroll 2
  for (int jj = 0; jj < c; ++jj) {
    if (jj + kStages - 1 < c) stage(jj + kStages - 1);
    else asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    __syncthreads();
    const uint32_t* st = sm + (jj % kStages) * rows * 2 * kK + threadIdx.x;
    uint64_t d[kRB], e[kRP];
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      d[i] = st[(rb0 + i) * 2 * kK] |
             ((uint64_t)st[((rb0 + i) * 2 + 1) * kK] << 32);
    }
#pragma unroll
    for (int q = 0; q < kRP; ++q) {
      e[q] = st[(rp0 + q) * 2 * kK] |
             ((uint64_t)st[((rp0 + q) * 2 + 1) * kK] << 32);
    }
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
#pragma unroll
      for (int q = 0; q < kRP; ++q) gl_acc_mac(acc[i][q], d[i], e[q]);
    }
    __syncthreads();  // the stage is refilled at the next digit
  }

#pragma unroll
  for (int i = 0; i < kRB; ++i) {
#pragma unroll
    for (int q = 0; q < kRP; ++q) {
      const int b = b0 + rb0 + i, p = p0 + threadIdx.z * kRP + q;
      if (b < batch && p < pnum) {
        gl_store(out_lo, out_hi, ((size_t)b * pnum + p) * n + k,
                 gl_acc_reduce(acc[i][q]));
      }
    }
  }
}

bool tile_ok(const Tile& t) {
  return t.bg >= 1 && t.pg >= 1 && kK * t.bg * t.pg <= kMaxThreads &&
         t.smem() <= 48 * 1024;
}

}  // namespace

extern "C" {

// d: u32 pair [c, batch, n] (digit NTTs j0 .. j0 + c - 1); ek: u32 pair
// [knum, pnum_ek, n]; prev: u32 pair [batch, pnum, n] or null -> out.  The
// block tile is bg x pg thread groups (ops/ntt_kernels.py::relin_tile);
// n must be a multiple of 32 and d, ek 16-byte aligned.
int cuhe_relin_mulacc(const uint32_t* d_lo, const uint32_t* d_hi,
                      const uint32_t* ek_lo, const uint32_t* ek_hi,
                      const uint32_t* prev_lo, const uint32_t* prev_hi,
                      uint32_t* out_lo, uint32_t* out_hi, int batch, int pnum,
                      int pnum_ek, int n, int c, int j0, int bg, int pg,
                      cudaStream_t stream) {
  const Tile t{bg, pg};
  if (!tile_ok(t) || n % kK || c < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((batch + t.tb() - 1) / t.tb(), n / kK,
                  (pnum + t.tp() - 1) / t.tp());
  relin_mulacc_kernel<<<grid, dim3(kK, bg, pg), t.smem(), stream>>>(
      d_lo, d_hi, ek_lo, ek_hi, prev_lo, prev_hi, out_lo, out_hi, batch, pnum,
      pnum_ek, n, c, j0);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel at tile bg x pg, or minus a CUDA
// error.
int cuhe_relin_blocks_per_sm(int bg, int pg, cudaStream_t) {
  const Tile t{bg, pg};
  if (!tile_ok(t)) return -(int)cudaErrorInvalidValue;
  int occ = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, relin_mulacc_kernel, kK * bg * pg, t.smem());
  return e == cudaSuccess ? occ : -(int)e;
}

}  // extern "C"
