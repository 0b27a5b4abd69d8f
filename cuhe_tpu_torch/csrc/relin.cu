// Relinearization multiply-accumulate against the eval keys.
//
// Replaces the contraction half of the TPU kernels
//   cuhe_tpu/ops/ntt_kernels.py::_relin_call   (B4)
//   cuhe_tpu/ops/ntt_kernels.py::_relin_p_call (B5, planes in chunks)
// which accumulate into an output block revisited across a *sequential*
// digit grid axis.  Blocks on the card run in parallel and in no order, so
// the sum over digits is a loop inside each thread instead: with the c digit
// NTTs of a chunk already in device memory (csrc/ntt.cu, digit prologue),
//   out[b, p, k] = prev[b, p, k] + sum_{jj < c} D[jj, b, k] * ek[j0 + jj, p, k]
// mod P.  Chunks run in order on one stream, each adding the previous
// chunk's partial, so no atomics are needed.  Eval keys and digit NTTs are
// both mat-linear, so the contraction is pointwise in k.
//
// What bounds it: device memory at the shapes of the gate step.  A thread
// owns one position k for a tile of kTB ciphertexts by kTP planes, so each
// loaded digit word is used kTP times and each eval-key word kTB times,
// cutting the eval-key traffic (the largest operand: 262 MB at PRINCE
// level 0) by kTB against one thread per (b, p, k).

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTB = 4;
constexpr int kTP = 4;

__global__ void __launch_bounds__(kThreads)
relin_mulacc_kernel(const uint32_t* __restrict__ d_lo,
                    const uint32_t* __restrict__ d_hi,
                    const uint32_t* __restrict__ ek_lo,
                    const uint32_t* __restrict__ ek_hi,
                    const uint32_t* __restrict__ prev_lo,
                    const uint32_t* __restrict__ prev_hi,
                    uint32_t* __restrict__ out_lo,
                    uint32_t* __restrict__ out_hi, int batch, int pnum,
                    int pnum_ek, int n, int c, int j0) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int b0 = blockIdx.y * kTB, p0 = blockIdx.z * kTP;

  uint64_t acc[kTB][kTP];
#pragma unroll
  for (int i = 0; i < kTB; ++i) {
#pragma unroll
    for (int q = 0; q < kTP; ++q) {
      const int b = b0 + i, p = p0 + q;
      acc[i][q] = (prev_lo && b < batch && p < pnum)
                      ? gl_load(prev_lo, prev_hi,
                                ((size_t)b * pnum + p) * n + k)
                      : 0;
    }
  }
  for (int jj = 0; jj < c; ++jj) {
    uint64_t d[kTB], e[kTP];
#pragma unroll
    for (int i = 0; i < kTB; ++i) {
      d[i] = b0 + i < batch
                 ? gl_load(d_lo, d_hi, ((size_t)jj * batch + b0 + i) * n + k)
                 : 0;
    }
#pragma unroll
    for (int q = 0; q < kTP; ++q) {
      e[q] = p0 + q < pnum
                 ? gl_load(ek_lo, ek_hi,
                           ((size_t)(j0 + jj) * pnum_ek + p0 + q) * n + k)
                 : 0;
    }
#pragma unroll
    for (int i = 0; i < kTB; ++i) {
#pragma unroll
      for (int q = 0; q < kTP; ++q) {
        acc[i][q] = gl_add(acc[i][q], gl_mul(d[i], e[q]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTB; ++i) {
#pragma unroll
    for (int q = 0; q < kTP; ++q) {
      const int b = b0 + i, p = p0 + q;
      if (b < batch && p < pnum) {
        gl_store(out_lo, out_hi, ((size_t)b * pnum + p) * n + k, acc[i][q]);
      }
    }
  }
}

}  // namespace

extern "C" {

// d: u32 pair [c, batch, n] (digit NTTs j0 .. j0 + c - 1); ek: u32 pair
// [knum, pnum_ek, n]; prev: u32 pair [batch, pnum, n] or null -> out.
int cuhe_relin_mulacc(const uint32_t* d_lo, const uint32_t* d_hi,
                      const uint32_t* ek_lo, const uint32_t* ek_hi,
                      const uint32_t* prev_lo, const uint32_t* prev_hi,
                      uint32_t* out_lo, uint32_t* out_hi, int batch, int pnum,
                      int pnum_ek, int n, int c, int j0, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, (batch + kTB - 1) / kTB,
                  (pnum + kTP - 1) / kTP);
  relin_mulacc_kernel<<<grid, kThreads, 0, stream>>>(
      d_lo, d_hi, ek_lo, ek_hi, prev_lo, prev_hi, out_lo, out_hi, batch, pnum,
      pnum_ek, n, c, j0);
  return (int)cudaGetLastError();
}

}  // extern "C"
