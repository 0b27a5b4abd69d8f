// Integer multiply-rate calibration, for the operation side of a kernel's
// bound (the least time the card could take for its work).
//
// The card's data sheet gives no integer rates beside the int8 tensor
// cores, and the Goldilocks kernels run on the integer pipes.  This is the
// Hopper counterpart of the multiply half only of the TPU's VPU rate probe
// (scripts/tpu_probe_calib.py::bench_vpu); its add / xor / shift half is
// csrc/probe_alu.cu.  Every thread runs kChains independent dependency
// chains of one multiply each, with nothing else in the loop, so the launch
// runs at the card's peak rate for that multiply.
//   mode 0: 64x64 -> 128-bit products.  Chain a takes the low word (a * y),
//           chain b the high word (__umul64hi(b, y)); one step of both is
//           one full product, the part of a Goldilocks multiply that no
//           algorithm avoids.
//   mode 1: 32x32 + 64 -> 64-bit multiply-adds in one wide instruction
//           (t = hi32(t) * m + t), the step of a multiword product such as
//           the ICRT's.
//   mode 2: the same 32x32 -> 64-bit products as two narrow instructions:
//           chain a the low word (a * m), chain b the high word
//           (__umulhi(b, m)).  The faster of modes 1 and 2 is the card's
//           rate for such products.
// Each thread writes the XOR of its chains, so nothing is optimised away.
// Products (or multiply-adds) per launch: blocks * kThreads * kChains * iters.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

__global__ void __launch_bounds__(kThreads)
calib_kernel(uint64_t* __restrict__ out, int mode, int iters) {
  const uint64_t tid = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
  // A multiplier known only at run time, so the compiler cannot turn the
  // multiplies into shifts.
  const uint64_t y = 0xFFFFFFFF00000001ull ^ ((uint64_t)(uint32_t)iters << 33);
  uint64_t a[kChains], b[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    a[k] = (tid * kChains + k) * 0x9E3779B97F4A7C15ull + 1;
    b[k] = a[k] | (1ull << 63);
  }
  if (mode == 0) {
#pragma unroll 4
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        a[k] = a[k] * y;
        b[k] = __umul64hi(b[k], y);
      }
    }
  } else if (mode == 1) {
    const uint32_t m = (uint32_t)(y >> 32) | 1u;
#pragma unroll 4
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        a[k] = (a[k] >> 32) * m + a[k];
      }
    }
  } else {
    const uint32_t m = (uint32_t)(y >> 32) | 1u;
    uint32_t a32[kChains], b32[kChains];
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      a32[k] = (uint32_t)a[k] | 1u;
      b32[k] = (uint32_t)b[k] | (1u << 31);
    }
#pragma unroll 4
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        a32[k] = a32[k] * m;
        b32[k] = __umulhi(b32[k], m);
      }
    }
#pragma unroll
    for (int k = 0; k < kChains; ++k) a[k] = ((uint64_t)b32[k] << 32) | a32[k];
  }
  uint64_t r = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) r ^= a[k] ^ b[k];
  out[tid] = r;
}

}  // namespace

extern "C" {

// out: u64 [blocks * 256]; operations per launch: blocks * 256 * 8 * iters.
int cuhe_calib(uint64_t* out, int mode, int iters, int blocks,
               cudaStream_t stream) {
  if (mode < 0 || mode > 2 || iters < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  calib_kernel<<<blocks, kThreads, 0, stream>>>(out, mode, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
