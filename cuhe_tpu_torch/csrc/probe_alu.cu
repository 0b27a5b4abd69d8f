// 32-bit add / xor / shift rate: the Hopper counterpart of the integer half
// of the TPU's VPU rate probe (scripts/tpu_probe_calib.py::bench_vpu and its
// vpu_kernel; the multiply half is csrc/calib.cu).
//
// The probe's recurrence, exactly: y = x, then `reps` times
//   y = (y + x) ^ (y >> 3)
// over u32 words (wrap-around add, logical shift), with the whole array
// recomputed `grid` times: the TPU grid revisits one block `grid` times;
// here gridDim.y copies of the launch each recompute every element and
// write the same result.  Operations, counted as bench_vpu counts them:
// 3 * count * reps * grid.
//
// What bounds it: the integer pipes.  Each step is one add, one shift and
// one xor.  The shift (SHF) and the xor (LOP3) run on the ALU pipe; nvcc
// issues the add as IMAD.IADD on the FMA pipe, each pipe 64 results per
// clock per SM on compute capability 9.0 (CUDA C++ Programming Guide,
// throughput table), so the ALU pipe sets the least time at two of the three
// operations per slot.  probes/calib.py reads the loop's instructions from
// this kernel's SASS and takes the bound from them.  The bytes, one read and
// one write of each word per copy, take far less.  One chain per thread
// would be bound by the latency of its dependent steps, so each thread
// carries kElems independent elements.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kElems = 8;

__global__ void __launch_bounds__(kThreads)
alu_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
           int count, int reps) {
  const int stride = gridDim.x * kThreads;
  const int i0 = blockIdx.x * kThreads + threadIdx.x;
  uint32_t xv[kElems], y[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int i = i0 + e * stride;
    xv[e] = i < count ? x[i] : 0u;
    y[e] = xv[e];
  }
#pragma unroll 4
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int e = 0; e < kElems; ++e) y[e] = (y[e] + xv[e]) ^ (y[e] >> 3);
  }
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int i = i0 + e * stride;
    if (i < count) out[i] = y[e];
  }
}

}  // namespace

extern "C" {

// x, out: u32 [count]; the recurrence `reps` times, recomputed `grid` times.
int cuhe_probe_alu(const uint32_t* x, uint32_t* out, int count, int reps,
                   int grid, cudaStream_t stream) {
  if (count < 1 || reps < 0 || grid < 1 || grid > 65535)
    return (int)cudaErrorInvalidValue;
  const int per_block = kThreads * kElems;
  const dim3 g((count + per_block - 1) / per_block, grid);
  alu_kernel<<<g, kThreads, 0, stream>>>(x, out, count, reps);
  return (int)cudaGetLastError();
}

}  // extern "C"
