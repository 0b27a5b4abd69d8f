// Tensor-core dot rate: the Hopper counterpart of the TPU's MXU rate probe
// (scripts/tpu_probe_calib.py::bench_dot and its dot_kernel).
//
// out = x @ w, x [m, k] and w [k, n] row-major, int8 -> int32 (exact) or
// bf16 -> f32, with the product recomputed `grid` times, as the probe
// recomputes its one block over its grid: gridDim.z copies of the launch
// each compute every tile and write the same result.
//
// What bounds it: the tensor cores, 1979 int8 TOPS and 989 bf16 TFLOPS
// dense (H100 SXM data sheet), which only wgmma fed by TMA reaches.  This
// simple kernel uses the warp-level mma.sync through inline PTX
// (m16n8k32 s8 -> s32, m16n8k16 bf16 -> f32).  A block computes a 128 x 128
// tile of out with 8 warps, 2 along m and 4 along n, each warp 64 x 32 =
// 4 x 4 mma tiles.  K advances in 64-byte slices staged in shared memory
// with no software pipelining; w's slice is transposed on the way in
// (byte or half-word permutes in registers) so that each column's K run is
// contiguous, as the .col B operand wants.  Rows are padded to 80 bytes,
// which makes the fragment reads free of bank conflicts.
//
// In 32-bit words both types share one fragment layout: one mma's K step is
// 32 bytes = 8 words, and thread (g, t) of a warp (g = lane / 4,
// t = lane % 4) holds words t and t + 4 of rows g and g + 8 of the A tile,
// words t and t + 4 of column g of the B tile, and out's entries (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128;
constexpr int kSliceBytes = 64;
constexpr int kSliceWords = kSliceBytes / 4;
constexpr int kRowWords = kSliceWords + 4;  // 80-byte padded smem rows

template <bool BF16>
struct Mma;

template <>
struct Mma<false> {
  using Elem = uint8_t;  // int8 bits
  using Acc = int32_t;
  __device__ static void run(int32_t (&d)[4], const uint32_t (&a)[4],
                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Mma<true> {
  using Elem = uint16_t;  // bf16 bits
  using Acc = float;
  __device__ static void run(float (&d)[4], const uint32_t (&a)[4],
                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// Rows k0 .. k0 + kSlice - 1, columns n0 .. n0 + 127 of w into bs[col][word],
// K contiguous: each thread reads kPer consecutive rows of one word (kPer
// columns) and permutes them into kPer column words.
template <bool BF16>
__device__ __forceinline__ void stage_w(const uint32_t* __restrict__ w32,
                                        uint32_t* bs, int k0, int n0,
                                        int n) {
  constexpr int kPer = BF16 ? 2 : 4;  // elements per word
  const int nw = n / kPer;            // words per row of w
  for (int i = threadIdx.x; i < kSliceWords * (kBN / kPer); i += kThreads) {
    const int cw = i % (kBN / kPer), kw = i / (kBN / kPer);
    const uint32_t* src = w32 + (size_t)(k0 + kw * kPer) * nw + n0 / kPer + cw;
    uint32_t* dst = bs + cw * kPer * kRowWords + kw;
    if constexpr (BF16) {
      const uint32_t r0 = src[0], r1 = src[nw];
      dst[0] = __byte_perm(r0, r1, 0x5410);
      dst[kRowWords] = __byte_perm(r0, r1, 0x7632);
    } else {
      const uint32_t r0 = src[0], r1 = src[nw], r2 = src[2 * nw],
                     r3 = src[3 * nw];
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
      const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t2 = __byte_perm(r0, r1, 0x7362);  // r0.2 r1.2 r0.3 r1.3
      const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
      dst[0] = __byte_perm(t0, t1, 0x5410);
      dst[kRowWords] = __byte_perm(t0, t1, 0x7632);
      dst[2 * kRowWords] = __byte_perm(t2, t3, 0x5410);
      dst[3 * kRowWords] = __byte_perm(t2, t3, 0x7632);
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const uint32_t* __restrict__ x32, const uint32_t* __restrict__ w32,
           typename Mma<BF16>::Acc* __restrict__ out, int k, int n) {
  using Acc = typename Mma<BF16>::Acc;
  constexpr int kElemBytes = BF16 ? 2 : 1;
  __shared__ __align__(16) uint32_t as[kBM * kRowWords];
  __shared__ __align__(16) uint32_t bs[kBN * kRowWords];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int xw = k * kElemBytes / 4;  // words per row of x

  Acc acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  for (int kb = 0; kb < k * kElemBytes; kb += kSliceBytes) {
    __syncthreads();  // the previous slice has been read
    for (int i = threadIdx.x; i < kBM * (kSliceWords / 4); i += kThreads) {
      const int r = i / (kSliceWords / 4), q = i % (kSliceWords / 4);
      *reinterpret_cast<uint4*>(as + r * kRowWords + q * 4) =
          *reinterpret_cast<const uint4*>(x32 + (size_t)(m0 + r) * xw +
                                          kb / 4 + q * 4);
    }
    stage_w<BF16>(w32, bs, kb / kElemBytes, n0, n);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kSliceWords; ks += 8) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint32_t* p = as + (wm + mi * 16 + g) * kRowWords + ks + t;
        a[mi][0] = p[0];
        a[mi][1] = p[8 * kRowWords];
        a[mi][2] = p[4];
        a[mi][3] = p[8 * kRowWords + 4];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint32_t* p = bs + (wn + ni * 8 + g) * kRowWords + ks + t;
        b[ni][0] = p[0];
        b[ni][1] = p[4];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) Mma<BF16>::run(acc[mi][ni], a[mi], b[ni]);
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const size_t r = m0 + wm + mi * 16 + g;
      const int c = n0 + wn + ni * 8 + 2 * t;
      out[r * n + c] = acc[mi][ni][0];
      out[r * n + c + 1] = acc[mi][ni][1];
      out[(r + 8) * n + c] = acc[mi][ni][2];
      out[(r + 8) * n + c + 1] = acc[mi][ni][3];
    }
  }
}

template <bool BF16>
int launch_dot(const void* x, const void* w, void* out, int m, int k, int n,
               int grid, cudaStream_t stream) {
  const int slice = kSliceBytes / (BF16 ? 2 : 1);
  if (m < kBM || n < kBN || k < slice || m % kBM || n % kBN || k % slice ||
      grid < 1 || grid > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 g(n / kBN, m / kBM, grid);
  dot_kernel<BF16><<<g, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
      static_cast<typename Mma<BF16>::Acc*>(out), k, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: int8 [m, k], w: int8 [k, n] -> out: int32 [m, n]; m, n multiples of
// 128, k of 64; the product computed `grid` times.
int cuhe_probe_dot_s8(const void* x, const void* w, void* out, int m, int k,
                      int n, int grid, cudaStream_t stream) {
  return launch_dot<false>(x, w, out, m, k, n, grid, stream);
}

// x: bf16 [m, k], w: bf16 [k, n] -> out: f32 [m, n]; m, n multiples of 128,
// k of 32; the product computed `grid` times.
int cuhe_probe_dot_bf16(const void* x, const void* w, void* out, int m, int k,
                        int n, int grid, cudaStream_t stream) {
  return launch_dot<true>(x, w, out, m, k, n, grid, stream);
}

}  // extern "C"
