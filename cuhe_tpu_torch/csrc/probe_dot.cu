// Tensor-core dot rate: the Hopper counterpart of the TPU's MXU rate probe
// (scripts/tpu_probe_calib.py::bench_dot and its dot_kernel).
//
// out = x @ w, x [m, k] and w [k, n] row-major, int8 -> int32 (exact) or
// bf16 -> f32, with the product recomputed `grid` times, as the probe
// recomputes its one block over its grid: every copy computes every tile and
// writes the same result.
//
// What bounds it: the tensor cores, 1979 int8 TOPS and 989 bf16 TFLOPS
// dense (H100 SXM data sheet), which only wgmma fed by TMA reaches.  So:
//   * a layout pass first: wgmma reads 8-bit operands only K-major, and w
//     arrives N-major, so a small transpose writes w^T [n, k] into scratch
//     once per call (bf16 takes the same pass: one descriptor scheme);
//   * a persistent, warp-specialised kernel: min(#SMs, units) blocks of 384
//     threads walk the units (copy, 128 x BN tile of out) with a stride
//     loop.  Warpgroup 0 is the producer: it gives registers back
//     (setmaxnreg 40) and one thread keeps a ring of shared-memory
//     stages full with TMA loads (128-byte K slices of x and w^T, 128B
//     swizzle), each stage guarded by a full and an empty mbarrier.
//     Warpgroups 1 and 2 are the consumers (setmaxnreg 232): each owns a
//     64 x BN half of the tile and runs wgmma.mma_async on the stage's
//     shared-memory descriptors, 4 per K slice (k16 bf16, k32 int8), keeps
//     one commit group in flight and releases a stage once the group that
//     read it has completed.  The producer runs ahead into the next unit
//     while the consumers store the last one;
//   * the epilogue goes through shared memory and TMA stores: each consumer
//     writes its fragments, a few columns a round, into the next of its
//     output buffers in the 128B-swizzled layout of out's 64 x 32 boxes,
//     and one thread stores the boxes while the warpgroup fills the next
//     buffer or starts the next unit.  Stores straight from the fragments
//     (8 rows x 32 bytes a warp instruction) run far below the TMA store's
//     rate, and with a single buffer a consumer would wait for each round's
//     stores to drain;
//   * BN = 256 where n allows it (3 stages of 48 KB, 2 output buffers of
//     16 KB a consumer: 210 KB), else 128 (5 stages of 32 KB, 4 buffers of
//     8 KB: 225 KB); the host picks BN and the block count (probes/calib.py
//     ::dot_launch_config) and passes them in.
// A K tail of 64 bytes (k * itemsize = 64 mod 128) is the TMA box's zero
// fill past k: the stage's byte count is always the whole box.
//
// Two stop points, compile-time variants of the same kernel with their own
// entry points: LOADS_ONLY runs the TMA ring and the barriers and the
// consumers release each stage without wgmma (out is zero); MMA_ONLY runs
// the wgmma loop on one resident, zeroed stage with no loads and no layout
// pass (out is zero).  Both keep the epilogue.
//
// Accumulator fragment of m64nNk16 / m64nNk32 (f32 or s32): thread lane of
// warp w of the warpgroup holds, for i < N / 8, entries (16 w + lane / 4,
// 8 i + 2 (lane % 4)) and the next column in d[4 i], d[4 i + 1], and the
// same 8 rows below in d[4 i + 2], d[4 i + 3].

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kBM = 128;
constexpr int kSliceBytes = 128;  // one K slice: a 128B-swizzled row
constexpr int kATileBytes = kBM * kSliceBytes;
constexpr int kConsumerWarps = 8;

enum Mode { kFull = 0, kLoadsOnly = 1, kMmaOnly = 2 };

// The shared memory of one block: kStages ring stages (a 128 x 128-byte
// slice of x, a BN x 128-byte slice of w^T), then each consumer's kBufs
// output buffers of 64 rows x kCols columns (kCols / 32 TMA boxes of 64
// rows x 128 bytes), then the barriers; 1024 bytes of slack align the
// stages.  BN = 256: 3 stages, 2 buffers of 64 columns; BN = 128: 5
// stages, 4 of 32 (every ring and epilogue shape that fits measured within
// a few per cent of these on an H100).
template <int BN>
struct Ring {
  static constexpr int kStageBytes = kATileBytes + BN * kSliceBytes;
  static constexpr int kStages = BN == 256 ? 3 : 5;
  static constexpr int kCols = BN == 256 ? 64 : 32;
  static constexpr int kBufs = BN == 256 ? 2 : 4;
  static constexpr int kBoxBytes = 64 * 128;
  static constexpr int kBufBytes = 64 * kCols * 4;
  static constexpr int kCBytes = kBufs * kBufBytes;
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes +
                                    2 * kCBytes + 2 * kStages * 8;
  static_assert(kSmemBytes <= 232448, "more than a block's shared memory");
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// A phase that never completes is a fault of the kernel: after 2^28 polls
// (seconds) it traps, and the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// out's 64 x 32 box at (c0, c1) from shared memory, in the bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// all but the last N bulk store groups have read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void st_shared2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a),
               "f"(b)
               : "memory");
}
__device__ __forceinline__ void st_shared2(uint32_t addr, int32_t a,
                                           int32_t b) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a),
               "r"(b)
               : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in 128B swizzle: start
// address >> 4, LBO 1 (unused by this layout), SBO 1024 B between 8-row
// groups, layout type 1 (128B swizzle) in bits 62-63.  The tile starts on a
// 1024-byte boundary, so the base offset is 0; a K step of 32 bytes adds 2.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(int32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <class Acc, int N>
__device__ __forceinline__ void fence_acc(Acc (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(d[i]);
}

#define CUHE_R0_63                                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define CUHE_R64_127                                                    \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "   \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "   \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "      \
  "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, "  \
  "%113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "  \
  "%124, %125, %126, %127"
#define CUHE_ACC8(C, d, i)                                               \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]),           \
      C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define CUHE_ACC64(C, d, i)                                              \
  CUHE_ACC8(C, d, i), CUHE_ACC8(C, d, i + 8), CUHE_ACC8(C, d, i + 16),   \
      CUHE_ACC8(C, d, i + 24), CUHE_ACC8(C, d, i + 32),                  \
      CUHE_ACC8(C, d, i + 40), CUHE_ACC8(C, d, i + 48),                  \
      CUHE_ACC8(C, d, i + 56)

// One warpgroup product d += A (64 x K, shared) B^T (N x K, shared), K =
// 32 bytes: m64nNk16 bf16 -> f32, m64nNk32 s8 -> s32; scale-d is 1 (the
// accumulator is zeroed before a unit's first product).
template <bool BF16, int BN>
struct Wgmma;

template <>
struct Wgmma<true, 256> {
  using Acc = float;
  __device__ __forceinline__ static void run(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{" CUHE_R0_63 ", " CUHE_R64_127 "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : CUHE_ACC64("+f", d, 0), CUHE_ACC64("+f", d, 64)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<true, 128> {
  using Acc = float;
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" CUHE_R0_63 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : CUHE_ACC64("+f", d, 0)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<false, 256> {
  using Acc = int32_t;
  __device__ __forceinline__ static void run(int32_t (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{" CUHE_R0_63 ", " CUHE_R64_127 "}, %128, %129, p;\n}\n"
        : CUHE_ACC64("+r", d, 0), CUHE_ACC64("+r", d, 64)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<false, 128> {
  using Acc = int32_t;
  __device__ __forceinline__ static void run(int32_t (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{" CUHE_R0_63 "}, %64, %65, p;\n}\n"
        : CUHE_ACC64("+r", d, 0)
        : "l"(a), "l"(b), "r"(1));
  }
};

// ---- the layout pass: w [k, n] -> w^T [n, k] -------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
transpose_kernel(const T* __restrict__ w, T* __restrict__ wt, int k, int n) {
  __shared__ T tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int j = threadIdx.y; j < 32; j += 8)
    tile[j][threadIdx.x] = w[(size_t)(r0 + j) * n + c0 + threadIdx.x];
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8)
    wt[(size_t)(c0 + j) * k + r0 + threadIdx.x] = tile[threadIdx.x][j];
}

// ---- the dot kernel ---------------------------------------------------------

template <bool BF16, int BN, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
dot_kernel(const __grid_constant__ CUtensorMap tm_x,
           const __grid_constant__ CUtensorMap tm_wt,
           const __grid_constant__ CUtensorMap tm_out, int slices,
           int tiles_n, int tiles, long long units) {
  using R = Ring<BN>;
  using Acc = typename Wgmma<BF16, BN>::Acc;
  constexpr int kSliceElems = kSliceBytes / (BF16 ? 2 : 1);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // stages on 1024 B
  const uint32_t cbuf0 = base + R::kStages * R::kStageBytes;
  const uint32_t full0 = cbuf0 + 2 * R::kCBytes;
  const uint32_t empty0 = full0 + R::kStages * 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (MODE != kMmaOnly && threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const int tile = static_cast<int>(u % tiles);
        const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < slices; ++kt) {
          const uint32_t a = base + stage * R::kStageBytes;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full0 + 8 * stage, R::kStageBytes);
          tma_load(&tm_x, a, full0 + 8 * stage, kt * kSliceElems, m0);
          tma_load(&tm_wt, a + kATileBytes, full0 + 8 * stage,
                   kt * kSliceElems, n0);
          if (++stage == R::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: a 64 x BN half of the tile each -----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    if constexpr (MODE == kMmaOnly) {
      // one resident stage of zeros, seen by the async proxy
      const uint4 z = make_uint4(0, 0, 0, 0);
      uint4* s0 = reinterpret_cast<uint4*>(smem_raw + (base - raw));
      for (int i = threadIdx.x - 128; i < R::kStageBytes / 16; i += 256)
        s0[i] = z;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
    }
    Acc acc[BN / 2];
    uint32_t round = 0;  // epilogue rounds so far: buffer round % kBufs
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const int tile = static_cast<int>(u % tiles);
      const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      for (int kt = 0; kt < slices; ++kt) {
        const uint32_t a = base + stage * R::kStageBytes;
        if constexpr (MODE != kMmaOnly) mbar_wait(full0 + 8 * stage, phase);
        if constexpr (MODE == kLoadsOnly) {
          if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        } else {
          const uint64_t da = smem_desc(a + cw * (kATileBytes / 2));
          const uint64_t db = smem_desc(a + kATileBytes);
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Wgmma<BF16, BN>::run(acc, da + 2 * j, db + 2 * j);
          wgmma_commit();
          fence_acc(acc);
          // the group before this one has read its stage: release it
          wgmma_wait<1>();
          if (MODE == kFull && kt > 0 && lane == 0)
            mbar_arrive(empty0 + 8 * prev);
        }
        prev = stage;
        if (MODE != kMmaOnly && ++stage == R::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if constexpr (MODE != kLoadsOnly) {
        wgmma_wait<0>();
        fence_acc(acc);
        if (MODE == kFull && lane == 0) mbar_arrive(empty0 + 8 * prev);
      }
      // The epilogue, kCols columns a round: the fragments into the next of
      // this consumer's buffers, in the 128B-swizzled layout of out's TMA
      // boxes (16-byte chunk c of row r at chunk c ^ (r % 8)), once the
      // stores of its last round have read it; then one thread stores the
      // boxes with TMA while the warpgroup goes on.
      const uint32_t cbuf = cbuf0 + cw * R::kCBytes;
      const int r = 16 * warp + lane / 4;
#pragma unroll
      for (int rd = 0; rd < BN / R::kCols; ++rd, ++round) {
        const uint32_t buf = cbuf + round % R::kBufs * R::kBufBytes;
        if (threadIdx.x % 128 == 0) bulk_wait_read<R::kBufs - 1>();
        named_sync(2 + cw, 128);
#pragma unroll
        for (int ii = 0; ii < R::kCols / 8; ++ii) {
          const int i = rd * (R::kCols / 8) + ii;
          const int c = 8 * ii + 2 * (lane % 4);  // column in the round
          const int cb = (c % 32) * 4;            // byte in the box's row
          const uint32_t box = buf + (c / 32) * R::kBoxBytes +
                               ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15));
          st_shared2(box + r * 128, acc[4 * i], acc[4 * i + 1]);
          st_shared2(box + (r + 8) * 128, acc[4 * i + 2], acc[4 * i + 3]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(2 + cw, 128);
        if (threadIdx.x % 128 == 0) {
#pragma unroll
          for (int b = 0; b < R::kCols / 32; ++b)
            tma_store(&tm_out, buf + b * R::kBoxBytes,
                      n0 + rd * R::kCols + 32 * b, m0 + 64 * cw);
          bulk_commit();
        }
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait();
  }
}

// ---- host side -------------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda)
cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || !p) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// 2-D map of a row-major [rows, cols] matrix of `es`-byte elements: boxes
// of 128 bytes of a row by box_rows rows, 128B swizzle, zeros past the
// edges.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr,
                       CUtensorMapDataType type, int es, int rows, int cols,
                       int box_rows) {
  EncodeTiled encode;
  const cudaError_t e = encode_fn(&encode);
  if (e != cudaSuccess) return e;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * es};
  cuuint32_t box[2] = {(cuuint32_t)(128 / es), (cuuint32_t)box_rows};
  cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool BF16, int BN, int MODE>
int launch(const void* x, const void* w, void* wt, void* out, int m, int k,
           int n, int grid, int blocks, cudaStream_t stream) {
  using R = Ring<BN>;
  const int es = BF16 ? 2 : 1;
  if constexpr (MODE != kMmaOnly) {
    const dim3 tg(n / 32, k / 32), tb(32, 8);
    if (BF16)
      transpose_kernel<uint16_t><<<tg, tb, 0, stream>>>(
          static_cast<const uint16_t*>(w), static_cast<uint16_t*>(wt), k, n);
    else
      transpose_kernel<uint8_t><<<tg, tb, 0, stream>>>(
          static_cast<const uint8_t*>(w), static_cast<uint8_t*>(wt), k, n);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const auto in_type =
      BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap tm_x, tm_wt, tm_out;
  cudaError_t e = tensor_map(&tm_x, x, in_type, es, m, k, kBM);
  if (e == cudaSuccess) e = tensor_map(&tm_wt, wt, in_type, es, n, k, BN);
  if (e == cudaSuccess)
    e = tensor_map(&tm_out, out,
                   BF16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_INT32,
                   4, m, n, 64);
  if (e != cudaSuccess) return (int)e;
  auto kern = &dot_kernel<BF16, BN, MODE>;
  // the shared-memory size above 48 KB, once per device (a host call each
  // time would sit inside every timed call)
  static uint64_t attribute_set = 0;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(attribute_set >> dev & 1)) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             R::kSmemBytes);
    if (e == cudaSuccess) attribute_set |= 1ull << dev;
  }
  if (e != cudaSuccess) return (int)e;
  const int tiles_n = n / BN, tiles = m / kBM * tiles_n;
  const int slices = (k * es + kSliceBytes - 1) / kSliceBytes;
  kern<<<blocks, kThreads, R::kSmemBytes, stream>>>(
      tm_x, tm_wt, tm_out, slices, tiles_n, tiles, (long long)grid * tiles);
  return (int)cudaGetLastError();
}

template <bool BF16, int MODE>
int dispatch(const void* x, const void* w, void* wt, void* out, int m, int k,
             int n, int grid, int bn, int blocks, cudaStream_t stream) {
  const int es = BF16 ? 2 : 1;
  if (m < kBM || n < 128 || k < 1 || m % kBM || n % bn || (k * es) % 64 ||
      (bn != 128 && bn != 256) || k / 32 > 65535 || grid < 1 ||
      grid > 65535 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  return bn == 256
             ? launch<BF16, 256, MODE>(x, w, wt, out, m, k, n, grid, blocks,
                                       stream)
             : launch<BF16, 128, MODE>(x, w, wt, out, m, k, n, grid, blocks,
                                       stream);
}

}  // namespace

extern "C" {

// x: int8 [m, k], w: int8 [k, n] -> out: int32 [m, n], through wt: int8
// [n, k] scratch; m a multiple of 128, n of bn (128 or 256), k of 64; the
// product computed `grid` times by `blocks` persistent blocks.
int cuhe_probe_dot_s8(const void* x, const void* w, void* wt, void* out, int m,
                      int k, int n, int grid, int bn, int blocks,
                      cudaStream_t stream) {
  return dispatch<false, kFull>(x, w, wt, out, m, k, n, grid, bn, blocks,
                                stream);
}

// x: bf16 [m, k], w: bf16 [k, n] -> out: f32 [m, n], through wt: bf16 [n, k]
// scratch; k a multiple of 32; otherwise as cuhe_probe_dot_s8.
int cuhe_probe_dot_bf16(const void* x, const void* w, void* wt, void* out,
                        int m, int k, int n, int grid, int bn, int blocks,
                        cudaStream_t stream) {
  return dispatch<true, kFull>(x, w, wt, out, m, k, n, grid, bn, blocks,
                               stream);
}

// The stop points, for int8 (bf16 = 0) or bf16 inputs: out is zero.
int cuhe_probe_dot_loads_only(const void* x, const void* w, void* wt,
                              void* out, int m, int k, int n, int grid, int bn,
                              int blocks, int bf16, cudaStream_t stream) {
  return bf16 ? dispatch<true, kLoadsOnly>(x, w, wt, out, m, k, n, grid, bn,
                                           blocks, stream)
              : dispatch<false, kLoadsOnly>(x, w, wt, out, m, k, n, grid, bn,
                                            blocks, stream);
}

int cuhe_probe_dot_mma_only(const void* x, const void* w, void* wt, void* out,
                            int m, int k, int n, int grid, int bn, int blocks,
                            int bf16, cudaStream_t stream) {
  return bf16 ? dispatch<true, kMmaOnly>(x, w, wt, out, m, k, n, grid, bn,
                                         blocks, stream)
              : dispatch<false, kMmaOnly>(x, w, wt, out, m, k, n, grid, bn,
                                          blocks, stream);
}

}  // extern "C"
