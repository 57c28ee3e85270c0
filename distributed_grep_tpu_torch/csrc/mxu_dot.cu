// One-hot membership product on the tensor cores: the probe of what a
// one-hot-dot formulation of byte-class membership costs.
//
// Replaces the TPU kernel benchmarks/kernel_compare.py:bench_mxu_dot's
// `kernel` (the MXU probe, launched through its `probe`) and computes, for
// (chunk, lanes) uint8 stripes with lanes % 4096 == 0 and chunk % 512 == 0
// and a (256, 128) int8 membership matrix M,
//
//   out[li, l, j] = sum over t < chunk, s < 32 of M[x[t, li*4096 + s*128 + l], j]
//
// as int32, shape (lanes / 4096, 128, 128): per lane block li (the
// reference's 32 sublanes x 128 lanes), the sum over every step (t, s) of
// one-hot(x[t, li, s, :]) (128 x 256) @ M (256 x 128).  The reference's
// output BlockSpec maps every grid point to one block and re-zeroes it at
// the first chunk step of each lane block, so its (128, 128) result is
// out[lanes / 4096 - 1] here; every block's MACs run in both.
//
// Design.  The TPU kernel walks its grid in order and keeps the sum in its
// resident output block; here a persistent grid of blocks walks contiguous
// ranges of rows, a row being one (lane block li, t): its 32 steps s are
// the 4096 contiguous bytes x[t, li*4096 .. + 4096].
//   * The product runs as wgmma.mma_async m64n128k32 .s32.s8.s8, the only
//     instruction that reaches Hopper's full int8 tensor-core rate.  Two
//     consumer warpgroups own lanes l in [0, 64) and [64, 128) of a step,
//     each with all 128 columns j as 64 int32 accumulators a thread, kept
//     in registers across the block's steps: per step 8 wgmma (the k32
//     slices of the 256 byte values).
//   * B, the membership matrix, is staged once a block in shared memory as
//     M^T (128 x 256 bytes, 32 KB): 8-bit wgmma takes B K-major only.  It
//     lies in the 128-byte swizzle that the matrix descriptors name: two
//     halves of byte values [0, 128) and [128, 256), column j as a 128-byte
//     row j, its 16-byte chunk c at (c ^ (j & 7)).
//   * A, the one-hot, is built in registers with arithmetic, not loaded:
//     for a k32 slice a thread's 4 registers hold rows g and g + 8 of its
//     warp's 16 lanes at byte columns 4 tig .. + 3 and 16 + 4 tig .. + 3,
//     each `(x >> 2) == column / 4 ? 1 << 8 (x & 3) : 0` (a compare and a
//     select: 64 a step, about 128 thread-instructions per input byte
//     against 8 tensor-core clocks per byte per SM).  Two register sets:
//     the next step's one-hot is built while the tensor cores run the
//     current step's product (commit, then wait until one group is left).
//   * One producer warp brings each row's 4096 bytes with one bulk copy
//     (cp.async.bulk, completing on an mbarrier) into a ring of 3 stages;
//     the consumers release a stage when they have read its bytes.
//   * The launcher splits the rows evenly over one block per SM and passes
//     each block's range.  A block adds its accumulators to the zeroed
//     output with int32 atomicAdd (128 x 128 a flush) where its range
//     leaves a lane block and at its end, and restarts from zero.
//
// Bound.  32768 MACs (128 columns x 256 byte values) per input byte: for a
// 64 MiB segment 2^41 MACs, about 2.2224 ms at the H100 SXM's 1,979 TOP/s
// of dense int8 (NVIDIA's data sheet, 700 W); its bytes take 0.02 ms.
// This kernel takes 2.2639 ms per 64 MiB in a CUDA graph (2.2951 eagerly)
// on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py): 0.98 of the
// int8 rate.  With A as one-hot tiles written to a swizzled shared buffer
// (both operands from shared memory, a proxy fence and a warpgroup barrier
// a step) it took 3.02 ms, and the first version (mma.sync m16n8k32 with
// an identity table in shared memory for A, one block of 8 warps an SM)
// 5.87 ms (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLaneBlock = 4096;  // lanes per output block: 32 x 128
constexpr int kCols = 128;        // l and j
constexpr int kSteps = 32;        // steps s of a row
constexpr int kRowBytes = kSteps * kCols;  // one row: 4096 bytes
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kStages = 3;        // rows in the ring
constexpr int kMaxBlocks = 1000;  // the range table fits a 4 KB parameter block

// Shared memory, from a 1024-byte aligned base (the swizzle's period).
constexpr int kHalfBytes = kCols * 128;        // 128 rows of 128 bytes
constexpr int kStageOff = 2 * kHalfBytes;      // after B (32 KB)
constexpr int kBarOff = kStageOff + kStages * kRowBytes;
constexpr int kSmemBytes = 1024 + kBarOff + 2 * kStages * 8;

// Row ranges: block b walks rows [row[b], row[b + 1]), row = li * chunk + t.
struct Ranges {
  int row[kMaxBlocks + 1];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// Wait for the phase of `bar` with this parity.  The poll loop lives in
// the asm, so the compiler sees no divergent branch before a wgmma.  No
// poll limit: every phase waited for is completed by the same block (a
// trap after a limit would leave the CUDA context unusable).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(static_cast<uint64_t>(__cvta_generic_to_global(src))), "r"(bytes),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma matrix descriptor of a K-major operand in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (the stride byte
// offset); the leading byte offset is unused for this layout.  A k32 slice
// inside the 128-byte span starts 32 bytes further on.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t{1} << 16) | (uint64_t{1024 >> 4} << 32) |
         (uint64_t{1} << 62);
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

// Keeps the compiler from moving accumulator accesses across a wait.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define DGREP_D_LIST                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define DGREP_D_OUT(d)                                                      \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),   \
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),          \
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),      \
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),      \
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),      \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),      \
      "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),      \
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),      \
      "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),      \
      "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),      \
      "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),      \
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),      \
      "+r"(d[61]), "+r"(d[62]), "+r"(d[63])

// d += A (64 x 32, from registers) @ B (32 x 128, descriptor).
__device__ __forceinline__ void wgmma_rs(int (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " DGREP_D_LIST
      ", {%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : DGREP_D_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The 32 A registers of one step (8 k32 slices x 4) for the bytes xl, xh
// of this thread's rows g and g + 8: register r of slice kk holds byte
// columns 32 kk + 16 (r >> 1) + 4 tig .. + 3 of row g + 8 (r & 1).
__device__ __forceinline__ void one_hot(uint32_t (&a)[8][4], int xl, int xh,
                                        int tig) {
  const int ql = (xl >> 2) - tig, qh = (xh >> 2) - tig;
  const uint32_t bl = 1u << ((xl & 3) * 8), bh = 1u << ((xh & 3) * 8);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    a[kk][0] = ql == 8 * kk ? bl : 0u;
    a[kk][1] = qh == 8 * kk ? bh : 0u;
    a[kk][2] = ql == 8 * kk + 4 ? bl : 0u;
    a[kk][3] = qh == 8 * kk + 4 ? bh : 0u;
  }
}

// One step (t, s): this warpgroup's 64 lanes of `xs` (the step's 128
// bytes) one-hot in `a`, times B, added to `acc`; then wait until only
// this step's product is in flight, so that the other register set may
// be rebuilt.
__device__ __forceinline__ void mma_step(int (&acc)[64], uint32_t (&a)[8][4],
                                         const uint8_t* xs,
                                         const uint64_t (&desc_b)[8], int lo,
                                         int tig) {
  one_hot(a, xs[lo], xs[lo + 8], tig);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_rs(acc, a[kk], desc_b[kk]);
  wgmma_commit();
  wgmma_wait<1>();
}

__global__ void __launch_bounds__(kThreads, 1)
mxu_dot_kernel(const uint8_t* __restrict__ data,
               const int8_t* __restrict__ member, int* __restrict__ out,
               int chunk, int lanes, const __grid_constant__ Ranges ranges) {
  extern __shared__ uint8_t raw_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw_smem) + 1023) & ~uintptr_t{1023});
  uint8_t* bmat = smem;
  uint8_t* stage = smem + kStageOff;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;
  const int r0 = ranges.row[blockIdx.x];
  const int r1 = ranges.row[blockIdx.x + 1];
  if (r0 >= r1) return;  // more blocks than rows
  const int tid = threadIdx.x;
  // the warp's index, uniform to the compiler: wgmma needs a path that no
  // thread-dependent branch leads to
  const int warp_idx = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (tid == kConsumers) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp_idx == kConsumers / 32) {  // the producer: one thread issues copies
    if (tid == kConsumers) {
      for (int r = r0, i = 0; r < r1; ++r, ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        const int li = r / chunk, t = r - li * chunk;
        bulk_load(stage + s * kRowBytes,
                  data + static_cast<size_t>(t) * lanes +
                      static_cast<size_t>(li) * kLaneBlock,
                  kRowBytes, &full[s]);
      }
    }
    return;
  }

  // B = M^T in the 128-byte swizzle: chunk i is (half h, column j, chunk c).
  for (int i = tid; i < 2 * kCols * 8; i += kConsumers) {
    const int h = i >> 10, j = (i >> 3) & (kCols - 1), c = i & 7;
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int k = h * 128 + c * 16 + q * 4 + b;
        v |= static_cast<uint32_t>(static_cast<uint8_t>(
                 __ldg(member + k * kCols + j)))
             << (8 * b);
      }
      w[q] = v;
    }
    *reinterpret_cast<uint4*>(bmat + h * kHalfBytes + j * 128 +
                              ((c ^ (j & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  // make the generic-proxy writes visible to wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  const int wg = tid >> 7;           // warpgroup: lanes l in [64 wg, + 64)
  const int warp = warp_idx & 3;     // its warp: 16 of them
  const int g = (tid & 31) >> 2;
  const int tig = tid & 3;  // the thread's place in its quad
  const int lo = wg * 64 + warp * 16 + g;  // this thread's rows l: lo, lo + 8
  uint64_t desc_b[8];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    desc_b[kk] = sw128_desc(bmat + (kk >> 2) * kHalfBytes + (kk & 3) * 32);
  }

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  uint32_t a0[8][4], a1[8][4];  // the one-hot of even and odd steps

  for (int r = r0, i = 0; r < r1; ++r, ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const uint8_t* row = stage + s * kRowBytes;
    for (int step = 0; step < kSteps; step += 2) {
      mma_step(acc, a0, row + step * kCols, desc_b, lo, tig);
      mma_step(acc, a1, row + (step + 1) * kCols, desc_b, lo, tig);
    }
    mbar_arrive(&empty[s]);  // this thread has read the row's bytes
    const int li = r / chunk;
    if (r + 1 == r1 || r + 1 == (li + 1) * chunk) {
      // the range leaves lane block li: add the sums, restart from zero
      wgmma_wait<0>();
      fence_acc(acc);
      int* o = out + static_cast<size_t>(li) * kCols * kCols;
#pragma unroll
      for (int n8 = 0; n8 < 16; ++n8) {
        const int col = n8 * 8 + tig * 2;
        atomicAdd(o + lo * kCols + col, acc[4 * n8]);
        atomicAdd(o + lo * kCols + col + 1, acc[4 * n8 + 1]);
        atomicAdd(o + (lo + 8) * kCols + col, acc[4 * n8 + 2]);
        atomicAdd(o + (lo + 8) * kCols + col + 1, acc[4 * n8 + 3]);
      }
#pragma unroll
      for (int i2 = 0; i2 < 64; ++i2) acc[i2] = 0;
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream) with `n_blocks` blocks, block b summing rows bounds[b] ..
// bounds[b + 1] (a row is one (lane block, t): row = li * chunk + t);
// `bounds` (host memory, n_blocks + 1 ints) must rise from 0 to
// lanes / 4096 * chunk.  `out` must hold lanes / 4096 x 128 x 128 zeroed
// int32; `member` is 256 x 128 int8 on the card; `data` is 16-byte
// aligned.  Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int dgrep_mxu_dot(const void* data, const void* member, void* out,
                             int chunk, int lanes, const int* bounds,
                             int n_blocks, void* stream) {
  if (chunk <= 0 || lanes <= 0 || chunk % 512 != 0 ||
      lanes % kLaneBlock != 0 || n_blocks < 1 || n_blocks > kMaxBlocks ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ranges ranges;
  const long long rows = static_cast<long long>(lanes / kLaneBlock) * chunk;
  if (bounds[0] != 0 || bounds[n_blocks] != rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int b = 0; b <= n_blocks; ++b) {
    if (b > 0 && bounds[b] < bounds[b - 1]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    ranges.row[b] = bounds[b];
  }
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mxu_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mxu_dot_kernel<<<n_blocks, kThreads, kSmemBytes, st>>>(
      static_cast<const uint8_t*>(data), static_cast<const int8_t*>(member),
      static_cast<int*>(out), chunk, lanes, ranges);
  return static_cast<int>(cudaGetLastError());
}
