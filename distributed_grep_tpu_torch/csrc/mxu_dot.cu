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
// resident output block; here blocks run in parallel and in no order.
//   * The product runs as mma.sync m16n8k32 s8 x s8 -> s32 (inline PTX) on
//     the tensor cores, with the int32 accumulators in registers across all
//     of a block's (t, s) steps.  A block of 8 warps owns one lane block's
//     128 x 128 output: warp w covers lanes l in [64 (w / 4), + 64) (four
//     m16 tiles) and columns j in [32 (w % 4), + 32) (four n8 tiles).
//   * M's B fragments for the warp's 32 columns and all 256 byte values
//     (8 k32 slices x 4 n8 tiles x 2 registers) are loaded once and stay in
//     registers.
//   * The one-hot A fragments are not built with compares (about 64
//     integer operations per input byte): each is a 32-bit load from a 256
//     x 256 identity table in shared memory (row x holds byte 1 at column
//     x), its rows padded to 272 bytes so that the rows of different bytes
//     fall on different banks more often.
//   * A 64 MB segment has 16 lane blocks, too few blocks for 132 SMs, so the
//     (t, s) reduction is split across `splits` blocks per lane block
//     (grid lane_blocks x splits); each adds its sums to the zeroed output
//     with int32 atomicAdd.
//   * Each round, the block stages 32 steps' 128-byte rows in shared memory
//     with one 16-byte load per thread.
//
// Bound.  32768 MACs (128 columns x 256 byte values) per input byte: for a
// 64 MiB segment 2^41 MACs, about 2.2 ms at the H100 SXM's 1,979 TOP/s of
// dense int8 (NVIDIA's data sheet, 700 W).  mma.sync does not reach that
// rate on Hopper (wgmma does), and each m16n8k32 here also costs one
// shared-memory load of its A fragment.  This first version is simple and
// right: it takes 5.87 ms per 64 MiB (2.6x the bound; 255 registers, no
// spill) on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py, PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLaneBlock = 4096;  // lanes per output block: 32 x 128
constexpr int kCols = 128;        // l and j
constexpr int kThreads = 256;     // 8 warps
constexpr int kStageSteps = 32;   // (t, s) steps staged per round
constexpr int kIdStride = 272;    // bytes per identity row: 256 + 16 pad
constexpr int kSmemBytes = 256 * kIdStride + kStageSteps * kCols;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 1)
mxu_dot_kernel(const uint8_t* __restrict__ data,
               const int8_t* __restrict__ member, int* __restrict__ out,
               int chunk, int lanes, int splits) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ident = smem;
  uint8_t* stage = smem + 256 * kIdStride;
  const int li = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;  // mma groupID
  const int tig = tid & 3;        // mma thread-in-group
  const int q = warp & 3;         // columns j in [32 q, 32 q + 32)
  const int h = warp >> 2;        // lanes l in [64 h, 64 h + 64)

  uint32_t* id32 = reinterpret_cast<uint32_t*>(ident);
  for (int i = tid; i < 256 * (kIdStride / 4); i += kThreads) {
    const int r = i / (kIdStride / 4);
    const int w = i % (kIdStride / 4);
    id32[i] = (w == (r >> 2)) ? (1u << ((r & 3) * 8)) : 0u;
  }

  // B fragments (k32 x n8, column-major): register `half` of (kk, n8)
  // holds M[kk*32 + half*16 + tig*4 + i][32 q + 8 n8 + g] in byte i.
  uint32_t bf[8][4][2];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8) {
      const int j = q * 32 + n8 * 8 + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k0 = kk * 32 + half * 16 + tig * 4;
        uint32_t v = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v |= static_cast<uint32_t>(static_cast<uint8_t>(
                   __ldg(member + (k0 + i) * kCols + j)))
               << (8 * i);
        }
        bf[kk][n8][half] = v;
      }
    }
  }

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n8][e] = 0;

  const long long total = static_cast<long long>(chunk) * 32;
  const long long u0 = total * blockIdx.y / splits;
  const long long u1 = total * (blockIdx.y + 1) / splits;
  const size_t row_stride = static_cast<size_t>(lanes);
  const uint8_t* base = data + static_cast<size_t>(li) * kLaneBlock;
  const int srow = tid >> 3;          // staged step of this thread's load
  const int soff = (tid & 7) * 16;    // its 16 bytes in the 128-byte row
  __syncthreads();

  for (long long ub = u0; ub < u1; ub += kStageSteps) {
    const long long u = ub + srow;
    if (u < u1) {
      const uint8_t* src = base + static_cast<size_t>(u >> 5) * row_stride +
                           static_cast<size_t>(u & 31) * kCols + soff;
      *reinterpret_cast<uint4*>(stage + srow * kCols + soff) =
          __ldg(reinterpret_cast<const uint4*>(src));
    }
    __syncthreads();
    const int n = static_cast<int>(u1 - ub < kStageSteps ? u1 - ub
                                                         : kStageSteps);
    for (int step = 0; step < n; ++step) {
      const uint8_t* xs = stage + step * kCols + h * 64;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        // A fragment rows g and g + 8 of this m16 tile: lanes whose bytes
        // select the identity rows; register i of slice kk is 4 one-hot
        // bytes of columns kk*32 + (i >= 2) * 16 + tig*4 .. + 3.
        const uint32_t* lo = reinterpret_cast<const uint32_t*>(
                                 ident + xs[mt * 16 + g] * kIdStride) + tig;
        const uint32_t* hi = reinterpret_cast<const uint32_t*>(
                                 ident + xs[mt * 16 + g + 8] * kIdStride) + tig;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint32_t a[4] = {lo[kk * 8], hi[kk * 8], lo[kk * 8 + 4],
                                 hi[kk * 8 + 4]};
#pragma unroll
          for (int n8 = 0; n8 < 4; ++n8) {
            mma_s8(acc[mt][n8], a, bf[kk][n8][0], bf[kk][n8][1]);
          }
        }
      }
    }
    __syncthreads();
  }

  // C fragment: registers 0, 1 at row g, columns 2 tig, 2 tig + 1;
  // registers 2, 3 at row g + 8.
  int* o = out + static_cast<size_t>(li) * kCols * kCols;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int row = h * 64 + mt * 16 + g;
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8) {
      const int col = q * 32 + n8 * 8 + tig * 2;
      atomicAdd(o + row * kCols + col, acc[mt][n8][0]);
      atomicAdd(o + row * kCols + col + 1, acc[mt][n8][1]);
      atomicAdd(o + (row + 8) * kCols + col, acc[mt][n8][2]);
      atomicAdd(o + (row + 8) * kCols + col + 1, acc[mt][n8][3]);
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `out` must hold lanes / 4096 x 128 x 128 zeroed int32; `member`
// is 256 x 128 int8 on the card; `data` is 16-byte aligned.  `splits`
// blocks share each lane block's (t, s) steps.  Returns cudaGetLastError()
// after the launch: 0 on success.
extern "C" int dgrep_mxu_dot(const void* data, const void* member, void* out,
                             int chunk, int lanes, int splits, void* stream) {
  if (chunk <= 0 || lanes <= 0 || chunk % 512 != 0 ||
      lanes % kLaneBlock != 0 || splits < 1 ||
      static_cast<long long>(splits) > static_cast<long long>(chunk) * 32 ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mxu_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid(lanes / kLaneBlock, splits);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mxu_dot_kernel<<<grid, block, kSmemBytes, st>>>(
      static_cast<const uint8_t*>(data), static_cast<const int8_t*>(member),
      static_cast<int*>(out), chunk, lanes, splits);
  return static_cast<int>(cudaGetLastError());
}
