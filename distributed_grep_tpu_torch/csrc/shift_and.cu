// Shift-And byte scan over (chunk, lanes) stripes, bit-packed output.
//
// Replaces the TPU kernel distributed_grep_tpu/ops/pallas_scan.py:_kernel
// (launched through _shift_and_pallas / shift_and_scan_words) and computes
// the same words at the same layout:
//
//   data  (chunk, lanes) uint8, column-major stripes: data[c * lanes + l]
//         is byte c of stripe l.
//   out   (chunk / 32, lanes) uint32.  Per lane the state steps as
//         s = ((s << 1) | 1) & B[byte], starting from 0 at the stripe head.
//         coarse: word w = (OR of s over bytes 32w .. 32w+31) & match_bit,
//                 nonzero iff a candidate match ends in that 32-byte span;
//         exact:  bit t of word w set iff (s & match_bit) after byte 32w+t.
//
// Design.  The TPU grid carries each lane's state across sequential chunk
// blocks in VMEM scratch, and rebuilds B[byte] from byte-range compares
// because Pallas on the TPU has no vector gather.  Hopper blocks run in no
// order, and it has gathers, so here one thread owns one lane and walks
// the whole chunk with its state in a register, and B[byte] is a lookup
// in a 256-entry table copied to shared memory at block start (the
// caller passes the table by value as a kernel parameter).  At each step a
// warp's 32 threads read 32 neighbouring bytes of one row, and each word
// store is coalesced across lanes.  A thread first loads the 32 bytes of
// a word (32 independent loads in flight), then runs the 32 dependent
// state steps on them.
//
// Bound.  Per input byte the kernel does about five integer operations
// (load, table lookup, shift-or, and, accumulate) and moves 1 byte in and
// 1/8 byte out.  On an H100 SXM the byte traffic bounds it: for a 64 MB
// segment, 72 MiB at 3.35 TB/s is 0.0225 ms, against 0.0101 ms for the
// operations at 128 per SM per clock (4 schedulers x 32 lanes; integer
// code can use the FP32 pipe as well as the 64 INT32 lanes).  chip_smoke.py
// measures
// 0.080 ms on an H100 80GB HBM3 at 700 W, 3.5x the bound: this first
// version loads one byte per thread per step and keeps the shared-memory
// table unreplicated (lookups of different bytes that share a bank
// conflict); wider loads and several lanes per thread are left for later
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct BTable {
  uint32_t b[256];
};

constexpr int kThreads = 256;

template <bool kCoarse>
__global__ void __launch_bounds__(kThreads)
shift_and_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
                 const BTable table, int chunk, int lanes, uint32_t match_bit) {
  __shared__ uint32_t sb[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) sb[i] = table.b[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t stride = static_cast<size_t>(lanes);
  const uint8_t* p = data + lane;
  uint32_t* o = out + lane;
  const int n_words = chunk / 32;
  uint32_t s = 0;
  for (int w = 0; w < n_words; ++w) {
    const uint8_t* row = p + static_cast<size_t>(w) * 32 * stride;
    uint32_t bytes[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) bytes[t] = __ldg(row + t * stride);
    uint32_t word = 0;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      s = ((s << 1) | 1u) & sb[bytes[t]];
      if (kCoarse) {
        word |= s;
      } else {
        word |= ((s & match_bit) != 0u ? 1u : 0u) << t;
      }
    }
    o[static_cast<size_t>(w) * stride] = kCoarse ? (word & match_bit) : word;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `table_host` points to 256 uint32 B-masks in HOST memory; they
// travel as a kernel parameter.  Returns cudaGetLastError() after the
// launch: 0 on success.
extern "C" int dgrep_shift_and_scan(const void* data, void* out,
                                    const void* table_host, int chunk,
                                    int lanes, unsigned int match_bit,
                                    int coarse, void* stream) {
  if (chunk <= 0 || lanes <= 0 || chunk % 32 != 0 || lanes % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BTable table;
  const uint32_t* t = static_cast<const uint32_t*>(table_host);
  for (int i = 0; i < 256; ++i) table.b[i] = t[i];
  const dim3 grid((lanes + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (coarse) {
    shift_and_kernel<true><<<grid, block, 0, st>>>(d, o, table, chunk, lanes,
                                                   match_bit);
  } else {
    shift_and_kernel<false><<<grid, block, 0, st>>>(d, o, table, chunk, lanes,
                                                    match_bit);
  }
  return static_cast<int>(cudaGetLastError());
}
