// Wu-Manber approximate scan (<= k edit errors, k = 1..3) over
// (chunk, lanes) stripes, exact match-end bits.
//
// Replaces the TPU kernel distributed_grep_tpu/ops/pallas_approx.py:_kernel
// (launched through _approx_pallas / approx_scan_words) and computes the
// same words at the port's layout:
//
//   data  (chunk, lanes) uint8, column-major stripes: data[c * lanes + l]
//         is byte c of stripe l.
//   out   (chunk / 32, lanes) uint32: bit t of word w of lane l is set iff
//         (R_k & match_bit) after byte 32w+t of stripe l.
//
// The k+1 rows step per byte c as models/approx.py states:
//   R_0' = ((R_0 << 1) | 1) & B[c]
//   R_j' = (((R_j << 1) | 1) & B[c]) | R_{j-1} | (R_{j-1} << 1)
//          | (R'_{j-1} << 1) | ((1 << j) - 1)
// seeded with R_j = (1 << j) - 1 at the stripe head and reset to those
// seeds at every '\n', before the match check.
//
// Design.  The TPU grid carries the rows across sequential chunk blocks in
// VMEM scratch and rebuilds B[c] from byte-range compares (Pallas on the
// TPU has no vector gather), which is why the reference caps a model at
// 48 ranges.  Here one thread owns one lane and walks its whole stripe
// with the k+1 rows in registers (the kernel is templated on k, so the
// rows are plain registers and the row loop unrolls), and B[c] is a
// lookup in a 256-entry table copied to shared memory at block start: any
// number of ranges costs the same.  A thread first loads the 32 bytes of
// a word (32 independent loads in flight), then runs the 32 dependent
// steps; a warp's loads of one row are 32 neighbouring bytes, and each
// word store is coalesced across lanes.
//
// Bound.  Per input byte the kernel does the byte load and table lookup,
// the newline test, two operations for R_0, about six for each further
// row, a select per row for the newline reset and about three for the
// output bit: about 10 + 9k operations (the compiled kernel has 20.5, 27.8
// and 34.8 instructions per step for k = 1, 2, 3), against 1 byte in and
// 1/8 byte out.  For a 64 MB segment on an H100 SXM, at 128 operations per
// SM per clock (4 schedulers x 32 lanes, 132 SMs, 1.98 GHz) that is about
// 0.038, 0.056 and 0.074 ms, above the 0.0225 ms of the bytes: bound by
// operations.  It runs at 0.10-0.13 ms on an H100 80GB HBM3 at 700 W
// (PERF.md), about the time of csrc/shift_and.cu whatever k: with 65536
// lanes a segment gives an SM only about 16 warps, too few to hide the
// loads' latency, so latency, not the row arithmetic, sets its time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct BTable {
  uint32_t b[256];
};

constexpr int kThreads = 256;
constexpr uint32_t kNewline = 0x0A;

template <int K>
__global__ void __launch_bounds__(kThreads)
approx_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
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

  uint32_t seed[K + 1];
  uint32_t r[K + 1];
#pragma unroll
  for (int j = 0; j <= K; ++j) {
    seed[j] = (1u << j) - 1u;
    r[j] = seed[j];
  }
  for (int w = 0; w < n_words; ++w) {
    const uint8_t* row = p + static_cast<size_t>(w) * 32 * stride;
    uint32_t bytes[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) bytes[t] = __ldg(row + t * stride);
    uint32_t word = 0;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const uint32_t c = bytes[t];
      const uint32_t b = sb[c];
      const bool nl = c == kNewline;
      uint32_t nw[K + 1];
      nw[0] = ((r[0] << 1) | 1u) & b;
#pragma unroll
      for (int j = 1; j <= K; ++j) {
        nw[j] = (((r[j] << 1) | 1u) & b) | r[j - 1] | (r[j - 1] << 1) |
                (nw[j - 1] << 1) | seed[j];
      }
#pragma unroll
      for (int j = 0; j <= K; ++j) r[j] = nl ? seed[j] : nw[j];
      word |= ((r[K] & match_bit) != 0u ? 1u : 0u) << t;
    }
    o[static_cast<size_t>(w) * stride] = word;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `table_host` points to 256 uint32 B-masks in HOST memory; they
// travel as a kernel parameter.  Returns cudaGetLastError() after the
// launch: 0 on success.
extern "C" int dgrep_approx_scan(const void* data, void* out,
                                 const void* table_host, int chunk, int lanes,
                                 unsigned int match_bit, int k, void* stream) {
  if (chunk <= 0 || lanes <= 0 || chunk % 32 != 0 || lanes % 32 != 0 ||
      k < 1 || k > 3) {
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
  switch (k) {
    case 1:
      approx_kernel<1><<<grid, block, 0, st>>>(d, o, table, chunk, lanes,
                                               match_bit);
      break;
    case 2:
      approx_kernel<2><<<grid, block, 0, st>>>(d, o, table, chunk, lanes,
                                               match_bit);
      break;
    default:
      approx_kernel<3><<<grid, block, 0, st>>>(d, o, table, chunk, lanes,
                                               match_bit);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
