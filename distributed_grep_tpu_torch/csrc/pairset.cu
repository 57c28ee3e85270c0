// Exact 1-2-byte literal-set scan over (chunk, lanes) stripes, match-end
// bits.
//
// Replaces the TPU kernel distributed_grep_tpu/ops/pallas_pairset.py:
// _kernel (launched through _pairset_pallas / pairset_scan_words) and
// computes the same words at the same layout:
//
//   data  (chunk, lanes) uint8, column-major stripes: data[c * lanes + l]
//         is byte c of stripe l.
//   out   (chunk / 32, lanes) uint32: bit t of word w of lane l is set iff
//         a member of the set ends at byte 32w + t of stripe l.
//
// Per lane, from the stripe head with prev = '\n', each byte b (folded
// A-Z -> a-z when asked) sets its bit to
//
//   (words[word_byte] >> rowcls[cls_byte]) & 1,
//   (cls_byte, word_byte) = (prev, b), or (b, prev) when transposed,
//
// the row-partition factorization of models/pairset.py.  A stripe head
// can only miss a 2-byte match that spans it (no member holds '\n'); the
// engine's stitch restores those.
//
// Design.  The TPU kernel splits each 256-entry table into two 128-entry
// subtables and selects between two lane gathers, because its gather
// covers 128 entries.  Here both tables (2 x 256 uint32, 2 KB) travel by
// value as a kernel parameter, each block copies them to shared memory,
// and a lookup is one shared-memory load.  One thread owns one lane and
// walks its whole stripe, as csrc/shift_and.cu does: a warp reads 32
// neighbouring bytes of one row per step, loads the 32 bytes of a word
// before its 32 steps, and stores each word coalesced across lanes.  With
// accumulate set it ORs into the words already in `out` (the FDR
// candidate words of a mixed set).
//
// Bound.  Per input byte about 8 integer operations (load, fold, two
// lookups, shift, and, output bit, carry) and 1 byte in, 1/8 byte out:
// for a 64 MB segment the operations bound it, 0.032 ms against 0.0225 ms
// of bytes on an H100 SXM (chip_smoke.py reports both beside the
// measured time).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct PairTables {
  uint32_t rowcls[256];
  uint32_t words[256];
};

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pairset_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
               const PairTables tables, int chunk, int lanes, int transposed,
               int fold, int accumulate) {
  __shared__ uint32_t s_rc[256];
  __shared__ uint32_t s_w[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_rc[i] = tables.rowcls[i];
    s_w[i] = tables.words[i];
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t stride = static_cast<size_t>(lanes);
  const uint8_t* p = data + lane;
  uint32_t* o = out + lane;
  const int n_out = chunk / 32;
  uint32_t prev = 0x0Au;  // a stripe head never reports a false pair
  for (int wd = 0; wd < n_out; ++wd) {
    const uint8_t* row = p + static_cast<size_t>(wd) * 32 * stride;
    uint32_t bytes[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) bytes[t] = __ldg(row + t * stride);
    uint32_t word = 0u;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      uint32_t b = bytes[t];
      if (fold && b - 65u < 26u) b += 32u;
      const uint32_t cls = transposed ? b : prev;
      const uint32_t wi = transposed ? prev : b;
      word |= ((s_w[wi] >> s_rc[cls]) & 1u) << t;
      prev = b;
    }
    uint32_t* dst = o + static_cast<size_t>(wd) * stride;
    *dst = accumulate ? (*dst | word) : word;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `rowcls_host` and `words_host` point to 256 uint32 each in
// HOST memory; they travel as a kernel parameter.  Returns
// cudaGetLastError() after the launch: 0 on success.
extern "C" int dgrep_pairset_scan(const void* data, void* out,
                                  const void* rowcls_host,
                                  const void* words_host, int chunk,
                                  int lanes, int transposed, int fold,
                                  int accumulate, void* stream) {
  if (chunk <= 0 || lanes <= 0 || chunk % 32 != 0 || lanes % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PairTables tables;
  const uint32_t* rc = static_cast<const uint32_t*>(rowcls_host);
  const uint32_t* w = static_cast<const uint32_t*>(words_host);
  for (int i = 0; i < 256; ++i) {
    if (rc[i] > 31u) return static_cast<int>(cudaErrorInvalidValue);
    tables.rowcls[i] = rc[i];
    tables.words[i] = w[i];
  }
  const dim3 grid((lanes + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  pairset_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint32_t*>(out), tables,
      chunk, lanes, transposed, fold, accumulate);
  return static_cast<int>(cudaGetLastError());
}
