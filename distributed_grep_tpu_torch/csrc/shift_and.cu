// Shift-And byte scan over (lanes, chunk) stripes, bit-packed output.
//
// Replaces the TPU kernel distributed_grep_tpu/ops/pallas_scan.py:_kernel
// (launched through _shift_and_pallas / shift_and_scan_words) and computes
// its words, reshaped to (chunk / 32, lanes):
//
//   data  (lanes, chunk) uint8 stripes, as the document lies: byte c of
//         stripe l is data[l * pitch + c] (pitch >= chunk and the base
//         address multiples of 16, so a window stripes[:, a:b] needs no
//         copy).
//   out   (chunk / 32, lanes) uint32.  Per lane the state steps as
//         s = ((s << 1) | 1) & B[byte], starting from 0 at the stripe head.
//         coarse: word w = (OR of s over bytes 32w .. 32w+31) & match_bit,
//                 nonzero iff a candidate match ends in that 32-byte span;
//         exact:  bit t of word w set iff (s & match_bit) after byte 32w+t.
//
// Design.  The TPU grid carries each lane's state across sequential chunk
// blocks in VMEM scratch and rebuilds B[byte] from byte-range compares,
// because Pallas on the TPU has no vector gather.  Hopper has gathers:
// B[byte] is a lookup in a 256-entry table in shared memory, and a
// thread owns a lane with its state in a register.
//
// Reads: a TMA ring (csrc/stripe_ring.cuh, shared with csrc/pairset.cu
// and csrc/shift_and_swar.cu).  A block of kRows = 256 threads owns 256
// lanes; one thread of it keeps kStages = 2 boxes of (256 lanes x 128
// bytes) in flight (cp.async.bulk.tensor, CU_TENSOR_MAP_SWIZZLE_128B,
// completing on an mbarrier each), and every thread reads its 128 bytes
// of a box as 8 16-byte shared loads, chunk c of row r at (c ^ (r & 7)) *
// 16, which no two threads of a quarter-warp share a bank on.  66 KB of
// shared memory a block: 3 blocks (24 warps) an SM at most; 32 registers
// a thread (48 for G = 1), no spills.  A design run on an H100 80GB HBM3 at 700 W
// (PERF.md section 6, run D) chose this over 16-byte global loads with the
// next 16 bytes in flight and the same arithmetic: those took 0.0413 ms at
// one thread a lane and 0.0555 ms with 8-word sub-stripes (64 warps an
// SM), against 0.0379 ms here; torch's int64 sum of the same 64 MiB took
// 0.0316 ms.
//
// Sub-stripes with a warm-up.  blockIdx.y cuts each stripe into n_sub
// sub-stripes; one starting at byte c0 > 0 first steps `warm` words from
// c0 - 32 * warm from state 0, storing nothing.  Exact because bits up to
// the match bit m - 1 depend on the last m bytes alone (the shift moves
// bits up only), and 32 * warm >= m - 1 (ops/cuda_scan.warmup_words).
// The launcher adds sub-stripes only until every SM has a block:
// n_sub = SMs / lane blocks, at least 1.  benchmarks/substripe_sweep.py
// (run W, PERF.md section 6; device times) found one a lane fastest at
// 65536 lanes (0.0345 ms; 8-word sub-stripes 0.0380) and at 32768 lanes
// x 256 bytes, and two fastest at 16384 x 256 (1.17x one a lane): the
// ring caps a block's warps, so more blocks than SMs add warm-up only.
//
// The match bit's history.  Every B entry gets the bits above the match
// bit set (sticky), so a match at byte t moves up one bit a byte: bit
// m - 1 + j holds "a match at byte t - j".  Read every G bytes (G the
// largest power of two <= 33 - m, a template argument) with one bit
// reversal, that gives the word's bits without a per-byte accumulate:
// about 5 instructions a byte (byte extract, table address, lookup,
// shift-or, and).
//
// Bound.  1 byte in and 1/8 byte out per byte: for a 64 MiB segment 72 MiB
// at 3.35 TB/s is 0.0225 ms on an H100 SXM, above the operations (5 a byte
// at 132 x 128 per clock, 0.0100 ms).  chip_smoke.py measured 0.0383 ms
// (coarse, the volcano filter) and 0.0382 ms (exact) on an H100 80GB HBM3
// at 700 W, against 0.0779 and 0.0923 ms for the column-layout kernel
// before it (PERF.md section 6).

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "stripe_ring.cuh"

namespace {

using stripe_ring::kBox;
using stripe_ring::kRows;

struct BTable {
  uint32_t b[256];
};

template <bool kCoarse, int G>
__global__ void __launch_bounds__(kRows)
shift_and_kernel(const __grid_constant__ CUtensorMap map,
                 uint32_t* __restrict__ out, const BTable table, int n_words,
                 int lanes, uint32_t match_bit, int sub_words, int warm) {
  extern __shared__ uint8_t raw[];
  __shared__ uint32_t sb[256];
  stripe_ring::Ring<> ring(raw);
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kRows;
  const int own = blockIdx.y * sub_words;
  const int end = min(own + sub_words, n_words);
  const int w0 = max(0, own - warm);
  const int n_box = ((end - w0) * 32 + kBox - 1) / kBox;

  const uint32_t sticky = ~((match_bit << 1) - 1u);
  for (int i = tid; i < 256; i += kRows) sb[i] = table.b[i] | sticky;
  if (tid == 0) ring.start(&map, w0 * 32, lane0, n_box);
  __syncthreads();

  const int mpos = 31 - __clz(match_bit);
  const int lane = lane0 + tid;
  uint32_t s = 0;
  int w = w0;
  for (int b = 0; b < n_box; ++b, w += kBox / 32) {
    const uint8_t* box = ring.wait(b);
#pragma unroll
    for (int q = 0; q < kBox / 32; ++q) {
      if (w + q < end) {
        const uint4 lo = stripe_ring::chunk16<>(box, tid, 2 * q);
        const uint4 hi = stripe_ring::chunk16<>(box, tid, 2 * q + 1);
        const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        uint32_t word = 0;
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          s = (s * 2u + 1u) & sb[__byte_perm(v[t >> 2], 0u, 0x4440u + (t & 3))];
          if ((t + 1) % G == 0) word |= __brev(s >> mpos) >> (31 - t);
        }
        if (w + q >= own && lane < lanes) {
          out[static_cast<size_t>(w + q) * lanes + lane] =
              kCoarse ? (word != 0u ? match_bit : 0u) : word;
        }
      }
    }
    ring.release(&map, b, w0 * 32, lane0, n_box);
  }
}

// Launch one instance, with sub-stripes until every SM has a block.  The
// shared-memory opt-in and the SM count are asked once per device, at the
// first launch (which precedes any graph capture: utils/slope.py warms
// every chain up first).
template <bool C, int G>
int launch(const CUtensorMap& map, uint32_t* o, const BTable& table,
           int n_words, int lanes, unsigned match_bit, int warm,
           cudaStream_t st) {
  auto kernel = shift_and_kernel<C, G>;
  static int cache[stripe_ring::kMaxDevices] = {};
  int sms = 0;
  const int err = stripe_ring::prepare(kernel, stripe_ring::kSmemBytes,
                                       cache, &sms);
  if (err != 0) return err;
  const int lane_blocks = (lanes + kRows - 1) / kRows;
  const int n_want = max(1, min(n_words, sms / lane_blocks));
  const int sub_words = (n_words + n_want - 1) / n_want;
  const dim3 grid(lane_blocks, (n_words + sub_words - 1) / sub_words);
  kernel<<<grid, kRows, stripe_ring::kSmemBytes, st>>>(
      map, o, table, n_words, lanes, match_bit, sub_words, warm);
  return static_cast<int>(cudaGetLastError());
}

// The instance for G: the largest power of two <= 33 - m, the bytes of
// history that fit above the match bit m - 1.
template <bool C>
int launch_g(const CUtensorMap& map, uint32_t* o, const BTable& table,
             int n_words, int lanes, unsigned match_bit, int warm,
             cudaStream_t st) {
  using Launch = int (*)(const CUtensorMap&, uint32_t*, const BTable&, int,
                         int, unsigned, int, cudaStream_t);
  constexpr Launch kByLog2G[] = {&launch<C, 1>, &launch<C, 2>,
                                 &launch<C, 4>, &launch<C, 8>,
                                 &launch<C, 16>, &launch<C, 32>};
  const int room = 33 - (32 - __builtin_clz(match_bit));
  int log2g = 0;
  while (log2g < 5 && (2 << log2g) <= room) ++log2g;
  return kByLog2G[log2g](map, o, table, n_words, lanes, match_bit, warm, st);
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `table_host` points to 256 uint32 B-masks in HOST memory; they
// travel as a kernel parameter, as does the tensor map of `data`.  `pitch`
// is the byte distance between stripes; `warm` the warm-up in 32-byte
// words.  Returns a cudaError_t: cudaGetLastError() after the launch, 0 on
// success.
extern "C" int dgrep_shift_and_scan(const void* data, void* out,
                                    const void* table_host, int chunk,
                                    int lanes, long long pitch,
                                    unsigned int match_bit, int coarse,
                                    int warm, void* stream) {
  if (match_bit == 0 || warm < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  const int err = stripe_ring::encode_stripes(&map, data, chunk, lanes, pitch);
  if (err != 0) return err;
  BTable table;
  const uint32_t* t = static_cast<const uint32_t*>(table_host);
  for (int i = 0; i < 256; ++i) table.b[i] = t[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  return coarse ? launch_g<true>(map, o, table, chunk / 32, lanes, match_bit,
                                 warm, st)
                : launch_g<false>(map, o, table, chunk / 32, lanes, match_bit,
                                  warm, st);
}
