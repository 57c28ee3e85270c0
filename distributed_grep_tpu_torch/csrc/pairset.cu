// Exact 1-2-byte literal-set scan over (lanes, chunk) stripes, match-end
// bits.
//
// Replaces the TPU kernel distributed_grep_tpu/ops/pallas_pairset.py:
// _kernel (launched through _pairset_pallas / pairset_scan_words) and
// computes its words, reshaped to (chunk / 32, lanes):
//
//   data  (lanes, chunk) uint8 stripes, as the document lies: byte c of
//         stripe l is data[l * pitch + c] (pitch >= chunk and the base
//         address multiples of 16, so a window stripes[:, a:b] needs no
//         copy).
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
// covers 128 entries.  Here the lookups are shared-memory loads.  Both
// tables travel by value as a kernel parameter (2 KB), folded for -i on
// the host (entry v holds the entry of fold(v)), so the kernel never folds
// a byte.
//
// Reads: the TMA ring of csrc/shift_and.cu (csrc/stripe_ring.cuh): a block
// of 256 threads owns 256 lanes, a thread reads its row of each 256 x 128-
// byte box as 8 16-byte shared loads.
//
// Lookups: the two tables interleaved, entry v = (words[v], rowcls[v]),
// one 8-byte load a byte, the previous byte's entry kept in registers.
// The table is held 16 times over (32 KB), copy i at bank pair i, and
// thread t reads copy t % 16, so a half-warp's loads never share a bank
// whatever the bytes (random bytes put 3-4 of 32 on one bank of a plain
// 256-entry table).  Design runs on an H100 80GB HBM3 at 700 W (PERF.md
// section 6, runs G and L; device times at 65536 lanes x 1024 bytes) chose
// this over one 256 x 256-bit matrix M[prev][b] (8 KB, built by each block
// from the tables, one 4-byte load a byte at M[prev][b / 32]): 0.0381
// against 0.0430 ms on random bytes, 0.0380 against 0.0475 ms on words;
// and 128-byte boxes over 64-byte ones (0.0379 against 0.0395 ms).
// 32 registers a thread, no spills; 98 KB of shared memory a block, two
// blocks (16 warps) an SM.
//
// Output: each step moves its bit into the word with one funnel shift
// (the word shifts right, the new bit enters at bit 31), so after 32
// steps bit t is byte t's.  About 5 operations a byte: byte extract,
// table address, lookup, shift, funnel shift.
//
// Sub-stripes with a warm-up.  blockIdx.y cuts each stripe into n_sub
// sub-stripes; one starting at byte c0 > 0 seeds prev with byte c0 - 1 of
// its stripe, read from global memory, so its bits equal the full scan's:
// a bit depends on its byte and the one before alone.  The launcher adds
// sub-stripes only until every SM has a block: n_sub = SMs / lane blocks,
// at least 1: the best count benchmarks/substripe_sweep.py found at 65536
// x 1024, 32768 x 256 and 16384 x 256 bytes (runs H and L, PERF.md).
//
// Bound.  1 byte in and 1/8 byte out per byte: for a 64 MiB segment 72 MiB
// at 3.35 TB/s is 0.0225 ms on an H100 SXM, above the operations (about 5
// a byte at 132 x 128 per clock, 0.0100 ms) and the shared-memory lookups
// (one a byte at 132 x 32 per clock, 0.0080 ms).  With accumulate set the
// kernel ORs into the words already in `out` (the FDR candidate words of a
// mixed set).

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "stripe_ring.cuh"

namespace {

using stripe_ring::kRows;

struct PairTables {
  uint32_t rowcls[256];
  uint32_t words[256];
};

constexpr int kBoxBytes = 128;  // stripe bytes per box row
constexpr int kCopies = 16;     // replicas of the interleaved table
// the interleaved table follows the ring and its barriers
constexpr int kTableOffset = stripe_ring::kStages * kRows * kBoxBytes + 64;
constexpr int kSmemBytes = 1024 + kTableOffset + 256 * kCopies * 8;

template <bool kTransposed>
__global__ void __launch_bounds__(kRows)
pairset_kernel(const __grid_constant__ CUtensorMap map,
               const uint8_t* __restrict__ data, long long pitch,
               uint32_t* __restrict__ out, const PairTables tables,
               int n_words, int lanes, int sub_words, int accumulate) {
  extern __shared__ uint8_t raw[];
  stripe_ring::Ring<kBoxBytes> ring(raw);
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kRows;
  const int own = blockIdx.y * sub_words;
  const int end = min(own + sub_words, n_words);
  const int n_box = ((end - own) * 32 + kBoxBytes - 1) / kBoxBytes;
  uint2* tab = reinterpret_cast<uint2*>(ring.base + kTableOffset);
  if (tid == 0) ring.start(&map, own * 32, lane0, n_box);
  for (int i = tid; i < 256 * kCopies; i += kRows) {
    const int v = i / kCopies;
    tab[i] = make_uint2(tables.words[v], tables.rowcls[v]);
  }
  __syncthreads();

  const int lane = lane0 + tid;
  const uint2* my = tab + (tid % kCopies);
  uint32_t pv = 0x0Au;  // a stripe head never reports a false pair
  if (own > 0 && lane < lanes) {
    pv = __ldg(data + lane * pitch + own * 32 - 1);
  }
  uint2 pe = my[pv * kCopies];
  int w = own;
  for (int b = 0; b < n_box; ++b, w += kBoxBytes / 32) {
    const uint8_t* box = ring.wait(b);
#pragma unroll
    for (int q = 0; q < kBoxBytes / 32; ++q) {
      if (w + q < end) {
        const uint4 lo = stripe_ring::chunk16<kBoxBytes>(box, tid, 2 * q);
        const uint4 hi = stripe_ring::chunk16<kBoxBytes>(box, tid, 2 * q + 1);
        const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        uint32_t word = 0;
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          const uint32_t c = __byte_perm(v[t >> 2], 0u, 0x4440u + (t & 3));
          const uint2 e = my[c * kCopies];
          word = __funnelshift_r(word, kTransposed ? pe.x >> e.y : e.x >> pe.y,
                                 1);
          pe = e;
        }
        if (lane < lanes) {
          uint32_t* dst = out + static_cast<size_t>(w + q) * lanes + lane;
          *dst = accumulate ? (*dst | word) : word;
        }
      }
    }
    ring.release(&map, b, own * 32, lane0, n_box);
  }
}

template <bool T>
int launch(const CUtensorMap& map, const uint8_t* d, long long pitch,
           uint32_t* o, const PairTables& tables, int n_words, int lanes,
           int accumulate, cudaStream_t st) {
  auto kernel = pairset_kernel<T>;
  static int cache[stripe_ring::kMaxDevices] = {};
  int sms = 0;
  const int err = stripe_ring::prepare(kernel, kSmemBytes, cache, &sms);
  if (err != 0) return err;
  const int lane_blocks = (lanes + kRows - 1) / kRows;
  const int n_want = max(1, min(n_words, sms / lane_blocks));
  const int sub_words = (n_words + n_want - 1) / n_want;
  const dim3 grid(lane_blocks, (n_words + sub_words - 1) / sub_words);
  kernel<<<grid, kRows, kSmemBytes, st>>>(map, d, pitch, o, tables, n_words,
                                          lanes, sub_words, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `rowcls_host` and `words_host` point to 256 uint32 each in
// HOST memory; they travel (folded when `fold` is set) as a kernel
// parameter, as does the tensor map of `data`.  `pitch` is the byte
// distance between stripes.  Returns a cudaError_t: cudaGetLastError()
// after the launch, 0 on success.
extern "C" int dgrep_pairset_scan(const void* data, void* out,
                                  const void* rowcls_host,
                                  const void* words_host, int chunk,
                                  int lanes, long long pitch, int transposed,
                                  int fold, int accumulate, void* stream) {
  CUtensorMap map;
  const int err = stripe_ring::encode_stripes(&map, data, chunk, lanes, pitch,
                                              kBoxBytes);
  if (err != 0) return err;
  PairTables tables;
  const uint32_t* rc = static_cast<const uint32_t*>(rowcls_host);
  const uint32_t* w = static_cast<const uint32_t*>(words_host);
  for (int i = 0; i < 256; ++i) {
    const int f = (fold && i >= 'A' && i <= 'Z') ? i + 32 : i;
    if (rc[f] > 31u) return static_cast<int>(cudaErrorInvalidValue);
    tables.rowcls[i] = rc[f];
    tables.words[i] = w[f];
  }
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return transposed ? launch<true>(map, d, pitch, o, tables, chunk / 32,
                                   lanes, accumulate, st)
                    : launch<false>(map, d, pitch, o, tables, chunk / 32,
                                    lanes, accumulate, st);
}
