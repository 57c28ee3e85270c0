// Wu-Manber approximate scan (<= k edit errors, k = 1..3) over
// (lanes, chunk) stripes, exact match-end bits.
//
// Replaces the TPU kernel distributed_grep_tpu/ops/pallas_approx.py:_kernel
// (launched through _approx_pallas / approx_scan_words) and computes its
// words, reshaped to (chunk / 32, lanes):
//
//   data  (lanes, chunk) uint8 stripes, as the document lies: byte c of
//         stripe l is data[l * pitch + c] (pitch >= chunk, a multiple of 16,
//         and data 16-byte aligned).
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
// 48 ranges.  Here B[c] is a lookup in a 256-entry table copied to shared
// memory at block start, so any number of ranges costs the same, and the
// rows are registers (the kernel is templated on k).
//
// Reads: 16-byte global loads.  A thread reads the 32 bytes of a word of
// its stripe as two 16-byte loads (one sector), and loads the next 16
// bytes before stepping the current ones; each byte becomes its table
// offset with one shift and one mask.  A warp's 32 lanes store one
// coalesced 128-byte row of words.  Blocks of 256 threads, 32 registers a
// thread (__launch_bounds__ for 64 warps an SM), no spills.  A design run
// on an H100 80GB HBM3 at 700 W (PERF.md section 6, run D) chose this over
// the TMA ring of csrc/shift_and.cu with the same step: the ring took
// 0.0688-0.0707 ms at k = 1 against 0.0602 here, and 1.16-1.18x this
// kernel's time at k = 2 and 3 at its best.  The row arithmetic, not the
// reads, sets this kernel's time; the ring adds a block barrier per box
// (its cost is inferred, not measured).
//
// Sub-stripes with a warm-up.  Each stripe is cut into n_sub sub-stripes,
// one thread each; one starting at byte c0 > 0 first steps `warm` words
// from the seeds, storing nothing.  Exact because the rows threshold
// Sellers' DP, whose start is free and restarts at every '\n': a match of
// <= k edits ending at c spans <= m + k bytes, and 32 * warm >= m + k - 1
// (ops/approx_scan.warmup_words: 1 word, 2 when m + k - 1 > 32).  The
// launcher adds sub-stripes only until every SM has a block: n_sub = SMs
// / lane blocks, at least 1.  benchmarks/substripe_sweep.py (run W,
// PERF.md section 6; device times) found one a lane fastest for k = 1, 2
// and 3 at 65536 lanes (0.0570, 0.0772, 0.0969 ms; 2 a lane 1.01-1.02x
// that, 8-word sub-stripes at 64 warps an SM 1.10-1.16x) and at 32768 x
// 256 bytes, and two fastest at 16384 x 256 (1.34-1.43x one a lane).
//
// Bound.  Per input byte: the byte extract and table lookup, the newline
// test, two operations for R_0, about six for each further row, a select
// per row for the newline reset and about three for the output bit: about
// 10 + 9k operations, against 1 byte in and 1/8 byte out.  For a 64 MiB
// segment on an H100 SXM, at 128 operations per SM per clock (4 schedulers
// x 32 lanes, 132 SMs, 1.98 GHz) that is about 0.038, 0.056 and 0.074 ms
// for k = 1, 2, 3, above the 0.0225 ms of the bytes: bound by operations.
// chip_smoke.py measured 0.0610, 0.0814 and 0.1016 ms on an H100 80GB
// HBM3 at 700 W (26.2, 33.5 and 40.5 SASS instructions a byte), against
// 0.1110, 0.1003 and 0.1286 ms for the column-layout kernel before it
// (PERF.md section 6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct BTable {
  uint32_t b[256];
};

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // up to 64 warps an SM: 32 registers
constexpr int kMaxDevices = 64;
constexpr uint32_t kNewline = 0x0A;

// The shared-memory byte offset of byte r of q (4 bytes an entry).
__device__ __forceinline__ uint32_t offset_of(uint32_t q, int r) {
  return (r == 0 ? (q << 2) : (q >> (8 * r - 2))) & 0x3FCu;
}

// Step the 16 bytes of v (bytes t0 .. t0 + 15 of the current word).
template <int K>
__device__ __forceinline__ void step16(const uint4 v, const int t0,
                                       const uint32_t* sb, uint32_t (&r)[K + 1],
                                       uint32_t& word, int mpos) {
  const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t o = offset_of(q[k], i);
      const uint32_t b = *reinterpret_cast<const uint32_t*>(
          reinterpret_cast<const char*>(sb) + o);
      const bool nl = o == (kNewline << 2);
      uint32_t nw[K + 1];
      nw[0] = ((r[0] << 1) | 1u) & b;
#pragma unroll
      for (int j = 1; j <= K; ++j) {
        nw[j] = (((r[j] << 1) | 1u) & b) | r[j - 1] | (r[j - 1] << 1) |
                (nw[j - 1] << 1) | ((1u << j) - 1u);
      }
#pragma unroll
      for (int j = 0; j <= K; ++j) r[j] = nl ? (1u << j) - 1u : nw[j];
      word |= ((r[K] >> mpos) & 1u) << (t0 + 4 * k + i);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
approx_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
              const BTable table, int n_words, int lanes, int n_sub,
              long long pitch, uint32_t match_bit, int sub_words, int warm) {
  __shared__ uint32_t sb[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) sb[i] = table.b[i];
  __syncthreads();

  const long long g = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (g >= static_cast<long long>(lanes) * n_sub) return;
  const int lane = static_cast<int>(g % lanes);
  const int own = static_cast<int>(g / lanes) * sub_words;
  const int end = min(own + sub_words, n_words);
  int w = max(0, own - warm);
  const uint4* p = reinterpret_cast<const uint4*>(data + lane * pitch) + 2 * w;
  const int mpos = 31 - __clz(match_bit);
  uint32_t r[K + 1];
#pragma unroll
  for (int j = 0; j <= K; ++j) r[j] = (1u << j) - 1u;
  uint4 lo = __ldg(p);
  for (; w < end; ++w, p += 2) {
    const uint4 hi = __ldg(p + 1);
    uint32_t word = 0;
    step16<K>(lo, 0, sb, r, word, mpos);
    lo = __ldg(p + (w + 1 < end ? 2 : 0));  // the next word's first half
    step16<K>(hi, 16, sb, r, word, mpos);
    if (w >= own) out[static_cast<size_t>(w) * lanes + lane] = word;
  }
}

// SMs of the current device, asked once per device.
int sm_count(int* sms) {
  static int count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (count[dev] == 0) {
    err = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *sms = count[dev];
  return 0;
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `table_host` points to 256 uint32 B-masks in HOST memory; they
// travel as a kernel parameter.  `pitch` is the byte distance between
// stripes; `warm` the warm-up in 32-byte words.  Returns a cudaError_t:
// cudaGetLastError() after the launch, 0 on success.
extern "C" int dgrep_approx_scan(const void* data, void* out,
                                 const void* table_host, int chunk, int lanes,
                                 long long pitch, unsigned int match_bit,
                                 int k, int warm, void* stream) {
  if (chunk <= 0 || lanes <= 0 || chunk % 32 != 0 || lanes % 32 != 0 ||
      pitch < chunk || pitch % 16 != 0 ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0 || match_bit == 0 ||
      warm < 0 || k < 1 || k > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  BTable table;
  const uint32_t* t = static_cast<const uint32_t*>(table_host);
  for (int i = 0; i < 256; ++i) table.b[i] = t[i];
  // sub-stripes until every SM has a block
  const int n_words = chunk / 32;
  const int lane_blocks = (lanes + kThreads - 1) / kThreads;
  const int n_want = max(1, min(n_words, sms / lane_blocks));
  const int sub_words = (n_words + n_want - 1) / n_want;
  const int n_sub = (n_words + sub_words - 1) / sub_words;
  const long long threads = static_cast<long long>(lanes) * n_sub;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (k) {
    case 1:
      approx_kernel<1><<<grid, block, 0, st>>>(d, o, table, n_words, lanes,
                                               n_sub, pitch, match_bit,
                                               sub_words, warm);
      break;
    case 2:
      approx_kernel<2><<<grid, block, 0, st>>>(d, o, table, n_words, lanes,
                                               n_sub, pitch, match_bit,
                                               sub_words, warm);
      break;
    default:
      approx_kernel<3><<<grid, block, 0, st>>>(d, o, table, n_words, lanes,
                                               n_sub, pitch, match_bit,
                                               sub_words, warm);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
