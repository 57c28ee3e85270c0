// FDR bucketed literal-set filter over (chunk, lanes) stripes, candidate
// bits.
//
// Replaces the TPU kernel distributed_grep_tpu/ops/pallas_fdr.py:_kernel
// (launched through _fdr_pallas / fdr_scan_words) and computes the same
// words at the same layout:
//
//   data  (chunk, lanes) uint8, column-major stripes: data[c * lanes + l]
//         is byte c of stripe l.
//   out   (chunk / 32, lanes) uint32: bit t of word w of lane l is set iff
//         the bank's pipeline is nonzero after byte 32w + t of stripe l (a
//         CANDIDATE end; the host confirms it).
//
// Per lane, from the stripe head with prev = 0 and every pipeline stage
// all ones, each byte b (folded A-Z -> a-z when asked) steps
//
//   h_f    = (prev * a_f) ^ (b * b_f)            one hash per family f
//   M_k    = AND over the checks i of slot k of  tab_i[h_fam(i) & (D_i - 1)]
//   V_k    = V_{k-1}(previous byte) & M_k,  V_0 = M_0
//   bit    = V_{m-1} != 0;   prev = b
//
// which is models/fdr.py's filter.  Domains nest (models/fdr.pair_hash),
// so masking one hash per family down to each check's domain equals the
// reference's per-check hash.
//
// Design.  The TPU kernel splits every table into 128-entry subtables and
// selects among them with masks, because its lane gather covers 128
// entries, and carries V across chunk blocks in VMEM scratch.  Here the
// plan is data: the wrapper (ops/fdr_scan.py) packs one bank into a small
// device buffer -- m, the checks sorted by slot with each slot's index
// range, each check's family, domain mask and table offset, then the
// bank's own tables concatenated (at most 64 x 128 entries, 32 KB) --
// which each block copies to shared memory, so a lookup is one
// shared-memory load.  One thread owns one lane and walks its whole
// stripe with V[0..m) in registers (the kernel is templated on m = 1..6),
// as csrc/shift_and.cu does: a warp reads 32 neighbouring bytes of one row
// per step, loads the 32 bytes of a word before its 32 dependent steps,
// and stores each word coalesced across lanes.  With accumulate set it
// ORs into the words already in `out` (later banks, the pairset sidecar).
//
// Bound.  Per input byte: 3 integer operations (load, fold, output bit),
// 3 per hash family, 2 per check (mask, lookup), 1 per check AND and 1
// per slot; 1 byte in and 1/8 byte out.  The lookups go to shared memory
// at random addresses, so neighbouring lanes conflict on its 32 banks;
// chip_smoke.py reports the larger of the bytes, operations and
// shared-memory bounds beside the measured time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 6;
constexpr int kMaxChecks = 16;
constexpr int kMaxTable = 64 * 128;
// Plan buffer layout, in uint32 words (ops/fdr_scan.py writes it):
//   [0]            m
//   [1]            n_checks
//   [2, 10)        first check index of slot k, k = 0..m (checks sorted
//                  by slot; entry m is n_checks)
//   [10, 58)       per check: family, domain - 1, table offset
//   [64, ...)      the tables, concatenated in check order
constexpr int kSlotStart = 2;
constexpr int kChecks = 10;
constexpr int kCheckStride = 3;
constexpr int kTables = 64;
constexpr int kPlanWords = kTables + kMaxTable;

template <int M>
__global__ void __launch_bounds__(kThreads)
fdr_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
           const uint32_t* __restrict__ plan, int chunk, int lanes,
           int n_plan, int fold, int accumulate) {
  __shared__ uint32_t sp[kPlanWords];
  for (int i = threadIdx.x; i < n_plan; i += blockDim.x) sp[i] = plan[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;

  int s_lo[M + 1];
#pragma unroll
  for (int k = 0; k <= M; ++k) s_lo[k] = static_cast<int>(sp[kSlotStart + k]);
  const uint32_t* ck = sp + kChecks;
  const uint32_t* tab = sp + kTables;

  uint32_t v[M];
#pragma unroll
  for (int k = 0; k < M; ++k) v[k] = 0xFFFFFFFFu;  // stripe heads over-report
  uint32_t prev = 0u;

  const size_t stride = static_cast<size_t>(lanes);
  const uint8_t* p = data + lane;
  uint32_t* o = out + lane;
  const int n_out = chunk / 32;
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
      const uint32_t h0 = (prev * 37u) ^ (b * 101u);
      const uint32_t h1 = (prev * 171u) ^ (b * 59u);
      uint32_t mk[M];
#pragma unroll
      for (int k = 0; k < M; ++k) {
        uint32_t acc = 0xFFFFFFFFu;
        // kept rolled: unrolled inside the 32-step body the kernel ran
        // 2.4-3.7x slower on the BASELINE banks (PERF.md, runs H and J)
#pragma unroll 1
        for (int i = s_lo[k]; i < s_lo[k + 1]; ++i) {
          const uint32_t* e = ck + kCheckStride * i;
          const uint32_t h = e[0] ? h1 : h0;
          acc &= tab[e[2] + (h & e[1])];
        }
        mk[k] = acc;
      }
#pragma unroll
      for (int k = M - 1; k > 0; --k) v[k] = v[k - 1] & mk[k];
      v[0] = mk[0];
      word |= (v[M - 1] != 0u ? 1u : 0u) << t;
      prev = b;
    }
    uint32_t* dst = o + static_cast<size_t>(wd) * stride;
    *dst = accumulate ? (*dst | word) : word;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `plan` is the DEVICE buffer ops/fdr_scan.py packs (layout
// above), `n_plan` its length in uint32 words; `m` the bank's slots.
// Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int dgrep_fdr_scan(const void* data, void* out, const void* plan,
                              int chunk, int lanes, int m, int n_plan,
                              int fold, int accumulate, void* stream) {
  if (chunk <= 0 || lanes <= 0 || chunk % 32 != 0 || lanes % 32 != 0 ||
      m < 1 || m > kMaxSlots || n_plan < kTables || n_plan > kPlanWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((lanes + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  const uint32_t* pl = static_cast<const uint32_t*>(plan);
  switch (m) {
    case 1:
      fdr_kernel<1><<<grid, block, 0, st>>>(d, o, pl, chunk, lanes, n_plan,
                                            fold, accumulate);
      break;
    case 2:
      fdr_kernel<2><<<grid, block, 0, st>>>(d, o, pl, chunk, lanes, n_plan,
                                            fold, accumulate);
      break;
    case 3:
      fdr_kernel<3><<<grid, block, 0, st>>>(d, o, pl, chunk, lanes, n_plan,
                                            fold, accumulate);
      break;
    case 4:
      fdr_kernel<4><<<grid, block, 0, st>>>(d, o, pl, chunk, lanes, n_plan,
                                            fold, accumulate);
      break;
    case 5:
      fdr_kernel<5><<<grid, block, 0, st>>>(d, o, pl, chunk, lanes, n_plan,
                                            fold, accumulate);
      break;
    default:
      fdr_kernel<6><<<grid, block, 0, st>>>(d, o, pl, chunk, lanes, n_plan,
                                            fold, accumulate);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
