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
// The pipeline is a window, not a long recurrence:
//
//   V_{m-1}(t) = AND over k of M_k(t - (m-1-k)),
//
// with every term before the stripe head all ones and prev = 0 at row 0
// (ops/fdr_scan.py's plain version computes it so).  So the kernel is
// position-parallel: ONE THREAD PER OUTPUT WORD (w, l), (chunk / 32) x
// lanes threads (2M for a 64 MB segment, where a thread per lane gave 16
// warps per SM and left the card latency-bound).  A thread reads rows
// 32w - m .. 32w + 31 of its lane (row -1 reads as 0: the prev of row 0)
// into registers; consecutive threads of a warp are consecutive lanes, so
// every row read is coalesced.  The m rows before 32w are also read by
// the thread of word w - 1: at most 6 of 38 rows, served by L1 and L2,
// so the block does not stage its tile in shared memory (that would add
// a barrier and shared memory beside the tables; not measured).
//
// The thread computes its 32 outputs in two groups of 16 accumulators:
// for each slot k (lag m-1-k, unrolled) and each check of that slot (a
// loop uniform over the grid), 16 independent lookups
//   acc[u] &= tab_i[hash(row 32w + g + u - lag) & (D_i - 1)],
// each 5 integer operations (two multiplies, xor-and, the address, the
// AND) and one shared-memory load; rows before the stripe head give all
// ones.  The check descriptors (hash multipliers, domain mask, table
// offset, pre-scaled to byte addresses) are one __grid_constant__
// kernel parameter, read from the constant bank, uniform across the
// warp: the only shared-memory load per check per byte is the table
// lookup.  Each block copies the bank's tables (at most 64 x 128 entries,
// 32 KB; config 5's 2176 entries, 8.5 KB) to shared memory once, after
// it has issued its byte loads.  With accumulate set it ORs into the
// words already in `out` (later banks, the pairset sidecar).
//
// Bound.  Per input byte: 3 integer operations (load, fold, output bit),
// 3 per hash family, 2 per check (mask, lookup), 1 per check AND and 1
// per slot; 1 byte in and 1/8 byte out.  The lookups go to shared memory
// at data-dependent addresses, so the lanes of a warp conflict on its 32
// banks (about 3.5-way for random bytes).  A variant that kept 2^k copies
// of every entry side by side, lane l reading copy l mod 2^k (up to 32
// copies within 48 KB), ran slower on the banks of configs 2, 3 and 5 in a
// design run: with one thread per output word a launch has 8192 blocks,
// and writing every block's copies cost more than the conflicts it
// removed, so the tables are held once.  chip_smoke.py reports the larger
// of the bytes, operations and shared-memory bounds beside the measured
// time.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;  // output bits per pass over the checks
constexpr int kMaxSlots = 6;
constexpr int kMaxChecks = 16;
constexpr int kMaxTable = 64 * 128;
// Plan buffer layout, in uint32 words (ops/fdr_scan.py:pack_bank writes
// it).  The header [0, 128):
//   [0] m   [1] n_checks   [2] table words (a multiple of 4)
//   [8, 16)   first check of slot k, k = 0..m (checks sorted by slot;
//             entries from m on are n_checks)
//   [16, 32)  per check: the hash multiplier of prev (a_f)
//   [32, 48)  per check: the hash multiplier of the byte (b_f)
//   [48, 64)  per check: domain - 1
//   [64, 80)  per check: table offset in words
// The tables [128, 128 + table words), concatenated in check order.
constexpr int kHeaderWords = 128;

struct Header {  // the header's first 80 words
  uint32_t m, n_checks, n_tab, pad[5];
  uint32_t slot_start[8];
  uint32_t mul_prev[kMaxChecks];
  uint32_t mul_byte[kMaxChecks];
  uint32_t dmask[kMaxChecks];
  uint32_t off[kMaxChecks];
};

// The kernel parameter: the descriptors pre-scaled to byte addresses.  A
// hash h = (prev * a) ^ (b * b_f) masked to D - 1 becomes
// ((prev * 4a) ^ (b * 4b_f)) & 4(D - 1) = 4h, and the table's byte offset
// is added to the shared base once per check, so a lookup is two
// multiplies, one xor-and and a load at [4h + uniform base].
struct Plan {
  uint32_t slot_start[8];
  uint32_t mul_prev[kMaxChecks];  // 4 a_f
  uint32_t mul_byte[kMaxChecks];  // 4 b_f
  uint32_t dmask[kMaxChecks];     // 4 (D - 1)
  uint32_t off[kMaxChecks];       // byte offset of the table
  uint32_t n_tab;                 // table words
};

__device__ __forceinline__ uint32_t load_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

template <int M>
__global__ void __launch_bounds__(kThreads)
fdr_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
           const uint32_t* __restrict__ tables, int chunk, int lanes,
           int fold, int accumulate, const __grid_constant__ Plan plan) {
  extern __shared__ uint4 smem[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int wd = blockIdx.y * blockDim.y + threadIdx.y;
  const bool live = lane < lanes && wd < chunk / 32;
  const bool head = wd == 0;  // uniform over a warp: a warp is one row
  const size_t stride = static_cast<size_t>(lanes);

  // by[j] is row 32 wd - M + j; rows before the stripe head read as 0
  uint32_t by[32 + M];
  if (live) {
    const uint8_t* row0 = data + lane + static_cast<size_t>(wd) * 32 * stride;
#pragma unroll
    for (int j = 0; j < 32 + M; ++j) {
      const ptrdiff_t off = static_cast<ptrdiff_t>(j - M) *
                            static_cast<ptrdiff_t>(stride);
      by[j] = (j < M && head) ? 0u : static_cast<uint32_t>(__ldg(row0 + off));
    }
  }
  const uint4* src = reinterpret_cast<const uint4*>(tables);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < static_cast<int>(plan.n_tab / 4);
       i += blockDim.x * blockDim.y) {
    smem[i] = src[i];
  }
  __syncthreads();
  if (!live) return;
  if (fold) {
#pragma unroll
    for (int j = 0; j < 32 + M; ++j) {
      by[j] += (by[j] - 65u < 26u) ? 32u : 0u;
    }
  }

  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint32_t word = 0u;
#pragma unroll
  for (int g = 0; g < 32; g += kGroup) {
    uint32_t acc[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) acc[u] = 0xFFFFFFFFu;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int lag = M - 1 - k;
#pragma unroll 1
      for (int i = static_cast<int>(plan.slot_start[k]);
           i < static_cast<int>(plan.slot_start[k + 1]); ++i) {
        const uint32_t a = plan.mul_prev[i];
        const uint32_t c = plan.mul_byte[i];
        const uint32_t dm = plan.dmask[i];
        const uint32_t tab = sbase + plan.off[i];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int q = M + g + u - lag;  // by index of row 32 wd + g + u - lag
          uint32_t x = load_shared(
              tab + (((by[q - 1] * a) ^ (by[q] * c)) & dm));
          if (g + u < lag && head) x = 0xFFFFFFFFu;  // before the stripe head
          acc[u] &= x;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      word |= (acc[u] != 0u ? 1u : 0u) << (g + u);
    }
  }
  uint32_t* dst = out + static_cast<size_t>(wd) * stride + lane;
  *dst = accumulate ? (*dst | word) : word;
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `plan_host` and `plan_dev` are the same buffer
// (ops/fdr_scan.py:pack_bank, layout above), on the host and on the
// device: the descriptors are read from the host copy into the kernel's
// parameter, the tables are copied by each block from the device copy.
// Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int dgrep_fdr_scan(const void* data, void* out,
                              const void* plan_host, const void* plan_dev,
                              int chunk, int lanes, int fold, int accumulate,
                              void* stream) {
  if (chunk <= 0 || lanes <= 0 || chunk % 32 != 0 || lanes % 32 != 0 ||
      plan_host == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Header h;
  std::memcpy(&h, plan_host, sizeof(Header));
  const int m = static_cast<int>(h.m);
  if (m < 1 || m > kMaxSlots || h.n_checks < 1 || h.n_checks > kMaxChecks ||
      h.n_tab > kMaxTable || h.n_tab % 4 != 0 || h.slot_start[0] != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan plan;
  for (int k = 0; k < 8; ++k) {
    plan.slot_start[k] = k <= m ? h.slot_start[k] : h.n_checks;
    if (plan.slot_start[k] > h.n_checks ||
        (k > 0 && plan.slot_start[k] < plan.slot_start[k - 1])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (plan.slot_start[m] != h.n_checks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < kMaxChecks; ++i) {
    const bool used = i < static_cast<int>(h.n_checks);
    const uint32_t dmask = used ? h.dmask[i] : 0u;
    if (used && ((dmask & (dmask + 1)) != 0 || h.off[i] + dmask >= h.n_tab)) {
      return static_cast<int>(cudaErrorInvalidValue);  // not 2^k - 1, or past
    }
    plan.mul_prev[i] = used ? 4u * h.mul_prev[i] : 0u;
    plan.mul_byte[i] = used ? 4u * h.mul_byte[i] : 0u;
    plan.dmask[i] = 4u * dmask;
    plan.off[i] = used ? 4u * h.off[i] : 0u;
  }
  plan.n_tab = h.n_tab;

  // 256 threads: 256 lanes of one word row, or for narrow layouts all
  // lanes of 256 / lanes word rows
  const int bx = lanes < kThreads ? lanes : kThreads;
  const dim3 block(bx, kThreads / bx);
  const dim3 grid((lanes + bx - 1) / bx,
                  (chunk / 32 + block.y - 1) / block.y);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(h.n_tab) * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  const uint32_t* tabs = static_cast<const uint32_t*>(plan_dev) + kHeaderWords;
  switch (m) {
    case 1:
      fdr_kernel<1><<<grid, block, bytes, st>>>(d, o, tabs, chunk, lanes,
                                                fold, accumulate, plan);
      break;
    case 2:
      fdr_kernel<2><<<grid, block, bytes, st>>>(d, o, tabs, chunk, lanes,
                                                fold, accumulate, plan);
      break;
    case 3:
      fdr_kernel<3><<<grid, block, bytes, st>>>(d, o, tabs, chunk, lanes,
                                                fold, accumulate, plan);
      break;
    case 4:
      fdr_kernel<4><<<grid, block, bytes, st>>>(d, o, tabs, chunk, lanes,
                                                fold, accumulate, plan);
      break;
    case 5:
      fdr_kernel<5><<<grid, block, bytes, st>>>(d, o, tabs, chunk, lanes,
                                                fold, accumulate, plan);
      break;
    default:
      fdr_kernel<6><<<grid, block, bytes, st>>>(d, o, tabs, chunk, lanes,
                                                fold, accumulate, plan);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
