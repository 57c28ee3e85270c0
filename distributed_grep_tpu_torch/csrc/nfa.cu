// Bit-parallel Glushkov NFA scan over (chunk, lanes) stripes, exact
// match-end bits.
//
// Replaces the TPU kernel distributed_grep_tpu/ops/pallas_nfa.py:_kernel
// (launched through _nfa_pallas / nfa_scan_words) and computes the same
// words at the same layout:
//
//   data  (chunk, lanes) uint8, column-major stripes: data[c * lanes + l]
//         is byte c of stripe l.
//   out   (chunk / 32, lanes) uint32: bit t of word w of lane l is set iff
//         a match ends at byte 32w + t of stripe l.
//
// Per lane, from the stripe head with D = 0 and prev_nl = 1 (the stripe
// start counts as a line start), every byte steps the position automaton
// of models/nfa.py:
//
//   reached[w] = init_float[w] | (prev_nl ? init_anchor[w] : 0)
//              | ((D[w] & chain_src[w]) << 1)            (within the word)
//              | OR over specials (w', j, follow) with bit j of D[w'] set
//   D[w]       = reached[w] & B[w][byte]
//   out bit    = any_w (D[w] & final[w]) != 0;   prev_nl = (byte == '\n')
//
// chain_src never holds bit 31: an edge that crosses a word is a special,
// so the shift stays inside its 32-bit word.
//
// Design.  The TPU kernel unrolls the whole plan into its body and builds
// B[byte] from byte-range compares or 128-lane gathers, because Pallas on
// the TPU has no vector gather.  Here the plan is data, packed by the
// wrapper (ops/nfa_scan.py:pack_plan) into one buffer: a header that the
// launcher turns into a __grid_constant__ kernel parameter (the chain,
// init and final masks and each exception table's word, byte selector
// and offset, read as constant-bank operands, no registers), and a part
// each block copies to dynamic shared memory:
//
//   - B interleaved by byte, B[byte][0..S) with S = 1, 2, 4, 4 words for
//     n_words = 1..4, so a step reads all its state words' B masks with
//     one 32-, 64- or 128-bit shared load;
//   - the specials as exception tables.  For each byte slice s (bits
//     8s..8s+7) of a state word w that holds special source bits, a
//     256-entry table T[w][s][v] (S words each) holds the OR of `follow`
//     over the specials whose source bit lies in slice s and is set in v.
//     A special's contribution is (its bit of D ? follow : 0), and OR
//     distributes over it, so ORing T[w][s][(D[w] >> 8s) & 0xff] for each
//     such slice equals the OR over the specials.  At most 4 words x 4
//     slices x 256 x 4 words x 4 B = 64 KB (68 KB with B), above the 48
//     KB of static shared memory, hence the dynamic allocation and its
//     opt-in.
//
// The kernel is templated on n_words and on the number of tables NT
// (0-4, else rounded up to 8 or 16; padding lookups read entry 0 of
// table 0, which is zero), so a step's specials are NT independent
// lookups with no branch and no loop: select the table's word (n_words
// - 1 and-ors with constant masks), extract its byte (one __byte_perm),
// one shared load, and an OR per state word.  Their cost does not depend
// on how many specials are live or on how many lanes of the warp are live
// (the previous kernel walked a word's specials in a loop whenever one
// lane had a live source bit, so the warp diverged), and a model without
// specials compiles to a body with no table code.  A warp-uniform skip of
// a word whose masked state is zero in all 32 lanes (__any_sync) was not
// added: a zero slice reads entry 0 of its table, one broadcast shared
// load for the warp.
//
// One thread owns one lane and walks its whole stripe with D[0..n_words)
// in registers, as csrc/shift_and.cu does: a warp reads 32 neighbouring
// bytes of one row per load, and stores each word coalesced across lanes.
// The 32 bytes of the next word are loaded before the 32 dependent steps
// of this one, so the loads' latency hides behind the steps (in design
// runs on the card, loading each word's bytes just before its steps made
// every model slower, config 4's exact model about twice as slow).  With
// 2-4 state words the current word's bytes are packed 4 to a register
// (one __byte_perm a step to read one), which keeps every instance free of
// spills.  Holding B 32 / S times over, so that a warp's B lookups hit
// distinct banks, was slower in the same runs: each block then writes 32
// KB of copies.  The NFA recurrence has no bounded window, so the lanes
// stay the unit of parallelism: more stripes per segment would add
// boundary lines to the host's stitch.
//
// Bound.  Per input byte and state word: a B lookup, the chain shift-and-
// or, the init or, the AND with B and the final test, about 8 integer
// operations; per special table a byte extract, an address and an OR per
// state word; bytes moved per input byte: 1 in and 1/8 out.
// chip_smoke.py computes its bounds from the model and the shape and
// reports the larger beside the measured time.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 4;
constexpr int kSlices = 4;  // byte slices of a 32-bit state word
constexpr int kMaxTables = kMaxWords * kSlices;
constexpr int kMaxDevices = 64;
// Plan buffer layout, in uint32 words (ops/nfa_scan.py:pack_plan writes
// it).  The header [0, 64):
//   [0, 4) chain_src   [4, 8) init_float   [8, 12) init_anchor
//   [12, 16) final     [16] n_tables       [17] words of the shared part
//   [32, 48) state word of table i   [48, 64) byte slice of table i
//   (tables in (word, slice) order)
// The shared part [64, 64 + n_shared): B[byte][S], then table i at
// (1 + i) * 256 * S, 256 x S words each.
constexpr int kHeaderWords = 64;
constexpr int kMaxSharedWords = (1 + kMaxTables) * 256 * 4;

template <int NW>
constexpr int kStride = NW == 1 ? 1 : NW == 2 ? 2 : 4;

struct Plan {  // the kernel parameter
  uint32_t chain[kMaxWords];
  uint32_t init_float[kMaxWords];
  uint32_t init_anchor[kMaxWords];
  uint32_t fin[kMaxWords];
  uint32_t wmask[kMaxTables][kMaxWords];  // all ones at the table's word
  uint32_t sel[kMaxTables];  // __byte_perm selector of the table's slice
  uint32_t off[kMaxTables];  // byte offset of the table in shared memory
  uint32_t n_shared;         // words of the shared part
};

// One B or table entry: S words, aligned for one vector shared load.
template <int S>
struct alignas(4 * S) Entry {
  uint32_t w[S];
};

template <int NW, int NT>
__global__ void __launch_bounds__(kThreads)
nfa_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
           const uint32_t* __restrict__ shared_part, int chunk, int lanes,
           const __grid_constant__ Plan plan) {
  constexpr int S = kStride<NW>;
  using E = Entry<S>;
  extern __shared__ uint4 smem[];
  const uint4* src = reinterpret_cast<const uint4*>(shared_part);
  for (int i = threadIdx.x; i < static_cast<int>(plan.n_shared / 4);
       i += blockDim.x) {
    smem[i] = src[i];
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;

  const E* btab = reinterpret_cast<const E*>(smem);
  const char* sbase = reinterpret_cast<const char*>(smem);
  uint32_t d[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) d[w] = 0u;

  const size_t stride_l = static_cast<size_t>(lanes);
  const uint8_t* p = data + lane;
  uint32_t* o = out + lane;
  const int n_out = chunk / 32;
  // cur holds this word's 32 bytes; the next word's are loaded into nxt
  // before the 32 steps, so their latency hides behind the steps.  With
  // 2-4 state words cur packs 4 bytes to a register: unpacked, ptxas
  // spilled registers of the 2-word instances with 3 and 8 tables.
  constexpr bool kPacked = NW > 1;
  uint32_t cur[kPacked ? 8 : 32], nxt[32];
#pragma unroll
  for (int t = 0; t < 32; ++t) nxt[t] = __ldg(p + t * stride_l);
  uint32_t prev_nl = 1u;  // the stripe start counts as a line start
  for (int wd = 0; wd < n_out; ++wd) {
    if constexpr (kPacked) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        cur[k] = __byte_perm(
            __byte_perm(nxt[4 * k], nxt[4 * k + 1], 0x3340u),
            __byte_perm(nxt[4 * k + 2], nxt[4 * k + 3], 0x3340u), 0x5410u);
      }
    } else {
#pragma unroll
      for (int t = 0; t < 32; ++t) cur[t] = nxt[t];
    }
    const int next = wd + 1 < n_out ? wd + 1 : wd;
    const uint8_t* row = p + static_cast<size_t>(next) * 32 * stride_l;
#pragma unroll
    for (int t = 0; t < 32; ++t) nxt[t] = __ldg(row + t * stride_l);
    uint32_t word = 0u;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const uint32_t b =
          kPacked ? __byte_perm(cur[t / 4], 0u, 0x4440u | (t % 4)) : cur[t];
      const uint32_t nl_mask = 0u - prev_nl;
      uint32_t r[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        r[w] = plan.init_float[w] | (nl_mask & plan.init_anchor[w]) |
               ((d[w] & plan.chain[w]) << 1);
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        uint32_t x = d[0];
        if constexpr (NW > 1) {
          x &= plan.wmask[i][0];
#pragma unroll
          for (int w = 1; w < NW; ++w) x |= d[w] & plan.wmask[i][w];
        }
        const uint32_t v = __byte_perm(x, 0u, plan.sel[i]);
        const E e = *reinterpret_cast<const E*>(sbase + plan.off[i] +
                                                v * sizeof(E));
#pragma unroll
        for (int w = 0; w < NW; ++w) r[w] |= e.w[w];
      }
      const E bv = btab[b];
      uint32_t hit = 0u;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        d[w] = r[w] & bv.w[w];
        hit |= d[w] & plan.fin[w];
      }
      word |= (hit != 0u ? 1u : 0u) << t;
      prev_nl = (b == 0x0Au) ? 1u : 0u;
    }
    o[static_cast<size_t>(wd) * stride_l] = word;
  }
}

template <int NW, int NT>
int launch(const uint8_t* d, uint32_t* o, const uint32_t* shared_part,
           int chunk, int lanes, const Plan& plan, cudaStream_t st) {
  auto kernel = nfa_kernel<NW, NT>;
  const size_t bytes = static_cast<size_t>(plan.n_shared) * 4;
  if (bytes > 48 * 1024) {
    // The opt-in above 48 KB, once per device (a function attribute of
    // the device's context); the first launch precedes any graph capture
    // (utils/slope.py warms every chain up first).
    static bool opted[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= kMaxDevices) {
      return static_cast<int>(cudaErrorInvalidDevice);
    }
    if (!opted[dev]) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSharedWords * 4);
      if (err != cudaSuccess) return static_cast<int>(err);
      opted[dev] = true;
    }
  }
  const dim3 grid((lanes + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  kernel<<<grid, block, bytes, st>>>(d, o, shared_part, chunk, lanes, plan);
  return static_cast<int>(cudaGetLastError());
}

// The instance for n_tables: NT = n_tables up to 4, else rounded up to 8
// or 16 (at most 4 NW); the extra lookups read entry 0 of table 0, which
// is zero.
template <int NW>
int launch_nw(const uint8_t* d, uint32_t* o, const uint32_t* sp, int chunk,
              int lanes, const Plan& plan, int n_tables, cudaStream_t st) {
  if (n_tables == 0) return launch<NW, 0>(d, o, sp, chunk, lanes, plan, st);
  if (n_tables == 1) return launch<NW, 1>(d, o, sp, chunk, lanes, plan, st);
  if (n_tables == 2) return launch<NW, 2>(d, o, sp, chunk, lanes, plan, st);
  if (n_tables == 3) return launch<NW, 3>(d, o, sp, chunk, lanes, plan, st);
  if (n_tables == 4) return launch<NW, 4>(d, o, sp, chunk, lanes, plan, st);
  if constexpr (NW >= 2) {
    if (n_tables <= 8) return launch<NW, 8>(d, o, sp, chunk, lanes, plan, st);
  }
  if constexpr (NW >= 3) {
    return launch<NW, 16>(d, o, sp, chunk, lanes, plan, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `plan_host` and `plan_dev` are the same buffer
// (ops/nfa_scan.py:pack_plan, layout above), on the host and on the
// device: the header is read from the host copy into the kernel's
// parameter, the shared part is copied by each block from the device
// copy.  Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int dgrep_nfa_scan(const void* data, void* out,
                              const void* plan_host, const void* plan_dev,
                              int chunk, int lanes, int n_words,
                              void* stream) {
  if (chunk <= 0 || lanes <= 0 || chunk % 32 != 0 || lanes % 32 != 0 ||
      n_words < 1 || n_words > kMaxWords || plan_host == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t* h = static_cast<const uint32_t*>(plan_host);
  const int s = n_words == 1 ? kStride<1>
                : n_words == 2 ? kStride<2> : kStride<4>;
  const int n_tables = static_cast<int>(h[16]);
  if (n_tables < 0 || n_tables > kSlices * n_words ||
      h[17] != static_cast<uint32_t>((1 + n_tables) * 256 * s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan plan;
  std::memset(&plan, 0, sizeof(Plan));
  std::memcpy(&plan, h, 16 * sizeof(uint32_t));  // the four masks
  plan.n_shared = h[17];
  int last = -1;
  for (int i = 0; i < kMaxTables; ++i) {
    plan.sel[i] = 0x4444u;  // padding: a zero byte
    plan.off[i] = 256u * s * 4u;  // entry 0 of table 0 is zero
    if (i >= n_tables) continue;
    const int w = static_cast<int>(h[32 + i]);
    const int sl = static_cast<int>(h[48 + i]);
    if (w < 0 || w >= n_words || sl < 0 || sl >= kSlices ||
        kSlices * w + sl <= last) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    last = kSlices * w + sl;
    plan.wmask[i][w] = 0xFFFFFFFFu;
    plan.sel[i] = 0x4440u | static_cast<uint32_t>(sl);
    plan.off[i] = static_cast<uint32_t>((1 + i) * 256 * s * 4);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  const uint32_t* sp = static_cast<const uint32_t*>(plan_dev) + kHeaderWords;
  switch (n_words) {
    case 1:
      return launch_nw<1>(d, o, sp, chunk, lanes, plan, n_tables, st);
    case 2:
      return launch_nw<2>(d, o, sp, chunk, lanes, plan, n_tables, st);
    case 3:
      return launch_nw<3>(d, o, sp, chunk, lanes, plan, n_tables, st);
    default:
      return launch_nw<4>(d, o, sp, chunk, lanes, plan, n_tables, st);
  }
}
