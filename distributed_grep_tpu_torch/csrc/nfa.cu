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
// the TPU has no vector gather; a cost budget keeps wide plans off it.
// Here the plan is data: the wrapper (ops/nfa_scan.py) packs it into one
// small device buffer, which each block copies to shared memory -- the
// header (chain, init and final masks, the specials' index ranges), the
// n_words x 256 B table (at most 4 KB) and the specials, each a (bit,
// follow[4]) record, grouped by the word of their source bit.  B[byte]
// is one shared-memory lookup per state word.  One thread owns one lane
// and walks its whole stripe with D[0..n_words) in registers (the kernel
// is templated on n_words = 1..4), as csrc/shift_and.cu does: a warp reads
// 32 neighbouring bytes of one row per step, loads the 32 bytes of a word
// before the 32 dependent steps, and stores each word coalesced across
// lanes.  The specials are a plain loop over the word's records, skipped
// when no special source bit of that word is set (one AND and a branch);
// a wide bounded repeat (a[bc]{40,90}d: 51 specials over 3 words) pays
// (2 + n_words) operations per special whose word is live.
//
// Bound.  Per input byte and state word: a B lookup, the chain shift-and-
// or, the init or, the AND with B and the final test, about 8 integer
// operations, plus 2 + n_words per live special; bytes moved per input
// byte: 1 in and 1/8 out.  For a 64 MB segment at 1 word that is 72 MiB
// at 3.35 TB/s, 0.0225 ms, against about 0.03 ms of operations:
// chip_smoke.py computes both from the model and the shape and reports
// the larger beside the measured time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 4;
constexpr int kMaxSpecials = 128;
// Plan buffer layout, in uint32 words (ops/nfa_scan.py writes it):
//   [0, 4)    chain_src       [4, 8)   init_float   [8, 12)  init_anchor
//   [12, 16)  final           [16, 21) special index range start per word
//   [21, 25)  special source-bit mask per word
//   [32, 32 + 4 * 256)        B table, word w at 32 + 256 * w
//   [1056, ...)               specials, 5 words each: bit, follow[0..4)
constexpr int kChain = 0;
constexpr int kInitFloat = 4;
constexpr int kInitAnchor = 8;
constexpr int kFinal = 12;
constexpr int kSpecStart = 16;
constexpr int kSpecMask = 21;
constexpr int kB = 32;
constexpr int kSpecials = kB + kMaxWords * 256;
constexpr int kSpecStride = 5;
constexpr int kPlanWords = kSpecials + kSpecStride * kMaxSpecials;

template <int NW>
__global__ void __launch_bounds__(kThreads)
nfa_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
           const uint32_t* __restrict__ plan, int chunk, int lanes,
           int n_specials) {
  __shared__ uint32_t sp[kPlanWords];
  const int n_plan = kSpecials + kSpecStride * n_specials;
  for (int i = threadIdx.x; i < n_plan; i += blockDim.x) sp[i] = plan[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;

  uint32_t chain[NW], init_f[NW], init_a[NW], fin[NW], smask[NW], d[NW];
  int s_lo[NW], s_hi[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    chain[w] = sp[kChain + w];
    init_f[w] = sp[kInitFloat + w];
    init_a[w] = sp[kInitAnchor + w];
    fin[w] = sp[kFinal + w];
    smask[w] = sp[kSpecMask + w];
    s_lo[w] = static_cast<int>(sp[kSpecStart + w]);
    s_hi[w] = static_cast<int>(sp[kSpecStart + w + 1]);
    d[w] = 0u;
  }
  const uint32_t* sb = sp + kB;
  const uint32_t* ss = sp + kSpecials;

  const size_t stride = static_cast<size_t>(lanes);
  const uint8_t* p = data + lane;
  uint32_t* o = out + lane;
  const int n_out = chunk / 32;
  uint32_t prev_nl = 1u;  // the stripe start counts as a line start
  for (int wd = 0; wd < n_out; ++wd) {
    const uint8_t* row = p + static_cast<size_t>(wd) * 32 * stride;
    uint32_t bytes[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) bytes[t] = __ldg(row + t * stride);
    uint32_t word = 0u;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const uint32_t b = bytes[t];
      const uint32_t nl_mask = 0u - prev_nl;
      uint32_t r[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        r[w] = init_f[w] | (nl_mask & init_a[w]) | ((d[w] & chain[w]) << 1);
      }
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (d[w] & smask[w]) {
          for (int s = s_lo[w]; s < s_hi[w]; ++s) {
            const uint32_t* e = ss + kSpecStride * s;
            const uint32_t sel = 0u - ((d[w] >> e[0]) & 1u);
#pragma unroll
            for (int v = 0; v < NW; ++v) r[v] |= sel & e[1 + v];
          }
        }
      }
      uint32_t hit = 0u;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        d[w] = r[w] & sb[256 * w + b];
        hit |= d[w] & fin[w];
      }
      word |= (hit != 0u ? 1u : 0u) << t;
      prev_nl = (b == 0x0Au) ? 1u : 0u;
    }
    o[static_cast<size_t>(wd) * stride] = word;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `plan` is the DEVICE buffer ops/nfa_scan.py packs (layout
// above) with `n_specials` special records.  Returns cudaGetLastError()
// after the launch: 0 on success.
extern "C" int dgrep_nfa_scan(const void* data, void* out, const void* plan,
                              int chunk, int lanes, int n_words,
                              int n_specials, void* stream) {
  if (chunk <= 0 || lanes <= 0 || chunk % 32 != 0 || lanes % 32 != 0 ||
      n_words < 1 || n_words > kMaxWords || n_specials < 0 ||
      n_specials > kMaxSpecials) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((lanes + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  const uint32_t* pl = static_cast<const uint32_t*>(plan);
  switch (n_words) {
    case 1:
      nfa_kernel<1><<<grid, block, 0, st>>>(d, o, pl, chunk, lanes, n_specials);
      break;
    case 2:
      nfa_kernel<2><<<grid, block, 0, st>>>(d, o, pl, chunk, lanes, n_specials);
      break;
    case 3:
      nfa_kernel<3><<<grid, block, 0, st>>>(d, o, pl, chunk, lanes, n_specials);
      break;
    default:
      nfa_kernel<4><<<grid, block, 0, st>>>(d, o, pl, chunk, lanes, n_specials);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
