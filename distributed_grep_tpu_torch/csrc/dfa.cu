// Table-DFA scans over (lanes, chunk) stripes, exact match-end bits: K1,
// the byte-at-a-time walk, and K2, the k-byte-stride walk.
//
// K1 replaces the reference's XLA device DFA scan,
// distributed_grep_tpu/ops/scan_jnp.py:81 _dfa_scan_core (the recurrence
// dfa_scan_body, packed by _pack_lane_bits); K2 replaces its k-byte-stride
// scan, scan_jnp.py:99 _dfa_stride_core over models/dfa.StrideTable (k = 2
// or 4, a table with no '$' accepts).  Both are XLA device code, not
// Pallas kernels.  They compute the same bits, as the port's words:
//
//   data   (lanes, chunk) uint8 stripes, as the document lies: byte c of
//          stripe l is data[l * pitch + c] (pitch >= chunk, a multiple of
//          16, and data 16-byte aligned).
//   out    (chunk / 32, lanes) uint32: bit t of word w of lane l is set
//          iff after byte c = 32w + t of stripe l the state accepts, or
//          accepts at end of line and byte c + 1 of the stripe is '\n'.
//          The stripe's last byte counts as followed by '\n'.  Every
//          stripe starts in the start state.
//
// Bound.  Each input byte is read once and each output bit written once:
// a 64 MiB segment takes 0.0225 ms at 3.35 TB/s (with the table, 0.0228
// ms for config 3's 0.8 MB Aho-Corasick bank, 0.0396 for config 5's 57 MB
// bank).  The walk is a chain of dependent table reads, one a byte (K1)
// or one a stride (K2).
//
// What the first design (one thread a stripe) lost to that bound (PERF.md
// section 6 rows 9-10; an H100 80GB HBM3 at 700 W): K1 0.0683 ms on
// 'nee(dle|t)', 0.0954 on config 3's bank, 0.4536 on config 5's; K2 0.0467
// (k = 2) and 0.0563 (k = 4) on 'nee(dle|t)', 0.0714 on config 3's bank.
//  1. One thread walked one whole stripe: 65536 stripes made about 16
//     warps an SM, each thread a chain of 1024 dependent reads.  Past the
//     L2 that chain is the whole time: about 870 clocks a step.
//  2. 21-22 SASS instructions a byte: a class lookup, the table lookup, a
//     mask and three shift-ors (accept, end of line, newline) for every
//     byte, '$' or not.
//  3. 256 blocks each copied the table to shared memory in a loop of
//     threads, into at most 96 KB.
//  4. K2 made k class loads and k - 1 multiplies a stride.
//
// The design, one skeleton for both kernels (PERF.md section 6 measures
// each piece):
//  1. Sub-stripes with speculative entry states.  Each stripe is cut into
//     n_sub sub-stripes of whole 32-byte words, one thread each, the
//     threads of one stripe neighbouring lanes of one warp.  Sub-stripe 0
//     starts in the start state; every other one starts from a guess, the
//     start state (every table the port builds sends '\n' there from every
//     state, so the guess is usually right within a line).  Exactness does
//     not rest on that: a fix-up round walks each sub-stripe whose entry
//     (its predecessor's exit, exchanged with __shfl_up_sync) differs from
//     the state its words were walked from, beside a second walk from that
//     old state, and rewrites its words until the two walks meet; from
//     there on they are the same.  A sub-stripe whose walks never met hands
//     on its new exit, and its successor is fixed up in the next round: at
//     most n_sub - 1 rounds rewrite words.  The threads in flight no longer
//     depend on how many stripes there are: 2 sub-stripes fill every SM
//     for a 64 MiB segment, and the fix-ups re-walk about 0.1% of it.
//  2. A persistent grid of one block of 1024 threads an SM.  Each block
//     copies its tables into shared memory once, with bulk asynchronous
//     copies completing on an mbarrier, into up to the 227 KB a block may
//     use; then it takes lane groups (1024 / n_sub stripes) in a loop.
//  3. Fewer instructions a byte.  K1 on a table of at most 256 slots uses
//     byte-indexed entries: one byte, the next state's slot, at
//     [slot * 256 + byte], the class map folded in; a slot's low bit is
//     its state's accept flag (and the next bit its end-of-line flag), so
//     a step is one PRMT (the index from the entry and the data word), one
//     shared load and one funnel shift that gathers the accept bit.  Other
//     K1 tables keep the class map and the packed entries, flags in bits
//     30-31, gathered with a funnel shift and one bit reverse a word.
//     Tables with no '$' run an instance with no end-of-line work; '$'
//     tables get their newline bits four bytes at a time (a SWAR zero-byte
//     test and one multiply).  K2 reads k class maps premultiplied by
//     their digit's weight: a stride's column is k loads and k - 1 adds.
//  4. Where the table is past shared memory, the rows of the states
//     nearest the start (the packed rows come breadth-first) are kept in
//     shared memory and the rest read through the L2: a table past the L2
//     (config 5's bank) pins as many rows as fit, one the L2 holds 128 KB
//     of them, K2's wide rows 32 KB; the stripes' loads skip the L1, which
//     is left to the table.
//  5. The data: two neighbouring threads load their two words together,
//     each 16-byte load of the pair reading one 32-byte sector, and swap
//     halves; each thread stores its own words (a warp's store covers
//     32 / n_sub neighbouring lanes in each of n_sub rows) and a fix-up
//     rewrites them in place.  The stripes' stream bounds the walk where
//     the table is in shared memory; the chain of table reads where it is
//     not.
// Tried and dropped (PERF.md): staging a lane group's words in shared
// memory for whole rows (it took the L1 the banks need), two stripes a
// thread on the global branch, a TMA ring of 32-byte boxes (a block
// barrier a word), prefetching the stripes two words ahead or into the L2.
// launch_plan (ops/dfa_scan.py) mirrors the launcher's choice of n_sub
// and of where the table lies; a launch reports its plan.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxDevices = 64;
// The most dynamic shared memory a block may use on the H100 (227 KB);
// ops/dfa_scan.py SMEM_BYTES says the same.
constexpr int kSmemBytes = 232448;
constexpr int kBarBytes = 16;  // the mbarrier, first in shared memory
// The global branch's head of the table in shared memory (PERF.md, PR
// 23).  A K1 table past the L2 (config 5's bank) gains from every row
// pinned, since the L1 cannot hold its hot rows either; one the L2 holds
// (config 3's) does best with 128 KB pinned and the rest of the SM's
// memory left to the L1.  K2's rows are wide and sparse, where the L1's
// sectors serve better than whole rows pinned: 32 KB.
constexpr long long kL2Bytes = 50ll << 20;
constexpr long long kHotBytes = 128 * 1024;
constexpr long long kStrideHotBytes = 32 * 1024;
constexpr uint32_t kAcceptEol = 1u << 30;
constexpr uint32_t kNextMask = kAcceptEol - 1u;
constexpr uint32_t kAllLanes = 0xFFFFFFFFu;
constexpr uint32_t kNewline = 0x0Au;

// Where the table lies (ops/dfa_scan.py BRANCHES).
enum Branch : int { kChoose = 0, kBytes = 1, kShared = 2, kGlobal = 3 };

struct Params {
  const uint8_t* data;
  uint32_t* out;
  long long pitch;
  int lanes;
  int n_words;
  int n_sub;
  const uint8_t* aux;    // copied first: K1's class map, K2's class maps
  int aux_bytes;
  const uint8_t* table;  // the entries: copied after aux where shared
  int table_bytes;       // copied to shared memory, a multiple of 16
  uint32_t start;
  uint32_t n_classes;
  uint32_t hot;  // global branch: the entries whose copy is in shared memory
  int32_t* exits;             // K1: each stripe's last state, or null
  const int32_t* slot_state;  // K1: each slot's (row's) state
  unsigned long long* fixups;  // [steps re-walked, most rounds], or null
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread copies `aux` and, where W keeps it there, the table into
// shared memory with bulk asynchronous copies completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(static_cast<uint64_t>(__cvta_generic_to_global(src))), "r"(bytes),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void expect_bytes(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Thread 0 copies the class maps and the table's shared part (`aux`, then
// p.table_bytes of p.table) into shared memory with bulk asynchronous
// copies completing on `bar`; every thread waits for them.
__device__ __forceinline__ void load_tables(uint64_t* bar, uint8_t* dst,
                                            const Params& p) {
  if (threadIdx.x == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    expect_bytes(bar, p.aux_bytes + p.table_bytes);
    if (p.aux_bytes > 0) bulk_copy(dst, p.aux, p.aux_bytes, bar);
    if (p.table_bytes > 0) {
      bulk_copy(dst + p.aux_bytes, p.table, p.table_bytes, bar);
    }
  }
  __syncthreads();  // the barrier is initialized before anyone polls it
  while (!mbar_try_wait(bar, 0)) {
  }
}

// Bit i set iff byte i of x is '\n': a zero-byte test of x ^ '\n' (0x80
// in each zero byte, exactly), then one multiply gathers the four bits.
__device__ __forceinline__ uint32_t newline_bits4(uint32_t x) {
  const uint32_t v = x ^ 0x0A0A0A0Au;
  const uint32_t z = ~(((v & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | v) & 0x80808080u;
  return (((z >> 7) * 0x00204081u) >> 21) & 0xFu;
}

// The newline bits of 16 bytes.
__device__ __forceinline__ uint32_t newline_bits(const uint4 v) {
  return newline_bits4(v.x) | newline_bits4(v.y) << 4 |
         newline_bits4(v.z) << 8 | newline_bits4(v.w) << 12;
}

// A walker steps 16 bytes (`half`, the unrolled hot path, gathering each
// byte's accept and end-of-line flags by funnel shifts; two halves and
// `bits` make a word) or one unit of bytes read from memory (`unit`, the
// fix-up's step); `norm` strips what a state carries beside its identity.
// Each is built from the class maps in shared memory (`aux`), the table's
// copy there (`shared`: all of it, or on the global branch its first
// p.hot entries, the rows of the states nearest the start) and Params.

// K1 on byte-indexed entries in shared memory: tab[slot * 256 + byte] is
// the next slot; bit 0 of a slot is its state's accept flag, bit 1 (with
// '$' accepts) its accept_eol flag.
template <bool kEolT>
struct ByteWalker {
  static constexpr bool kEol = kEolT;
  static constexpr bool kStream = false;
  static constexpr int kUnit = 1;
  static constexpr int kKeep = 0;  // bits below the meeting byte are new
  const uint8_t* tab;

  __device__ __forceinline__ ByteWalker(const uint8_t*, const uint8_t* shared,
                                        const Params&)
      : tab(shared) {}

  static __device__ __forceinline__ uint32_t norm(uint32_t s) { return s; }

  __device__ __forceinline__ void half(const uint4 v, uint32_t& s,
                                       uint32_t& acc, uint32_t& eol) const {
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // byte 0 the data byte, byte 1 the slot, bytes 2-3 zero
        s = tab[__byte_perm(q[j], s, 0x5540u | i)];
        acc = __funnelshift_r(acc, s, 1);
        if (kEol) eol = __funnelshift_r(eol, s >> 1, 1);
      }
    }
  }

  __device__ __forceinline__ uint32_t bits(uint32_t acc, uint32_t eol,
                                           uint32_t nl,
                                           uint32_t next_nl) const {
    return kEol ? acc | (eol & ((nl >> 1) | (next_nl << 31))) : acc;
  }

  __device__ __forceinline__ uint32_t unit(const uint8_t* at, uint32_t s,
                                           uint32_t& a, uint32_t& e) const {
    s = tab[(s << 8) | __ldg(at)];
    a = s & 1u;
    e = (s >> 1) & 1u;
    return s;
  }

  __device__ __forceinline__ int32_t state_of(uint32_t s,
                                              const Params& p) const {
    return __ldg(p.slot_state + s);
  }
};

// K1 on the class map and packed entries (ops/dfa_scan.packed_table, rows
// in breadth-first order from the start): bits 0-29 the next state's row
// offset, bit 31 accept, bit 30 accept_eol.  A state is carried with its
// flags: a shared-memory address shifts them out, a global one masks them.
template <bool kEolT, bool kShared>
struct ClassWalker {
  static constexpr bool kEol = kEolT;
  static constexpr bool kStream = !kShared;  // the L1 serves the table
  static constexpr int kUnit = 1;
  static constexpr int kKeep = 0;
  const uint8_t* cls;
  const uint32_t* hot;  // shared memory: all entries, or the first n_hot
  const uint32_t* tab;  // global memory
  uint32_t n_hot;

  __device__ __forceinline__ ClassWalker(const uint8_t* aux,
                                         const uint8_t* shared,
                                         const Params& p)
      : cls(aux),
        hot(reinterpret_cast<const uint32_t*>(shared)),
        tab(reinterpret_cast<const uint32_t*>(p.table)),
        n_hot(p.hot) {}

  static __device__ __forceinline__ uint32_t norm(uint32_t s) {
    return s & kNextMask;
  }

  __device__ __forceinline__ uint32_t entry(uint32_t s, uint32_t c) const {
    if (kShared) {
      return *reinterpret_cast<const uint32_t*>(
          reinterpret_cast<const uint8_t*>(hot) + ((s + c) << 2));
    }
    const uint32_t i = (s + c) & kNextMask;
    return i < n_hot ? hot[i] : __ldg(tab + i);
  }

  __device__ __forceinline__ void half(const uint4 v, uint32_t& s,
                                       uint32_t& acc, uint32_t& eol) const {
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s = entry(s, cls[__byte_perm(q[j], 0, 0x4440u | i)]);
        acc = __funnelshift_l(s, acc, 1);  // bit 31 in; reversed below
        if (kEol) eol = __funnelshift_l(s << 1, eol, 1);
      }
    }
  }

  __device__ __forceinline__ uint32_t bits(uint32_t acc, uint32_t eol,
                                           uint32_t nl,
                                           uint32_t next_nl) const {
    acc = __brev(acc);
    if (!kEol) return acc;
    return acc | (__brev(eol) & ((nl >> 1) | (next_nl << 31)));
  }

  __device__ __forceinline__ uint32_t unit(const uint8_t* at, uint32_t s,
                                           uint32_t& a, uint32_t& e) const {
    s = entry(s, cls[__ldg(at)]);
    a = s >> 31;
    e = (s >> 30) & 1u;
    return s;
  }

  __device__ __forceinline__ int32_t state_of(uint32_t s,
                                              const Params& p) const {
    return __ldg(p.slot_state + norm(s) / p.n_classes);
  }
};

// K2: K class maps, map i premultiplied by n_classes**(K - 1 - i), and
// packed entries (ops/dfa_scan.packed_stride_table, rows in breadth-first
// order from the start): the next state's row offset above K accept bits,
// bit i the accept after byte i of the stride.
template <int K, bool kShared>
struct StrideWalker {
  static constexpr bool kEol = false;
  static constexpr bool kStream = !kShared;
  static constexpr int kUnit = K;
  static constexpr int kKeep = K;  // the meeting stride's bits are new
  const uint32_t* cls;
  const uint32_t* hot;  // shared memory: all entries, or the first n_hot
  const uint32_t* tab;  // global memory
  uint32_t n_hot;

  __device__ __forceinline__ StrideWalker(const uint8_t* aux,
                                          const uint8_t* shared,
                                          const Params& p)
      : cls(reinterpret_cast<const uint32_t*>(aux)),
        hot(reinterpret_cast<const uint32_t*>(shared)),
        tab(reinterpret_cast<const uint32_t*>(p.table)),
        n_hot(p.hot) {}

  static __device__ __forceinline__ uint32_t norm(uint32_t s) { return s; }

  __device__ __forceinline__ uint32_t entry(uint32_t idx) const {
    if (kShared) return hot[idx];
    return idx < n_hot ? hot[idx] : __ldg(tab + idx);
  }

  __device__ __forceinline__ void half(const uint4 v, uint32_t& s,
                                       uint32_t& acc, uint32_t&) const {
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 16 / K; ++j) {
      uint32_t col = 0;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int b = K * j + i;  // byte b of the 16
        col += cls[256 * i + __byte_perm(q[b / 4], 0, 0x4440u | (b % 4))];
      }
      const uint32_t e = entry(s + col);
      s = e >> K;
      acc = __funnelshift_r(acc, e, K);  // the K accept bits, in order
    }
  }

  __device__ __forceinline__ uint32_t bits(uint32_t acc, uint32_t, uint32_t,
                                           uint32_t) const {
    return acc;
  }

  __device__ __forceinline__ uint32_t unit(const uint8_t* at, uint32_t s,
                                           uint32_t& a, uint32_t& e) const {
    uint32_t col = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) col += cls[256 * i + __ldg(at + i)];
    const uint32_t x = entry(s + col);
    a = x & ((1u << K) - 1u);
    e = 0;
    return x >> K;
  }

  __device__ __forceinline__ int32_t state_of(uint32_t s,
                                              const Params&) const {
    return static_cast<int32_t>(s);
  }
};

// 16 bytes of the stripes, read-only; kStream keeps them out of the L1
// (each 32-byte sector is read whole by one pair's load and never again),
// which leaves the L1 to a table read through it.
template <bool kStream>
__device__ __forceinline__ uint4 load16(const uint4* p) {
  if (!kStream) return __ldg(p);
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Two neighbouring threads load their two words together: each 16-byte
// load of the pair reads one 32-byte sector (the even thread the low half
// of a word, the odd one its high half), so a warp's load touches 16 lines
// where it would touch 32, and one exchange of halves gives each thread
// its own word.  `v1` holds the even thread's word's half, `v2` the odd's.
__device__ __forceinline__ void swap_halves(const uint4 v1, const uint4 v2,
                                            bool odd, uint4& lo, uint4& hi) {
  const uint4 send = odd ? v1 : v2;
  uint4 recv;
  recv.x = __shfl_xor_sync(kAllLanes, send.x, 1);
  recv.y = __shfl_xor_sync(kAllLanes, send.y, 1);
  recv.z = __shfl_xor_sync(kAllLanes, send.z, 1);
  recv.w = __shfl_xor_sync(kAllLanes, send.w, 1);
  lo = odd ? recv : v1;
  hi = odd ? v2 : recv;
}

// The speculative walk of words [w0, w0 + len) of one stripe from state s,
// beside the partner thread's (threadIdx.x ^ 1) walk of [pw0, pw0 + plen)
// of `prow`: word k of both loaded together, the next word's loads issued
// before this one steps.  Every thread of the warp takes max_len steps (a
// shorter sub-stripe skips its last).  Word w goes to dst[w * stride].
// Returns the state after the last byte.
template <class W>
__device__ __forceinline__ uint32_t walk(const W& wk, const uint8_t* row,
                                         int w0, int len,
                                         const uint8_t* prow, int pw0,
                                         int plen, int max_len, int n_words,
                                         uint32_t s, uint32_t* dst,
                                         int stride) {
  const bool odd = threadIdx.x & 1;
  // the even thread's stream and the odd one's, this thread's half of each
  const uint4* e = reinterpret_cast<const uint4*>(odd ? prow : row) +
                   2 * (odd ? pw0 : w0) + odd;
  const uint4* o = reinterpret_cast<const uint4*>(odd ? row : prow) +
                   2 * (odd ? w0 : pw0) + odd;
  const int e_len = odd ? plen : len, o_len = odd ? len : plen;
  uint4 v1 = make_uint4(0, 0, 0, 0), v2 = v1;
  if (e_len > 0) v1 = load16<W::kStream>(e);
  if (o_len > 0) v2 = load16<W::kStream>(o);
  uint4 lo, hi;
  swap_halves(v1, v2, odd, lo, hi);
  for (int k = 0; k < max_len; ++k) {
    v1 = make_uint4(0, 0, 0, 0);
    v2 = v1;
    if (k + 1 < e_len) v1 = load16<W::kStream>(e + 2 * (k + 1));
    if (k + 1 < o_len) v2 = load16<W::kStream>(o + 2 * (k + 1));
    uint32_t acc = 0, eol = 0, nl = 0;
    if (k < len) {
      wk.half(lo, s, acc, eol);
      wk.half(hi, s, acc, eol);
      if (W::kEol) nl = newline_bits(lo) | newline_bits(hi) << 16;
    }
    swap_halves(v1, v2, odd, lo, hi);
    if (k < len) {
      const int w = w0 + k;
      // bit 31's next byte: the next word's first, or past the stripe '\n'
      uint32_t next_nl = 1u;
      if (W::kEol && w + 1 < n_words) {
        next_nl = static_cast<uint32_t>(
            (k + 1 < len ? lo.x & 0xFFu : __ldg(row + 32 * (w + 1))) ==
            kNewline);
      }
      dst[static_cast<size_t>(w) * stride] = wk.bits(acc, eol, nl, next_nl);
    }
  }
  return s;
}

// The fix-up of words [w0, w1): the walk from `sn` (the true entry) beside
// the walk from `so` (the state the words were walked from), rewriting
// words until the two states are equal after a unit.  Returns true where
// they met (the words' exit stands); else `exit` is the new walk's.
template <class W>
__device__ bool fix(const W& wk, const uint8_t* row, int w0, int w1,
                    int n_words, uint32_t sn, uint32_t so, uint32_t* dst,
                    int stride, uint32_t& exit, uint32_t& steps) {
  for (int w = w0; w < w1; ++w) {
    const uint8_t* at = row + 32 * w;
    uint32_t acc = 0, eol = 0, nl = 0;
    int t = 0;
    bool met = false;
    for (; t < 32; t += W::kUnit) {
      uint32_t a, e, a_old, e_old;
      sn = wk.unit(at + t, sn, a, e);
      so = wk.unit(at + t, so, a_old, e_old);
      acc |= a << t;
      if (W::kEol) {
        eol |= e << t;
        nl |= static_cast<uint32_t>(__ldg(at + t) == kNewline) << t;
      }
      steps += W::kUnit;
      if (W::norm(sn) == W::norm(so)) {
        met = true;
        break;
      }
    }
    uint32_t* d = dst + static_cast<size_t>(w) * stride;
    if (met) {
      // K1: bits below the meeting byte t are the new walk's (each one's
      // next byte was read); bit t and up are the same in both walks.
      // K2: the meeting stride's bits are the new walk's too.
      const int n = t + W::kKeep;
      const uint32_t keep = n >= 32 ? kAllLanes : (1u << n) - 1u;
      const uint32_t bits = W::kEol ? acc | (eol & (nl >> 1)) : acc;
      *d = (bits & keep) | (*d & ~keep);
      return true;
    }
    uint32_t bits = acc;
    if (W::kEol) {
      const uint32_t next_nl =
          w + 1 < n_words ? static_cast<uint32_t>(__ldg(at + 32) == kNewline)
                          : 1u;
      bits |= eol & ((nl >> 1) | (next_nl << 31));
    }
    *d = bits;
  }
  exit = sn;
  return false;
}

template <class W>
__global__ void __launch_bounds__(kThreads, 1)
    scan_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint8_t* aux = smem + kBarBytes;
  load_tables(bar, aux, p);
  const W wk(aux, aux + p.aux_bytes, p);

  const int n_sub = p.n_sub;  // a power of two
  const int group = kThreads / n_sub;  // stripes a lane group
  const int n_groups = (p.lanes + group - 1) / group;
  const int sub = threadIdx.x & (n_sub - 1);
  const int local = threadIdx.x / n_sub;
  const int base = p.n_words / n_sub, rem = p.n_words % n_sub;
  const int w0 = sub * base + min(sub, rem);
  const int w1 = w0 + base + (sub < rem ? 1 : 0);
  // the partner thread's sub-stripe (walk loads the pair's words together)
  const int partner = threadIdx.x ^ 1;
  const int p_sub = partner & (n_sub - 1);
  const int p_w0 = p_sub * base + min(p_sub, rem);
  const int p_len = base + (p_sub < rem ? 1 : 0);
  const int max_len = base + (rem > 0 ? 1 : 0);
  uint32_t steps = 0;
  int most_rounds = 0;

  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const int lane = g * group + local;
    const bool active = lane < p.lanes;  // whole warps: lanes % 32 == 0
    const uint8_t* row = p.data + static_cast<long long>(lane) * p.pitch;
    const uint8_t* p_row =
        p.data + static_cast<long long>(g * group + partner / n_sub) * p.pitch;
    // a warp's stores: 32 / n_sub neighbouring lanes in each of n_sub rows
    uint32_t* dst = p.out + lane;
    uint32_t s = p.start;
    if (active) {
      s = walk(wk, row, w0, w1 - w0, p_row, p_w0, p_len, max_len, p.n_words,
               p.start, dst, p.lanes);
    }
    if (n_sub > 1) {
      uint32_t cur = p.start;  // the state this sub-stripe's words began in
      int rounds = 0;
      for (;;) {
        const uint32_t prev = __shfl_up_sync(kAllLanes, s, 1, n_sub);
        const uint32_t want = sub == 0 ? p.start : prev;
        const bool need = active && sub > 0 && W::norm(want) != W::norm(cur);
        if (!__any_sync(kAllLanes, need)) break;
        ++rounds;
        if (need) {
          uint32_t exit;
          if (!fix(wk, row, w0, w1, p.n_words, want, cur, dst, p.lanes, exit,
                   steps)) {
            s = exit;
          }
          cur = want;
        }
      }
      most_rounds = max(most_rounds, rounds);
    }
    if (p.exits != nullptr && active && sub == n_sub - 1) {
      p.exits[lane] = wk.state_of(s, p);
    }
  }
  if (p.fixups != nullptr) {
    const uint32_t total = __reduce_add_sync(kAllLanes, steps);
    const int most = __reduce_max_sync(kAllLanes, most_rounds);
    if ((threadIdx.x & 31) == 0 && (total != 0 || most != 0)) {
      atomicAdd(p.fixups, static_cast<unsigned long long>(total));
      atomicMax(p.fixups + 1, static_cast<unsigned long long>(most));
    }
  }
}

int device_sms(int* sms) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (cached[dev] == 0) {
    err = cudaDeviceGetAttribute(&cached[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *sms = cached[dev];
  return 0;
}

// Opt an instance in to kSmemBytes of dynamic shared memory, once per
// device (so never while a CUDA graph is captured after a first launch).
template <class W>
int allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(scan_kernel<W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    done[dev] = true;
  }
  return 0;
}

// The launcher's sub-stripe count: the fewest rounds of lane groups
// (1024 / n_sub stripes) over the SMs times the longest sub-stripe (in
// words), the smaller count on a tie (fewer fix-ups).  A forced count must
// be a power of two up to 32 and the words; 0 means refused.
int choose_sub(int lanes, int n_words, int sms, int forced) {
  if (forced != 0) {
    const bool ok = forced > 0 && forced <= 32 &&
                    (forced & (forced - 1)) == 0 && forced <= n_words;
    return ok ? forced : 0;
  }
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= 8 && s <= n_words; s *= 2) {
    const long long groups = (1ll * lanes * s + kThreads - 1) / kThreads;
    const long long c = ((groups + sms - 1) / sms) * ((n_words + s - 1) / s);
    if (best_cost < 0 || c < best_cost) {
      best = s;
      best_cost = c;
    }
  }
  return best;
}

struct Choice {
  int n_sub = 0;
  int branch = 0;
  long long resident = 0;  // bytes of tables in shared memory
};

// The launcher's plan: the first shared-memory format whose tables
// (`shared_bytes` per branch, 0 where it does not apply) fit beside the
// mbarrier, else the global branch: `global_bytes` of class
// maps and at most `hot_cap` bytes of the table's head resident.  Returns
// false if a forced count or branch is refused.
bool choose(int lanes, int n_words, int sms, int forced_sub,
            int forced_branch, const long long (&shared_bytes)[2],
            long long global_bytes, long long table_bytes, long long hot_cap,
            Choice* out) {
  if (forced_branch < kChoose || forced_branch > kGlobal) return false;
  Choice c;
  c.n_sub = choose_sub(lanes, n_words, sms, forced_sub);
  if (c.n_sub == 0) return false;
  for (int b = kBytes; b <= kShared; ++b) {
    const long long bytes = shared_bytes[b - kBytes];
    if (bytes > 0 && kBarBytes + bytes <= kSmemBytes &&
        (forced_branch == kChoose || forced_branch == b)) {
      c.branch = b;
      c.resident = bytes;
      *out = c;
      return true;
    }
  }
  if (forced_branch != kChoose && forced_branch != kGlobal) return false;
  long long hot = (kSmemBytes - kBarBytes - global_bytes) / 16 * 16;
  if (hot > hot_cap) hot = hot_cap;
  if (hot > table_bytes) hot = table_bytes;
  c.branch = kGlobal;
  c.resident = global_bytes + hot;
  *out = c;
  return true;
}

template <class W>
int launch(Params p, const Choice& c, int sms, cudaStream_t st) {
  const int err = allow_smem<W>();
  if (err != 0) return err;
  p.n_sub = c.n_sub;
  const int group = kThreads / c.n_sub;
  const int n_groups = (p.lanes + group - 1) / group;
  const int smem = static_cast<int>(kBarBytes + c.resident);
  scan_kernel<W><<<n_groups < sms ? n_groups : sms, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

long long pad16(long long bytes) { return (bytes + 15) / 16 * 16; }

bool bad_stripes(const void* data, int chunk, int lanes, long long pitch) {
  return chunk <= 0 || lanes <= 0 || chunk % 32 != 0 || lanes % 32 != 0 ||
         pitch < chunk || pitch % 16 != 0 || !aligned16(data);
}

void report(int* plan, const Choice& c, int sms, int lanes) {
  if (plan == nullptr) return;
  const int group = kThreads / c.n_sub;
  const int n_groups = (lanes + group - 1) / group;
  plan[0] = c.n_sub;
  plan[1] = c.branch;
  plan[2] = n_groups < sms ? n_groups : sms;
  plan[3] = static_cast<int>(c.resident);
}

}  // namespace

// K1 on `stream` (a cudaStream_t, or null for the legacy default stream).
// Device pointers: `table` n_entries uint32 packed entries (their buffer
// padded to 16 bytes), `cls` 256 uint8 classes, `byte_table` n_slots * 256
// uint8 byte-indexed entries or null, `slot_state` n_slots int32,
// `row_state` n_entries / n_classes int32 (each row's state: the rows are
// in breadth-first order).  `start` is the start state's row offset,
// `start_slot` its slot; `has_eol` says the table has '$' accepts.
// `exits`, `lanes` int32 or null, receives each stripe's state after its
// last byte.  `n_sub` forces the sub-stripe count and `branch` the
// table's place (0: the launcher's choice); `fixups`, 2 int64 or null,
// gains the steps re-walked and keeps the most fix-up rounds of a warp;
// `plan`, 4 host ints or null, receives the sub-stripe count, the branch,
// the blocks and the bytes of tables in shared memory.  Returns a
// cudaError_t: cudaGetLastError() after the launch, 0 on success,
// cudaErrorInvalidValue for arguments (or a forced count or branch) the
// kernel refuses.
extern "C" int dgrep_dfa_scan(const void* data, void* out, const void* table,
                              const void* cls, int n_entries, int chunk,
                              int lanes, long long pitch, unsigned int start,
                              void* exits, int n_classes,
                              const void* byte_table, int n_slots,
                              unsigned int start_slot,
                              const void* slot_state, const void* row_state,
                              int has_eol, int n_sub, int branch,
                              void* fixups, int* plan, void* stream) {
  if (bad_stripes(data, chunk, lanes, pitch) || n_entries <= 0 ||
      static_cast<long long>(start) >= n_entries || n_classes <= 0 ||
      n_entries % n_classes != 0 ||
      static_cast<unsigned long long>(n_entries) > kNextMask + 1ull ||
      !aligned16(table) || !aligned16(cls) || row_state == nullptr ||
      (byte_table != nullptr &&
       (n_slots <= 0 || n_slots > 256 || start_slot >= unsigned(n_slots) ||
        !aligned16(byte_table) || slot_state == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  int err = device_sms(&sms);
  if (err != 0) return err;
  const int n_words = chunk / 32;
  const long long table_bytes = pad16(4ll * n_entries);
  const long long shared_bytes[2] = {
      byte_table != nullptr ? 256ll * n_slots : 0, 256 + table_bytes};
  Choice c;
  if (!choose(lanes, n_words, sms, n_sub, branch, shared_bytes, 256,
              table_bytes, table_bytes > kL2Bytes ? kSmemBytes : kHotBytes,
              &c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.data = static_cast<const uint8_t*>(data);
  p.out = static_cast<uint32_t*>(out);
  p.pitch = pitch;
  p.lanes = lanes;
  p.n_words = n_words;
  p.exits = static_cast<int32_t*>(exits);
  p.fixups = static_cast<unsigned long long*>(fixups);
  p.n_classes = static_cast<uint32_t>(n_classes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool eol = has_eol != 0;
  if (c.branch == kBytes) {
    p.table = static_cast<const uint8_t*>(byte_table);
    p.table_bytes = 256 * n_slots;
    p.start = start_slot;
    p.slot_state = static_cast<const int32_t*>(slot_state);
    err = eol ? launch<ByteWalker<true>>(p, c, sms, st)
              : launch<ByteWalker<false>>(p, c, sms, st);
  } else {
    p.aux = static_cast<const uint8_t*>(cls);
    p.aux_bytes = 256;
    p.table = static_cast<const uint8_t*>(table);
    p.table_bytes = static_cast<int>(c.resident - 256);
    p.hot = static_cast<uint32_t>(p.table_bytes / 4);
    p.start = start;
    p.slot_state = static_cast<const int32_t*>(row_state);
    if (c.branch == kShared) {
      err = eol ? launch<ClassWalker<true, true>>(p, c, sms, st)
                : launch<ClassWalker<false, true>>(p, c, sms, st);
    } else {
      err = eol ? launch<ClassWalker<true, false>>(p, c, sms, st)
                : launch<ClassWalker<false, false>>(p, c, sms, st);
    }
  }
  if (err == 0) report(plan, c, sms, lanes);
  return err;
}

// K2 on `stream`: `table` holds n_entries = n_states * n_classes**k uint32
// entries (ops/dfa_scan.packed_stride_table, the buffer padded to 16
// bytes), `cls_maps` k * 256 uint32 premultiplied class maps
// (ops/dfa_scan.stride_class_maps); `start` is the start state's row
// offset; k is 2 or 4.  The words are dgrep_dfa_scan's for a table
// without '$' accepts.  `n_sub`, `branch` (0, 2 or 3), `fixups` and `plan`
// as dgrep_dfa_scan's.  Returns a cudaError_t as dgrep_dfa_scan does.
extern "C" int dgrep_dfa_stride_scan(const void* data, void* out,
                                     const void* table, const void* cls_maps,
                                     int n_entries, int chunk, int lanes,
                                     long long pitch, unsigned int start,
                                     int k, int n_sub, int branch,
                                     void* fixups, int* plan, void* stream) {
  if (bad_stripes(data, chunk, lanes, pitch) || n_entries <= 0 ||
      static_cast<long long>(start) >= n_entries || (k != 2 && k != 4) ||
      static_cast<unsigned long long>(n_entries) > (0xFFFFFFFFull >> k) ||
      !aligned16(table) || !aligned16(cls_maps) || branch == kBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  int err = device_sms(&sms);
  if (err != 0) return err;
  const int n_words = chunk / 32;
  const long long table_bytes = pad16(4ll * n_entries);
  const long long maps = 1024ll * k;
  const long long shared_bytes[2] = {0, maps + table_bytes};
  Choice c;
  if (!choose(lanes, n_words, sms, n_sub, branch, shared_bytes, maps,
              table_bytes, kStrideHotBytes, &c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.data = static_cast<const uint8_t*>(data);
  p.out = static_cast<uint32_t*>(out);
  p.pitch = pitch;
  p.lanes = lanes;
  p.n_words = n_words;
  p.aux = static_cast<const uint8_t*>(cls_maps);
  p.aux_bytes = static_cast<int>(maps);
  p.table = static_cast<const uint8_t*>(table);
  p.table_bytes = static_cast<int>(c.resident - maps);
  p.hot = static_cast<uint32_t>(p.table_bytes / 4);
  p.start = start;
  p.fixups = static_cast<unsigned long long*>(fixups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shared = c.branch == kShared;
  if (k == 2) {
    err = shared ? launch<StrideWalker<2, true>>(p, c, sms, st)
                 : launch<StrideWalker<2, false>>(p, c, sms, st);
  } else {
    err = shared ? launch<StrideWalker<4, true>>(p, c, sms, st)
                 : launch<StrideWalker<4, false>>(p, c, sms, st);
  }
  if (err == 0) report(plan, c, sms, lanes);
  return err;
}
