// Table-DFA scan over (lanes, chunk) stripes, exact match-end bits.
//
// Replaces the reference's XLA device DFA scan,
// distributed_grep_tpu/ops/scan_jnp.py:_dfa_scan_core (the recurrence
// dfa_scan_body, packed by _pack_lane_bits): XLA device code, not a Pallas
// kernel, and the last device code of the reference with no CUDA
// counterpart.  It computes the same bits, as the port's words:
//
//   data   (lanes, chunk) uint8 stripes, as the document lies: byte c of
//          stripe l is data[l * pitch + c] (pitch >= chunk, a multiple of
//          16, and data 16-byte aligned).
//   table  n_states * n_classes uint32 entries, one per (state, class):
//          bits 0..29 the next state times n_classes (the row offset of
//          the next state), bit 31 accept[next], bit 30 accept_eol[next]
//          (ops/dfa_scan.packed_table).
//   cls    256 uint8: each byte's class.
//   out    (chunk / 32, lanes) uint32: bit t of word w of lane l is set
//          iff after byte c = 32w + t of stripe l the state accepts, or
//          accepts at end of line and byte c + 1 of the stripe is '\n'.
//          The stripe's last byte counts as followed by '\n'.
//
// Every stripe starts in `start` (the row offset of the start state).
//
// Design.  The step is a dependent gather chain: a byte's class, then the
// entry of (state, class), whose next state indexes the next byte's entry.
// Nothing vectorizes it, so a thread walks one stripe: 16-byte loads of
// its own stripe (the next 16 bytes load while the current ones step),
// the class table in shared memory, and one table read a byte -- the
// accept and end-of-line flags ride in the entry, and the next state is
// stored premultiplied, so a step is two loads, an add and a mask.  The
// table is copied to shared memory when it fits kSmemTableBytes (two
// blocks of 256 threads an SM then hold it twice); a larger one (an
// Aho-Corasick bank of thousands of states and up to 256 classes) is read
// from global memory through the read-only path, where the L2 serves it.
// A warp's 32 lanes store one coalesced 128-byte row of words.
//
// Bound.  Per input byte one class lookup and one transition lookup, at
// random addresses: at best 32 a clock an SM in shared memory or the L1
// (132 SMs at 1.98 GHz), about 0.016 ms for a 64 MiB segment, under the
// 0.0225 ms its bytes take at 3.35 TB/s (plus the table once): bound by
// bytes.  The walk itself is latency-bound: a thread's 1024 steps are a
// chain of dependent reads, and 65536 lanes give each SM only 16 warps to
// hide them.  chip_smoke.py measured 0.0689 ms for 'nee(dle|t)' (table
// in shared memory), 0.1007 for config 3's 0.8 MB Aho-Corasick bank and
// 0.4533 for config 5's 57 MB bank, past the L2 (PERF.md section 6, run
// 13A, an H100 80GB HBM3 at 700 W).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr uint32_t kAcceptEol = 1u << 30;
constexpr uint32_t kNextMask = kAcceptEol - 1u;
constexpr uint32_t kNewline = 0x0A;
// The largest table copied to shared memory (ops/dfa_scan.py
// SMEM_TABLE_BYTES says the same).
constexpr int kSmemTableBytes = 96 * 1024;

// Step the 16 bytes of v, bits t0 .. t0 + 15 of the current word.
__device__ __forceinline__ void step16(const uint4 v, const int t0,
                                       const uint32_t* __restrict__ tab,
                                       const uint32_t* __restrict__ cls,
                                       uint32_t& state, uint32_t& acc,
                                       uint32_t& eol, uint32_t& nl) {
  const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t b = (q[k] >> (8 * i)) & 0xFFu;
      const uint32_t e = tab[state + cls[b]];
      const int t = t0 + 4 * k + i;
      state = e & kNextMask;
      acc |= (e >> 31) << t;
      eol |= ((e >> 30) & 1u) << t;
      nl |= static_cast<uint32_t>(b == kNewline) << t;
    }
  }
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
dfa_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
           const uint32_t* __restrict__ table,
           const uint8_t* __restrict__ cls_global, int n_entries, int n_words,
           int lanes, long long pitch, uint32_t start) {
  extern __shared__ uint32_t smem[];  // 256 classes, then the table
  uint32_t* cls = smem;
  for (int i = threadIdx.x; i < 256; i += kThreads) cls[i] = cls_global[i];
  const uint32_t* tab = table;
  if (kSmem) {
    uint32_t* t = smem + 256;
    for (int i = threadIdx.x; i < n_entries; i += kThreads) t[i] = table[i];
    tab = t;
  }
  __syncthreads();

  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const uint4* p = reinterpret_cast<const uint4*>(data + lane * pitch);
  uint32_t state = start;
  uint4 lo = __ldg(p);
  for (int w = 0; w < n_words; ++w, p += 2) {
    const uint4 hi = __ldg(p + 1);
    uint32_t acc = 0, eol = 0, nl = 0;
    step16(lo, 0, tab, cls, state, acc, eol, nl);
    const bool more = w + 1 < n_words;
    lo = __ldg(p + (more ? 2 : 0));  // the next word's first half
    step16(hi, 16, tab, cls, state, acc, eol, nl);
    // bit t's next byte: bit t + 1 of this word, or the next word's first
    // byte, or for the stripe's last byte a '\n'
    const uint32_t next_nl = more ? static_cast<uint32_t>((lo.x & 0xFFu) ==
                                                          kNewline)
                                  : 1u;
    out[static_cast<size_t>(w) * lanes + lane] =
        acc | (eol & ((nl >> 1) | (next_nl << 31)));
  }
}

// Opt the shared-memory instance in to kSmemTableBytes of dynamic shared
// memory, once per device (so never while a CUDA graph is captured after
// a first launch).
int allow_smem_table() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!done[dev]) {
    err = cudaFuncSetAttribute(dfa_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               4 * 256 + kSmemTableBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    done[dev] = true;
  }
  return 0;
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `table` and `cls` are device pointers (n_entries uint32 and
// 256 uint8); `start` is the start state's row offset.  Returns a
// cudaError_t: cudaGetLastError() after the launch, 0 on success.
extern "C" int dgrep_dfa_scan(const void* data, void* out, const void* table,
                              const void* cls, int n_entries, int chunk,
                              int lanes, long long pitch, unsigned int start,
                              void* stream) {
  if (chunk <= 0 || lanes <= 0 || chunk % 32 != 0 || lanes % 32 != 0 ||
      pitch < chunk || pitch % 16 != 0 ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0 || n_entries <= 0 ||
      static_cast<long long>(start) >= n_entries ||
      static_cast<unsigned long long>(n_entries) > kNextMask + 1ull) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((lanes + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  const uint32_t* t = static_cast<const uint32_t*>(table);
  const uint8_t* c = static_cast<const uint8_t*>(cls);
  const long long table_bytes = 4ll * n_entries;
  if (table_bytes <= kSmemTableBytes) {
    const int smem = static_cast<int>(4 * 256 + table_bytes);
    const int err = allow_smem_table();
    if (err != 0) return err;
    dfa_kernel<true><<<grid, block, smem, st>>>(d, o, t, c, n_entries,
                                                chunk / 32, lanes, pitch,
                                                start);
  } else {
    dfa_kernel<false><<<grid, block, 4 * 256, st>>>(d, o, t, c, n_entries,
                                                    chunk / 32, lanes, pitch,
                                                    start);
  }
  return static_cast<int>(cudaGetLastError());
}
