// Narrow-width probe: a Shift-And-shaped scan of (chunk, lanes) stripes
// whose state and compare chain run at a chosen element width.
//
// Replaces the TPU kernel benchmarks/probe_narrow.py:_mini_kernel
// (launched through _run) and computes the same words at the same layout:
//
//   data  (chunk, lanes) uint8, column-major stripes: data[c * lanes + l]
//         is byte c of stripe l.  The reference's (chunk, lanes / 128, 128)
//         tile is the same memory.
//   out   (chunk / 32, lanes) uint32.  Per lane, starting from s = 0, each
//         byte b steps s = ((s << 1) | 1) & bmask(b), where bmask is the OR
//         of the masks of the six classes below that b equals (wildcard 0),
//         all at width T.  Word w = (OR of s over bytes 32w .. 32w+31) &
//         match_bit, with match_bit = 1 << 6: nonzero iff 'volcano' ends in
//         that 32-byte span.
//
// The probe asks what the state's width does to the compiled step, so the
// six compares stay a chain at width T (uint32_t, uint16_t or uint8_t, the
// reference's i32, i16 and i8), not a B-table lookup; chip_smoke.py prints
// the SASS instructions per step of each width.  CUDA has no 8- or 16-bit
// ALU lanes: the compiler computes in 32-bit registers and keeps the value
// at width T where the result could differ.
//
// Design.  The TPU kernel carries each lane's state across sequential
// chunk blocks in VMEM scratch.  Here one thread owns one lane and walks
// its whole stripe with the state in a register: it loads the 32 bytes of
// a word (32 independent loads in flight), then runs the 32 dependent
// steps.  A warp's loads of one row are 32 neighbouring bytes, and each
// word store is coalesced across lanes.
//
// Bound.  Per input byte: the load, six compares and six selects (or
// and-ors) of the chain, the shift-or, the and and the accumulate -- about
// 16 operations, against 1 byte in and 1/8 byte out.  For a 64 MB segment
// on an H100 SXM at 128 operations per SM per clock (132 SMs, 1.98 GHz)
// that is about 0.032 ms, above the 0.0225 ms of the bytes: bound by
// operations.  The compiled kernel has 704 SASS instructions (22 per step)
// at every width, and takes 0.173 ms at i32 and 0.209 ms at i16 and i8 per
// 64 MiB on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py, PERF.md),
// 5.4-6.5x its bound: as csrc/shift_and.cu at 65536 lanes (about 16 warps
// per SM), load latency, not arithmetic, sets its time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T class_mask(T b) {
  T m = T(0);  // wildcard
  m = T(m | (b == T('v') ? T(0x01) : T(0)));
  m = T(m | (b == T('o') ? T(0x42) : T(0)));
  m = T(m | (b == T('l') ? T(0x04) : T(0)));
  m = T(m | (b == T('c') ? T(0x08) : T(0)));
  m = T(m | (b == T('a') ? T(0x10) : T(0)));
  m = T(m | (b == T('n') ? T(0x20) : T(0)));
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
narrow_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
              int chunk, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const T match_bit = T(1u << 6);
  const size_t stride = static_cast<size_t>(lanes);
  const uint8_t* p = data + lane;
  uint32_t* o = out + lane;
  const int n_words = chunk / 32;
  T s = T(0);
  for (int w = 0; w < n_words; ++w) {
    const uint8_t* row = p + static_cast<size_t>(w) * 32 * stride;
    uint8_t bytes[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) bytes[t] = __ldg(row + t * stride);
    T word = T(0);
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const T bmask = class_mask<T>(T(bytes[t]));
      s = T(T(T(s << 1) | T(1)) & bmask);
      word = T(word | s);
    }
    o[static_cast<size_t>(w) * stride] = static_cast<uint32_t>(T(word & match_bit));
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `width_bits` is 32, 16 or 8.  Returns cudaGetLastError() after
// the launch: 0 on success.
extern "C" int dgrep_narrow_probe(const void* data, void* out, int chunk,
                                  int lanes, int width_bits, void* stream) {
  if (chunk <= 0 || lanes <= 0 || chunk % 32 != 0 || lanes % 32 != 0 ||
      (width_bits != 32 && width_bits != 16 && width_bits != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((lanes + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (width_bits == 32) {
    narrow_kernel<uint32_t><<<grid, block, 0, st>>>(d, o, chunk, lanes);
  } else if (width_bits == 16) {
    narrow_kernel<uint16_t><<<grid, block, 0, st>>>(d, o, chunk, lanes);
  } else {
    narrow_kernel<uint8_t><<<grid, block, 0, st>>>(d, o, chunk, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}
