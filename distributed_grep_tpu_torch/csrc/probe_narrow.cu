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
// The probe asks what the state's width does to the step, so the six
// compares stay a chain at each width, not a B-table lookup; chip_smoke.py
// prints the SASS instructions per lane and byte of each width.  The card's
// ALU is 32 bits wide, so a narrow width pays only by packing more lanes
// into a register: i32 keeps one lane a register and compares natively; i16
// keeps two (the bytes widened to halfwords with a byte permute) and i8
// four, each compared with exact packed arithmetic (no borrow or carry
// crosses elements; a class bit is set iff its element equals the class
// byte).  Every class mask lies below bit 7, so the step's shift never
// carries a bit out of its element: s = ((s << 1) | ONES) & bmask with
// ONES = one 1 an element.
//
// Design.  The TPU kernel carries each lane's state across sequential
// chunk blocks in VMEM scratch.  Here one thread owns kLanesPerThread = 4
// adjacent lanes and reads byte c of all of them with one 4-byte load per
// row (a warp reads 128 contiguous bytes a row); it keeps the 32 rows of
// its next word in flight while it runs the 32 dependent steps of the
// current one, and stores its lanes' words with one 16-byte store.  The
// loads are the same at every width; the widths differ only in the
// arithmetic.  Four lanes a thread leave 512 warps for a 64 MiB segment
// (65536 lanes), 4 an SM: the launcher cuts each stripe into a power of
// two of sub-stripes until the card holds kWarpsPerSm warps an SM (8 at
// 64 MiB), each started by a warm-up on the 8 bytes before it (a state
// bit k <= 6 depends only on the last k + 1 bytes).
//
// Bound.  Per input byte: the load, six compares and six selects (or
// and-ors) of the class chain, the shift-or, the and and the accumulate --
// about 16 operations at i32, against 1 byte in and 1/8 byte out.  For a
// 64 MB segment on an H100 SXM at 128 operations per SM per clock (132 SMs,
// 1.98 GHz) that is about 0.032 ms, above the 0.0225 ms of the bytes: bound
// by operations.  But compares, selects, logic ops and shifts issue on the
// SM's 64 integer lanes a clock, not 128, and the kernel compiles to about
// 20.5 SASS instructions a lane and byte at i32, 16.5 at i16 and 9.7 at i8
// (chip_smoke.py phase 1), so the integer pipe sets its times: 0.0871 ms
// at i32, 0.0584 at i16 and 0.0361 at i8 per 64 MiB in CUDA graphs on an
// NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py).  The first version
// (one lane a thread, one-byte loads, the narrow widths masked, not
// packed) took 0.1743, 0.2097 and 0.2097 ms eagerly.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // one warp a scheduler where a block has an SM
constexpr int kLanesPerThread = 4;  // one 4-byte load a row
constexpr int kWarpsPerSm = 16;  // sub-stripes until the card holds this many
constexpr int kWarm = 8;  // warm-up bytes before a sub-stripe's first word
constexpr uint32_t kMatchBit = 1u << 6;

// The classes, one per mask bit: bit p of bmask is set iff the byte equals
// class_byte(p) ('o' owns bits 1 and 6).
__device__ __forceinline__ constexpr uint32_t class_byte(int p) {
  return p == 0 ? 'v' : p == 1 ? 'o' : p == 2 ? 'l' : p == 3 ? 'c'
       : p == 4 ? 'a' : p == 5 ? 'n' : 'o';
}

// i32: one lane, its byte b; the six compares and selects.
__device__ __forceinline__ uint32_t class_mask32(uint32_t b) {
  uint32_t m = 0;  // wildcard
  m |= b == 'v' ? 0x01u : 0u;
  m |= b == 'o' ? 0x42u : 0u;
  m |= b == 'l' ? 0x04u : 0u;
  m |= b == 'c' ? 0x08u : 0u;
  m |= b == 'a' ? 0x10u : 0u;
  m |= b == 'n' ? 0x20u : 0u;
  return m;
}

// Packed widths W = 16 or 8: bit W - 1 of each element of the result is
// set iff that element of v is nonzero (the other bits are garbage).  At
// W = 8 every value occurs, so the low 7 bits and the top bit are tested
// apart: (v & 0x7F) + 0x7F sets the top bit iff the low bits are nonzero,
// without a carry out of the byte.  At W = 16 the elements are widened
// bytes (below 0x100), so adding 0x7FFF sets bit 15 iff the element is
// nonzero, again without a carry out.
template <int W>
__device__ __forceinline__ uint32_t nonzero_top(uint32_t v) {
  if constexpr (W == 8) {
    return ((v & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | v;
  } else {
    return v + 0x7FFF7FFFu;
  }
}

// The packed class masks of the W-bit elements of x (bytes at W = 8,
// widened bytes at W = 16): bit p of an element is set iff the element
// equals class_byte(p).  Mismatch flags are gathered at the class bits,
// then inverted once.
template <int W>
__device__ __forceinline__ uint32_t class_mask_packed(uint32_t x) {
  constexpr uint32_t ones = W == 8 ? 0x01010101u : 0x00010001u;
  constexpr uint32_t top = ones << (W - 1);
  uint32_t miss = 0;
#pragma unroll
  for (int p = 0; p < 7; ++p) {
    const uint32_t ne = nonzero_top<W>(x ^ (class_byte(p) * ones)) & top;
    miss |= ne >> (W - 1 - p);  // one shift-and-add (LEA.HI)
  }
  return ~miss & (0x7Fu * ones);
}

// state registers a thread at a width
__host__ __device__ constexpr int kRegs(int bits) {
  return kLanesPerThread * bits / 32;
}

// kRows steps of this thread's lanes on rows v (byte i of v[t] is lane
// i's): s steps, acc ORs each state (register q holds lanes
// q * (32 / kBits) .. of the thread's).
template <int kBits, int kRows>
__device__ __forceinline__ void steps(const uint32_t (&v)[kRows],
                                      uint32_t (&s)[kRegs(kBits)],
                                      uint32_t (&acc)[kRegs(kBits)]) {
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
#pragma unroll
    for (int q = 0; q < kRegs(kBits); ++q) {
      const uint32_t v4 = v[t];
      if constexpr (kBits == 32) {
        const uint32_t bmask = class_mask32(__byte_perm(v4, 0, 0x4440 + (q & 3)));
        s[q] = ((s[q] << 1) | 1u) & bmask;
      } else if constexpr (kBits == 16) {
        const uint32_t x = __byte_perm(v4, 0, (q & 1) ? 0x4342 : 0x4140);
        s[q] = ((s[q] << 1) | 0x00010001u) & class_mask_packed<16>(x);
      } else {
        s[q] = ((s[q] << 1) | 0x01010101u) & class_mask_packed<8>(v4);
      }
      acc[q] |= s[q];
    }
  }
}

template <int kRows>
__device__ __forceinline__ void load_rows(uint32_t (&v)[kRows],
                                          const uint8_t* p, size_t stride) {
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    v[t] = __ldg(reinterpret_cast<const uint32_t*>(p + t * stride));
  }
}

// Block row blockIdx.y is sub-stripe j of n_sub: words [j n / n_sub,
// (j + 1) n / n_sub) of every lane, after a warm-up on the kWarm bytes
// before its first word.  A state bit k <= 6 depends only on the last
// k + 1 bytes, so kWarm >= 7 bytes from s = 0 give the exact state.
template <int kBits>
__global__ void __launch_bounds__(kThreads)
narrow_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
              int chunk, int lanes) {
  const int lane0 =
      (blockIdx.x * blockDim.x + threadIdx.x) * kLanesPerThread;
  if (lane0 >= lanes) return;
  const size_t stride = static_cast<size_t>(lanes);
  const uint8_t* p = data + lane0;
  uint32_t* o = out + lane0;
  const int n_words = chunk / 32;
  const int w0 = static_cast<int>(
      static_cast<long long>(n_words) * blockIdx.y / gridDim.y);
  const int w1 = static_cast<int>(
      static_cast<long long>(n_words) * (blockIdx.y + 1) / gridDim.y);
  uint32_t s[kRegs(kBits)], acc[kRegs(kBits)];
#pragma unroll
  for (int q = 0; q < kRegs(kBits); ++q) s[q] = acc[q] = 0;
  if (w0 > 0) {
    uint32_t warm[kWarm];
    load_rows(warm, p + (static_cast<size_t>(w0) * 32 - kWarm) * stride,
              stride);
    steps<kBits>(warm, s, acc);  // acc is reset before each word
  }
  // the next word's 32 rows are in flight while the current word steps
  uint32_t cur[32], next[32];
  load_rows(cur, p + static_cast<size_t>(w0) * 32 * stride, stride);
  for (int w = w0; w < w1; ++w) {
    const uint8_t* rows = p + static_cast<size_t>(w) * 32 * stride;
    if (w + 1 < w1) load_rows(next, rows + 32 * stride, stride);
#pragma unroll
    for (int q = 0; q < kRegs(kBits); ++q) acc[q] = 0;
    steps<kBits>(cur, s, acc);
    // lane i of the thread: element i % (32 / kBits) of register i / (..)
    uint32_t word[kLanesPerThread];
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) {
      word[i] = (acc[i * kBits / 32] >> (kBits * i % 32)) & kMatchBit;
    }
    *reinterpret_cast<uint4*>(o + static_cast<size_t>(w) * stride) =
        make_uint4(word[0], word[1], word[2], word[3]);
    if (w + 1 < w1) {
#pragma unroll
      for (int t = 0; t < 32; ++t) cur[t] = next[t];
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `width_bits` is 32, 16 or 8; lanes % kLanesPerThread == 0,
// `data` aligned to kLanesPerThread bytes and `out` to 16.  Returns
// cudaGetLastError() after the launch: 0 on success.
extern "C" int dgrep_narrow_probe(const void* data, void* out, int chunk,
                                  int lanes, int width_bits, void* stream) {
  if (chunk <= 0 || lanes <= 0 || chunk % 32 != 0 || lanes % 32 != 0 ||
      lanes % kLanesPerThread != 0 ||
      reinterpret_cast<uintptr_t>(data) % kLanesPerThread != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (width_bits != 32 && width_bits != 16 && width_bits != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // sub-stripes until the card holds kWarpsPerSm warps an SM
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int threads = lanes / kLanesPerThread;
  const int warps = (threads + 31) / 32;
  const int n_words = chunk / 32;
  int n_sub = 1;  // a power of two: even sub-stripes of a power-of-two chunk
  while (n_sub < n_words &&
         static_cast<long long>(warps) * n_sub < kWarpsPerSm * sms) {
    n_sub *= 2;
  }
  n_sub = std::min(n_sub, n_words);
  const dim3 grid((threads + kThreads - 1) / kThreads, n_sub);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (width_bits == 32) {
    narrow_kernel<32><<<grid, block, 0, st>>>(d, o, chunk, lanes);
  } else if (width_bits == 16) {
    narrow_kernel<16><<<grid, block, 0, st>>>(d, o, chunk, lanes);
  } else {
    narrow_kernel<8><<<grid, block, 0, st>>>(d, o, chunk, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}
