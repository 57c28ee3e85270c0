// SWAR Shift-And: four stripes' automata packed in one uint32, coarse
// words.
//
// Replaces the TPU kernel distributed_grep_tpu/ops/pallas_scan.py:
// _swar_kernel (launched through _swar_pallas / swar_shift_and_scan_words)
// and computes the same words at the port's layout:
//
//   data  the (chunk, lanes) uint8 stripe layout read as (chunk, lanes / 4)
//         uint32 (no copy): byte k of element j of row c is byte c of
//         stripe 4j + k, exactly the reference's swar_pack_tiles.
//   out   (chunk / 32, lanes / 4) uint32: byte k of word w of element j is
//         (OR of stripe 4j+k's state over bytes 32w .. 32w+31) & match_bit,
//         nonzero iff a candidate match ends in that 32-byte span -- byte k
//         of the packed word equals the unpacked coarse word of stripe
//         4j+k (csrc/shift_and.cu).
//
// Per stripe the state is one byte (models of at most 8 symbols), and one
// step for all four is  s = ((s << 1) | 0x01010101) & B4(x),  where B4(x)
// holds in byte k the 8-bit B-mask of byte k of x.  The only leak of
// s << 1 across stripes lands on bit 0 of the next byte, which the
// | 0x01010101 sets anyway, so the packed step is exact.
//
// Design.  The TPU kernel builds B4(x) with a packed zero-byte test per
// class value (about five integer operations per value per uint32,
// SWAR_MAX_VALUES = 16 values at most) because Pallas on the TPU has no
// gather.  Here B4(x) is four lookups in 256-entry tables held in shared
// memory, one per byte plane with its mask pre-shifted into place, so
// B4(x) = T0[x & 0xff] | T1[(x >> 8) & 0xff] | T2[(x >> 16) & 0xff]
// | T3[x >> 24]: about 11 operations per uint32 whatever the classes
// (three byte extracts, four lookups, three ORs and the address
// arithmetic folded into the loads), plus three for the step and the
// accumulate -- about 3.5 per input byte, against about 5 for
// csrc/shift_and.cu, with 1 byte in and 1/32 byte out (shift_and.cu's
// coarse words: 1/8).
//
// One thread per packed element is a quarter of the threads of the
// unpacked kernel: 16384 for a 64 MB segment (65536 stripes x 1024
// bytes), about four warps per SM.  Blocks of 64 threads spread them over
// all 132 SMs (256 blocks), and each thread keeps two words of loads in
// flight: it issues the next word's 32 independent loads before it runs
// the current word's 32 dependent steps.
//
// Bound.  For a 64 MB segment on an H100 SXM: 64 MiB in and 2 MiB out at
// 3.35 TB/s is 0.0207 ms; about 3.5 operations per byte at 128 per SM per
// clock (4 schedulers x 32 lanes, 132 SMs, 1.98 GHz) is 0.0070 ms.  The
// bytes bound it.  It runs at about 0.05 ms on an H100 80GB HBM3 at 700 W,
// 1.5x faster than csrc/shift_and.cu on the same model in the same run
// (PERF.md): a quarter of the threads, but four times the bytes per load
// and a quarter of the step instructions.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Masks {
  uint8_t m[256];  // B[byte] & 0xff: the 8-bit Shift-And mask of each byte
};

constexpr int kThreads = 64;
constexpr uint32_t kOnes = 0x01010101u;

__device__ __forceinline__ void load_word(const uint32_t* __restrict__ col,
                                          size_t stride, int w,
                                          uint32_t (&v)[32]) {
  const uint32_t* row = col + static_cast<size_t>(w) * 32 * stride;
#pragma unroll
  for (int t = 0; t < 32; ++t) v[t] = __ldg(row + t * stride);
}

__device__ __forceinline__ uint32_t scan_word(const uint32_t (&v)[32],
                                              const uint32_t (*sb)[256],
                                              uint32_t& s) {
  uint32_t word = 0;
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const uint32_t x = v[t];
    const uint32_t bm = sb[0][x & 0xffu] | sb[1][(x >> 8) & 0xffu] |
                        sb[2][(x >> 16) & 0xffu] | sb[3][x >> 24];
    s = ((s << 1) | kOnes) & bm;
    word |= s;
  }
  return word;
}

__global__ void __launch_bounds__(kThreads)
swar_kernel(const uint32_t* __restrict__ data, uint32_t* __restrict__ out,
            const Masks masks, int chunk, int plane, uint32_t match_rep) {
  __shared__ uint32_t sb[4][256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const uint32_t m = masks.m[i];
    sb[0][i] = m;
    sb[1][i] = m << 8;
    sb[2][i] = m << 16;
    sb[3][i] = m << 24;
  }
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= plane) return;
  const size_t stride = static_cast<size_t>(plane);
  const uint32_t* col = data + j;
  uint32_t* o = out + j;
  const int n_words = chunk / 32;
  uint32_t s = 0;
  uint32_t a[32], b[32];
  load_word(col, stride, 0, a);
  int w = 0;
  for (; w + 1 < n_words; w += 2) {
    load_word(col, stride, w + 1, b);
    o[static_cast<size_t>(w) * stride] = scan_word(a, sb, s) & match_rep;
    if (w + 2 < n_words) load_word(col, stride, w + 2, a);
    o[static_cast<size_t>(w + 1) * stride] = scan_word(b, sb, s) & match_rep;
  }
  if (w < n_words) {
    o[static_cast<size_t>(w) * stride] = scan_word(a, sb, s) & match_rep;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `data` is the (chunk, lanes) uint8 layout, 4-byte aligned;
// `masks_host` points to 256 uint8 B-masks in HOST memory, passed by value
// as a kernel parameter; `match_bit` is the model's match bit (< 256).
// Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int dgrep_swar_scan(const void* data, void* out,
                               const void* masks_host, int chunk, int lanes,
                               unsigned int match_bit, void* stream) {
  if (chunk <= 0 || lanes <= 0 || chunk % 32 != 0 || lanes % 4 != 0 ||
      match_bit == 0 || match_bit > 0x80u ||
      reinterpret_cast<uintptr_t>(data) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Masks masks;
  const uint8_t* m = static_cast<const uint8_t*>(masks_host);
  for (int i = 0; i < 256; ++i) masks.m[i] = m[i];
  const int plane = lanes / 4;
  const dim3 grid((plane + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  swar_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(data), static_cast<uint32_t*>(out), masks,
      chunk, plane, match_bit * kOnes);
  return static_cast<int>(cudaGetLastError());
}
