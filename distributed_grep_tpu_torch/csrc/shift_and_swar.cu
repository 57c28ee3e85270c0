// SWAR Shift-And over (lanes, chunk) stripes: four stripes' automata
// packed in one uint32, coarse words.
//
// Replaces the TPU kernel distributed_grep_tpu/ops/pallas_scan.py:
// _swar_kernel (launched through _swar_pallas / swar_shift_and_scan_words)
// and computes the same words at the port's layout:
//
//   data  (lanes, chunk) uint8 stripes, as the document lies: byte c of
//         stripe l is data[l * pitch + c] (pitch >= chunk and the base
//         address multiples of 16, so a window stripes[:, a:b] needs no
//         copy).  Packed element j holds stripes 4j .. 4j + 3, stripe 4j + k
//         in byte k: the reference's swar_pack_tiles.
//   out   (chunk / 32, lanes / 4) uint32: byte k of word w of element j is
//         (OR of stripe 4j+k's state over bytes 32w .. 32w+31) & match_bit,
//         nonzero iff a candidate match ends in that 32-byte span -- byte k
//         of the packed word equals the unpacked coarse word of stripe
//         4j+k (csrc/shift_and.cu).
//
// Per stripe the state is one byte (models of at most 8 symbols), and one
// step for all four is  s = ((s << 1) | 0x01010101) & B4,  where byte k of
// B4 is the 8-bit B-mask of stripe 4j+k's byte.  The only leak of s << 1
// across stripes lands on bit 0 of the next byte, which the | 0x01010101
// sets anyway, so the packed step is exact.
//
// Design.  The TPU kernel builds B4 with a packed zero-byte test per class
// value (about five integer operations per value per uint32,
// SWAR_MAX_VALUES = 16 values at most) because Pallas on the TPU has no
// gather.  Here B4 comes from four lookups in one 256-entry table in shared
// memory whose entry v holds v's mask in all four bytes, merged into place
// with three byte permutes: about 18 operations a step of four bytes (four
// byte extracts, four table addresses, four lookups, three permutes, the
// shift, the or-and of the step and the accumulate), 4.5 a byte, with 1
// byte in and 1/32 byte out.  One table for all four stripes lets equal
// bytes of a warp share one address (a broadcast) instead of a bank.
//
// Reads: the TMA ring of csrc/shift_and.cu (csrc/stripe_ring.cuh) with
// 64-byte boxes.  A block of 64 threads owns 256 lanes, one box of 256 x
// 64 bytes a stage (32 KB of ring a block); thread t reads rows 4t .. 4t +
// 3 of a box as 16-byte shared loads.  The box's 64-byte swizzle puts
// chunk c of row r at r * 64 + (c ^ ((r >> 1) & 3)) * 16, so rows 4t + k
// of 8 consecutive threads would fall on 2 of the 8 bank groups: thread
// t reads its rows in the order 4t + ((k + rot) & 3), rot = (t >> 1) & 3,
// which puts a quarter-warp's 8 loads on 8 distinct groups, and the byte
// permutes route each row's mask to byte lane (k + rot) & 3.  No 4 x 4
// byte transpose is needed: the lookups take the bytes one at a time
// anyway.  Design runs on an H100 80GB HBM3 at 700 W (PERF.md section 6,
// runs H and J; device times at 65536 lanes x 1024 bytes, each design at
// its best sub-stripe count) chose this over 128-byte boxes (0.0382 ms at
// 4 sub-stripes a lane, against 0.0346 at one) and over 16-byte global
// loads of the four stripes with the next 16 bytes in flight (0.0426 ms
// at 2).  64 registers a thread, no spills.
//
// Sub-stripes with a warm-up, as csrc/shift_and.cu: blockIdx.y cuts each
// stripe into sub-stripes; one starting at byte c0 > 0 first steps `warm`
// words from c0 - 32 * warm from state 0, storing nothing.  Exact because
// a stripe's state byte depends on its last m <= 8 bytes alone, and 32 *
// warm >= m - 1 (ops/swar_scan.warmup_words: 1 word, 0 for m = 1).  The
// launcher adds sub-stripes until every SM has two blocks (n_sub = 2 SMs /
// lane blocks, at least 1), the best count benchmarks/substripe_sweep.py
// found at 65536 x 1024, 32768 x 256 and 16384 x 256 bytes (runs J and
// L): 0.0342 ms at 65536 x 1024, 0.96x the time of csrc/shift_and.cu.
//
// Bound.  For a 64 MB segment on an H100 SXM: 64 MiB in and 2 MiB out at
// 3.35 TB/s is 0.0207 ms, above the operations (0.0112 ms at 4.5 a byte,
// 128 per SM per clock) and the lookups (0.0080 ms at one a byte, 32 per
// SM per clock).

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "stripe_ring.cuh"

namespace {

using stripe_ring::kRows;

struct Masks {
  uint8_t m[256];  // B[byte] & 0xff: the 8-bit Shift-And mask of each byte
};

constexpr int kThreads = kRows / 4;  // one thread per packed element
constexpr uint32_t kOnes = 0x01010101u;
constexpr int kBoxBytes = 64;  // stripe bytes per box row
constexpr int kRingBytes = stripe_ring::ring_bytes<kBoxBytes>();

// Byte-permute selectors for B4 when row k's mask goes to byte lane
// (k + rot) & 3: z01 = perm(e0, e1, sel01) puts e0 at lane_0 and e1 at
// lane_1, z23 = perm(e2, e3, sel23) e2 at lane_2 and e3 at lane_3 (every
// byte of an entry is the mask); B4 = perm(z01, z23, sel_m) takes lanes 0
// and 1 from z01 and lanes 2 and 3 from z23.
struct Sel {
  uint32_t z01 = 0, z23 = 0, m = 0;
  __device__ explicit Sel(int rot) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int lk = (k + rot) & 3;
      if (k == 1) z01 |= 4u << (4 * lk);
      if (k == 3) z23 |= 4u << (4 * lk);
      m |= static_cast<uint32_t>(k < 2 ? lk : 4 + lk) << (4 * lk);
    }
  }
};

// Step the 16 bytes v[k] of each of the four rows.
__device__ __forceinline__ void step16(const uint32_t (&v)[4][4],
                                       const uint32_t* sb, const Sel& sel,
                                       uint32_t& s, uint32_t& word) {
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const uint32_t bsel = 0x4440u + (t & 3);
    const uint32_t e0 = sb[__byte_perm(v[0][t >> 2], 0u, bsel)];
    const uint32_t e1 = sb[__byte_perm(v[1][t >> 2], 0u, bsel)];
    const uint32_t e2 = sb[__byte_perm(v[2][t >> 2], 0u, bsel)];
    const uint32_t e3 = sb[__byte_perm(v[3][t >> 2], 0u, bsel)];
    const uint32_t bm = __byte_perm(__byte_perm(e0, e1, sel.z01),
                                    __byte_perm(e2, e3, sel.z23), sel.m);
    s = ((s << 1) | kOnes) & bm;
    word |= s;
  }
}

__device__ __forceinline__ void unpack(const uint4 c, uint32_t (&v)[4]) {
  v[0] = c.x;
  v[1] = c.y;
  v[2] = c.z;
  v[3] = c.w;
}

__global__ void __launch_bounds__(kThreads)
swar_kernel(const __grid_constant__ CUtensorMap map,
            uint32_t* __restrict__ out, const Masks masks, int n_words,
            int plane, uint32_t match_rep, int sub_words, int warm) {
  extern __shared__ uint8_t raw[];
  __shared__ uint32_t sb[256];
  stripe_ring::Ring<kBoxBytes> ring(raw);
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kRows;
  const int own = blockIdx.y * sub_words;
  const int end = min(own + sub_words, n_words);
  const int w0 = max(0, own - warm);
  const int n_box = ((end - w0) * 32 + kBoxBytes - 1) / kBoxBytes;

  for (int i = tid; i < 256; i += kThreads) sb[i] = masks.m[i] * kOnes;
  if (tid == 0) ring.start(&map, w0 * 32, lane0, n_box);
  __syncthreads();

  // v[k] holds row 4 tid + ((k + rot) & 3)
  const int rot = (tid >> 1) & 3;
  const Sel sel(rot);
  int row[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) row[k] = 4 * tid + ((k + rot) & 3);

  const int j = blockIdx.x * kThreads + tid;
  uint32_t s = 0;
  int w = w0;
  for (int b = 0; b < n_box; ++b, w += kBoxBytes / 32) {
    const uint8_t* box = ring.wait(b);
#pragma unroll
    for (int q = 0; q < kBoxBytes / 32; ++q) {
      if (w + q < end) {
        uint32_t word = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            unpack(stripe_ring::chunk16<kBoxBytes>(box, row[k], 2 * q + h),
                   v[k]);
          }
          step16(v, sb, sel, s, word);
        }
        if (w + q >= own && j < plane) {
          out[static_cast<size_t>(w + q) * plane + j] = word & match_rep;
        }
      }
    }
    ring.release(&map, b, w0 * 32, lane0, n_box);
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t, or null for the legacy default
// stream).  `masks_host` points to 256 uint8 B-masks in HOST memory, passed
// by value as a kernel parameter, as is the tensor map of `data`; `pitch`
// is the byte distance between stripes; `match_bit` the model's match bit
// (< 256); `warm` the warm-up in 32-byte words.  The launcher adds
// sub-stripes until every SM has two blocks; the SM count and the
// shared-memory opt-in are asked once per device, at the first launch.
// Returns a cudaError_t: cudaGetLastError() after the launch, 0 on
// success.
extern "C" int dgrep_swar_scan(const void* data, void* out,
                               const void* masks_host, int chunk, int lanes,
                               long long pitch, unsigned int match_bit,
                               int warm, void* stream) {
  if (match_bit == 0 || match_bit > 0x80u || warm < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  int err = stripe_ring::encode_stripes(&map, data, chunk, lanes, pitch,
                                       kBoxBytes);
  if (err != 0) return err;
  static int cache[stripe_ring::kMaxDevices] = {};
  int sms = 0;
  err = stripe_ring::prepare(swar_kernel, kRingBytes, cache, &sms);
  if (err != 0) return err;
  Masks masks;
  const uint8_t* m = static_cast<const uint8_t*>(masks_host);
  for (int i = 0; i < 256; ++i) masks.m[i] = m[i];
  const int n_words = chunk / 32;
  const int lane_blocks = (lanes + kRows - 1) / kRows;
  const int n_want = max(1, min(n_words, 2 * sms / lane_blocks));
  const int sub_words = (n_words + n_want - 1) / n_want;
  const dim3 grid(lane_blocks, (n_words + sub_words - 1) / sub_words);
  swar_kernel<<<grid, kThreads, kRingBytes,
                static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<uint32_t*>(out), masks, n_words, lanes / 4,
      match_bit * kOnes, sub_words, warm);
  return static_cast<int>(cudaGetLastError());
}
