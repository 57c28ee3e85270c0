// The TMA ring that the stripe kernels read the (lanes, chunk) stripes
// through: csrc/shift_and.cu, csrc/pairset.cu, csrc/shift_and_swar.cu.
//
// A block owns kRows = 256 lanes.  One thread of it keeps kStages = 2
// boxes of (256 lanes x B bytes) in flight (cp.async.bulk.tensor with the
// B-byte swizzle, B = 128 or 64, each completing on an mbarrier), and the
// block's threads read a box from shared memory: 16-byte chunk c of row r
// lies at r * B + (c ^ (r & 7)) * 16 for B = 128, r * B + (c ^ ((r >> 1)
// & 3)) * 16 for B = 64, which no two of 8 consecutive rows share a bank
// on.  The ring is the first 2 x 256 x B bytes (1024-byte aligned, for the
// swizzle) of the block's dynamic shared memory, its barriers follow.
//
//   Ring<B> ring(raw_smem);
//   if (threadIdx.x == 0) ring.start(&map, x0, lane0, n_box);
//   __syncthreads();
//   for (int b = 0; b < n_box; ++b) {
//     const uint8_t* box = ring.wait(b);
//     ... read this thread's rows of box ...
//     ring.release(&map, b, x0, lane0, n_box);  // a block barrier
//   }
//
// The ring's cost: ring_bytes<B>() of shared memory a block (kernels add
// their own tables), one mbarrier wait and one block barrier a box.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace stripe_ring {

constexpr int kRows = 256;   // lanes per block, rows per box
constexpr int kBox = 128;    // stripe bytes per box row: the swizzle span
constexpr int kStages = 2;   // boxes in the ring
constexpr int kMaxDevices = 64;

// Dynamic shared memory of a ring of B-byte boxes: 1024-byte alignment for
// the swizzle, the ring, its barriers.
template <int B>
constexpr int ring_bytes() {
  return 1024 + kStages * kRows * B + kStages * 8;
}
constexpr int kSmemBytes = ring_bytes<kBox>();

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int B = kBox>
struct Ring {
  static constexpr int kStageBytes = kRows * B;
  uint8_t* base;   // kStages boxes
  uint64_t* full;  // one mbarrier a box

  __device__ explicit Ring(uint8_t* raw) {
    base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t{1023});
    full = reinterpret_cast<uint64_t*>(base + kStages * kStageBytes);
  }

  // Load the box of stripe bytes x .. x + B of lanes y .. y + kRows into
  // stage s; its barrier completes when the bytes have landed (out-of-range
  // parts are zero-filled and counted).
  __device__ __forceinline__ void load(const CUtensorMap* map, int s, int x,
                                       int y) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(&full[s])),
        "r"(kStageBytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
            smem_addr(base + s * kStageBytes)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(&full[s])),
        "r"(x), "r"(y)
        : "memory");
  }

  // One thread: initialise the barriers and issue the first boxes (box b
  // covers stripe bytes x0 + b * B onwards of lanes lane0 ..).
  __device__ void start(const CUtensorMap* map, int x0, int lane0,
                        int n_box) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&full[s]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages && s < n_box; ++s) {
      load(map, s, x0 + s * B, lane0);
    }
  }

  // Wait for box b.  No poll limit: every box a thread waits for was issued
  // (n_box counts only boxes in range), and a trap after a limit would
  // leave the process's CUDA context unusable.
  __device__ __forceinline__ const uint8_t* wait(int b) const {
    const int s = b % kStages;
    const uint32_t parity = (b / kStages) & 1;
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(smem_addr(&full[s])), "r"(parity)
          : "memory");
    }
    return base + s * kStageBytes;
  }

  // Every thread is done with box b: refill its stage with box b + kStages.
  __device__ __forceinline__ void release(const CUtensorMap* map, int b,
                                          int x0, int lane0, int n_box) {
    __syncthreads();
    if (threadIdx.x == 0 && b + kStages < n_box) {
      load(map, b % kStages, x0 + (b + kStages) * B, lane0);
    }
  }
};

// 16-byte chunk c of row r of a B-byte box (the B-byte swizzle).
template <int B = kBox>
__device__ __forceinline__ uint4 chunk16(const uint8_t* box, int r, int c) {
  static_assert(B == 128 || B == 64, "a 128- or 64-byte swizzle");
  const int sw = B == 128 ? (r & 7) : ((r >> 1) & 3);
  return *reinterpret_cast<const uint4*>(box + r * B + ((c ^ sw) << 4));
}

// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint so the
// library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// cuCtxGetCurrent, looked up the same way.
typedef CUresult (*CtxGetCurrent)(CUcontext*);

inline CtxGetCurrent ctx_get_current_fn() {
  static CtxGetCurrent fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuCtxGetCurrent", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuCtxGetCurrent", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<CtxGetCurrent>(p);
  }
  return fn;
}

// The tensor map's encode is a driver call: it needs a context current on
// the calling thread.  A thread whose first CUDA call is a launch (a scan
// whose segments are resident on the card, so it uploads nothing first)
// has none yet, so the runtime's primary context of the current device is
// made current, as a runtime call would.  A capturing thread has one.
inline int bind_context() {
  const CtxGetCurrent get = ctx_get_current_fn();
  CUcontext ctx = nullptr;
  if (get != nullptr && get(&ctx) == CUDA_SUCCESS && ctx != nullptr) {
    return 0;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  return static_cast<int>(err);
}

// The tensor map of (lanes, chunk) stripes at `data`, byte c of stripe l at
// data[l * pitch + c], in boxes of kRows x box_bytes (128 or 64).  Checks
// the layout the ring needs (chunk and lanes multiples of 32, pitch >=
// chunk, pitch and address multiples of 16) and returns a cudaError_t: 0
// on success.
inline int encode_stripes(CUtensorMap* map, const void* data, int chunk,
                          int lanes, long long pitch, int box_bytes = kBox) {
  if (chunk <= 0 || lanes <= 0 || chunk % 32 != 0 || lanes % 32 != 0 ||
      pitch < chunk || pitch % 16 != 0 ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
      (box_bytes != 128 && box_bytes != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int bound = bind_context();
  if (bound != 0) return bound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(chunk),
                              static_cast<cuuint64_t>(lanes)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_bytes), kRows};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(data),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// The current device's SM count, asked once per device and `kernel`'s
// dynamic shared memory opted up to `smem` bytes at the same time (the
// first launch, which precedes any graph capture: utils/slope.py warms
// every chain up first).  `cache` is the caller's per-device slot array.
// Returns a cudaError_t: 0 on success.
template <typename Kernel>
int prepare(Kernel kernel, int smem, int (&cache)[kMaxDevices], int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (cache[dev] == 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int count = 0;
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    cache[dev] = count;
  }
  *sms = cache[dev];
  return 0;
}

}  // namespace stripe_ring
