// Hopper (sm_90a) tensor-memory-accelerator (TMA) staging: tensor maps
// encoded on the host, tiled loads into shared memory completing on an
// mbarrier.  A load writes its box densely in shared memory (innermost
// dimension fastest) and fills elements outside the tensor with zeros.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace vf {

// ----------------------------------------------------------------- host
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library the process has loaded
// (PyTorch loads it), found with dlsym: no -lcuda at link time.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return reinterpret_cast<EncodeTiledFn>(
        lib ? dlsym(lib, "cuTensorMapEncodeTiled") : nullptr);
  }();
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first), strides in
// bytes of dimensions 1.. (multiples of 16), zero fill; `swizzle`
// CU_TENSOR_MAP_SWIZZLE_NONE or _128B (then the box's innermost extent
// is 128 bytes and its shared-memory destination 1024-byte aligned).
inline bool encode_bf16(CUtensorMap* map, const void* base, int rank,
                        const uint64_t* dims, const uint64_t* strides,
                        const uint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (B, S, C) bf16 map with row stride `rstride` and batch stride
// `bstride` (elements, multiples of 8), boxes of 64 channels x 64 rows
// (8 KB), 128-byte swizzled: the operand tiles of the attention kernels.
inline bool encode_rows(CUtensorMap* map, const void* base, int B, int S,
                        int C, long long bstride, long long rstride) {
  const uint64_t dims[3] = {static_cast<uint64_t>(C),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {static_cast<uint64_t>(rstride) * 2,
                               static_cast<uint64_t>(bstride) * 2};
  const uint32_t box[3] = {64, 64, 1};
  return encode_bf16(map, base, 3, dims, strides, box,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

// --------------------------------------------------------------- device
// Bytes kept for a kernel's mbarriers at the start of its dynamic shared
// memory (tiles after them stay 128-byte aligned, as TMA boxes need).
constexpr int kBarBytes = 128;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
               "r"(count)
               : "memory");
}

// Make initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA traffic on the barrier.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
      "r"(parity)
      : "memory");
}

// A 1-D bulk copy of `bytes` contiguous bytes (a multiple of 16; src and
// dst 16-byte aligned) from global into this block's shared memory,
// completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(bytes),
      "r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
      : "memory");
}

// Tiled TMA loads of the box at coordinates (c0, c1, c2[, c3]) into dst
// (128-byte aligned; 1024 with the 128-byte swizzle), completing on
// `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
      : "memory");
}

}  // namespace vf
