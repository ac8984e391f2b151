// Shared helpers of the port's CUDA kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace vf {

// dtype codes passed by the Python wrappers (_native.DTYPE_CODES).
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

}  // namespace vf
