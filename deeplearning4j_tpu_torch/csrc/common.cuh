// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel reads its storage type (float or bf16), computes in f32,
// and rounds through the storage type exactly where the JAX reference
// casts (the scaled Q tile, the softmax weights fed to the PV product,
// the output), so a kernel and its plain PyTorch version round at the
// same places.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace dl4j {

// dtype codes passed from the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round an f32 value through the storage type (identity for f32)
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// opt a kernel into more than 48 KB of dynamic shared memory when needed;
// the largest size granted per (kernel, device) is kept, so a launch's
// host path sets the attribute only when it grows
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> granted;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = granted[{reinterpret_cast<const void*>(kernel), dev}];
  if (have >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

}  // namespace dl4j

// Each kernel source is its own shared library, so this is defined once per
// library: the Python wrappers turn an error code into its message.
extern "C" const char* dl4j_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
