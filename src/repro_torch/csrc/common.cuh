// Helpers shared by the port's CUDA kernels: the masked-score value, the
// conversion from fp32 to a storage type (fp32, bf16), fp32 vector loads,
// and the error text the wrappers raise with.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr float NEG_INF = -1e30f;   // the masked-score value of the TPU kernels

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Load N consecutive fp32 values. The address must be aligned to 4*N bytes.
template <int N> __device__ __forceinline__ void load_f(const float* src, float* dst) {
  if constexpr (N == 4) {
    const float4 r = *reinterpret_cast<const float4*>(src);
    dst[0] = r.x; dst[1] = r.y; dst[2] = r.z; dst[3] = r.w;
  } else if constexpr (N == 2) {
    const float2 r = *reinterpret_cast<const float2*>(src);
    dst[0] = r.x; dst[1] = r.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

}  // namespace repro_torch

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
