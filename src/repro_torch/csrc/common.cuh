// Helpers shared by the port's CUDA kernels: conversions between the storage
// types (fp32, bf16) and fp32, and 16-byte-or-smaller vector loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr float NEG_INF = -1e30f;   // the masked-score value of the TPU kernels

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round to T's precision and back: the TPU kernels cast q*scale and the
// softmax weights to the operand dtype before each product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Two bf16 packed in one 32-bit word, element 0 in the low half.
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* dst) {
  dst[0] = __uint_as_float(w << 16);
  dst[1] = __uint_as_float(w & 0xffff0000u);
}

// Load N consecutive elements as fp32. The address must be aligned to
// N * sizeof(element) bytes, which the wrappers check for the base pointers.
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

template <int N> __device__ __forceinline__ void load_f(const __nv_bfloat16* src, float* dst) {
  if constexpr (N == 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(src);
    unpack_bf16x2(r.x, dst); unpack_bf16x2(r.y, dst + 2);
    unpack_bf16x2(r.z, dst + 4); unpack_bf16x2(r.w, dst + 6);
  } else if constexpr (N == 4) {
    const uint2 r = *reinterpret_cast<const uint2*>(src);
    unpack_bf16x2(r.x, dst); unpack_bf16x2(r.y, dst + 2);
  } else if constexpr (N == 2) {
    unpack_bf16x2(*reinterpret_cast<const uint32_t*>(src), dst);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = __bfloat162float(src[i]);
  }
}

}  // namespace repro_torch

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
