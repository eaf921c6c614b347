// Helpers shared by the port's CUDA kernels (plain C interface, ctypes-bound).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LCG_EXPORT extern "C" __attribute__((visibility("default")))

// Every library exports this so the Python wrapper can name an error code.
LCG_EXPORT const char* lcg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace lcg {

constexpr float kNegInf = -1e30f;  // finite "minus infinity" of the softmaxes

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// Load 8 consecutive elements (16-byte aligned for bf16, 32 for f32) as f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

}  // namespace lcg
