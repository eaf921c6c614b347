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

// Launches that ran, counted on the device by the first thread of each
// launch's first block, so graph replays count too (a profiler trace can
// drop records).  Each library's kernels count into their own slots
// (kernels.py names them); lcg_device_counts copies the slots out.
constexpr int kCountSlots = 16;
__device__ unsigned long long g_launch_counts[kCountSlots];

LCG_EXPORT int lcg_device_counts(unsigned long long* out) {  // kCountSlots values
  return cudaMemcpyFromSymbol(out, g_launch_counts, sizeof(g_launch_counts));
}

namespace lcg {

constexpr float kNegInf = -1e30f;  // finite "minus infinity" of the softmaxes

__device__ __forceinline__ void count_launch(int slot) {
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    atomicAdd(&g_launch_counts[slot], 1ull);
}

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
// The 4 signed bytes of a 32-bit word as f32, lowest address first.
__device__ __forceinline__ void unpack_s8x4(uint32_t w, float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xFFu));
}
// 8 consecutive int8 values (8-byte aligned) as f32.
__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  unpack_s8x4(w.x, out);
  unpack_s8x4(w.y, out + 4);
}

}  // namespace lcg
