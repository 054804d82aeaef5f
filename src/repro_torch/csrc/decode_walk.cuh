// The element formats of the decode walks (B3-B6), which paged_walk.cuh
// reads: bf16, f32, int8 with an f32 scale per row, or int4 nibble pairs
// (even index in the low nibble) with an f32 scale per row.  Quantized rows
// are dequantized in registers as (float)q * scale[row], the TPU kernels'
// _dequant_tile; no f32 copy of a quantized cache is ever written to global
// memory.  The walk itself, one for all four kernels, is in paged_walk.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_walk {

constexpr float kNegInf = -1e30f;

// ---- element formats: kScaled says whether rows carry a scale; load()
// converts the 16 bytes of elements that start at element d0 of a row.

struct Bf16 {
  static constexpr bool kScaled = false;
  __device__ __forceinline__ static void load(const __nv_bfloat16* row, int d0, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + d0);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

struct F32 {
  static constexpr bool kScaled = false;
  __device__ __forceinline__ static void load(const float* row, int d0, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(row + d0);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  }
};

struct Int8 {
  static constexpr bool kScaled = true;
};

struct Int4 {  // a row holds D/2 bytes
  static constexpr bool kScaled = true;
  __device__ __forceinline__ static float lo(uint8_t b) {
    return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(b << 4)) >> 4);
  }
  __device__ __forceinline__ static float hi(uint8_t b) {
    return static_cast<float>(static_cast<int8_t>(b) >> 4);
  }
};

}  // namespace decode_walk
