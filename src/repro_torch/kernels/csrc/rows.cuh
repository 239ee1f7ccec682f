// rows.cuh: the memory row storage types of the port's CUDA kernels.
//
// A memory row is W f32 values, W bf16 values (raw 16-bit patterns), or W
// int8 codes with one f32 scale per row (dequantized as float(q)·scale,
// the plain version's arithmetic). The reads stage rows with 16-byte loads
// and see every row as f32 through these traits; the write rounds to bf16
// with f32_to_bf16. Conversions are written out on bit patterns, so no
// header conversion rule (or fast-math flag) changes their rounding.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ float bf16_to_f32(uint16_t h) {
  return __uint_as_float((unsigned)h << 16);
}

// Round to nearest even, as torch's float -> bfloat16 conversion.
__device__ __forceinline__ uint16_t f32_to_bf16(float f) {
  const unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;   // NaN
  return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// The row storage types of the reads. unpack() turns one 16-byte load of
// kPer values into f32 (int8: times the row's scale); at() reads value w
// of a row.
struct RowsF32 {
  using T = float;
  static constexpr int kPer = 4;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ void unpack(uint4 v, float, float* d) {
    *reinterpret_cast<float4*>(d) = make_float4(
        __uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
        __uint_as_float(v.w));
  }
  static __device__ __forceinline__ float at(const T* r, int w, float) {
    return r[w];
  }
};

struct RowsBF16 {                      // raw bf16 bit patterns
  using T = uint16_t;
  static constexpr int kPer = 8;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ void unpack(uint4 v, float, float* d) {
    const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float4*>(d + 4 * i) = make_float4(
          __uint_as_float(x[2 * i] << 16),
          __uint_as_float(x[2 * i] & 0xffff0000u),
          __uint_as_float(x[2 * i + 1] << 16),
          __uint_as_float(x[2 * i + 1] & 0xffff0000u));
  }
  static __device__ __forceinline__ float at(const T* r, int w, float) {
    return bf16_to_f32(r[w]);
  }
};

struct RowsI8 {                        // int8 codes and one f32 scale a row
  using T = int8_t;
  static constexpr int kPer = 16;
  static constexpr bool kScaled = true;
  static __device__ __forceinline__ void unpack(uint4 v, float s, float* d) {
    const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[j] = __fmul_rn((float)(int8_t)(x[i] >> (8 * j)), s);
      *reinterpret_cast<float4*>(d + 4 * i) =
          make_float4(f[0], f[1], f[2], f[3]);
    }
  }
  static __device__ __forceinline__ float at(const T* r, int w, float s) {
    return __fmul_rn((float)r[w], s);
  }
};
