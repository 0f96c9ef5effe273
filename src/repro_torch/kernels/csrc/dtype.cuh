// Loads and stores of float32 or bfloat16 elements as float, for the LM
// kernels' bf16 instances (rmsnorm*.cu, flash_attention*.cu,
// selective_scan*.cu).
//
// The contract is the TPU kernels' (repro/kernels/rmsnorm.py,
// flash_attention.py, selective_scan.py): an input is loaded in its own
// type and widened to float32, every operation is float32, and an output is
// rounded once, to nearest even, when it is stored in its type. Widening
// a bf16 is exact (its bits are a float's top 16), so a bf16 instance that
// keeps the float32 instance's arithmetic gives the float32 instance's
// result on the widened inputs, rounded once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dt {

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kBf16 = false;
template <>
constexpr bool kBf16<bf16> = true;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// two bf16 (one 32-bit word, element 0 in the low half) <-> float2
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// four consecutive elements as one load: a float4, or four bf16 in a uint2
template <typename T>
struct Vec4 {
  using type = float4;
};
template <>
struct Vec4<bf16> {
  using type = uint2;
};

__device__ __forceinline__ float4 as_f4(const float4& v) { return v; }
__device__ __forceinline__ float4 as_f4(const uint2& v) {
  const float2 a = unpack2(v.x), b = unpack2(v.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ typename Vec4<T>::type from_f4(const float4& v);
template <>
__device__ __forceinline__ float4 from_f4<float>(const float4& v) {
  return v;
}
template <>
__device__ __forceinline__ uint2 from_f4<bf16>(const float4& v) {
  return make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
}

// a double rounded once to bf16, to nearest even: the double's significand
// is rounded to bf16's 8 bits in its own bits (the result is then exact in
// float and in bf16). Below float's normal range (|x| < 2^-126, where bf16
// is subnormal) it goes through float, two roundings; infinities and NaNs
// pass through.
__device__ __forceinline__ bf16 bf16_from_double(double x) {
  unsigned long long b = static_cast<unsigned long long>(__double_as_longlong(x));
  const unsigned long long e = b & 0x7ff0000000000000ULL;
  if (e == 0x7ff0000000000000ULL || fabs(x) < 1.1754943508222875e-38)
    return __float2bfloat16_rn(__double2float_rn(x));
  b += 0x00000fffffffffffULL + ((b >> 45) & 1ULL);
  b &= ~((1ULL << 45) - 1ULL);
  return __float2bfloat16_rn(static_cast<float>(
      __longlong_as_double(static_cast<long long>(b))));
}

template <typename T>
__device__ __forceinline__ T from_double(double x);
template <>
__device__ __forceinline__ float from_double<float>(double x) {
  return static_cast<float>(x);
}
template <>
__device__ __forceinline__ bf16 from_double<bf16>(double x) {
  return bf16_from_double(x);
}

// a pointer's alignment to `bytes`
inline bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<std::uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace dt
