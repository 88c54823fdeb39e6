// Neg2Zero -> Logarithm on the card, f32 log1p(max(f32(x), 0)), shared by
// dense_xform.cu (dense_transform, int32 or f32 input), fused_xform.cu and
// fused_decode_xform.cu (the dense half of loop ②, int32 values): one copy
// of the transform.
//
// max is taken after the conversion to f32 and as a compare, so a NaN
// input stays NaN as in the reference (fmaxf would turn it into 0); on
// int32 input the two agree bit for bit. Built without fast math, so
// log1pf keeps its accuracy (rtol 1e-6 against torch.log1p).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

__device__ __forceinline__ float neg2zero_log1p(float v) { return log1pf(v < 0.f ? 0.f : v); }

__device__ __forceinline__ float4 neg2zero_log1p(float4 v) {
  return make_float4(neg2zero_log1p(v.x), neg2zero_log1p(v.y), neg2zero_log1p(v.z),
                     neg2zero_log1p(v.w));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Four consecutive elements of a read-only int32 or f32 buffer as f32: one
// 16-byte load where p is 16-byte aligned (vec), else four 4-byte loads.
template <typename T>
__device__ __forceinline__ float4 load_quad_f32(const T* __restrict__ p, bool vec) {
  static_assert(std::is_same<T, int>::value || std::is_same<T, float>::value, "int32 or f32");
  if (vec) {
    if constexpr (std::is_same<T, float>::value) {
      return __ldg(reinterpret_cast<const float4*>(p));
    } else {
      const int4 a = __ldg(reinterpret_cast<const int4*>(p));
      return make_float4(static_cast<float>(a.x), static_cast<float>(a.y),
                         static_cast<float>(a.z), static_cast<float>(a.w));
    }
  }
  return make_float4(static_cast<float>(__ldg(p)), static_cast<float>(__ldg(p + 1)),
                     static_cast<float>(__ldg(p + 2)), static_cast<float>(__ldg(p + 3)));
}

}  // namespace
