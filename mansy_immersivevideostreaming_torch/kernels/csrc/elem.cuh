// K8's element types: q, k, v, o (and dO, dq, dk, dv) are f32 or bf16 in
// device memory and f32 in registers.  The f32 instantiations of these
// helpers are identities, so a kernel templated on the element type compiles
// its f32 instance as it did before the type was a parameter.

#pragma once

#include <cuda_bf16.h>
#include <type_traits>

namespace mansy {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// f32 -> T, rounded to nearest even (torch's and XLA's f32 -> bf16 convert)
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

// x rounded to T and back: where the bf16 function rounds an f32 value
template <typename T>
__device__ __forceinline__ float round_as(float x) { return to_f32(from_f32<T>(x)); }

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

}  // namespace mansy
