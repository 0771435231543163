// Element types of the GNN kernels' feature tensors: fp32 or bf16 in
// device memory, always fp32 in registers and shared memory. Loads widen
// to fp32; stores round to nearest even (as torch's .to(bfloat16)), NaN
// and inf kept. Header-only; included by the kernels of csrc/.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace elem {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four consecutive elements p[0..3] as fp32, those at or past `n` read as
// 0; one 16-byte (fp32) or 8-byte (bf16) load where `vec` says p is
// aligned to it and all four lie before n.
__device__ __forceinline__ void load4(const float* p, int n, bool vec,
                                      float (&x)[4]) {
  if (vec && n >= 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = j < n ? __ldg(p + j) : 0.0f;
}
__device__ __forceinline__ void load4(const bf16* p, int n, bool vec,
                                      float (&x)[4]) {
  if (vec && n >= 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
    x[0] = __low2float(a); x[1] = __high2float(a);
    x[2] = __low2float(b); x[3] = __high2float(b);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = j < n ? __bfloat162float(p[j]) : 0.0f;
}

// Stores x[0..3] at p[0..3], those at or past `n` not stored; one wide store
// where `vec` says p is aligned to it and all four lie before n.
__device__ __forceinline__ void store4(float* p, int n, bool vec,
                                       const float (&x)[4]) {
  if (vec && n >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) p[j] = x[j];
}
__device__ __forceinline__ void store4(bf16* p, int n, bool vec,
                                       const float (&x)[4]) {
  if (vec && n >= 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
    uint2 t;
    t.x = *reinterpret_cast<const unsigned*>(&a);
    t.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = t;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) p[j] = __float2bfloat16_rn(x[j]);
}

}  // namespace elem
