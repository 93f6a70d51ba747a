// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel takes its tensors as raw pointers and a dtype code
// (0 = float32, 1 = bfloat16), accumulates in float32, and rounds to the
// working type with `rnd<T>` exactly where the TPU kernel it replaces
// rounds (round-to-nearest-even, like XLA's convert).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ptt {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// value rounded to T and widened back to float
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float elu(float x) {
  return x > 0.f ? x : expm1f(x);
}

// 16 int8 values at a 16-byte aligned address -> 16 floats (one vector
// load; byte i of the vector is value i)
__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  const int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = (float)(int8_t)((w[i] >> (8 * j)) & 0xff);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace ptt

// Run the statements after T with T bound to the element type named by
// `code`; an unknown code returns cudaErrorInvalidValue from the enclosing
// C entry point.
#define PTT_DISPATCH(code, T, ...)           \
  do {                                       \
    if ((code) == 0) {                       \
      typedef float T;                       \
      __VA_ARGS__;                           \
    } else if ((code) == 1) {                \
      typedef ::ptt::bf16 T;                 \
      __VA_ARGS__;                           \
    } else {                                 \
      return (int)cudaErrorInvalidValue;     \
    }                                        \
  } while (0)
