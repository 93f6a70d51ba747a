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

// one 16-byte vector load (p 16-byte aligned)
__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// the 16 / sizeof(KV) values of a 16-byte vector as floats (element i at
// the i-th lowest address)
template <typename KV>
__device__ __forceinline__ void unpack16(const uint4& u, float* out);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& u, float* out) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack16<bf16>(const uint4& u, float* out) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// int8: byte b + 128 (the sign bit flipped) becomes the low mantissa byte
// of 2^23 (one byte permute), and 2^23 + 128 is subtracted: exact, and two
// full-rate instructions a value where an int-to-float conversion is a
// quarter-rate one
template <>
__device__ __forceinline__ void unpack16<int8_t>(const uint4& u,
                                                 float* out) {
  const unsigned w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                         u.z ^ 0x80808080u, u.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] =
          __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 + j)) -
          8388736.f;
  }
}

// 16 int8 values at a 16-byte aligned address -> 16 floats (one vector
// load; byte i of the vector is value i)
__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  unpack16<int8_t>(ld16(p), out);
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The weight 2^(m - m_max) of a flash partial with running max m (logits
// in log2 units, as K1 and K2 keep them) in a merge whose largest max is
// m_max: 0 when no partial attended a key (m_max = -inf), so merging empty
// partials gives m = -inf, l = 0, acc = 0 instead of 2^(-inf + inf) = NaN.
__device__ __forceinline__ float partial_weight(float m, float m_max) {
  return m_max == -INFINITY ? 0.f : exp2f(m - m_max);
}

// 16 bytes global -> shared, asynchronously (cp.async, cached in L2 only);
// zeros, and no read, when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Launch `kern` over `grid` in thread-block clusters of cluster_x blocks
// along x (gridDim.x a multiple of it; at most 8, the portable size).
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kern)(Params...), dim3 grid, dim3 block,
                             unsigned cluster_x, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // dynamic shared memory near or above 48 KB (with the kernel's few KB of
  // static shared memory): opt in
  if (smem > 46 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

// D += A.B on the tensor cores: one m16n8k16 product, bf16 operands, f32
// accumulators (A: 4 registers, B: 2, C/D: 4, in the PTX fragment layouts)
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory (lane L gives row L % 8 of
// matrix L / 8): register i holds this lane's two values of matrix i, row
// lane / 4, columns 2 (lane % 4) + 0..1; `_trans` the transposed matrices
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
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
