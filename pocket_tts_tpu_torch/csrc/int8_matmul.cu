// K4a: x (T, K) @ dequant(q (K, N) int8) * scale (N,) -> (T, N).
//
// Replaces the TPU kernel `pocket_tts_tpu/ops/quant_matmul.py:
// int8_matmul_pallas` (`_int8_kernel`). Per output: the float32 sum of
// x[t, k] * q[k, n] (x in the working type, q widened to it exactly:
// |q| <= 127), times the per-channel float32 scale, rounded once to the
// working type. The TPU kernel computes the same thing with an MXU dot.
//
// Where it runs: every quantized linear that no fused kernel covers, i.e.
// the backbone prefill (T = 16..256 rows of a prompt or sentence bucket,
// K = 1024 or 4096, N = 1024..4096) and `input_linear` once per frame
// (T = 1, K = 32, N = 1024).
//
// What bounds it on the H100: at T = 1 bytes (the int8 weight, 32 KB for
// input_linear, is read once); at prefill T the FLOPs (2*T*K*N, up to
// 2.1 GFLOP for one 256 x 1024 x 4096 call), which this version runs on
// the CUDA cores in float32, not on the tensor cores. The design is a
// plain shared-memory tiled GEMM: 64 x 64 output tiles, 16-deep K steps,
// 256 threads each owning a 4 x 4 register tile. The int8 weight tile is
// widened to float as it is staged into shared memory, so the weight
// crosses HBM as int8 only; the scale is applied in the epilogue. Ragged
// edges in T, K and N are masked, so any T and K = 32 (smaller than a
// sensible K tile) work. A wgmma/TMA pipeline in bf16 is later work.
#include "common.cuh"

namespace ptt {

constexpr int MM_BM = 64, MM_BN = 64, MM_BK = 16, MM_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(MM_THREADS)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, T* __restrict__ y, int M,
                   int K, int N) {
  __shared__ float as[MM_BK][MM_BM + 4];  // x tile, transposed
  __shared__ float bs[MM_BK][MM_BN];      // widened weight tile
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;
  const int tr = tid / 16, tc = tid % 16;  // 16 x 16 threads, 4 x 4 each
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += MM_BK) {
    // x tile: 64 rows x 16 k, 4 elements per thread
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * MM_THREADS;
      const int r = e / MM_BK, kk = e % MM_BK;
      const int gm = m0 + r, gk = k0 + kk;
      as[kk][r] = (gm < M && gk < K) ? to_f(x[(size_t)gm * K + gk]) : 0.f;
    }
    // weight tile: 16 k x 64 n, 4 elements per thread
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * MM_THREADS;
      const int kk = e / MM_BN, c = e % MM_BN;
      const int gk = k0 + kk, gn = n0 + c;
      bs[kk][c] = (gk < K && gn < N) ? (float)q[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MM_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][tr * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tc * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + tr * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tc * 4 + j;
      if (gn < N) y[(size_t)gm * N + gn] = from_f<T>(acc[i][j] * scale[gn]);
    }
  }
}

}  // namespace ptt

// x (M, K) working type; q (K, N) int8; scale (N,) float32; y (M, N).
extern "C" int ptt_int8_matmul(const void* x, const void* q,
                               const void* scale, void* y, int M, int K,
                               int N, int dtype, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + ptt::MM_BN - 1) / ptt::MM_BN,
                  (M + ptt::MM_BM - 1) / ptt::MM_BM);
  cudaStream_t st = (cudaStream_t)stream;
  PTT_DISPATCH(dtype, T,
               ptt::int8_matmul_kernel<T><<<grid, ptt::MM_THREADS, 0, st>>>(
                   (const T*)x, (const int8_t*)q, (const float*)scale,
                   (T*)y, M, K, N));
  return (int)cudaGetLastError();
}
