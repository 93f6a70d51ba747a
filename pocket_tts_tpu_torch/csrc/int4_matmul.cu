// K4b: x (M, K) @ dequant(q4 (K/2, N) packed int4) -> (M, N), with
// per-channel float32 scales (N,) or K-grouped bfloat16 scales (K/group, N)
// (q4_0, group 32).
//
// Replaces the TPU kernel `pocket_tts_tpu/ops/quant_matmul.py:
// int4_matmul_pallas` (`_int4_kernel`, `_int4_grouped_kernel`). Layout
// (io/quant.py): packed row r holds logical row r in its low nibble
// (stored + 8) and logical row r + K/2 in its high nibble (signed), so a
// packed row meets x[:, r] and x[:, r + K/2]. Per output: the float32 sum
// of x[m, k] * w[k, n]; per-channel scales multiply the sum (the TPU
// kernel's `acc * s`), grouped scales multiply each nibble in float32
// before the sum (nibble x bf16 scale is exact in float32, so this is the
// float32 product with the dequantized weight up to summation order),
// rounded once to the working type. The TPU kernel's MXU workarounds
// (INT4_SCHEME rawf32m, the grouped T == 1 block-diagonal path, the 0/1
// scale-expansion matmul, POCKET_TTS_BD_VARIANT) round elsewhere in bf16
// and are not carried over.
//
// Where it runs: every int4 linear that no fused kernel covers, i.e. the
// backbone prefill (M = 16..256 rows of a prompt or sentence bucket,
// K = 1024 or 4096, N = 1024..4096) and `input_linear` once per frame
// (M = 1, K = 32, N = 1024; per-channel even under q4_0, since 32 is not a
// multiple of 2 x 32).
//
// What bounds it on the H100: at M = 1 bytes (16 KB of int4 for
// input_linear) and launch latency; at prefill M the FLOPs (2*M*K*N, up to
// 2.1 GFLOP for one 256 x 1024 x 4096 call), which this version runs on
// the CUDA cores in float32, not on the tensor cores. The design is K4a's
// plain shared-memory tiled GEMM: 64 x 64 output tiles, 256 threads each
// owning a 4 x 4 register tile. A K step covers 16 packed rows, i.e. 32
// logical rows: each thread loads one 4-byte char4 (4 columns x 2 logical
// rows), unpacks and scales it into a float tile in shared memory, so the
// weight crosses HBM as int4 only; the x tile stages the matching 16 low
// and 16 high columns. Ragged edges in M, K and N are masked. A wgmma/TMA
// pipeline in bf16 is later work.
#include "qdot.cuh"

namespace ptt {

constexpr int M4_BM = 64, M4_BN = 64, M4_BKP = 16, M4_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(M4_THREADS)
int4_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const void* __restrict__ scale, T* __restrict__ y, int M,
                   int K, int N, int group) {
  // rows [0, 16): logical rows k0 + i (low nibbles); [16, 32): k0 + i + K/2
  __shared__ float as[2 * M4_BKP][M4_BM + 4];  // x tile, transposed
  __shared__ float bs[2 * M4_BKP][M4_BN];      // dequantized weight tile
  const int tid = threadIdx.x;
  const int kh = K / 2;
  const int m0 = blockIdx.y * M4_BM, n0 = blockIdx.x * M4_BN;
  const int tr = tid / 16, tc = tid % 16;  // 16 x 16 threads, 4 x 4 each
  const float* pc = group ? nullptr : (const float*)scale;
  const bf16* gs = group ? (const bf16*)scale : nullptr;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < kh; k0 += M4_BKP) {
    // x tile: 64 rows x 32 logical columns, 8 elements per thread
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + i * M4_THREADS;
      const int r = e / (2 * M4_BKP), j = e % (2 * M4_BKP);
      const int gm = m0 + r, gk = k0 + (j % M4_BKP);
      as[j][r] = (gm < M && gk < kh)
                     ? to_f(x[(size_t)gm * K + gk + (j / M4_BKP) * kh])
                     : 0.f;
    }
    // weight tile: 16 packed rows x 64 columns, one char4 per thread
    {
      const int kk = tid / (M4_BN / 4), c = 4 * (tid % (M4_BN / 4));
      const int gk = k0 + kk, gn = n0 + c;
      float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
      if (gk < kh && gn < N) {
        const char4 v =
            *reinterpret_cast<const char4*>(q + (size_t)gk * N + gn);
        const int b[4] = {v.x, v.y, v.z, v.w};
        float sl[4] = {1.f, 1.f, 1.f, 1.f}, sh[4] = {1.f, 1.f, 1.f, 1.f};
        if (gs) {
          const float4 a = load4(gs + (size_t)(gk / group) * N + gn);
          const float4 d = load4(gs + (size_t)((kh + gk) / group) * N + gn);
          sl[0] = a.x, sl[1] = a.y, sl[2] = a.z, sl[3] = a.w;
          sh[0] = d.x, sh[1] = d.y, sh[2] = d.z, sh[3] = d.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[j] = (float)((b[j] & 15) - 8) * sl[j];
          hi[j] = (float)(b[j] >> 4) * sh[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bs[kk][c + j] = lo[j];
        bs[M4_BKP + kk][c + j] = hi[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 2 * M4_BKP; ++kk) {
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
      if (gn < N)
        y[(size_t)gm * N + gn] = from_f<T>(acc[i][j] * (pc ? pc[gn] : 1.f));
    }
  }
}

}  // namespace ptt

// x (M, K) working type; q4 (K/2, N) packed int8; scale (N,) float32 when
// group == 0, else (K/group, N) bfloat16 with whole groups in each half of
// K; y (M, N). N a multiple of 4, q4 4-byte and scale 8-byte aligned.
extern "C" int ptt_int4_matmul(const void* x, const void* q4,
                               const void* scale, void* y, int M, int K,
                               int N, int group, int dtype, void* stream) {
  if (M < 1 || K < 2 || K % 2 || N < 4 || N % 4 || group < 0 ||
      (group && (K / 2) % group))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + ptt::M4_BN - 1) / ptt::M4_BN,
                  (M + ptt::M4_BM - 1) / ptt::M4_BM);
  cudaStream_t st = (cudaStream_t)stream;
  PTT_DISPATCH(dtype, T,
               ptt::int4_matmul_kernel<T><<<grid, ptt::M4_THREADS, 0, st>>>(
                   (const T*)x, (const int8_t*)q4, scale, (T*)y, M, K, N,
                   group));
  return (int)cudaGetLastError();
}
