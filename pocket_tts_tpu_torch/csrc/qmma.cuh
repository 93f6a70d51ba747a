// Tensor-core building blocks of the quantized-weight kernels: products of
// bf16 activation rows staged in shared memory with int8, packed int4 or
// plain bf16 weights, on `mma.sync.m16n8k16` with float32 accumulators.
// K5a and K5b over many rows (fused_layer.cu `rows_mma_kernel`) and
// K6 over many rows (fused_flow.cu) run them.
//
// The arithmetic is qdot.cuh's, on other units. The activation operand is
// already rounded to bf16 where the TPU kernels round their dot operand,
// so it enters the MMA exactly. A weight is widened to bf16 on chip: int8
// values and int4 nibbles (low nibble (b & 15) - 8, logical row k; high
// nibble b >> 4, arithmetic, logical row k + K/2: io/quant.py's packed
// halves) are exact in bf16. Per-channel scales multiply the float32 sum in
// the caller's epilogue. K-grouped scales (q4_0: one bf16 scale per group of
// logical rows and column) are never folded into the bf16 weight (a nibble
// times a bf16 scale is not exact in bf16): each k16 step accumulates into
// a fragment of its own, which is then added to the sum times its group's
// scale in float32. So the result is the float32 product with the
// dequantized weight up to summation order, as tile_dot's. Every sum runs in
// a fixed order (no float atomics), so a call gives the same bits run to
// run.
#pragma once

#include <cooperative_groups.h>

#include "qdot.cuh"

namespace ptt {

// 4 bytes global -> shared, asynchronously (cp.async.ca, for slices whose
// rows are not 16-byte aligned); zeros, and no read, when !valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// the bf16 bits of two floats (exact for the integers the weights hold)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// A column slice of a linear as the tensor-core products read it: logical
// rows [0, K) of the columns [c0, c0 + ncols) of a (K, N) linear, whose
// stored rows start at `w` (the slice's first column) with row stride `ld`
// elements: plain bf16 (K, ld), int8 (K, ld), or packed int4 (K/2, ld) with
// per-channel or grouped scales (gs: (K/group, ld) bf16 at the slice's first
// column, or null). `w` and `gs` may point to global or shared memory.
struct QSlice {
  const void* w;
  const bf16* gs;
  int kind, ld, K, group;
};

// Bs[k][c] (bf16, row stride ldb) = logical weight rows [k0, k0 + nk) of the
// slice, columns [0, nc) (nc a multiple of 4): every thread of the block,
// four columns at a time. A chunk of an int4 slice lies within one half
// (k0 + nk <= K/2 or k0 >= K/2).
// One group of four columns of logical row k: its 8 bytes of bf16, from
// the raw 4 bytes (int8 / int4) or 8 bytes (plain) loaded by slice_raw.
__device__ __forceinline__ uint2 slice_raw(const QSlice& s, int k, int c) {
  if (s.kind == LIN_PLAIN)
    return *reinterpret_cast<const uint2*>((const bf16*)s.w +
                                           (size_t)k * s.ld + c);
  const int row = s.kind == LIN_INT8 || k < s.K / 2 ? k : k - s.K / 2;
  return make_uint2(*reinterpret_cast<const uint32_t*>(
                        (const int8_t*)s.w + (size_t)row * s.ld + c),
                    0u);
}
__device__ __forceinline__ uint2 slice_widen(const QSlice& s, int k,
                                             uint2 o) {
  if (s.kind == LIN_PLAIN) return o;
  const uint32_t w = o.x;
  const int b[4] = {(int)(int8_t)(w & 0xff), (int)(int8_t)(w >> 8),
                    (int)(int8_t)(w >> 16), (int)(int8_t)(w >> 24)};
  const bool lo = k < s.K / 2;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = (float)(s.kind == LIN_INT8 ? b[j]
                   : lo ? (b[j] & 15) - 8 : b[j] >> 4);
  return make_uint2(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]));
}
__device__ __forceinline__ void slice_to_bf16(const QSlice& s, int k0, int nk,
                                              int nc, bf16* Bs, int ldb,
                                              int nthreads) {
  constexpr int B = 8;  // loads in flight a thread before the first store
  const int q4 = nc / 4;
  if (nthreads % q4 == 0) {
    // a fixed column group a thread, rows r0, r0 + step, ...
    const int c = threadIdx.x % q4 * 4, step = nthreads / q4;
    for (int r0 = threadIdx.x / q4; r0 < nk; r0 += B * step) {
      uint2 o[B];
#pragma unroll
      for (int u = 0; u < B; ++u)
        if (r0 + u * step < nk) o[u] = slice_raw(s, k0 + r0 + u * step, c);
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const int r = r0 + u * step;
        if (r < nk)
          *reinterpret_cast<uint2*>(Bs + (size_t)r * ldb + c) =
              slice_widen(s, k0 + r, o[u]);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < nk * q4; i += nthreads) {
    const int r = i / q4, c = (i - r * q4) * 4;
    *reinterpret_cast<uint2*>(Bs + (size_t)r * ldb + c) =
        slice_widen(s, k0 + r, slice_raw(s, k0 + r, c));
  }
}

// One warp's m16n8 fragments over k16 steps: acc[i] (4 floats: rows
// lane / 4 and + 8, columns 2 (lane % 4) + 0..1 of fragment i) +=
// A[rows mt_i * 16.., k-columns a_k(ks)..] . B[k-rows ks * 16.., columns
// nt * 8..]. As: bf16 rows, stride lda; Bs: bf16 (k, n), stride ldb (both
// multiples of 8). `scale(ks, col)`: the float32 scale of k16 step ks at
// fragment column col (grouped weights; the step's partial is kept apart
// and added times it), or nullptr for per-channel weights.
template <int NI, typename AK, typename Scale>
__device__ __forceinline__ void mma_steps(const bf16* As, int lda,
                                          const int (&mt)[NI], int nmt,
                                          const bf16* Bs, int ldb, int nt,
                                          int nks, AK a_k, bool grouped,
                                          Scale scale, float (&acc)[NI][4]) {
  const int lane = threadIdx.x & 31;
  for (int ks = 0; ks < nks; ++ks) {
    uint32_t b[2];
    ldmatrix_x2_trans(b, Bs + (size_t)(ks * 16 + (lane & 15)) * ldb + nt * 8);
    const int ak = a_k(ks);
    float s0 = 1.f, s1 = 1.f;
    if (grouped) {
      const int col = nt * 8 + 2 * (lane & 3);
      s0 = scale(ks, col);
      s1 = scale(ks, col + 1);
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if (i >= nmt) break;
      uint32_t a[4];
      ldmatrix_x4(a, As + (size_t)(mt[i] * 16 + (lane & 15)) * lda + ak +
                         (lane >> 4) * 8);
      if (grouped) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16_16816(t, a, b[0], b[1]);
        acc[i][0] = fmaf(s0, t[0], acc[i][0]);
        acc[i][1] = fmaf(s1, t[1], acc[i][1]);
        acc[i][2] = fmaf(s0, t[2], acc[i][2]);
        acc[i][3] = fmaf(s1, t[3], acc[i][3]);
      } else {
        mma_bf16_16816(acc[i], a, b[0], b[1]);
      }
    }
  }
}

// The float32 scale of logical weight row k at column col of a grouped
// slice (global or shared memory).
__device__ __forceinline__ float group_scale(const QSlice& s, int k,
                                            int col) {
  return __bfloat162float(s.gs[(size_t)(k / s.group) * s.ld + col]);
}

// ---------------------------------------------------------------------------
// K5a and K5b over many rows on the tensor cores (fused_layer.cu's
// `ptt_rows_mma`): rows_kernel's function for a bf16 working type.

constexpr int RM_THREADS = 256;   // 8 warps
constexpr int RM_BN = 64;         // output columns a block
constexpr int RM_BKS = 32;        // stored weight rows a k-tile
constexpr int RM_STAGES = 8;      // k-tiles in the cp.async ring: 16 KB in
                                  // flight a block
constexpr int RM_MAX_SPLITS = 8;  // reduction slices: a portable cluster
                                  // (ops/fused_layer.py plans at most 6)
constexpr int RM_RING_LD = RM_BN + 16;  // a raw k-tile row, padded: the
                                        // fragment reads hit distinct banks
constexpr int RM_CS_LD = RM_BN + 4;
constexpr int RM_LN_ROWS = 8;     // rows a LayerNorm chunk: one a warp
constexpr int RM_LN_BUFS = 2;     // LayerNorm chunks in flight

}  // namespace ptt
