// Block-level building blocks of the quantized-weight kernels K5a, K5b and
// K6 (fused_layer.cu, fused_flow.cu): a row LayerNorm into shared memory
// and a skinny product of a few activation rows with a column tile of an
// int8 (or plain) weight matrix streamed from HBM.
//
// A weight element is read once per call, four columns at a time (a 4-byte
// char4 for int8), widened to float on chip and never written back: the
// dequantized matrix never exists in HBM. Per-channel scales are applied
// by the caller's epilogue to the float32 sum, as the TPU kernels fold them
// into the accumulator.
#pragma once

#include "common.cuh"

namespace ptt {

constexpr int QD_THREADS = 256;
constexpr int QD_WARPS = QD_THREADS / 32;
// rows of the activation handled per pass over a weight tile (more rows
// take more passes; the tile is then read from L1/L2)
constexpr int QD_ROWS = 8;
// shared-memory floats `tile_dot` needs for its partial sums
constexpr int QD_RED = QD_ROWS * 4 * QD_THREADS;

__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

// optional per-channel vectors: a null pointer reads as `dflt`
template <typename T>
__device__ __forceinline__ float opt(const T* p, int i, float dflt) {
  return p ? to_f(p[i]) : dflt;
}

// Row-wise LayerNorm statistics, one warp per row: for each row r < nrows
// of length n, calls store(r, i, (x[r][i] - mean) * rsqrt(var + eps)) with
// mean and var (divisor n) in float32, as the TPU kernels compute them.
// load(r, i) reads an element as float. Ends with __syncthreads().
template <typename Load, typename Store>
__device__ void block_layernorm(int nrows, int n, float eps, Load load,
                                Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrows; r += QD_WARPS) {
    float s = 0.f;
    for (int i = lane; i < n; i += 32) s += load(r, i);
    const float mean = warp_sum(s) / (float)n;
    float v = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float d = load(r, i) - mean;
      v += d * d;
    }
    const float rstd = 1.0f / sqrtf(warp_sum(v) / (float)n + eps);
    for (int i = lane; i < n; i += 32) store(r, i, (load(r, i) - mean) * rstd);
  }
  __syncthreads();
}

// Block-wide skinny product over one column tile:
//   epi(r, n, sum_k xs[r*ldx + k] * w[k*ldw + n])
// for rows r < nrows and columns n in [n0, n0 + ncols), ncols <= 4*cg.
// xs: float activations in shared memory (already rounded to the working
// type where the TPU kernel rounds its dot operand); w: int8 or float /
// bf16 weights in global memory with row stride ldw (a multiple of 4, and
// w 16-byte aligned). cg (a power of two, 1..256) is the tile's number of
// 4-column groups: thread t owns group t % cg and the t / cg-th slice of
// the K range. Partial sums combine in a FIXED order (shuffles inside a
// warp, then the warps' or slices' partials in shared memory, in index
// order), so a call gives the same bits run to run. red: QD_RED floats of
// shared memory. Every thread of the block must call it; it synchronises.
template <typename W, typename Epi>
__device__ void tile_dot(const float* xs, int ldx, int nrows, int K,
                         const W* __restrict__ w, int ldw, int n0, int ncols,
                         int cg, float* red, Epi epi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid % cg, s = tid / cg, ns = QD_THREADS / cg;
  const int tn = 4 * cg;
  const int col = n0 + 4 * g;
  const bool colok = 4 * g < ncols;
  const int kc = (K + ns - 1) / ns;
  const int k0 = min(K, s * kc), k1 = min(K, k0 + kc);
  // one partial per warp when the warp's lanes share columns, else one per
  // slice (cg >= 32: a warp spans 32 distinct column groups)
  const bool in_warp = cg < 32;
  const int nslot = in_warp ? QD_WARPS : ns;
  const int slot = in_warp ? warp : s;
  for (int r0 = 0; r0 < nrows; r0 += QD_ROWS) {
    const int nr = min(QD_ROWS, nrows - r0);
    float acc[QD_ROWS][4];
#pragma unroll
    for (int r = 0; r < QD_ROWS; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    if (colok) {
      const float* xr = xs + (size_t)r0 * ldx;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const float4 wv = load4(w + (size_t)k * ldw + col);
#pragma unroll
        for (int r = 0; r < QD_ROWS; ++r) {
          if (r < nr) {
            const float xv = xr[r * ldx + k];
            acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
            acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
            acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
            acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
          }
        }
      }
    }
    if (in_warp) {
      for (int off = cg; off < 32; off <<= 1) {
#pragma unroll
        for (int r = 0; r < QD_ROWS; ++r) {
          if (r < nr) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
          }
        }
      }
    }
    if (!in_warp || lane < cg) {
#pragma unroll
      for (int r = 0; r < QD_ROWS; ++r) {
        if (r < nr) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            red[(slot * QD_ROWS + r) * tn + 4 * g + c] = acc[r][c];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < nr * tn; i += QD_THREADS) {
      const int r = i / tn, c = i - r * tn;
      if (c < ncols) {
        float v = 0.f;
        for (int j = 0; j < nslot; ++j) v += red[(j * QD_ROWS + r) * tn + c];
        epi(r0 + r, n0 + c, v);
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float silu_f(float x) {
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ float gelu_f(float h, int approx) {
  if (approx) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    return 0.5f * h * (1.0f + tanhf(c * (h + 0.044715f * h * h * h)));
  }
  return 0.5f * h * (1.0f + erff(h * 0.7071067811865476f));
}

}  // namespace ptt
