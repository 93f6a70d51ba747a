// Block-level building blocks of the quantized-weight kernels K5a, K5b and
// K6 (fused_layer.cu, fused_flow.cu): a
// row LayerNorm into shared memory
// and a skinny product of a few activation rows with a column tile of an
// int8, packed int4 (or plain) weight matrix streamed from HBM.
//
// A weight element is read once per call, four columns at a time (a 4-byte
// char4 for int8; for packed int4 one char4 holds four columns of two
// logical rows), widened to float on chip and never written back: the
// dequantized matrix never exists in HBM. Per-channel scales are applied
// by the caller's epilogue to the float32 sum, as the TPU kernels fold them
// into the accumulator. K-grouped int4 scales (q4_0: one bf16 scale per 32
// logical rows and column) are applied inside the sum, to each nibble in
// float32; nibble x bf16 scale is exact there, so the result is the float32
// product with the dequantized weight up to summation order.
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

// A weight matrix as tile_dot reads it. DenseW: int8 or plain float/bf16,
// stored row k is logical row k. Int4W: packed int4 halves (io/quant.py),
// stored row k holds logical row k in its low nibble ((b & 15) - 8) and
// logical row k + half in its high nibble (b >> 4, arithmetic), so a row
// multiplies x[k] and x[k + xoff]. Rows of a sub-tile (K5b's W2 tile) start
// at packed row r0 of the full matrix; gs (null: per-channel) holds the
// grouped scales, (2 * half / group, ld) bf16, row (r0 + k) / group for the
// low nibble and (half + r0 + k) / group for the high one.
template <typename W>
struct DenseW {
  const W* w;
  int ld, rows;
};
struct Int4W {
  const int8_t* q;
  int ld, rows, xoff;
  const bf16* gs;
  int group, r0, half;
};

// acc[r][c] += sum over stored rows [k0, k1) of x_r . w[., col + c]
template <typename W>
__device__ __forceinline__ void dot_rows(const DenseW<W>& w, int k0, int k1,
                                         int col, const float* xr, int ldx,
                                         int nr, float (&acc)[QD_ROWS][4]) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 wv = load4(w.w + (size_t)k * w.ld + col);
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

__device__ __forceinline__ void dot_rows(const Int4W& w, int k0, int k1,
                                         int col, const float* xr, int ldx,
                                         int nr, float (&acc)[QD_ROWS][4]) {
  // segments of the slice that share one scale group (the whole slice for
  // per-channel scales)
  for (int ks = k0; ks < k1;) {
    const int ke = w.gs ? min(k1, ((w.r0 + ks) / w.group + 1) * w.group
                                      - w.r0)
                        : k1;
    float sl[4] = {1.f, 1.f, 1.f, 1.f}, sh[4] = {1.f, 1.f, 1.f, 1.f};
    if (w.gs) {
      const int g = (w.r0 + ks) / w.group;
      const float4 a = load4(w.gs + (size_t)g * w.ld + col);
      const float4 b =
          load4(w.gs + (size_t)(w.half / w.group + g) * w.ld + col);
      sl[0] = a.x, sl[1] = a.y, sl[2] = a.z, sl[3] = a.w;
      sh[0] = b.x, sh[1] = b.y, sh[2] = b.z, sh[3] = b.w;
    }
#pragma unroll 4
    for (int k = ks; k < ke; ++k) {
      const char4 v = *reinterpret_cast<const char4*>(w.q + (size_t)k * w.ld
                                                      + col);
      const int b[4] = {v.x, v.y, v.z, v.w};
      float lo[4], hi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        lo[c] = (float)((b[c] & 15) - 8) * sl[c];
        hi[c] = (float)(b[c] >> 4) * sh[c];
      }
#pragma unroll
      for (int r = 0; r < QD_ROWS; ++r) {
        if (r < nr) {
          const float xl = xr[r * ldx + k], xh = xr[r * ldx + k + w.xoff];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(xh, hi[c], fmaf(xl, lo[c], acc[r][c]));
        }
      }
    }
    ks = ke;
  }
}

// Block-wide skinny product over one column tile:
//   epi(r, n, sum_k xs[r*ldx + k] * w[k][n])
// for rows r < nrows and columns n in [n0, n0 + ncols), ncols <= 4*cg.
// xs: float activations in shared memory (already rounded to the working
// type where the TPU kernel rounds its dot operand); w: a DenseW or Int4W
// view of weights in global memory (row stride a multiple of 4, rows
// 4-byte aligned for int8/int4, 16-byte for float, 8-byte for bf16 and for
// grouped scales). cg (a power of two, 1..256) is the tile's number of
// 4-column groups: thread t owns group t % cg and the t / cg-th slice of
// the stored rows. Partial sums combine in a FIXED order (shuffles inside a
// warp, then the warps' or slices' partials in shared memory, in index
// order), so a call gives the same bits run to run. red: QD_RED floats of
// shared memory. Every thread of the block must call it; it synchronises.
template <typename View, typename Epi>
__device__ void tile_dot(const float* xs, int ldx, int nrows, const View& w,
                         int n0, int ncols, int cg, float* red, Epi epi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid % cg, s = tid / cg, ns = QD_THREADS / cg;
  const int tn = 4 * cg;
  const int col = n0 + 4 * g;
  const bool colok = 4 * g < ncols;
  const int kc = (w.rows + ns - 1) / ns;
  const int k0 = min(w.rows, s * kc), k1 = min(w.rows, k0 + kc);
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
    if (colok) dot_rows(w, k0, k1, col, xs + (size_t)r0 * ldx, ldx, nr, acc);
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

// Weight kinds of a linear (ops/quant_matmul.py PLAIN, INT8, INT4,
// INT4_GROUPED).
enum { LIN_PLAIN = 0, LIN_INT8 = 1, LIN_INT4 = 2, LIN_INT4_G = 3 };

// One linear layer as the fused kernels take it, logical shape (K, N):
//   plain   w (K, N) of the working type, s null
//   int8    w (K, N) int8, s (N,) float32 per output channel
//   int4    w (K/2, N) packed halves, s (N,) float32 per output channel
//   int4_g  w (K/2, N) packed halves, s (K/group, N) bfloat16
// b: (N,) of the working type or null. A stacked (L, ...) linear gives
// layer l with `at`.
struct Lin {
  const void *w, *s, *b;
  int kind, group;
};

// Layer l of a stacked linear of logical shape (K, N), T the working type.
template <typename T>
__device__ __forceinline__ Lin lin_at(Lin a, int l, int K, int N) {
  const size_t kn = (size_t)K * N;
  switch (a.kind) {
    case LIN_PLAIN: a.w = (const T*)a.w + l * kn; break;
    case LIN_INT8: a.w = (const int8_t*)a.w + l * kn; break;
    default: a.w = (const int8_t*)a.w + l * kn / 2;
  }
  if (a.s)
    a.s = a.kind == LIN_INT4_G ? (const void*)((const bf16*)a.s
                                               + l * kn / a.group)
                               : (const void*)((const float*)a.s
                                               + (size_t)l * N);
  if (a.b) a.b = (const T*)a.b + (size_t)l * N;
  return a;
}

// tile_dot of xs (logical rows of width K, row stride ldx) with a linear,
// the epilogue receiving v * (per-channel scale) + bias: the linear's
// output in float32 before any rounding.
template <typename T, typename Epi>
__device__ void lin_tile(const float* xs, int ldx, int nrows, int K,
                         const Lin& a, int N, int n0, int ncols, int cg,
                         float* red, Epi epi) {
  const float* pc = (a.kind == LIN_INT8 || a.kind == LIN_INT4)
                        ? (const float*)a.s : nullptr;
  const T* b = (const T*)a.b;
  auto fin = [&](int r, int n, float v) {
    epi(r, n, v * (pc ? pc[n] : 1.f) + opt(b, n, 0.f));
  };
  switch (a.kind) {
    case LIN_PLAIN:
      tile_dot(xs, ldx, nrows, DenseW<T>{(const T*)a.w, N, K}, n0, ncols, cg,
               red, fin);
      break;
    case LIN_INT8:
      tile_dot(xs, ldx, nrows, DenseW<int8_t>{(const int8_t*)a.w, N, K}, n0,
               ncols, cg, red, fin);
      break;
    default:
      tile_dot(xs, ldx, nrows,
               Int4W{(const int8_t*)a.w, N, K / 2, K / 2,
                     a.kind == LIN_INT4_G ? (const bf16*)a.s : nullptr,
                     a.group, 0, K / 2},
               n0, ncols, cg, red, fin);
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
