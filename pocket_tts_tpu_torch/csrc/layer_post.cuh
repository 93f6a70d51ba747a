// The phases of a transformer layer's tail after attention, as device
// functions that one cooperative kernel runs with grid barriers between
// them: K5b (fused_layer.cu `fused_post_kernel`), K5c (fused_layer.cu
// `bilayer_kernel`) and K8 (megalayer.cu). Every block of the grid calls
// each function (they synchronise the block); blocks split the work by
// blockIdx.x, and the caller separates the phases with grid.sync():
//
//   out_proj_tiles   x1 = x + ls1 * (attn @ W_o + b_o)        float32, HBM
//   mlp_tiles        ln = round(LN(x1) * ns + nb) into shared memory; then
//                    this block's hidden tiles: h = gelu(ln @ W_1 + b_1)
//                    (rounded to the working type, or float32), and the
//                    block's partial of up = h @ q_2 (grouped W2 scales
//                    applied per nibble), written to part[blockIdx.x]
//   mlp_finish       v = x1 + ls2 * ((sum of the partials, in block
//                    order) * s_2 + b_2), handed to the caller per element
//
// The cross-block sum runs over the partials in block order (no float
// atomics), so the result does not depend on scheduling. A hidden tile is
// 32 hidden units: 32 W2 rows of int8, or 16 packed rows of int4, whose low
// nibbles hold hidden units h0.. and high nibbles H/2 + h0.. (io/quant.py's
// packed halves); the block first computes both h halves into one tile.
#pragma once

#include "qdot.cuh"

namespace ptt {

constexpr int FL_TILE = 32;  // columns per K5a tile / hidden units per tile

__host__ __device__ __forceinline__ bool packed(const Lin& l) {
  return l.kind == LIN_INT4 || l.kind == LIN_INT4_G;
}

// x1 (T_, dm) float32 = x + ls1 * (xs @ W_o + b_o); xs: the attention rows
// staged as floats in shared memory (every block that has a tile stages
// them). Column tiles of 32 over the grid.
template <typename T>
__device__ void out_proj_tiles(const float* xs, int T_, int dm, const Lin& wo,
                               const T* x, const T* ls1, float* x1,
                               float* red) {
  const int ntiles = (dm + FL_TILE - 1) / FL_TILE;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int n0 = t * FL_TILE;
    lin_tile<T>(xs, dm, T_, dm, wo, dm, n0, min(FL_TILE, dm - n0),
                FL_TILE / 4, red, [&](int r, int n, float proj) {
                  x1[r * dm + n] =
                      to_f(x[r * dm + n]) + opt(ls1, n, 1.f) * proj;
                });
  }
}

// Hidden tiles of the MLP into this block's partial of `up`, written to
// part + blockIdx.x * T_ * dm. xs: T_ x dm floats of shared memory for
// round(LN(x1)); acc: T_ x dm floats; hs: T_ x FL_TILE floats. round_h:
// round the GELU output to the working type (K5b, K5c, and K8 at int8) or
// keep it float32 (K8 at int4).
template <typename T>
__device__ void mlp_tiles(int T_, int dm, int H, const float* x1, const T* ns,
                          const T* nb, float eps, const Lin& w1,
                          const Lin& w2, int approx, bool round_h, float* xs,
                          float* acc, float* hs, float* red, float* part) {
  const int tid = threadIdx.x;
  block_layernorm(
      T_, dm, eps, [&](int r, int i) { return __ldcg(x1 + r * dm + i); },
      [&](int r, int i, float v) {
        xs[r * dm + i] = rnd<T>(v * opt(ns, i, 1.f) + opt(nb, i, 0.f));
      });
  for (int i = tid; i < T_ * dm; i += QD_THREADS) acc[i] = 0.f;
  __syncthreads();
  const bool p2 = packed(w2);
  const int span = p2 ? H / 2 : H;   // stored rows of W2
  const int tile = p2 ? FL_TILE / 2 : FL_TILE;  // stored W2 rows per tile
  const int ntiles_h = (span + tile - 1) / tile;
  const int8_t* q2 = (const int8_t*)w2.w;
  const bf16* gs2 = w2.kind == LIN_INT4_G ? (const bf16*)w2.s : nullptr;
  // W2 rows: as many 4-column groups as the row has, up to one per thread
  // (tile_dot takes a power of two)
  int cg2 = 1;
  while (2 * cg2 <= min(dm / 4, QD_THREADS)) cg2 *= 2;
  auto add = [&](int r, int n, float v) { acc[r * dm + n] += v; };
  for (int t = blockIdx.x; t < ntiles_h; t += gridDim.x) {
    const int h0 = t * tile, nh = min(tile, span - h0);
    for (int half = 0; half < (p2 ? 2 : 1); ++half) {
      const int c0 = h0 + half * span;
      lin_tile<T>(xs, dm, T_, dm, w1, H, c0, nh, tile / 4, red,
                  [&](int r, int n, float v) {
                    const float g = gelu_f(v, approx);
                    hs[r * FL_TILE + half * tile + (n - c0)] =
                        round_h ? rnd<T>(g) : g;
                  });
    }
    for (int n0 = 0; n0 < dm; n0 += 4 * cg2) {
      const int nc = min(4 * cg2, dm - n0);
      if (p2)
        tile_dot(hs, FL_TILE, T_,
                 Int4W{q2 + (size_t)h0 * dm, dm, nh, tile, gs2, w2.group, h0,
                       span},
                 n0, nc, cg2, red, add);
      else
        tile_dot(hs, FL_TILE, T_, DenseW<int8_t>{q2 + (size_t)h0 * dm, dm, nh},
                 n0, nc, cg2, red, add);
    }
  }
  float* mine = part + (size_t)blockIdx.x * T_ * dm;
  for (int i = tid; i < T_ * dm; i += QD_THREADS) mine[i] = acc[i];
}

// fin(i, v) for every element i < T_ * dm, spread over the grid:
// v = x1 + ls2 * ((sum over the grid's partials, in block order) * s_2 +
// b_2), s_2 per channel (grouped W2 scales were applied in mlp_tiles).
template <typename T, typename Fin>
__device__ void mlp_finish(int T_, int dm, const Lin& w2, const T* ls2,
                           const float* x1, const float* part, Fin fin) {
  const float* s2 = w2.kind == LIN_INT4_G ? nullptr : (const float*)w2.s;
  const T* b2 = (const T*)w2.b;
  const int G = gridDim.x;
  for (int i = blockIdx.x * QD_THREADS + threadIdx.x; i < T_ * dm;
       i += G * QD_THREADS) {
    float v = 0.f;
    for (int g = 0; g < G; ++g) v += __ldcg(part + (size_t)g * T_ * dm + i);
    const int n = i % dm;
    const float up = v * (s2 ? s2[n] : 1.f) + opt(b2, n, 0.f);
    fin(i, __ldcg(x1 + i) + opt(ls2, n, 1.f) * up);
  }
}

}  // namespace ptt
