// K6: the whole flow net (SimpleMLPAdaLN) in one launch.
//
// Replaces the TPU kernel `pocket_tts_tpu/ops/fused_flow.py:_make_flow`
// (`_kernel`, and its vmap rule: all B rows of a batch in one call). For R
// rows (1 solo, one per lane at batch) of conditioning c (d_model) and noise
// x (latent), and the time conditioning tc (dim):
//   sy   = silu(tc + c @ Wc)                     once: loop-invariant
//   h    = x @ Wi
//   per res block i < depth:
//     shift, scale, gate = sy @ Wa[i]
//     hn = LN(h; in_ln[i], eps 1e-6) * (1 + scale) + shift
//     h  = h + gate * (silu(hn @ W0[i]) @ W2[i])
//   shift, scale = sy @ Wfa
//   out  = (LN(h; final norm, eps 1e-6) * (1 + scale) + shift) @ Wf
// where "v @ W" is round(v) @ W + b in float32 with the weight's scales
// (qdot.cuh `Lin`): the activations stay float32 between dots and each
// dot's operand is rounded to the working type first (the TPU kernel's
// `xb = x32.astype(dt)`). The output is rounded once. The large linears are
// all int8 or all int4 (per-channel or K-grouped q4_0 scales); each of
// input_proj and final.linear has its own layout: int8, int4 or a plain
// weight of the working type (they can fall under the quantization size
// floor, and under q4_0 input_proj, K = 32, keeps per-channel int4 scales
// beside grouped big linears).
//
// What bounds it on the H100: latency, not bytes. The weights are ~8.9 MB
// of int8 (~4.5 MB of int4) at full width (~2.7 us at full HBM bandwidth
// for int8) but the net is a chain of dependent matrix-vector products.
// The TPU kernel keeps every
// weight resident in VMEM and runs the chain in one grid step; 227 KB of
// shared memory per SM cannot hold them, so here they stream from HBM (or
// L2, where they stay between frames) inside one COOPERATIVE launch, with
// a grid barrier between dependent steps:
//   phase A  sy = silu(tc + c @ Wc) and h = x @ Wi        (32-column tiles)
//   sync
//   phase B  all 7 AdaLN modulations (depth x 3 dim + 2 dim columns,
//            ~5.2 MB of the 8.9 MB), spread over every block
//   sync
//   per block i: LN + modulate + u = silu(. @ W0[i]); sync;
//                h += gate * (u @ W2[i]); sync
//   head     LN + modulate + @ Wf -> out
// 2 + 2 * depth barriers in all. Every block recomputes the (dim-wide)
// LayerNorm of each row itself, so only the matrix products are split
// across blocks. Each column tile applies to all R rows (tile_dot walks
// them 8 at a time), so a launch reads each weight byte once from HBM
// whatever R is; R is bounded by the rows of activations shared memory
// holds (32 at full width; the wrapper launches again for more).
// The float32 intermediates (sy, h, u, the modulations) live in a scratch
// buffer the caller allocates; reads after a barrier bypass L1 (__ldcg).
#include <cooperative_groups.h>

#include <algorithm>

#include "qdot.cuh"

namespace coop = cooperative_groups;

namespace ptt {

constexpr int FF_TILE = 32;  // columns per tile

struct FlowArgs {
  const void *x, *c, *tc;        // (R, latent), (R, d_model), (dim,)
  Lin wi;                        // input_proj (latent, dim)
  Lin wc;                        // cond_embed (d_model, dim)
  const void *lns, *lnb;         // (depth, dim) or null
  Lin wa;                        // depth x (dim, 3 dim)
  Lin w0;                        // depth x (dim, hid)
  Lin w2;                        // depth x (hid, dim)
  const void *fns, *fnb;         // (dim,) or null
  Lin wfa;                       // (dim, 2 dim)
  Lin wf;                        // final.linear (dim, latent)
  float* scratch;                // R rows of sy | h | u | mods (see below)
  void* out;                     // (R, latent)
  int latent, dmodel, dim, hid, depth, rows;
};

// SOLO: one row, known at compile time (the solo decode step), so the
// row loops of tile_dot fold away as they did before lanes existed.
template <typename T, bool SOLO>
__global__ void __launch_bounds__(QD_THREADS) fused_flow_kernel(FlowArgs a) {
  extern __shared__ float smem[];
  const int dim = a.dim, hid = a.hid, depth = a.depth;
  const int R = SOLO ? 1 : a.rows;
  constexpr int CG = FF_TILE / 4;
  float* red = smem;                 // QD_RED
  float* xs = red + QD_RED;          // R activation rows (max width)
  const int n3 = 3 * dim, n2 = 2 * dim;
  const int ms = depth * n3 + n2;    // modulation floats per row
  float* sy = a.scratch;             // (R, dim)
  float* h = sy + R * dim;           // (R, dim)
  float* u = h + R * dim;            // (R, hid)
  float* mods = u + R * hid;         // (R, ms): depth x 3 dim, then 2 dim
  coop::grid_group grid = coop::this_grid();
  const int tid = threadIdx.x, b = blockIdx.x, G = gridDim.x;
  const int nt_dim = (dim + FF_TILE - 1) / FF_TILE;

  // phase A: tiles [0, nt_dim) -> sy, [nt_dim, 2 nt_dim) -> h
  for (int t = b; t < 2 * nt_dim; t += G) {
    const bool cond = t < nt_dim;
    const int n0 = (cond ? t : t - nt_dim) * FF_TILE;
    const int K = cond ? a.dmodel : a.latent;
    const T* src = (const T*)(cond ? a.c : a.x);
    __syncthreads();  // xs of the previous tile is consumed
    for (int i = tid; i < R * K; i += QD_THREADS) xs[i] = to_f(src[i]);
    __syncthreads();
    if (cond) {
      lin_tile<T>(xs, K, R, K, a.wc, dim, n0, min(FF_TILE, dim - n0), CG,
                  red, [&](int r, int n, float v) {
                    sy[r * dim + n] =
                        silu_f(to_f(((const T*)a.tc)[n]) + v);
                  });
    } else {
      lin_tile<T>(xs, K, R, K, a.wi, dim, n0, min(FF_TILE, dim - n0), CG,
                  red, [&](int r, int n, float v) { h[r * dim + n] = v; });
    }
  }
  grid.sync();

  // phase B: every modulation, from round(sy)
  const int nt3 = (n3 + FF_TILE - 1) / FF_TILE;
  const int nt2 = (n2 + FF_TILE - 1) / FF_TILE;
  if (b < depth * nt3 + nt2) {
    for (int i = tid; i < R * dim; i += QD_THREADS)
      xs[i] = rnd<T>(__ldcg(sy + i));
    __syncthreads();
    for (int t = b; t < depth * nt3 + nt2; t += G) {
      if (t < depth * nt3) {
        const int l = t / nt3, n0 = (t % nt3) * FF_TILE;
        lin_tile<T>(xs, dim, R, dim, lin_at<T>(a.wa, l, dim, n3), n3, n0,
                    min(FF_TILE, n3 - n0), CG, red,
                    [&](int r, int n, float v) {
                      mods[r * ms + l * n3 + n] = v;
                    });
      } else {
        const int n0 = (t - depth * nt3) * FF_TILE;
        lin_tile<T>(xs, dim, R, dim, a.wfa, n2, n0, min(FF_TILE, n2 - n0),
                    CG, red, [&](int r, int n, float v) {
                      mods[r * ms + depth * n3 + n] = v;
                    });
      }
    }
  }
  grid.sync();

  // LN(h) * (1 + scale) + shift of every row, rounded, into xs (every
  // block); m: the row's shift | scale for this step
  auto modulated_ln = [&](const T* ns, const T* nb, int moff) {
    block_layernorm(
        R, dim, 1e-6f, [&](int r, int i) { return __ldcg(h + r * dim + i); },
        [&](int r, int i, float v) {
          const float* m = mods + r * ms + moff;
          const float hn = v * opt(ns, i, 1.f) + opt(nb, i, 0.f);
          xs[r * dim + i] =
              rnd<T>(hn * (1.0f + __ldcg(m + dim + i)) + __ldcg(m + i));
        });
  };
  const int nt_hid = (hid + FF_TILE - 1) / FF_TILE;
  for (int l = 0; l < depth; ++l) {
    if (b < nt_hid) {
      modulated_ln(a.lns ? (const T*)a.lns + l * dim : nullptr,
                   a.lnb ? (const T*)a.lnb + l * dim : nullptr, l * n3);
      const Lin w = lin_at<T>(a.w0, l, dim, hid);
      for (int t = b; t < nt_hid; t += G) {
        const int n0 = t * FF_TILE;
        lin_tile<T>(xs, dim, R, dim, w, hid, n0, min(FF_TILE, hid - n0), CG,
                    red, [&](int r, int n, float v) {
                      u[r * hid + n] = silu_f(v);
                    });
      }
    }
    grid.sync();
    if (b < nt_dim) {
      for (int i = tid; i < R * hid; i += QD_THREADS)
        xs[i] = rnd<T>(__ldcg(u + i));
      __syncthreads();
      const Lin w = lin_at<T>(a.w2, l, hid, dim);
      for (int t = b; t < nt_dim; t += G) {
        const int n0 = t * FF_TILE;
        lin_tile<T>(xs, hid, R, hid, w, dim, n0, min(FF_TILE, dim - n0), CG,
                    red, [&](int r, int n, float v) {
                      const float gate =
                          __ldcg(mods + r * ms + l * n3 + 2 * dim + n);
                      h[r * dim + n] = __ldcg(h + r * dim + n) + gate * v;
                    });
      }
    }
    grid.sync();
  }

  // head: the latent-wide output
  const int nt_lat = (a.latent + FF_TILE - 1) / FF_TILE;
  if (b < nt_lat) {
    modulated_ln((const T*)a.fns, (const T*)a.fnb, depth * n3);
    T* out = (T*)a.out;
    for (int t = b; t < nt_lat; t += G) {
      const int n0 = t * FF_TILE;
      lin_tile<T>(xs, dim, R, dim, a.wf, a.latent, n0,
                  min(FF_TILE, a.latent - n0), CG, red,
                  [&](int r, int n, float v) {
                    out[r * a.latent + n] = from_f<T>(v);
                  });
    }
  }
}

}  // namespace ptt

static size_t flow_smem(int dmodel, int dim, int hid, int latent,
                        int rows) {
  const int w = std::max(std::max(dmodel, dim), std::max(hid, latent));
  return sizeof(float) * (ptt::QD_RED + (size_t)rows * w);
}

// Largest cooperative grid K6 can take on this device for `rows` rows. 0 on
// error.
extern "C" int ptt_fused_flow_max_blocks(int dmodel, int dim, int hid,
                                         int latent, int rows, int dtype) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return 0;
  const size_t smem = flow_smem(dmodel, dim, hid, latent, rows);
  PTT_DISPATCH(dtype, T_, {
    auto kern = rows == 1 ? ptt::fused_flow_kernel<T_, true>
                          : ptt::fused_flow_kernel<T_, false>;
    if (cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kern, ptt::QD_THREADS, smem))
      return 0;
  });
  return per_sm * sms;
}

// A linear of logical shape (K, N) K6 takes: quantized (int8, int4 in
// either scale layout) or, when `plain_ok`, a plain weight.
static bool flow_lin_ok(const ptt::Lin& l, int K, bool plain_ok) {
  switch (l.kind) {
    case ptt::LIN_PLAIN: return plain_ok && l.s == nullptr;
    case ptt::LIN_INT8: return l.s != nullptr;
    case ptt::LIN_INT4: return l.s != nullptr && K % 2 == 0;
    case ptt::LIN_INT4_G:
      return l.s != nullptr && l.group > 0 && K % 2 == 0 &&
             (K / 2) % l.group == 0;
    default: return false;
  }
}

// p: x, c, tc, then (w, scale, bias) of input_proj and cond_embed, in_ln
//    scale and bias, (w, scale, bias) of adaln, mlp_0 and mlp_2 (stacked
//    over depth), final norm scale and bias, (w, scale, bias) of the final
//    adaln and final.linear, then scratch and out (device pointers;
//    optional ones null).
// ints: latent, d_model, dim, hid, depth, rows, then (kind, group) of
//    input_proj, cond_embed, adaln, mlp_0, mlp_2, final adaln,
//    final.linear.
extern "C" int ptt_fused_flow(void* const* p, const int* ints, int grid,
                              int dtype, void* stream) {
  const int* k = ints + 6;
  ptt::FlowArgs a{p[0], p[1], p[2],
                  {p[3], p[4], p[5], k[0], k[1]},
                  {p[6], p[7], p[8], k[2], k[3]},
                  p[9], p[10],
                  {p[11], p[12], p[13], k[4], k[5]},
                  {p[14], p[15], p[16], k[6], k[7]},
                  {p[17], p[18], p[19], k[8], k[9]},
                  p[20], p[21],
                  {p[22], p[23], p[24], k[10], k[11]},
                  {p[25], p[26], p[27], k[12], k[13]},
                  (float*)p[28], p[29],
                  ints[0], ints[1], ints[2], ints[3], ints[4], ints[5]};
  if (grid < 1 || a.dim % 4 || a.hid % 4 || a.latent % 4 || a.depth < 1 ||
      a.rows < 1 ||
      !flow_lin_ok(a.wi, a.latent, true) ||
      !flow_lin_ok(a.wc, a.dmodel, false) ||
      !flow_lin_ok(a.wa, a.dim, false) || !flow_lin_ok(a.w0, a.dim, false) ||
      !flow_lin_ok(a.w2, a.hid, false) ||
      !flow_lin_ok(a.wfa, a.dim, false) || !flow_lin_ok(a.wf, a.dim, true))
    return (int)cudaErrorInvalidValue;
  const size_t smem = flow_smem(a.dmodel, a.dim, a.hid, a.latent, a.rows);
  cudaStream_t st = (cudaStream_t)stream;
  void* args[] = {&a};
  PTT_DISPATCH(dtype, T_, {
    auto kern = a.rows == 1 ? ptt::fused_flow_kernel<T_, true>
                            : ptt::fused_flow_kernel<T_, false>;
    int rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
    rc = (int)cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                          dim3(ptt::QD_THREADS), args, smem,
                                          st);
    if (rc) return rc;
  });
  return (int)cudaGetLastError();
}
