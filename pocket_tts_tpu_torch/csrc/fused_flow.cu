// K6: the whole flow net (SimpleMLPAdaLN) in one launch.
//
// Replaces the TPU kernel `pocket_tts_tpu/ops/fused_flow.py:_make_flow`
// (`_kernel`). For one conditioning row c (d_model), noise x (latent) and
// the time conditioning tc (dim):
//   sy   = silu(tc + c @ Wc)                     once: loop-invariant
//   h    = x @ Wi
//   per res block i < depth:
//     shift, scale, gate = sy @ Wa[i]
//     hn = LN(h; in_ln[i], eps 1e-6) * (1 + scale) + shift
//     h  = h + gate * (silu(hn @ W0[i]) @ W2[i])
//   shift, scale = sy @ Wfa
//   out  = (LN(h; final norm, eps 1e-6) * (1 + scale) + shift) @ Wf
// where "v @ W" is round(v) @ q * s + b in float32: the activations stay
// float32 between dots and each dot's operand is rounded to the working
// type first (the TPU kernel's `xb = x32.astype(dt)`). The output is
// rounded once. The large linears are int8; input_proj and final.linear
// may be plain weights of the working type (they can fall under the
// quantization size floor), read with unit scales.
//
// What bounds it on the H100: latency, not bytes. The weights are ~8.9 MB
// of int8 at full width (~2.7 us at full HBM bandwidth) but the net is a
// chain of dependent matrix-vector products. The TPU kernel keeps every
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
// LayerNorm itself, so only the matrix products are split across blocks.
// The float32 intermediates (sy, h, u, the modulations) live in a scratch
// buffer the caller allocates; reads after a barrier bypass L1 (__ldcg).
#include <cooperative_groups.h>

#include <algorithm>

#include "qdot.cuh"

namespace coop = cooperative_groups;

namespace ptt {

constexpr int FF_TILE = 32;  // columns per tile

struct FlowArgs {
  const void *x, *c, *tc;        // (latent,), (d_model,), (dim,)
  const void* wi;                // (latent, dim) int8 or plain
  const float* si;               // (dim,) or null for a plain wi
  const void* bi;                // (dim,) or null
  const int8_t* wc;              // (d_model, dim)
  const float* sc;
  const void* bc;
  const void *lns, *lnb;         // (depth, dim) or null
  const int8_t* wa;              // (depth, dim, 3 dim)
  const float* sa;               // (depth, 3 dim)
  const void* ba;                // (depth, 3 dim) or null
  const int8_t* w0;              // (depth, dim, hid)
  const float* s0;
  const void* b0;
  const int8_t* w2;              // (depth, hid, dim)
  const float* s2;
  const void* b2;
  const void *fns, *fnb;         // (dim,) or null
  const int8_t* wfa;             // (dim, 2 dim)
  const float* sfa;
  const void* bfa;
  const void* wf;                // (dim, latent) int8 or plain
  const float* sf;               // (latent,) or null for a plain wf
  const void* bf;
  float* scratch;                // sy | h | u | mods (see below)
  void* out;                     // (latent,)
  int latent, dmodel, dim, hid, depth;
};

// A linear's output column n: v * s[n] + b[n], unit scale / zero bias when
// absent. The bias has the working type T.
template <typename T>
__device__ __forceinline__ float lin_out(float v, const float* s,
                                         const void* b, int n) {
  return v * (s ? s[n] : 1.f) + opt((const T*)b, n, 0.f);
}

// tile_dot on a weight that is int8 (s != null) or plain T (s == null)
template <typename T, typename Epi>
__device__ __forceinline__ void any_dot(const float* xs, int K, const void* w,
                                        const float* s, int ldw, int n0,
                                        int ncols, float* red, Epi epi) {
  if (s)
    tile_dot(xs, K, 1, K, (const int8_t*)w, ldw, n0, ncols, FF_TILE / 4, red,
             epi);
  else
    tile_dot(xs, K, 1, K, (const T*)w, ldw, n0, ncols, FF_TILE / 4, red,
             epi);
}

template <typename T>
__global__ void __launch_bounds__(QD_THREADS) fused_flow_kernel(FlowArgs a) {
  extern __shared__ float smem[];
  const int dim = a.dim, hid = a.hid, depth = a.depth;
  float* red = smem;                 // QD_RED
  float* xs = red + QD_RED;          // one activation row (max width)
  float* sy = a.scratch;             // (dim)
  float* h = sy + dim;               // (dim)
  float* u = h + dim;                // (hid)
  float* mods = u + hid;             // depth x 3 dim, then 2 dim (final)
  coop::grid_group grid = coop::this_grid();
  const int tid = threadIdx.x, b = blockIdx.x, G = gridDim.x;
  const int nt_dim = (dim + FF_TILE - 1) / FF_TILE;

  // phase A: tiles [0, nt_dim) -> sy, [nt_dim, 2 nt_dim) -> h
  for (int t = b; t < 2 * nt_dim; t += G) {
    const bool cond = t < nt_dim;
    const int n0 = (cond ? t : t - nt_dim) * FF_TILE;
    const int K = cond ? a.dmodel : a.latent;
    const T* src = (const T*)(cond ? a.c : a.x);
    for (int i = tid; i < K; i += QD_THREADS) xs[i] = to_f(src[i]);
    __syncthreads();
    if (cond) {
      tile_dot(xs, K, 1, K, a.wc, dim, n0, min(FF_TILE, dim - n0),
               FF_TILE / 4, red, [&](int, int n, float v) {
                 sy[n] = silu_f(to_f(((const T*)a.tc)[n]) +
                                lin_out<T>(v, a.sc, a.bc, n));
               });
    } else {
      any_dot<T>(xs, K, a.wi, a.si, dim, n0, min(FF_TILE, dim - n0), red,
                 [&](int, int n, float v) { h[n] = lin_out<T>(v, a.si, a.bi, n); });
    }
  }
  grid.sync();

  // phase B: every modulation, from round(sy)
  const int n3 = 3 * dim, nt3 = (n3 + FF_TILE - 1) / FF_TILE;
  const int n2 = 2 * dim, nt2 = (n2 + FF_TILE - 1) / FF_TILE;
  if (b < depth * nt3 + nt2) {
    for (int i = tid; i < dim; i += QD_THREADS) xs[i] = rnd<T>(__ldcg(sy + i));
    __syncthreads();
    for (int t = b; t < depth * nt3 + nt2; t += G) {
      if (t < depth * nt3) {
        const int l = t / nt3, n0 = (t % nt3) * FF_TILE;
        const int8_t* w = a.wa + (size_t)l * dim * n3;
        const float* s = a.sa + l * n3;
        const T* bb = a.ba ? (const T*)a.ba + l * n3 : nullptr;
        float* m = mods + l * n3;
        tile_dot(xs, dim, 1, dim, w, n3, n0, min(FF_TILE, n3 - n0),
                 FF_TILE / 4, red, [&](int, int n, float v) {
                   m[n] = v * s[n] + opt(bb, n, 0.f);
                 });
      } else {
        const int n0 = (t - depth * nt3) * FF_TILE;
        float* m = mods + depth * n3;
        tile_dot(xs, dim, 1, dim, a.wfa, n2, n0, min(FF_TILE, n2 - n0),
                 FF_TILE / 4, red, [&](int, int n, float v) {
                   m[n] = lin_out<T>(v, a.sfa, a.bfa, n);
                 });
      }
    }
  }
  grid.sync();

  // LN(h) * (1 + scale) + shift, rounded, into xs (every block)
  auto modulated_ln = [&](const T* ns, const T* nb, const float* m) {
    block_layernorm(
        1, dim, 1e-6f, [&](int, int i) { return __ldcg(h + i); },
        [&](int, int i, float v) {
          const float hn = v * opt(ns, i, 1.f) + opt(nb, i, 0.f);
          xs[i] = rnd<T>(hn * (1.0f + __ldcg(m + dim + i)) + __ldcg(m + i));
        });
  };
  const int nt_hid = (hid + FF_TILE - 1) / FF_TILE;
  for (int l = 0; l < depth; ++l) {
    const float* m = mods + l * n3;
    if (b < nt_hid) {
      modulated_ln(a.lns ? (const T*)a.lns + l * dim : nullptr,
                   a.lnb ? (const T*)a.lnb + l * dim : nullptr, m);
      const int8_t* w = a.w0 + (size_t)l * dim * hid;
      const float* s = a.s0 + l * hid;
      const T* bb = a.b0 ? (const T*)a.b0 + l * hid : nullptr;
      for (int t = b; t < nt_hid; t += G) {
        const int n0 = t * FF_TILE;
        tile_dot(xs, dim, 1, dim, w, hid, n0, min(FF_TILE, hid - n0),
                 FF_TILE / 4, red, [&](int, int n, float v) {
                   u[n] = silu_f(v * s[n] + opt(bb, n, 0.f));
                 });
      }
    }
    grid.sync();
    if (b < nt_dim) {
      for (int i = tid; i < hid; i += QD_THREADS) xs[i] = rnd<T>(__ldcg(u + i));
      __syncthreads();
      const int8_t* w = a.w2 + (size_t)l * hid * dim;
      const float* s = a.s2 + l * dim;
      const T* bb = a.b2 ? (const T*)a.b2 + l * dim : nullptr;
      for (int t = b; t < nt_dim; t += G) {
        const int n0 = t * FF_TILE;
        tile_dot(xs, hid, 1, hid, w, dim, n0, min(FF_TILE, dim - n0),
                 FF_TILE / 4, red, [&](int, int n, float v) {
                   const float hh = v * s[n] + opt(bb, n, 0.f);
                   h[n] = __ldcg(h + n) + __ldcg(m + 2 * dim + n) * hh;
                 });
      }
    }
    grid.sync();
  }

  // head: the latent-wide output
  const int nt_lat = (a.latent + FF_TILE - 1) / FF_TILE;
  if (b < nt_lat) {
    modulated_ln((const T*)a.fns, (const T*)a.fnb, mods + depth * n3);
    T* out = (T*)a.out;
    for (int t = b; t < nt_lat; t += G) {
      const int n0 = t * FF_TILE;
      any_dot<T>(xs, dim, a.wf, a.sf, a.latent, n0,
                 min(FF_TILE, a.latent - n0), red, [&](int, int n, float v) {
                   out[n] = from_f<T>(lin_out<T>(v, a.sf, a.bf, n));
                 });
    }
  }
}

}  // namespace ptt

static size_t flow_smem(int dmodel, int dim, int hid, int latent) {
  const int w = std::max(std::max(dmodel, dim), std::max(hid, latent));
  return sizeof(float) * (ptt::QD_RED + (size_t)w);
}

// Largest cooperative grid K6 can take on this device. 0 on error.
extern "C" int ptt_fused_flow_max_blocks(int dmodel, int dim, int hid,
                                         int latent, int dtype) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return 0;
  const size_t smem = flow_smem(dmodel, dim, hid, latent);
  PTT_DISPATCH(dtype, T_, {
    auto kern = ptt::fused_flow_kernel<T_>;
    if (cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kern, ptt::QD_THREADS, smem))
      return 0;
  });
  return per_sm * sms;
}

// ptrs: x, c, tc, wi, si, bi, wc, sc, bc, lns, lnb, wa, sa, ba, w0, s0, b0,
//       w2, s2, b2, fns, fnb, wfa, sfa, bfa, wf, sf, bf, scratch, out
//       (device pointers; optional ones null; si / sf null for plain
//       weights). dims: latent, d_model, dim, hid, depth.
extern "C" int ptt_fused_flow(void* const* p, const int* dims, int grid,
                              int dtype, void* stream) {
  ptt::FlowArgs a{p[0], p[1], p[2], p[3], (const float*)p[4], p[5],
                  (const int8_t*)p[6], (const float*)p[7], p[8], p[9], p[10],
                  (const int8_t*)p[11], (const float*)p[12], p[13],
                  (const int8_t*)p[14], (const float*)p[15], p[16],
                  (const int8_t*)p[17], (const float*)p[18], p[19], p[20],
                  p[21], (const int8_t*)p[22], (const float*)p[23], p[24],
                  p[25], (const float*)p[26], p[27], (float*)p[28], p[29],
                  dims[0], dims[1], dims[2], dims[3], dims[4]};
  if (grid < 1 || a.dim % 4 || a.hid % 4 || a.latent % 4 || a.depth < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = flow_smem(a.dmodel, a.dim, a.hid, a.latent);
  cudaStream_t st = (cudaStream_t)stream;
  void* args[] = {&a};
  PTT_DISPATCH(dtype, T_, {
    auto kern = ptt::fused_flow_kernel<T_>;
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
