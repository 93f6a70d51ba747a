// K6: the whole flow net (SimpleMLPAdaLN), in two launches.
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
// for int8), but the residual blocks are a chain of 2 x depth + 2 dependent
// products of width 512. The first port ran the whole net as one
// cooperative launch with 2 + 2 x depth grid barriers: every barrier was
// paid by the whole grid (~116 of its blocks idle in every chain step), the
// activations went through HBM between steps, and 32 rows ran at 0.4% of
// the bound (360.94 us; 71.87 solo, chip_smoke.py on an NVIDIA H100 80GB
// HBM3 at 700 W).
//
// Design.
//   Launch 1, `flow_mods_kernel`: the modulations, which depend on sy only
//   (~5.2 MB of the 8.9 MB of int8 weights). Clusters of `csize` blocks;
//   block q of each cluster computes sy's columns [q * cws, ..) of every
//   row (cws = `ff_cols(dim, csize)`), the cluster gathers round(sy)
//   through distributed shared memory, and then the grid's blocks take the
//   32-column tiles of every Wa[i] and of Wfa in turn, into a float32
//   scratch (R, depth x 3 dim + 2 dim).
//   Launch 2, `flow_chain_kernel`: the chain, on ONE thread-block cluster
//   per row block: 16 blocks (non-portable) or 8 where the card cannot
//   place 16 (ops/fused_flow.py `flow_cluster`). Block q owns columns
//   [q * cw, ..) of h (cw = ff_cols(dim, csize)), of LN(h) modulated and of
//   u (ff_cols(hid, csize)) in its shared memory. Per residual block,
//   three `barrier.cluster` arrive/wait (cluster.sync), no grid barrier:
//   h and each block's (sum, M2) of its h columns published -> each block
//   combines the row statistics and modulates its own columns -> every
//   block gathers the modulated rows through distributed shared memory and
//   multiplies its W0 columns -> every block gathers u and multiplies its
//   W2 columns into its h columns; 3 x depth + 3 barriers in all (21 at
//   depth 6), on 16 SMs, with nothing through HBM but the modulations.
//   The W0 / W2 weights do not depend on the chain: each block keeps its
//   columns of the next `nslot` steps (with their scales, bias and
//   modulation columns) in flight by `cp.async` into a ring in shared
//   memory (int8 at full width: 16 KB a step a block; the whole chain, 3 MB
//   of int8 or 1.5 MB of int4, would take 192 or 96 KB a block beside 64
//   rows of activations, so a ring of 3, or 2 where it does not fit).
//   input_proj and final.linear (a few KB) are read from global memory.
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W): faster
// than the first port's single cooperative launch at 32 rows (280 against
// 361 us), slower solo (91 against 72): a residual block costs ~11 us at
// one row in barriers, gathers and SIMT products.
// Products: bf16 calls of 16 rows or more (ops/fused_flow.py
// FLOW_MMA_ROWS) run on the tensor cores (qmma.cuh: the weight columns widened to bf16 in shared memory, FF_KC
// logical rows at a time, `mma.sync.m16n8k16` with float32 accumulators,
// grouped scales per k16 step); smaller calls and float32 run tile_dot's
// SIMT products (qdot.cuh) on the same structure. Rows: a row block is at
// most 64 rows on the tensor cores, 16 on SIMT; more rows are more clusters
// in the same two launches.
#include <cooperative_groups.h>

#include <algorithm>

#include "qmma.cuh"

namespace coop = cooperative_groups;

namespace ptt {

constexpr int FF_THREADS = QD_THREADS;  // tile_dot, block_layernorm
constexpr int FF_MAX_CLUSTER = 16;
constexpr int FF_MAX_ROWS = 64;  // rows a row block
constexpr int FF_KC = 256;     // logical weight rows widened at once (MMA)
constexpr int FF_PASS = 32;    // output columns a pass (MMA)
constexpr int FF_BS_LD = FF_PASS + 8;
constexpr int FF_MTILE = 32;   // modulation columns a tile

// output columns a block takes when `parts` blocks share n (a multiple of 8)
__host__ __device__ inline int ff_cols(int n, int parts) {
  return ((n + parts - 1) / parts + 7) / 8 * 8;
}
__host__ __device__ inline int ff_up16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline bool ff_packed(const Lin& l) {
  return l.kind == LIN_INT4 || l.kind == LIN_INT4_G;
}

struct FlowArgs {
  const void *x, *c, *tc;        // (rows, latent), (rows, d_model), (dim,)
  Lin wi;                        // input_proj (latent, dim)
  Lin wc;                        // cond_embed (d_model, dim)
  const void *lns, *lnb;         // (depth, dim) or null
  Lin wa;                        // depth x (dim, 3 dim)
  Lin w0;                        // depth x (dim, hid)
  Lin w2;                        // depth x (hid, dim)
  const void *fns, *fnb;         // (dim,) or null
  Lin wfa;                       // (dim, 2 dim)
  Lin wf;                        // final.linear (dim, latent)
  float* mods;                   // (rows, depth x 3 dim + 2 dim) scratch
  void* out;                     // (rows, latent)
  int latent, dmodel, dim, hid, depth, rows;
  int rb;      // rows a row block (a cluster of each launch; <= 64, 16 SIMT)
  int csize;   // blocks a cluster
  int nslot;   // the chain's weight ring
};

// One slot of the chain's ring: what a chain block reads in one step,
// loaded ahead by cp.async. Offsets in bytes, the same for every slot:
//   w    its W0 or W2 columns (stored rows x cw; int8 or packed int4)
//   g    their grouped scales (K / group rows x cw, bf16), q4_0 only
//   pc   their per-channel scales (cw floats)
//   b    their bias (cw values of the working type)
//   m    W0 step of block l (and the head, step 2 x depth): shift and
//        scale of its h columns (2 x rb x cwd floats), then the norm's
//        scale and bias (2 x cwd values); W2 step: gate (rb x cwd floats)
struct FlowSlot {
  size_t w, g, pc, b, m, bytes;
};
__host__ __device__ inline size_t ff_a16(size_t n) {
  return (n + 15) / 16 * 16;
}
__host__ __device__ inline FlowSlot ff_slot(const FlowArgs& a) {
  const int cwd = ff_cols(a.dim, a.csize), cwh = ff_cols(a.hid, a.csize);
  const bool p4 = ff_packed(a.w0), g = a.w0.kind == LIN_INT4_G;
  const size_t s0 = (size_t)(p4 ? a.dim / 2 : a.dim) * cwh;
  const size_t s2 = (size_t)(p4 ? a.hid / 2 : a.hid) * cwd;
  const size_t g0 = g ? (size_t)(a.dim / a.w0.group) * cwh * 2 : 0;
  const size_t g2 = g ? (size_t)(a.hid / a.w0.group) * cwd * 2 : 0;
  const int cwm = cwd > cwh ? cwd : cwh;
  FlowSlot f;
  f.w = 0;
  f.g = ff_a16(s0 > s2 ? s0 : s2);
  f.pc = f.g + ff_a16(g0 > g2 ? g0 : g2);
  f.b = f.pc + 4 * (size_t)cwm;
  f.m = f.b + 4 * (size_t)cwm;
  f.bytes = f.m + 4 * (2 * (size_t)a.rb * cwd + 2 * (size_t)cwd);
  return f;
}

// rows x bytes from g (row stride ld bytes) to shared d (row stride dld),
// by every thread of the block with cp.async: 16 bytes a copy where every
// row and address allows, else 4
__device__ inline void ff_copy_rows(int8_t* d, int dld, const int8_t* g,
                                    size_t ld, int rows, int bytes) {
  const bool v16 = bytes % 16 == 0 && ld % 16 == 0 && dld % 16 == 0 &&
                   (size_t)g % 16 == 0;
  const int unit = v16 ? 16 : 4, per = bytes / unit;
  for (int i = threadIdx.x; i < rows * per; i += FF_THREADS) {
    const int r = i / per, u = (i - r * per) * unit;
    if (v16)
      cp_async16(d + (size_t)r * dld + u, g + (size_t)r * ld + u, true);
    else
      cp_async4(d + (size_t)r * dld + u, g + (size_t)r * ld + u, true);
  }
}

// wait until at most nslot - 2 of this thread's cp.async groups are in
// flight (nslot 2 or 3)
__device__ __forceinline__ void ff_wait_ring(int nslot) {
  if (nslot >= 3)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// The A operand and product workspace: bf16 rows (MMA) or float rows and
// tile_dot's partials (SIMT), for operands up to kmax wide.
inline size_t ff_work_smem(bool mma, int rb, int kmax) {
  if (mma)
    return 2 * (size_t)ff_up16(rb) * (ff_up16(kmax) + 8) +
           2 * (size_t)FF_KC * FF_BS_LD;
  return 4 * ((size_t)rb * kmax + QD_RED);
}
// h, the modulated LN and u of the block's columns, the ring, the workspace
inline size_t ff_chain_smem(const FlowArgs& a, bool mma) {
  const int kmax = std::max(std::max(a.dim, a.hid), a.latent);
  return 4 * (size_t)a.rb * (2 * ff_cols(a.dim, a.csize) +
                             ff_cols(a.hid, a.csize)) +
         (size_t)a.nslot * ff_slot(a).bytes + ff_work_smem(mma, a.rb, kmax);
}
// sy's columns and the workspace
inline size_t ff_mods_smem(const FlowArgs& a, bool mma) {
  return 4 * (size_t)a.rb * ff_cols(a.dim, a.csize) +
         ff_work_smem(mma, a.rb, std::max(a.dmodel, a.dim));
}

// The workspace of a block: A rows as the products read them.
template <typename T, bool MMA>
struct FlowWork {
  float* xs;     // SIMT: rows x ld floats, rounded to T
  float* red;    // SIMT: tile_dot's partials
  bf16* As;      // MMA: rows x lda
  bf16* Bs;      // MMA: FF_KC x FF_BS_LD widened weights
  int lda;

  __device__ FlowWork(unsigned char* base, int rb, int kmax) {
    if (MMA) {
      lda = ff_up16(kmax) + 8;
      As = reinterpret_cast<bf16*>(base);
      Bs = As + (size_t)ff_up16(rb) * lda;
      xs = red = nullptr;
    } else {
      lda = 0;
      xs = reinterpret_cast<float*>(base);
      red = xs + (size_t)rb * kmax;
      As = Bs = nullptr;
    }
  }
  __device__ void pad(int R, int K) {
    if (MMA) {
      const int w = ff_up16(K) - K;
      for (int i = threadIdx.x; i < R * w; i += FF_THREADS)
        As[(size_t)(i / w) * lda + K + i % w] = from_f<bf16>(0.f);
    }
  }
  // A[r][c..c+3] = round(v)
  __device__ __forceinline__ void put4(int r, int c, int K, float4 v) {
    if (MMA)
      *reinterpret_cast<uint2*>(As + (size_t)r * lda + c) =
          make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
    else
      *reinterpret_cast<float4*>(xs + (size_t)r * K + c) =
          make_float4(rnd<T>(v.x), rnd<T>(v.y), rnd<T>(v.z), rnd<T>(v.w));
  }
  // A[r][c..c+3] = round(f(r, c)) (a float4), r < R, c < K (K a multiple
  // of 4), four vectors a thread at once: every load of f issued before the
  // first store. Ends with __syncthreads().
  template <typename F>
  __device__ void stage4(int R, int K, F f) {
    pad(R, K);
    constexpr int B = 4;  // loads in flight a thread before the first store
    const int k4 = K / 4;
    if (FF_THREADS % k4 == 0) {
      // a fixed column group a thread (its source found once), rows r0,
      // r0 + step, ...
      const int c = threadIdx.x % k4 * 4, step = FF_THREADS / k4;
      for (int r0 = threadIdx.x / k4; r0 < R; r0 += B * step) {
        float4 v[B];
#pragma unroll
        for (int u = 0; u < B; ++u)
          if (r0 + u * step < R) v[u] = f(r0 + u * step, c);
#pragma unroll
        for (int u = 0; u < B; ++u)
          if (r0 + u * step < R) put4(r0 + u * step, c, K, v[u]);
      }
    } else {
      const int total = R * k4;
      for (int e0 = threadIdx.x; e0 < total; e0 += B * FF_THREADS) {
        float4 v[B];
#pragma unroll
        for (int u = 0; u < B; ++u) {
          const int e = e0 + u * FF_THREADS;
          if (e < total) v[u] = f(e / k4, e % k4 * 4);
        }
#pragma unroll
        for (int u = 0; u < B; ++u) {
          const int e = e0 + u * FF_THREADS;
          if (e < total) put4(e / k4, e % k4 * 4, K, v[u]);
        }
      }
    }
    __syncthreads();
  }
};

// A column slice [c0, c0 + nc) of a linear of logical shape (K, N), in
// global memory.
template <typename T>
__device__ inline QSlice global_slice(const Lin& l, int K, int N, int c0) {
  const bool grouped = l.kind == LIN_INT4_G;
  const void* w =
      l.kind == LIN_PLAIN ? (const void*)((const T*)l.w + c0)
                          : (const void*)((const int8_t*)l.w + c0);
  return QSlice{w, grouped ? (const bf16*)l.s + c0 : nullptr, l.kind, N, K,
                l.group};
}

// out(r, c, v) for r < R, c < nc (nc <= 64, a multiple of 8), v = the
// slice's float32 product with A's rows, times the per-channel scale pc[c]
// (or 1) plus the bias b[c] (or 0). Every thread of the block calls it.
template <typename T, bool MMA, typename Out>
__device__ void slice_product(FlowWork<T, MMA>& wk, int K, int R,
                              const QSlice& s, const float* pc, const T* b,
                              int nc, Out out) {
  auto fin = [&](int r, int c, float v) {
    out(r, c, v * (pc ? pc[c] : 1.f) + opt(b, c, 0.f));
  };
  if constexpr (!MMA) {
    const int cg = nc <= 32 ? 8 : 16;
    switch (s.kind) {
      case LIN_PLAIN:
        tile_dot(wk.xs, K, R, DenseW<T>{(const T*)s.w, s.ld, K}, 0, nc, cg,
                 wk.red, fin);
        break;
      case LIN_INT8:
        tile_dot(wk.xs, K, R, DenseW<int8_t>{(const int8_t*)s.w, s.ld, K}, 0,
                 nc, cg, wk.red, fin);
        break;
      default:
        tile_dot(wk.xs, K, R,
                 Int4W{(const int8_t*)s.w, s.ld, K / 2, K / 2, s.gs, s.group,
                       0, K / 2},
                 0, nc, cg, wk.red, fin);
    }
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nmt_all = (R + 15) / 16;
    // warp w: n8 fragment w % 4 of the pass, m16 tiles w / 4, w / 4 + 2
    const int nt = warp & 3;
    int mt[2] = {warp >> 2, (warp >> 2) + 2};
    const int nmt = (mt[0] < nmt_all) + (mt[1] < nmt_all);
    const bool grouped = s.kind == LIN_INT4_G;
    const int kc = min(FF_KC, ff_up16(K));
    for (int c0 = 0; c0 < nc; c0 += FF_PASS) {
      const int np = min(FF_PASS, nc - c0);
      QSlice sp = s;
      sp.w = s.kind == LIN_PLAIN ? (const void*)((const bf16*)s.w + c0)
                                 : (const void*)((const int8_t*)s.w + c0);
      if (grouped) sp.gs = s.gs + c0;
      const bool active = nt * 8 < np && nmt > 0;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int k0 = 0; k0 < K; k0 += kc) {
        const int nk = min(kc, ff_up16(K) - k0);
        __syncthreads();  // Bs consumed
        for (int i = threadIdx.x; i < nk * (np / 4); i += FF_THREADS) {
          const int r = i / (np / 4), c = i % (np / 4) * 4;
          if (k0 + r >= K)
            *reinterpret_cast<uint2*>(wk.Bs + (size_t)r * FF_BS_LD + c) =
                make_uint2(0u, 0u);
        }
        slice_to_bf16(sp, k0, min(nk, K - k0), np, wk.Bs, FF_BS_LD,
                      FF_THREADS);
        __syncthreads();
        if (active)
          mma_steps<2>(
              wk.As, wk.lda, mt, nmt, wk.Bs, FF_BS_LD, nt, nk / 16,
              [&](int ks) { return k0 + ks * 16; }, grouped,
              [&](int ks, int col) {
                return group_scale(sp, k0 + ks * 16, col);
              },
              acc);
      }
      if (active) {
        // this thread's two columns: their scales and biases loaded once
        const int c = c0 + nt * 8 + 2 * (lane & 3);
        const float s0 = pc ? pc[c] : 1.f, s1 = pc ? pc[c + 1] : 1.f;
        const float b0 = opt(b, c, 0.f), b1 = opt(b, c + 1, 0.f);
        for (int i = 0; i < nmt; ++i)
          for (int h = 0; h < 2; ++h) {
            const int r = mt[i] * 16 + lane / 4 + 8 * h;
            if (r < R) {
              out(r, c, acc[i][2 * h] * s0 + b0);
              out(r, c + 1, acc[i][2 * h + 1] * s1 + b1);
            }
          }
      }
    }
  }
}

// Launch 1: sy, then the modulations of every row of this row block.
template <typename T, bool MMA, bool SOLO>
__global__ void __launch_bounds__(FF_THREADS) flow_mods_kernel(FlowArgs a) {
  extern __shared__ __align__(16) unsigned char ff_shared[];
  __shared__ const float* peer[FF_MAX_CLUSTER];
  coop::cluster_group cluster = coop::this_cluster();
  const int C = a.csize, q = (int)cluster.block_rank();
  // SOLO: one row, known at compile time, so the row loops of the
  // products fold away
  const int r0 = blockIdx.y * a.rb, R = SOLO ? 1 : min(a.rb, a.rows - r0);
  const int dim = a.dim, cws = ff_cols(dim, C);
  float* syq = reinterpret_cast<float*>(ff_shared);   // rb x cws
  FlowWork<T, MMA> wk(ff_shared + 4 * (size_t)a.rb * cws, a.rb,
                      max(a.dmodel, dim));
  if ((int)threadIdx.x < C)
    peer[threadIdx.x] = cluster.map_shared_rank(syq, (int)threadIdx.x);

  // sy columns [q * cws, ..) of every row: silu(tc + round(c) @ Wc)
  const T* c = (const T*)a.c + (size_t)r0 * a.dmodel;
  wk.stage4(R, a.dmodel,
            [&](int r, int i) { return load4(c + (size_t)r * a.dmodel + i); });
  const int c0 = q * cws, nc = min(cws, dim - c0);
  if (nc > 0) {
    const T* tc = (const T*)a.tc + c0;
    slice_product(wk, a.dmodel, R, global_slice<T>(a.wc, a.dmodel, dim, c0),
                  a.wc.kind == LIN_INT4_G ? nullptr
                                          : (const float*)a.wc.s + c0,
                  a.wc.b ? (const T*)a.wc.b + c0 : nullptr, nc,
                  [&](int r, int n, float v) {
                    syq[r * cws + n] = silu_f(to_f(tc[n]) + v);
                  });
  }
  cluster.sync();
  // round(sy) of every row, from the cluster's blocks
  wk.stage4(R, dim, [&](int r, int i) {
    return *reinterpret_cast<const float4*>(peer[i / cws] + r * cws +
                                            i % cws);
  });
  cluster.sync();  // every block has read every other's sy columns

  // the modulation tiles: depth x (dim, 3 dim), then (dim, 2 dim)
  const int n3 = 3 * dim, n2 = 2 * dim, ms = a.depth * n3 + n2;
  const int nt3 = (n3 + FF_MTILE - 1) / FF_MTILE;
  const int nt2 = (n2 + FF_MTILE - 1) / FF_MTILE;
  const int nblocks = gridDim.x;
  for (int t = blockIdx.x; t < a.depth * nt3 + nt2; t += nblocks) {
    const bool fin = t >= a.depth * nt3;
    const int l = fin ? 0 : t / nt3;
    const int N = fin ? n2 : n3;
    const int m0 = (fin ? t - a.depth * nt3 : t % nt3) * FF_MTILE;
    const Lin w = fin ? a.wfa : lin_at<T>(a.wa, l, dim, n3);
    float* dst = a.mods + (size_t)r0 * ms + (fin ? a.depth * n3 : l * n3) + m0;
    slice_product(wk, dim, R, global_slice<T>(w, dim, N, m0),
                  w.kind == LIN_INT4_G ? nullptr : (const float*)w.s + m0,
                  w.b ? (const T*)w.b + m0 : nullptr, min(FF_MTILE, N - m0),
                  [&](int r, int n, float v) { dst[(size_t)r * ms + n] = v; });
  }
}

// Launch 2: the chain of one row block on one cluster. Per residual block
// three cluster barriers: h and its row statistics published -> each block
// modulates its own h columns (LN with the combined statistics, the
// block's shift and scale from its ring slot) -> every block gathers the
// modulated rows and multiplies its W0 columns -> every block gathers u
// and multiplies its W2 columns into h. Nothing in a step waits on global
// memory: weights, scales, biases and modulation columns arrive by cp.async
// `nslot` steps ahead.
template <typename T, bool MMA, bool SOLO>
__global__ void __launch_bounds__(FF_THREADS) flow_chain_kernel(FlowArgs a) {
  extern __shared__ __align__(16) unsigned char ff_shared[];
  __shared__ const float* peer_h[FF_MAX_CLUSTER];
  __shared__ const float* peer_a[FF_MAX_CLUSTER];
  __shared__ const float* peer_u[FF_MAX_CLUSTER];
  __shared__ const float* peer_st[FF_MAX_CLUSTER];
  // this block's (sum, sum of squares about their mean) of its h columns,
  // and each row's (mean, rstd), a row of the row block
  __shared__ float stq[FF_MAX_ROWS][2];
  __shared__ float rowst[FF_MAX_ROWS][2];
  coop::cluster_group cluster = coop::this_cluster();
  const int C = a.csize, q = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // SOLO: one row, known at compile time, so the row loops of the
  // products fold away
  const int r0 = blockIdx.y * a.rb, R = SOLO ? 1 : min(a.rb, a.rows - r0);
  const int dim = a.dim, hid = a.hid, depth = a.depth;
  const int cwd = ff_cols(dim, C), cwh = ff_cols(hid, C);
  const int cwl = ff_cols(a.latent, C);
  const int n3 = 3 * dim, ms = depth * n3 + 2 * dim;
  const int cd0 = q * cwd, ncd = min(cwd, dim - cd0);   // my h columns
  const int ch0 = q * cwh, nch = min(cwh, hid - ch0);   // my u columns
  float* hq = reinterpret_cast<float*>(ff_shared);    // rb x cwd: h
  float* aq = hq + (size_t)a.rb * cwd;                // rb x cwd: LN(h)
  float* uq = aq + (size_t)a.rb * cwd;                // rb x cwh: u
  int8_t* slots = reinterpret_cast<int8_t*>(uq + (size_t)a.rb * cwh);
  const FlowSlot sl = ff_slot(a);
  FlowWork<T, MMA> wk(reinterpret_cast<unsigned char*>(slots) +
                          a.nslot * sl.bytes,
                      a.rb, max(max(dim, hid), a.latent));
  if (tid < C) {
    peer_h[tid] = cluster.map_shared_rank(hq, tid);
    peer_a[tid] = cluster.map_shared_rank(aq, tid);
    peer_u[tid] = cluster.map_shared_rank(uq, tid);
    peer_st[tid] = cluster.map_shared_rank(&stq[0][0], tid);
  }
  const float* mods = a.mods + (size_t)r0 * ms;

  // step s < 2 depth: W0[s / 2] (even) or W2[s / 2] (odd); 2 depth: the
  // head's modulation
  const int nsteps = 2 * depth + 1;
  auto big = [&](int s, Lin& w, int& K, int& N, int& cw) {
    const bool up = s % 2 == 0;
    K = up ? dim : hid;
    N = up ? hid : dim;
    cw = up ? cwh : cwd;
    w = lin_at<T>(up ? a.w0 : a.w2, s / 2, K, N);
  };
  // n bytes from g to d (both 16-byte aligned when v16, else 4)
  auto copy = [&](int8_t* d, const void* g, int n, bool v16) {
    const int unit = v16 ? 16 : 4;
    for (int i = tid * unit; i < n; i += FF_THREADS * unit) {
      if (v16)
        cp_async16(d + i, (const int8_t*)g + i, true);
      else
        cp_async4(d + i, (const int8_t*)g + i, true);
    }
  };
  auto slot = [&](int s) { return slots + (size_t)(s % a.nslot) * sl.bytes; };
  auto fill = [&](int s) {
    if (s >= nsteps) return;
    int8_t* d = slot(s);
    const size_t tsz = sizeof(T);
    if (s < 2 * depth) {
      Lin w;
      int K, N, cw;
      big(s, w, K, N, cw);
      const int c0 = q * cw, nc = min(cw, N - c0);
      if (nc > 0) {
        const bool p4 = ff_packed(w);
        ff_copy_rows(d + sl.w, cw, (const int8_t*)w.w + c0, N,
                  p4 ? K / 2 : K, nc);
        if (w.kind == LIN_INT4_G)
          ff_copy_rows(d + sl.g, 2 * cw, (const int8_t*)w.s + 2 * (size_t)c0,
                    2 * (size_t)N, K / w.group, 2 * nc);
        else
          copy(d + sl.pc, (const float*)w.s + c0, 4 * nc, true);
        if (w.b) copy(d + sl.b, (const T*)w.b + c0, (int)tsz * nc, true);
      }
    }
    if (ncd <= 0) return;
    const int l = s / 2;
    if (s % 2 == 1) {  // W2: gate
      ff_copy_rows(d + sl.m, 4 * cwd,
                (const int8_t*)(mods + l * n3 + 2 * dim + cd0), 4 * (size_t)ms,
                R, 4 * ncd);
      return;
    }
    // W0 of block l, or the head: shift, scale, norm scale and bias
    const int moff = s < 2 * depth ? l * n3 : depth * n3;
    const T* ns = s < 2 * depth
                      ? (a.lns ? (const T*)a.lns + l * dim : nullptr)
                      : (const T*)a.fns;
    const T* nb = s < 2 * depth
                      ? (a.lnb ? (const T*)a.lnb + l * dim : nullptr)
                      : (const T*)a.fnb;
    ff_copy_rows(d + sl.m, 4 * cwd, (const int8_t*)(mods + moff + cd0),
              4 * (size_t)ms, R, 4 * ncd);
    ff_copy_rows(d + sl.m + 4 * (size_t)a.rb * cwd, 4 * cwd,
              (const int8_t*)(mods + moff + dim + cd0), 4 * (size_t)ms, R,
              4 * ncd);
    int8_t* nd = d + sl.m + 8 * (size_t)a.rb * cwd;
    if (ns) copy(nd, ns + cd0, (int)tsz * ncd, true);
    if (nb) copy(nd + 4 * cwd, nb + cd0, (int)tsz * ncd, true);
  };
  auto slot_slice = [&](int s, const Lin& w, int K, int cw) {
    const int8_t* base = slot(s);
    return QSlice{base + sl.w,
                  w.kind == LIN_INT4_G
                      ? reinterpret_cast<const bf16*>(base + sl.g)
                      : nullptr,
                  w.kind, cw, K, w.group};
  };
  // per row, the sum of my h columns and their squared deviations from
  // their own mean, published with the next cluster barrier
  auto publish_stats = [&]() {
    __syncthreads();  // my h columns are written
    for (int r = warp; r < R; r += QD_WARPS) {
      float sum = 0.f;
      for (int c = lane; c < ncd; c += 32) sum += hq[r * cwd + c];
      sum = warp_sum(sum);
      const float mq = ncd > 0 ? sum / (float)ncd : 0.f;
      float m2 = 0.f;
      for (int c = lane; c < ncd; c += 32) {
        const float d = hq[r * cwd + c] - mq;
        m2 += d * d;
      }
      m2 = warp_sum(m2);
      if (lane == 0) {
        stq[r][0] = sum;
        stq[r][1] = m2;
      }
    }
  };
  // My columns of round(LN(h) * ns + nb) * (1 + scale) + shift) into aq:
  // the LayerNorm statistics of h combined from every block's pairs (a
  // warp a row; lane j takes block j's; mean = sum / dim, M2 = sum of M2_j
  // + n_j (mean_j - mean)^2, in a fixed tree), without walking h three
  // times through distributed shared memory.
  auto modulate = [&](int s) {
    for (int r = warp; r < R; r += QD_WARPS) {
      const int nj = lane < C ? min(cwd, dim - lane * cwd) : 0;
      const float sj = nj > 0 ? peer_st[lane][2 * r] : 0.f;
      const float m2j = nj > 0 ? peer_st[lane][2 * r + 1] : 0.f;
      const float mean = warp_sum(sj) / (float)dim;
      const float d = nj > 0 ? sj / (float)nj - mean : 0.f;
      const float m2 = warp_sum(m2j + (float)nj * d * d);
      if (lane == 0) {
        rowst[r][0] = mean;
        rowst[r][1] = 1.0f / sqrtf(m2 / (float)dim + 1e-6f);
      }
    }
    __syncthreads();
    const int8_t* m = slot(s) + sl.m;
    const float* shift = reinterpret_cast<const float*>(m);
    const float* scale = shift + (size_t)a.rb * cwd;
    const bool up = s < 2 * depth;
    const bool has_ns = up ? a.lns != nullptr : a.fns != nullptr;
    const bool has_nb = up ? a.lnb != nullptr : a.fnb != nullptr;
    const T* ns = reinterpret_cast<const T*>(m + 8 * (size_t)a.rb * cwd);
    const T* nb = reinterpret_cast<const T*>(m + 8 * (size_t)a.rb * cwd +
                                             4 * cwd);
    for (int i = tid; i < R * ncd; i += FF_THREADS) {
      const int r = i / ncd, c = i - r * ncd;
      const float v = (hq[r * cwd + c] - rowst[r][0]) * rowst[r][1];
      const float hn = v * (has_ns ? to_f(ns[c]) : 1.f) +
                       (has_nb ? to_f(nb[c]) : 0.f);
      aq[r * cwd + c] = rnd<T>(hn * (1.0f + scale[r * cwd + c]) +
                               shift[r * cwd + c]);
    }
  };
  // A = full rows of a buffer split over the blocks by cw columns
  auto gather = [&](const float* const* peer, int K, int cw) {
    wk.stage4(R, K, [&](int r, int i) {
      return *reinterpret_cast<const float4*>(peer[i / cw] + r * cw +
                                              i % cw);
    });
  };
  auto step_lin = [&](int s, const Lin& w, int K, int cw, int nc, auto out) {
    const int8_t* base = slot(s);
    slice_product(wk, K, R, slot_slice(s, w, K, cw),
                  w.kind == LIN_INT4_G
                      ? nullptr : reinterpret_cast<const float*>(base + sl.pc),
                  w.b ? reinterpret_cast<const T*>(base + sl.b) : nullptr, nc,
                  out);
  };

  for (int s = 0; s < a.nslot; ++s) {
    fill(s);
    cp_async_commit();  // one group a step, empty past the end
  }
  // (step s > 0 commits the group of step s - 1 + nslot after its
  // barrier: at step s's wait, nslot + s - 1 groups are committed, and
  // groups 0..s have landed when at most nslot - 2 are in flight)

  // h = round(x) @ Wi: my columns
  {
    const T* x = (const T*)a.x + (size_t)r0 * a.latent;
    wk.stage4(R, a.latent,
              [&](int r, int i) {
                return load4(x + (size_t)r * a.latent + i);
              });
    if (ncd > 0)
      slice_product(wk, a.latent, R,
                    global_slice<T>(a.wi, a.latent, dim, cd0),
                    (a.wi.kind == LIN_INT8 || a.wi.kind == LIN_INT4)
                        ? (const float*)a.wi.s + cd0 : nullptr,
                    a.wi.b ? (const T*)a.wi.b + cd0 : nullptr, ncd,
                    [&](int r, int n, float v) { hq[r * cwd + n] = v; });
    publish_stats();
  }

  for (int s = 0; s < nsteps; ++s) {
    ff_wait_ring(a.nslot);  // step s's slot has landed
    cluster.sync();         // h (or u) and the statistics are published
    // the slot step s - 1 used is free: the step nslot after it
    if (s > 0) {
      fill(s - 1 + a.nslot);
      cp_async_commit();
    }
    if (s % 2 == 0) {
      modulate(s);
      cluster.sync();       // every block's LN columns are written
    }
    if (s == 2 * depth) break;  // the head, below
    Lin w;
    int K, N, cw;
    big(s, w, K, N, cw);
    if (s % 2 == 0) {
      gather(peer_a, dim, cwd);
      if (nch > 0)
        step_lin(s, w, K, cw, nch,
                 [&](int r, int n, float v) { uq[r * cwh + n] = silu_f(v); });
    } else {
      gather(peer_u, hid, cwh);
      const float* gate = reinterpret_cast<const float*>(slot(s) + sl.m);
      if (ncd > 0)
        step_lin(s, w, K, cw, ncd, [&](int r, int n, float v) {
          hq[r * cwd + n] += gate[r * cwd + n] * v;
        });
      publish_stats();
    }
  }

  // the head: my latent columns of the modulated rows @ Wf
  gather(peer_a, dim, cwd);
  const int c0 = q * cwl, nc = min(cwl, a.latent - c0);
  if (nc > 0) {
    T* out = (T*)a.out + (size_t)r0 * a.latent + c0;
    slice_product(wk, dim, R, global_slice<T>(a.wf, dim, a.latent, c0),
                  (a.wf.kind == LIN_INT8 || a.wf.kind == LIN_INT4)
                      ? (const float*)a.wf.s + c0 : nullptr,
                  a.wf.b ? (const T*)a.wf.b + c0 : nullptr, nc,
                  [&](int r, int n, float v) {
                    out[(size_t)r * a.latent + n] = from_f<T>(v);
                  });
  }
  cp_async_wait<0>();
  cluster.sync();  // no block leaves while its LN columns are read
}

}  // namespace ptt

// A linear of logical shape (K, N) K6 takes: quantized (int8, int4 in
// either scale layout) or, when `plain_ok`, a plain weight; on the tensor
// cores grouped scales come in groups of a multiple of 16 rows.
static bool flow_lin_ok(const ptt::Lin& l, int K, bool plain_ok, bool mma) {
  switch (l.kind) {
    case ptt::LIN_PLAIN: return plain_ok && l.s == nullptr;
    case ptt::LIN_INT8: return l.s != nullptr;
    case ptt::LIN_INT4: return l.s != nullptr && K % 2 == 0;
    case ptt::LIN_INT4_G:
      return l.s != nullptr && l.group > 0 && K % 2 == 0 &&
             (K / 2) % l.group == 0 && (!mma || l.group % 16 == 0);
    default: return false;
  }
}

// f(chain kernel, modulation kernel) for a dtype code, product route (the
// tensor cores take bf16 only) and solo (one row).
template <typename F>
static int ff_dispatch(int dtype, int mma, int solo, F f) {
  if (dtype == 1 && mma)
    return f(ptt::flow_chain_kernel<ptt::bf16, true, false>,
             ptt::flow_mods_kernel<ptt::bf16, true, false>);
  if (dtype == 1 && solo)
    return f(ptt::flow_chain_kernel<ptt::bf16, false, true>,
             ptt::flow_mods_kernel<ptt::bf16, false, true>);
  if (dtype == 1)
    return f(ptt::flow_chain_kernel<ptt::bf16, false, false>,
             ptt::flow_mods_kernel<ptt::bf16, false, false>);
  if (dtype == 0 && !mma && solo)
    return f(ptt::flow_chain_kernel<float, false, true>,
             ptt::flow_mods_kernel<float, false, true>);
  if (dtype == 0 && !mma)
    return f(ptt::flow_chain_kernel<float, false, false>,
             ptt::flow_mods_kernel<float, false, false>);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory and (csize > 8) the non-portable cluster size.
static cudaError_t ff_prepare(void (*kern)(ptt::FlowArgs), size_t smem,
                              int csize) {
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc == cudaSuccess && csize > 8)
    rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return rc;
}

static cudaLaunchConfig_t ff_config(dim3 grid, size_t smem,
                                    cudaStream_t st,
                                    cudaLaunchAttribute* attr, int csize) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(ptt::FF_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `csize` blocks the card can hold at once for the chain
// kernel with chain_smem bytes of dynamic shared memory and the modulation
// kernel with mods_smem (the smaller of the two); 0 when it cannot place
// one, or on error.
extern "C" int ptt_flow_max_clusters(int csize, int chain_smem, int mods_smem,
                                     int mma, int solo, int dtype) {
  int best = 1 << 30;
  const int rc = ff_dispatch(dtype, mma, solo, [&](auto chain, auto mods) {
    void (*kerns[2])(ptt::FlowArgs) = {chain, mods};
    const int smem[2] = {chain_smem, mods_smem};
    for (int i = 0; i < 2; ++i) {
      cudaLaunchAttribute attr[1];
      cudaLaunchConfig_t cfg =
          ff_config(dim3(csize), smem[i], nullptr, attr, csize);
      int n = 0;
      if (ff_prepare(kerns[i], smem[i], csize) != cudaSuccess ||
          cudaOccupancyMaxActiveClusters(&n, kerns[i], &cfg) != cudaSuccess)
        return 1;
      best = std::min(best, n);
    }
    return 0;
  });
  cudaGetLastError();  // a refused size is an answer, not a sticky error
  return rc ? 0 : best;
}

// p: x, c, tc, then (w, scale, bias) of input_proj and cond_embed, in_ln
//    scale and bias, (w, scale, bias) of adaln, mlp_0 and mlp_2 (stacked
//    over depth), final norm scale and bias, (w, scale, bias) of the final
//    adaln and final.linear, then the modulation scratch (rows x (depth x 3
//    dim + 2 dim) floats) and out (device pointers; optional ones null).
// ints: latent, d_model, dim, hid, depth, rows, then (kind, group) of
//    input_proj, cond_embed, adaln, mlp_0, mlp_2, final adaln,
//    final.linear, then the plan (ops/fused_flow.py `flow_plan`): rows a
//    row block, blocks a cluster, the chain's ring slots, modulation
//    clusters, tensor cores (0/1).
// Two launches: the modulations, then the chain.
extern "C" int ptt_fused_flow(void* const* p, const int* ints, int dtype,
                              void* stream) {
  const int* k = ints + 6;
  const int* plan = ints + 20;
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
                  ints[0], ints[1], ints[2], ints[3], ints[4], ints[5],
                  plan[0], plan[1], plan[2]};
  const int ncl = plan[3], mma = plan[4];
  if (a.dim % 8 || a.hid % 8 || a.latent % 8 || a.dmodel % 4 ||
      a.depth < 1 || a.rows < 1 || a.rb < 1 ||
      a.rb > (mma ? ptt::FF_MAX_ROWS : 16) ||
      a.csize < 1 || a.csize > ptt::FF_MAX_CLUSTER || a.nslot < 2 ||
      a.nslot > 3 || ncl < 1 || (mma && dtype != 1) ||
      !flow_lin_ok(a.wi, a.latent, true, mma) ||
      !flow_lin_ok(a.wc, a.dmodel, false, mma) ||
      !flow_lin_ok(a.wa, a.dim, false, mma) ||
      !flow_lin_ok(a.w0, a.dim, false, mma) ||
      !flow_lin_ok(a.w2, a.hid, false, mma) ||
      a.w0.kind != a.w2.kind ||
      !flow_lin_ok(a.wfa, a.dim, false, mma) ||
      !flow_lin_ok(a.wf, a.dim, true, mma) ||
      ptt::ff_cols(std::max(a.dim, a.hid), a.csize) > 64)
    return (int)cudaErrorInvalidValue;
  const size_t chain_smem = ptt::ff_chain_smem(a, mma);
  const size_t mods_smem = ptt::ff_mods_smem(a, mma);
  // the dynamic shared memory a block can take beside the kernels' static
  // peer tables
  constexpr size_t limit = 232448 - 2048;
  if (chain_smem > limit || mods_smem > limit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nrb = (a.rows + a.rb - 1) / a.rb;
  return ff_dispatch(dtype, mma, a.rows == 1, [&](auto chain, auto mods) {
    cudaLaunchAttribute attr[1];
    cudaError_t rc = ff_prepare(mods, mods_smem, a.csize);
    if (rc != cudaSuccess) return (int)rc;
    cudaLaunchConfig_t cfg = ff_config(dim3(a.csize * ncl, nrb), mods_smem,
                                       st, attr, a.csize);
    rc = cudaLaunchKernelEx(&cfg, mods, a);
    if (rc != cudaSuccess) return (int)rc;
    rc = ff_prepare(chain, chain_smem, a.csize);
    if (rc != cudaSuccess) return (int)rc;
    cfg = ff_config(dim3(a.csize, nrb), chain_smem, st, attr, a.csize);
    rc = cudaLaunchKernelEx(&cfg, chain, a);
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaGetLastError();
  });
}
