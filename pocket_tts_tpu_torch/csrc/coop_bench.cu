// Measurements behind the design of the cooperative layer tail
// (layer_post.cuh, which K5b, K5c and K8 run); chip_smoke.py
// --kernel-times times them. The port launches none of these kernels.
//
// 1. The MLP's down projection and its cross-block sum, two ways, as one
// cooperative launch each at T = 1: the layer tail's own way against W2
// split by output columns. Both start from h (H,) and x1 (dm,) in global
// memory and end with
//   y = round(x1 + ls2 * ((h @ W2) * s2 + b2))
// and both take the same W2 bytes into shared memory at entry by the TMA.
//
//   mode 0, "rows" (the kernels' own): block b takes MLP tiles b, b + grid,
//     ...: W2's rows of the tile (issue_w2) and the tile's h units, its
//     partial of up over all dm columns (w2_dot) to p2[b]; a grid barrier;
//     the grid's partials summed per element by warps (mlp_finish).
//   mode 1, "cols" (the alternative): block b writes the h units of its
//     MLP tiles to hg, as the MLP phase would have computed them; a grid
//     barrier; every block stages all of h and takes column units of W2
//     (32 output columns over a slice of H / ks stored rows: issue_cols,
//     cols_phase). ks = 1: each unit's sums are whole, and y follows at
//     once; else slice partials to p3, a second grid barrier and their sum
//     in slice order.
//
// 2. What a grid barrier costs: a cooperative launch of n grid.sync()
// calls; the same with a cluster dimension and a cluster barrier after
// each (whether a cooperative launch takes a cluster at all); and a
// hand-written barrier (one arrival counter, release / acquire).
#include <cooperative_groups.h>

#include "layer_post.cuh"

namespace coop = cooperative_groups;

namespace ptt {

struct FinishArgs {
  Tail t;            // T = 1: x1, ls2, W2, the row partials p2, fin_e, o_w2
  CUtensorMap tm_w2;  // W2 in column units (mode 1)
  const float* h;    // (H,) float32, rounded as the MLP phase rounds it
  float* hg;         // (H,) scratch (mode 1)
  float* p3;         // (ks, dm) slice partials (mode 1)
  void* y;           // (dm,)
  int mode, ks, o_act;
};

template <typename T>
__global__ void __launch_bounds__(QD_THREADS)
    finish_bench_kernel(const __grid_constant__ FinishArgs a) {
  extern __shared__ __align__(128) unsigned char fb_shared[];
  __shared__ __align__(8) uint64_t bar[1];
  unsigned char* smem = align128(fb_shared);
  const Tail& t = a.t;
  const int dm = t.dm, H = t.H, tid = threadIdx.x;
  float* xs = reinterpret_cast<float*>(smem + a.o_act);  // H
  float* red = xs + H;                                    // CP_RED
  float* outs = red + CP_RED;                             // FL_TILE
  coop::grid_group grid = coop::this_grid();
  T* y = (T*)a.y;
  if (tid == 0 && a.mode) prefetch_map(&a.tm_w2);
  mbar_setup(bar, 1);

  if (a.mode == 0) {
    issue_w2(t, smem, bar);
    cp_async_commit();
    const bool p4 = packed(t.w2);
    const int b2 = w2_tile_bytes(t.w2.kind, dm);
    float* mine = t.p2 + (size_t)blockIdx.x * dm;
    int i = 0;
    for (int u = blockIdx.x; u < H / FL_TILE; u += gridDim.x, ++i) {
      if (tid < FL_TILE)  // the tile's h units in mlp_phase's column order
        xs[tid] = a.h[p4 ? (tid < 16 ? 16 * u + tid : H / 2 + 16 * u + tid - 16)
                         : 32 * u + tid];
      if (i == 0)
        wait_phase(bar, 0);
      else
        __syncthreads();
      w2_dot<1>(xs, 1, dm, smem + t.o_w2 + (size_t)i * b2, t.w2.kind, mine,
                i == 0);
      __syncthreads();
    }
    if (i == 0)
      for (int j = tid; j < dm; j += QD_THREADS) mine[j] = 0.f;
    grid.sync();
    mlp_finish<T>(t, [&](int n, float v) { y[n] = from_f<T>(v); });
    return;
  }

  issue_cols(t.w2, &a.tm_w2, H, dm, a.ks, smem, bar);
  cp_async_commit();
  for (int u = blockIdx.x; u < H / FL_TILE; u += gridDim.x)
    if (tid < FL_TILE) a.hg[FL_TILE * u + tid] = a.h[FL_TILE * u + tid];
  grid.sync();
  stage_floats(xs, a.hg, H);
  wait_phase(bar, 0);
  const float* s2 = t.w2.kind == LIN_INT4_G ? nullptr : (const float*)t.w2.s;
  const T* b2 = (const T*)t.w2.b;
  const T* ls2 = (const T*)t.ls2;
  auto fin = [&](int n, float v) {
    y[n] = from_f<T>(t.x1[n] + opt(ls2, n, 1.f) *
                                   (v * (s2 ? s2[n] : 1.f) + opt(b2, n, 0.f)));
  };
  if (a.ks == 1) {
    cols_phase(t.w2, H, dm, 1, smem, xs, nullptr, H, 1, red, outs,
               [&](int, int, int n, float v) { fin(n, v); });
    return;
  }
  float* p3 = a.p3;
  cols_phase(t.w2, H, dm, a.ks, smem, xs, nullptr, H, 1, red, outs,
             [&](int q, int, int n, float v) { p3[q * dm + n] = v; });
  grid.sync();
  for (int n = blockIdx.x * QD_THREADS + tid; n < dm;
       n += gridDim.x * QD_THREADS) {
    float p[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)  // every slice's load before the first add
      if (q < a.ks) p[q] = __ldcg(p3 + q * dm + n);
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < a.ks) v += p[q];
    fin(n, v);
  }
}

}  // namespace ptt

// p: h (H,) float32, x1 (dm,) float32, ls2 (dm,) or null, W2 (w, scale,
// bias), the row partials (grid, dm), hg (H,), p3 (ks, dm), y (dm,).
// lin: W2's (kind, group). plan: mode, grid, ks, fin_e, shared memory in
// bytes, o_act (the weights at 0).
extern "C" int ptt_finish_bench(void* const* p, const int* lin,
                                const int* plan, int dm, int H, int dtype,
                                void* stream) {
  using namespace ptt;
  const int mode = plan[0], grid = plan[1], ks = plan[2], smem = plan[4];
  Tail t{{}, {}, nullptr, nullptr, p[2], nullptr, nullptr, {}, {},
         {p[3], p[4], p[5], lin[0], lin[1]}, nullptr, (float*)p[6],
         (float*)p[1], nullptr, 1, dm, H, 1, plan[3], 0, 1, 0.f, 0, 0, 0};
  FinishArgs a{t, {}, (const float*)p[0], (float*)p[7], (float*)p[8], p[9],
               mode, ks, plan[5]};
  const bool p4 = packed(t.w2);
  const int stored = p4 ? H / 2 : H;
  if (dm < FL_TILE || dm % FL_TILE || H % FL_TILE || grid < 1 ||
      grid > H / FL_TILE || !(mode == 0 || mode == 1) ||
      !(ks == 1 || ks == 2 || ks == 4 || ks == 8) || (stored / ks) % 32 ||
      !t.w2.s || (lin[0] == LIN_INT4_G && (lin[1] < 1 ||
                                           (stored / ks) % lin[1])) ||
      !(plan[3] == 1 || plan[3] == 2 || plan[3] == 4 || plan[3] == 8))
    return (int)cudaErrorInvalidValue;
  Region r[2];
  r[0] = {0, cdiv(H / FL_TILE, grid), w2_tile_bytes(lin[0], dm)};
  if (mode)
    r[0] = {0, cdiv(dm / FL_TILE * ks, grid),
            col_unit_bytes(lin[0], H, ks, lin[1])};
  r[1] = {plan[5], 1, 4 * (H + CP_RED + FL_TILE)};
  if (!regions_ok(r, 2, smem) ||
      (mode && encode_lin(&a.tm_w2, t.w2, H, dm, ks, 32)))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&a};
  PTT_DISPATCH(dtype, T_, {
    const void* kern = (const void*)finish_bench_kernel<T_>;
    int rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc) return rc;
    rc = (int)cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(QD_THREADS),
                                          args, smem, (cudaStream_t)stream);
    if (rc) return rc;
  });
  return (int)cudaGetLastError();
}

namespace ptt {

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// A hand-written grid barrier: bar[0] counts arrivals, bar[1] is the
// generation. Thread 0 of a block reads the generation, arrives (release
// and acquire, after a fence over the block's writes); the last arrival
// resets the count and publishes the next generation (release), the
// others wait for it (acquire). bar starts as zeros and is left so.
__device__ __forceinline__ void hand_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned g = ld_acquire(bar + 1);
    __threadfence();
    unsigned old;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(old) : "l"(bar) : "memory");
    if (old == gridDim.x - 1) {
      bar[0] = 0;
      asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(bar + 1),
                   "r"(g + 1) : "memory");
    } else {
      while (ld_acquire(bar + 1) == g) {
      }
    }
  }
  __syncthreads();
}

// kind 0: n grid barriers (grid.sync); 1: each followed by a cluster
// barrier; 2: n hand-written barriers on bar
__global__ void __launch_bounds__(QD_THREADS)
    barrier_bench_kernel(int n, int kind, unsigned* bar) {
  coop::grid_group grid = coop::this_grid();
  for (int i = 0; i < n; ++i) {
    if (kind == 2) {
      hand_barrier(bar);
    } else {
      grid.sync();
      if (kind == 1) coop::this_cluster().sync();
    }
  }
}

}  // namespace ptt

// n barriers in one cooperative launch of `grid` blocks of QD_THREADS
// threads (cudaLaunchKernelEx with cudaLaunchAttributeCooperative): kind 0
// grid.sync(); 1 the same launch with cudaLaunchAttributeClusterDimension
// (clusters of 2) and a cluster barrier after each grid barrier; 2 the
// hand-written barrier on bar (2 unsigned, zeros).
extern "C" int ptt_barrier_bench(int n, int grid, int kind, void* bar,
                                 void* stream) {
  if (n < 0 || grid < 2 || grid % 2 || kind < 0 || kind > 2 ||
      (kind == 2 && !bar))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(ptt::QD_THREADS);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 2;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kind == 1 ? 2 : 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, ptt::barrier_bench_kernel,
                                            n, kind, (unsigned*)bar);
  return rc ? (int)rc : (int)cudaGetLastError();
}
