// K5a and K5b: one transformer layer's quantized linears, fused around the
// attention, for the backbone decode step (T = 1) and the mimi decoder
// transformer (T = 16 rows per frame).
//
// K5a replaces `pocket_tts_tpu/ops/fused_layer.py:_pre_call`
// (`_pre_kernel`):
//   qkv = round(round(LN(x)) @ q_in * s_in + b_in)
// LN in float32 over d_model with eps, times norm scale plus bias, rounded
// to the working type before the dot, as the TPU kernel stages it.
//
// K5b replaces `pocket_tts_tpu/ops/fused_layer.py:_post_call`
// (`_post_kernel`, `_post_x1_ln`, `_mlp_add`, `_post_tail`):
//   x1  = x + ls1 * (attn @ q_o * s_o + b_o)            float32, kept so
//   ln  = round(LN(x1) * n2s + n2b)
//   h   = round(gelu(ln @ q_1 * s_1 + b_1))             per hidden unit
//   up  = (sum over hidden of h @ q_2) * s_2 + b_2     s_2 once, on the
//                                                       float32 sum
//   out = round(x1 + ls2 * up)
// Absent biases read as zeros, absent layer scales as ones. GELU is erf
// (erff, correctly rounded to ~1 ulp; the TPU kernel uses a 1.5e-7
// polynomial) or tanh.
//
// What bounds them on the H100: bytes. At T = 1 each weight element feeds
// one multiply-add per row: 3 MB of int8 for the backbone's in_proj, 9 MB
// for out_proj + the MLP, i.e. ~1 us and ~3 us at full HBM bandwidth. What
// keeps them from it in this version is latency: few blocks per phase and
// grid-wide barriers.
//
// Design. K5a is one ordinary launch: each block recomputes the LayerNorm
// of the T rows (at most 16 x 1024 values) into shared memory, then streams
// its 32-column tile of q_in; there is no dependency between blocks.
// K5b has two dependencies across blocks that the TPU kernel met by walking
// its hidden tiles in order with scratch carried between grid steps: the
// LayerNorm of x1 needs all of out_proj, and the W2 sum runs over every
// hidden tile. Here it is one COOPERATIVE launch with two grid barriers:
//   phase 1  out_proj column tiles -> x1 (float32 scratch in HBM)
//   sync
//   phase 2  every block: LN(x1) into shared memory; then its 32-wide
//            hidden tiles: h tile, then h tile @ q_2 rows into a per-block
//            float32 partial of `up` (shared memory), written to HBM
//   sync
//   phase 3  each output element sums the blocks' partials in block order
//            (no float atomics: the result does not depend on scheduling)
//            and applies s_2, b_2, ls2 and the residual.
// Scratch (x1 and the partials) is allocated by the caller.
#include <cooperative_groups.h>

#include "qdot.cuh"

namespace coop = cooperative_groups;

namespace ptt {

constexpr int FL_TILE = 32;  // columns per K5a tile / hidden units per tile

struct PreArgs {
  const void *x, *ns, *nb;  // (T, dm); norm scale/bias (dm,) or null
  const int8_t* w;          // (dm, N)
  const float* s;           // (N,)
  const void* b;            // (N,) or null
  void* out;                // (T, N)
  int T, dm, N;
  float eps;
};

template <typename T>
__global__ void __launch_bounds__(QD_THREADS) fused_pre_kernel(PreArgs a) {
  extern __shared__ float smem[];
  float* red = smem;            // QD_RED
  float* xs = smem + QD_RED;    // T x dm
  const T* x = (const T*)a.x;
  const T* ns = (const T*)a.ns;
  const T* nb = (const T*)a.nb;
  const T* b = (const T*)a.b;
  T* out = (T*)a.out;
  const int dm = a.dm, N = a.N;
  block_layernorm(
      a.T, dm, a.eps, [&](int r, int i) { return to_f(x[r * dm + i]); },
      [&](int r, int i, float v) {
        xs[r * dm + i] = rnd<T>(v * opt(ns, i, 1.f) + opt(nb, i, 0.f));
      });
  const int ntiles = (N + FL_TILE - 1) / FL_TILE;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int n0 = t * FL_TILE;
    tile_dot(xs, dm, a.T, dm, a.w, N, n0, min(FL_TILE, N - n0), FL_TILE / 4,
             red, [&](int r, int n, float v) {
               out[(size_t)r * N + n] =
                   from_f<T>(v * a.s[n] + opt(b, n, 0.f));
             });
  }
}

struct PostArgs {
  const void *x, *attn;          // (T, dm)
  const int8_t* wo;              // (dm, dm)
  const float* so;               // (dm,)
  const void *bo, *ls1, *ls2;    // (dm,) or null
  const void *ns, *nb;           // norm2 (dm,) or null
  const int8_t* w1;              // (dm, H)
  const float* s1;               // (H,)
  const void* b1;                // (H,) or null
  const int8_t* w2;              // (H, dm)
  const float* s2;               // (dm,)
  const void* b2;                // (dm,) or null
  float* x1;                     // scratch (T, dm)
  float* part;                   // scratch (gridDim.x, T, dm)
  void* out;                     // (T, dm)
  int T, dm, H, approx;
  float eps;
};

template <typename T>
__global__ void __launch_bounds__(QD_THREADS) fused_post_kernel(PostArgs a) {
  extern __shared__ float smem[];
  const int T_ = a.T, dm = a.dm, H = a.H;
  float* red = smem;                 // QD_RED
  float* xs = red + QD_RED;          // T x dm: attn, then LN(x1)
  float* acc = xs + T_ * dm;         // T x dm: this block's partial of up
  float* hs = acc + T_ * dm;         // T x FL_TILE: one hidden tile
  const T* x = (const T*)a.x;
  const T* attn = (const T*)a.attn;
  const T* ls1 = (const T*)a.ls1;
  const T* ls2 = (const T*)a.ls2;
  const T* bo = (const T*)a.bo;
  const T* b1 = (const T*)a.b1;
  const T* b2 = (const T*)a.b2;
  const T* ns = (const T*)a.ns;
  const T* nb = (const T*)a.nb;
  T* out = (T*)a.out;
  coop::grid_group grid = coop::this_grid();
  const int tid = threadIdx.x;

  // phase 1: x1 = x + ls1 * (attn @ q_o * s_o + b_o)
  const int ntiles_o = (dm + FL_TILE - 1) / FL_TILE;
  if ((int)blockIdx.x < ntiles_o) {
    for (int i = tid; i < T_ * dm; i += QD_THREADS) xs[i] = to_f(attn[i]);
    __syncthreads();
    for (int t = blockIdx.x; t < ntiles_o; t += gridDim.x) {
      const int n0 = t * FL_TILE;
      tile_dot(xs, dm, T_, dm, a.wo, dm, n0, min(FL_TILE, dm - n0),
               FL_TILE / 4, red, [&](int r, int n, float v) {
                 const float proj = v * a.so[n] + opt(bo, n, 0.f);
                 a.x1[r * dm + n] =
                     to_f(x[r * dm + n]) + opt(ls1, n, 1.f) * proj;
               });
    }
  }
  grid.sync();

  // phase 2: LN(x1), then this block's hidden tiles into acc
  block_layernorm(
      T_, dm, a.eps, [&](int r, int i) { return __ldcg(a.x1 + r * dm + i); },
      [&](int r, int i, float v) {
        xs[r * dm + i] = rnd<T>(v * opt(ns, i, 1.f) + opt(nb, i, 0.f));
      });
  for (int i = tid; i < T_ * dm; i += QD_THREADS) acc[i] = 0.f;
  __syncthreads();
  const int ntiles_h = (H + FL_TILE - 1) / FL_TILE;
  // q_2 rows: as many 4-column groups as the row has, up to one per thread
  // (tile_dot takes a power of two)
  int cg2 = 1;
  while (2 * cg2 <= min(dm / 4, QD_THREADS)) cg2 *= 2;
  for (int t = blockIdx.x; t < ntiles_h; t += gridDim.x) {
    const int h0 = t * FL_TILE, nh = min(FL_TILE, H - h0);
    tile_dot(xs, dm, T_, dm, a.w1, H, h0, nh, FL_TILE / 4, red,
             [&](int r, int n, float v) {
               hs[r * FL_TILE + (n - h0)] =
                   rnd<T>(gelu_f(v * a.s1[n] + opt(b1, n, 0.f), a.approx));
             });
    for (int n0 = 0; n0 < dm; n0 += 4 * cg2) {
      tile_dot(hs, FL_TILE, T_, nh, a.w2 + (size_t)h0 * dm, dm, n0,
               min(4 * cg2, dm - n0), cg2, red,
               [&](int r, int n, float v) { acc[r * dm + n] += v; });
    }
  }
  float* mine = a.part + (size_t)blockIdx.x * T_ * dm;
  for (int i = tid; i < T_ * dm; i += QD_THREADS) mine[i] = acc[i];
  grid.sync();

  // phase 3: up = (sum of the partials, in block order) * s_2 + b_2
  const int G = gridDim.x;
  for (int i = blockIdx.x * QD_THREADS + tid; i < T_ * dm;
       i += G * QD_THREADS) {
    float v = 0.f;
    for (int g = 0; g < G; ++g) v += __ldcg(a.part + (size_t)g * T_ * dm + i);
    const int n = i % dm;
    const float up = v * a.s2[n] + opt(b2, n, 0.f);
    out[i] = from_f<T>(__ldcg(a.x1 + i) + opt(ls2, n, 1.f) * up);
  }
}

template <typename K>
static int set_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace ptt

// Shared memory of K5b for T rows of width dm (the caller sizes its grid
// with ptt_fused_post_max_blocks, which uses the same figure).
static size_t post_smem(int T, int dm) {
  return sizeof(float) *
         (ptt::QD_RED + 2 * (size_t)T * dm + (size_t)T * ptt::FL_TILE);
}

extern "C" int ptt_fused_pre(const void* x, const void* ns, const void* nb,
                             const void* w, const void* s, const void* b,
                             void* out, int T, int dm, int N, float eps,
                             int dtype, void* stream) {
  if (T < 1 || dm < 1 || N < 1 || N % 4) return (int)cudaErrorInvalidValue;
  ptt::PreArgs a{x, ns, nb, (const int8_t*)w, (const float*)s, b, out,
                 T, dm, N, eps};
  const size_t smem = sizeof(float) * (ptt::QD_RED + (size_t)T * dm);
  const int grid = (N + ptt::FL_TILE - 1) / ptt::FL_TILE;
  cudaStream_t st = (cudaStream_t)stream;
  PTT_DISPATCH(dtype, T_, {
    auto kern = ptt::fused_pre_kernel<T_>;
    int rc = ptt::set_smem(kern, smem);
    if (rc) return rc;
    kern<<<grid, ptt::QD_THREADS, smem, st>>>(a);
  });
  return (int)cudaGetLastError();
}

// Largest cooperative grid K5b can take on this device for (T, dm): blocks
// resident per SM at its shared-memory size times the SM count. 0 on error.
extern "C" int ptt_fused_post_max_blocks(int T, int dm, int dtype) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return 0;
  const size_t smem = post_smem(T, dm);
  PTT_DISPATCH(dtype, T_, {
    auto kern = ptt::fused_post_kernel<T_>;
    if (ptt::set_smem(kern, smem) ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kern, ptt::QD_THREADS, smem))
      return 0;
  });
  return per_sm * sms;
}

// ptrs: x, attn, wo, so, bo, ls1, ls2, ns, nb, w1, s1, b1, w2, s2, b2,
//       x1 scratch, partial scratch, out (device pointers; optional ones
//       null). grid: the cooperative grid (<= ptt_fused_post_max_blocks),
//       the partial scratch holds grid * T * dm floats.
extern "C" int ptt_fused_post(void* const* p, int T, int dm, int H,
                              float eps, int approx, int grid, int dtype,
                              void* stream) {
  if (T < 1 || dm < 4 || dm % 4 || H % 4 || grid < 1)
    return (int)cudaErrorInvalidValue;
  ptt::PostArgs a{p[0], p[1], (const int8_t*)p[2], (const float*)p[3],
                  p[4], p[5], p[6], p[7], p[8], (const int8_t*)p[9],
                  (const float*)p[10], p[11], (const int8_t*)p[12],
                  (const float*)p[13], p[14], (float*)p[15], (float*)p[16],
                  p[17], T, dm, H, approx, eps};
  const size_t smem = post_smem(T, dm);
  cudaStream_t st = (cudaStream_t)stream;
  void* args[] = {&a};
  PTT_DISPATCH(dtype, T_, {
    auto kern = ptt::fused_post_kernel<T_>;
    int rc = ptt::set_smem(kern, smem);
    if (rc) return rc;
    rc = (int)cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                          dim3(ptt::QD_THREADS), args, smem,
                                          st);
    if (rc) return rc;
  });
  return (int)cudaGetLastError();
}
