// K8: one whole quantized backbone layer at T = 1 in ONE launch (solo
// decode, `backbone.use_megalayer`).
//
// Replaces the TPU kernel `pocket_tts_tpu/ops/fused_step.py:_megalayer_call`
// (`_megalayer_kernel`, `:60-298`), int8 or int4 weights with per-channel
// scales, a cache of the working type or int8 with per-row float32 scales.
//
// What it computes (the TPU kernel's rounding points, `:100-295`, which are
// not those of the 3-call path K5a + K7 + K5b):
//   ln1  = round(LN(x) * n1s + n1b)
//   row  = ln1 @ W_in + b_in                                 float32
//   q    = round(rope(round(row_q)));  k = round(rope(round(row_k)))
//   v    = round(row_v)
//   int8 cache: k and v quantized as models.backbone.quantize_rows does
//        (absmax over the row / 127, at least 1e-12; round half to even,
//        clipped to +-127); else k and v in the cache type
//   attn = round(flash decode of q over slots 0..read_end of the cache,
//        the write slot and slots with pos < 0 skipped, then the new row
//        merged after the loop from its (dequantised) values, float32 and
//        unrounded, iff cur_pos >= 0)
//   x1   = x + attn @ W_o + b_o                              float32
//   h    = gelu(round(LN(x1) * n2s + n2b) @ W_1 + b_1)  float32 at int4,
//          rounded to the working type at int8 (`:262-289`)
//   y    = round(x1 + h @ W_2 + b_2)
// Logits are (q . k) / sqrt(D) (times k_scale[s] for int8 rows); the
// softmax weights (times v_scale[s]) are rounded to the working type before
// they meet the V rows, as in K1 and K7. The new row's K/V bytes (and its
// two scales) are written at the write slot in place. The rope rotates the
// two halves of each head in float32 with the products and sums rounded
// one at a time (as ops/rope.apply_rope_halves computes on the CPU); the
// TPU kernel's constant gather/swap/scatter matrices (G64, P64, `:100-136`)
// are a Mosaic workaround and are not carried over.
//
// What bounds it on the H100: bytes. At T = 1 every weight element feeds one
// multiply-add: ~12.6 MB of int8 weights per layer (~6.3 MB of int4), plus
// the live cache rows (~0.6 MB of int8 K/V at S = 384), i.e. ~4 us (~2 us)
// at 3.35 TB/s. What keeps this first version from it is latency: four grid
// barriers, and one block per head in the attention phase.
//
// Design: ONE cooperative launch (cudaLaunchCooperativeKernel) of ~128
// blocks, at most as many as the card holds at once, with grid barriers
// between five phases, the whole-row dependencies of the layer:
//   A  every block: LN1 of x into shared memory; the in_proj column tiles
//      (96 of 32 columns at d_model 1024) spread over the grid write the
//      float32 q/k/v row to a small global scratch
//   B  blocks 0..H-1, one per head: each rebuilds the rope'd K row and the V
//      row (d_model floats each, from the scratch) and, for int8 caches,
//      their absmax scales; writes its own head's columns of the new row
//      (block 0 the two scales) at the write slot; runs K7's flash loop
//      over the cache (tiles of 128 slots, two threads score a slot, V rows
//      staged in shared memory, int8 rows in 16-byte loads), which never
//      reads the write slot, so no block reads stale or half-written bytes;
//      merges the new row from registers and writes its attention columns
//      to the scratch
//   C  out_proj column tiles + residual into float32 x1 (layer_post.cuh)
//   D  every block: LN2 of x1; its 32-unit hidden tiles of the MLP into a
//      per-block partial (layer_post.cuh, as K5b)
//   E  y summed over the partials in block order (no atomics: the result
//      does not depend on scheduling)
// Shared memory is the larger of the two layouts (the attention phase's, and
// the matmul phases'); the wrapper sizes the grid with
// ptt_megalayer_max_blocks, as K5b does.
#include <cooperative_groups.h>

#include <type_traits>

#include "layer_post.cuh"

namespace coop = cooperative_groups;

namespace ptt {

constexpr int K8_TILE = 128;  // cache slots per attention tile

struct MegaArgs {
  const void* x;               // (dm,) working type
  const void *n1s, *n1b;       // norm1 (dm,) or null
  Lin win;                     // (dm, 3 dm)
  const float *cosv, *sinv;    // (D/2,) rope tables of the new position
  const int* cur_pos;          // (1,) the new row's position (< 0: invalid)
  void *kc, *vc;               // (S, dm) caches, written at ws
  const int* pos;              // (S,) positions, post-insert
  float *ksc, *vsc;            // (S,) row scales of int8 caches, or null
  Lin wo;                      // (dm, dm)
  const void *n2s, *n2b;       // norm2 (dm,) or null
  Lin w1, w2;                  // (dm, H), (H, dm)
  float* qkv;                  // scratch (3 dm,)
  float* attn;                 // scratch (dm,)
  float* x1;                   // scratch (dm,)
  float* part;                 // scratch (grid, dm)
  void* y;                     // (dm,) out
  int dm, nh, H, read_end, ws, approx, round_h;
  float eps;
};

// rope of column c of a float32 projected row: its half-pair rounded to the
// working type, then re*cos - im*sin (first half of the head) or re*sin +
// im*cos (second half), each product and sum rounded on its own
template <typename T, int D>
__device__ __forceinline__ float rope_at(const float* row, int c,
                                         const float* cosv,
                                         const float* sinv) {
  constexpr int half = D / 2;
  const int j = c % D;
  if (j < half) {
    const float re = rnd<T>(__ldcg(row + c)), im = rnd<T>(__ldcg(row + c + half));
    return __fsub_rn(__fmul_rn(re, cosv[j]), __fmul_rn(im, sinv[j]));
  }
  const float re = rnd<T>(__ldcg(row + c - half)), im = rnd<T>(__ldcg(row + c));
  return __fadd_rn(__fmul_rn(re, sinv[j - half]), __fmul_rn(im, cosv[j - half]));
}

// floats of shared memory the attention phase uses
__host__ __device__ constexpr int attend_floats(int dm, int D) {
  return 2 * dm + D + 2 * K8_TILE + K8_TILE * D + (QD_THREADS / D) * D +
         2 * QD_WARPS + 8;
}

// Phase B for head blockIdx.x: the new row, its write, the flash decode and
// the merge; writes the head's D attention columns to a.attn.
template <typename T, typename KV, int D>
__device__ void mega_attend(const MegaArgs& a, float* smem) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int G = QD_THREADS / D;  // slot groups in the PV phase
  const int dm = a.dm, h = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ws = a.ws, read_end = a.read_end;
  float* krow = smem;             // dm: the new K row (rope'd, rounded)
  float* vrow = krow + dm;        // dm: the new V row (rounded)
  float* qs = vrow + dm;          // D: this head's query
  float* ps = qs + D;             // K8_TILE scores, then weights
  float* vscs = ps + K8_TILE;     // K8_TILE: int8 the tile's v scales
  float* vs = vscs + K8_TILE;     // K8_TILE x D staged V rows
  float* red = vs + K8_TILE * D;  // G x D PV partials
  float* wmax = red + G * D;      // 2 x QD_WARPS absmax partials
  float* sh = wmax + 2 * QD_WARPS;  // scalars
  const float* qkv = a.qkv;
  const float scale = 1.0f / sqrtf((float)D);
  KV* kc = (KV*)a.kc + h * D;
  KV* vc = (KV*)a.vc + h * D;

  for (int c = tid; c < dm; c += QD_THREADS) {
    krow[c] = rnd<T>(rope_at<T, D>(qkv + dm, c, a.cosv, a.sinv));
    vrow[c] = rnd<T>(__ldcg(qkv + 2 * dm + c));
  }
  if (tid < D) qs[tid] = rnd<T>(rope_at<T, D>(qkv, h * D + tid, a.cosv,
                                              a.sinv));
  float sk = 1.f, sv = 1.f;
  if constexpr (QUANT) {
    __syncthreads();
    float mk = 0.f, mv = 0.f;
    for (int c = tid; c < dm; c += QD_THREADS) {
      mk = fmaxf(mk, fabsf(krow[c]));
      mv = fmaxf(mv, fabsf(vrow[c]));
    }
    mk = warp_max(mk);
    mv = warp_max(mv);
    if (lane == 0) {
      wmax[warp] = mk;
      wmax[QD_WARPS + warp] = mv;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < QD_WARPS; ++w) {
        mk = fmaxf(mk, wmax[w]);
        mv = fmaxf(mv, wmax[QD_WARPS + w]);
      }
      sh[0] = fmaxf(mk / 127.0f, 1e-12f);
      sh[1] = fmaxf(mv / 127.0f, 1e-12f);
    }
  }
  __syncthreads();
  if constexpr (QUANT) {
    sk = sh[0];
    sv = sh[1];
  }
  // the new row's value at column c as the cache stores it, and as float
  auto kq = [&](int c) {
    return QUANT ? fminf(fmaxf(rintf(krow[c] / sk), -127.f), 127.f)
                 : krow[c];
  };
  auto vq = [&](int c) {
    return QUANT ? fminf(fmaxf(rintf(vrow[c] / sv), -127.f), 127.f)
                 : vrow[c];
  };
  if (tid < D) {
    const int c = h * D + tid;
    if constexpr (QUANT) {
      kc[(size_t)ws * dm + tid] = (int8_t)kq(c);
      vc[(size_t)ws * dm + tid] = (int8_t)vq(c);
    } else {
      kc[(size_t)ws * dm + tid] = from_f<T>(krow[c]);
      vc[(size_t)ws * dm + tid] = from_f<T>(vrow[c]);
    }
  }
  if (QUANT && h == 0 && tid == 0) {
    a.ksc[ws] = sk;
    a.vsc[ws] = sv;
  }

  float m = -INFINITY, l = 0.f;  // meaningful in warp 0
  float acc = 0.f;               // PV partial of (slot group g, lane d)
  const int d = tid % D, g = tid / D;
  for (int base = 0; base <= read_end; base += K8_TILE) {
    const int n = min(K8_TILE, read_end - base + 1);
    // ---- stage the tile's V rows (slot ws left out) ----
    if constexpr (QUANT) {
      for (int e = tid; e < n * (D / 16); e += QD_THREADS) {
        const int i = e / (D / 16), c0 = (e % (D / 16)) * 16;
        if (base + i == ws) {
#pragma unroll
          for (int j = 0; j < 16; ++j) vs[i * D + c0 + j] = 0.f;
        } else {
          load16(vc + (size_t)(base + i) * dm + c0, vs + i * D + c0);
        }
      }
      if (tid < n) vscs[tid] = base + tid == ws ? 0.f : a.vsc[base + tid];
    } else {
      for (int e = tid; e < n * D; e += QD_THREADS) {
        const int s = base + e / D;
        vs[e] = s == ws ? 0.f : to_f(vc[(size_t)s * dm + e % D]);
      }
    }
    // ---- scores: two threads per slot ----
    {
      const int i = tid >> 1, hf = tid & 1, s = base + i;
      float dot = 0.f;
      bool ok = false;
      if (s <= read_end && s != ws) {
        ok = a.pos[s] >= 0;
        const KV* kr = kc + (size_t)s * dm + hf * (D / 2);
        const float* qh = qs + hf * (D / 2);
        if constexpr (QUANT) {
          float kf[D / 2];
#pragma unroll
          for (int c = 0; c < D / 2; c += 16) load16(kr + c, kf + c);
#pragma unroll
          for (int j = 0; j < D / 2; ++j) dot += kf[j] * qh[j];
        } else {
#pragma unroll
          for (int j = 0; j < D / 2; ++j) dot += to_f(kr[j]) * qh[j];
        }
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      if (hf == 0) {
        float lg = dot * scale;
        if constexpr (QUANT) lg = ok ? lg * a.ksc[s] : 0.f;
        ps[i] = ok ? lg : -INFINITY;
      }
    }
    __syncthreads();
    // ---- online softmax statistics: warp 0 ----
    if (tid < 32) {
      float tmax = -INFINITY;
      for (int j = tid; j < K8_TILE; j += 32) tmax = fmaxf(tmax, ps[j]);
      tmax = warp_max(tmax);
      const float m_new = fmaxf(m, tmax);
      float corr = 1.f, sum = 0.f;
      if (m_new != -INFINITY) {
        corr = expf(m - m_new);
        for (int j = tid; j < K8_TILE; j += 32) {
          const float p = expf(ps[j] - m_new);
          ps[j] = p;
          sum += p;
        }
      } else {
        for (int j = tid; j < K8_TILE; j += 32) ps[j] = 0.f;
      }
      sum = warp_sum(sum);
      l = l * corr + sum;
      m = m_new;
      if (tid == 0) sh[2] = corr;
    }
    __syncthreads();
    // ---- PV: p (times the v scale) rounded to the working type ----
    {
      const float corr = sh[2];
      float part = 0.f;
      for (int j = g; j < n; j += G) {
        const float p = QUANT ? ps[j] * vscs[j] : ps[j];
        part += rnd<T>(p) * vs[j * D + d];
      }
      acc = acc * corr + part;
    }
    __syncthreads();
  }
  red[g * D + d] = acc;
  // ---- merge the new row (float32, unrounded), warp 0 ----
  if (tid < 32) {
    float corr = 1.f, pn = 0.f;
    if (a.cur_pos[0] >= 0) {
      float dot = 0.f;
      for (int j = tid; j < D; j += 32) dot += qs[j] * (kq(h * D + j) * sk);
      const float lg = warp_sum(dot) * scale;
      const float m_fin = fmaxf(m, lg);
      corr = expf(m - m_fin);
      pn = expf(lg - m_fin);
      l = l * corr + pn;
    }
    if (tid == 0) {
      sh[2] = corr;
      sh[3] = pn;
      sh[4] = l;
    }
  }
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) s += red[gg * D + tid];
    s = s * sh[2] + sh[3] * (vq(h * D + tid) * sv);
    a.attn[h * D + tid] = rnd<T>(s / fmaxf(sh[4], 1e-30f));
  }
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(QD_THREADS) megalayer_kernel(MegaArgs a) {
  extern __shared__ float smem[];
  coop::grid_group grid = coop::this_grid();
  const int dm = a.dm;
  float* red = smem;           // QD_RED
  float* xs = red + QD_RED;    // dm: ln1, attn, then ln2
  float* acc = xs + dm;        // dm: this block's partial of up
  float* hs = acc + dm;        // FL_TILE: one hidden tile
  const T* x = (const T*)a.x;

  // A: ln1, then the in_proj column tiles -> float32 q/k/v row
  {
    const T* ns = (const T*)a.n1s;
    const T* nb = (const T*)a.n1b;
    block_layernorm(
        1, dm, a.eps, [&](int, int i) { return to_f(x[i]); },
        [&](int, int i, float v) {
          xs[i] = rnd<T>(v * opt(ns, i, 1.f) + opt(nb, i, 0.f));
        });
    const int n3 = 3 * dm, ntiles = (n3 + FL_TILE - 1) / FL_TILE;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int n0 = t * FL_TILE;
      lin_tile<T>(xs, dm, 1, dm, a.win, n3, n0, min(FL_TILE, n3 - n0),
                  FL_TILE / 4, red,
                  [&](int, int n, float v) { a.qkv[n] = v; });
    }
  }
  grid.sync();

  // B: one block per head
  if ((int)blockIdx.x < a.nh) mega_attend<T, KV, D>(a, smem);
  grid.sync();

  // C: x1 = x + attn @ W_o + b_o
  if ((int)blockIdx.x < (dm + FL_TILE - 1) / FL_TILE) {
    for (int i = threadIdx.x; i < dm; i += QD_THREADS)
      xs[i] = __ldcg(a.attn + i);
    __syncthreads();
    out_proj_tiles<T>(xs, 1, dm, a.wo, x, (const T*)nullptr, a.x1, red);
  }
  grid.sync();

  // D: LN2, then this block's hidden tiles
  mlp_tiles<T>(1, dm, a.H, a.x1, (const T*)a.n2s, (const T*)a.n2b, a.eps,
               a.w1, a.w2, a.approx, a.round_h != 0, xs, acc, hs, red,
               a.part);
  grid.sync();

  // E: y = round(x1 + up)
  T* y = (T*)a.y;
  mlp_finish<T>(1, dm, a.w2, (const T*)nullptr, a.x1, a.part,
                [&](int i, float v) { y[i] = from_f<T>(v); });
}

}  // namespace ptt

static size_t mega_smem(int dm, int D) {
  const int mm = ptt::QD_RED + 2 * dm + ptt::FL_TILE;
  const int at = ptt::attend_floats(dm, D);
  return sizeof(float) * (size_t)(mm > at ? mm : at);
}

static bool mega_lin_ok(const ptt::Lin& l, int K) {
  return (l.kind == ptt::LIN_INT8 || (l.kind == ptt::LIN_INT4 && K % 2 == 0))
         && l.s != nullptr;
}

#define PTT_K8_KERNEL(T_, quant)                                   \
  ((quant) ? (const void*)ptt::megalayer_kernel<T_, int8_t, 64>    \
           : (const void*)ptt::megalayer_kernel<T_, T_, 64>)

// Largest cooperative grid K8 can take on this device at width dm: blocks
// resident per SM at its shared-memory size times the SM count. 0 on error.
extern "C" int ptt_megalayer_max_blocks(int dm, int quant, int dtype) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return 0;
  const size_t smem = mega_smem(dm, 64);
  PTT_DISPATCH(dtype, T_, {
    const void* kern = PTT_K8_KERNEL(T_, quant);
    if (cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kern, ptt::QD_THREADS, smem))
      return 0;
  });
  return per_sm * sms;
}

// p (device pointers; optional ones null): x, norm1 scale, norm1 bias,
//   in_proj (w, scale, bias), cos, sin, cur_pos, k_cache, v_cache, pos,
//   k_scale, v_scale (int8 caches, else null), out_proj (w, scale, bias),
//   norm2 scale, norm2 bias, linear1 (w, scale, bias), linear2 (w, scale,
//   bias), the qkv (3 dm), attn (dm), x1 (dm) and partial (grid x dm)
//   float32 scratch, y.
// kinds: the weight kind of in_proj, out_proj, linear1, linear2 (all int8 or
//   all per-channel int4). D = 64; 0 <= ws <= read_end < S; grid >= H and
//   <= ptt_megalayer_max_blocks.
extern "C" int ptt_megalayer(void* const* p, const int* kinds, int dm, int H,
                             int D, int S, int read_end, int ws, float eps,
                             int approx, int grid, int dtype, void* stream) {
  const bool quant = p[12] != nullptr;
  ptt::MegaArgs a{p[0],
                  p[1],
                  p[2],
                  {p[3], p[4], p[5], kinds[0], 0},
                  (const float*)p[6],
                  (const float*)p[7],
                  (const int*)p[8],
                  p[9],
                  p[10],
                  (const int*)p[11],
                  (float*)p[12],
                  (float*)p[13],
                  {p[14], p[15], p[16], kinds[1], 0},
                  p[17],
                  p[18],
                  {p[19], p[20], p[21], kinds[2], 0},
                  {p[22], p[23], p[24], kinds[3], 0},
                  (float*)p[25],
                  (float*)p[26],
                  (float*)p[27],
                  (float*)p[28],
                  p[29],
                  dm,
                  dm / 64,
                  H,
                  read_end,
                  ws,
                  approx,
                  kinds[3] == ptt::LIN_INT8,
                  eps};
  if (D != 64 || dm % 64 || dm < 64 || H % 32 || ws < 0 || ws > read_end ||
      read_end >= S || (p[13] != nullptr) != quant || grid < a.nh ||
      (quant && dm % 16) || !mega_lin_ok(a.win, dm) ||
      !mega_lin_ok(a.wo, dm) || !mega_lin_ok(a.w1, dm) ||
      !mega_lin_ok(a.w2, H) || kinds[1] != kinds[0] ||
      kinds[2] != kinds[0] || kinds[3] != kinds[0])
    return (int)cudaErrorInvalidValue;
  const size_t smem = mega_smem(dm, D);
  cudaStream_t st = (cudaStream_t)stream;
  void* args[] = {&a};
  PTT_DISPATCH(dtype, T_, {
    const void* kern = PTT_K8_KERNEL(T_, quant);
    int rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
    rc = (int)cudaLaunchCooperativeKernel(kern, dim3(grid),
                                          dim3(ptt::QD_THREADS), args, smem,
                                          st);
    if (rc) return rc;
  });
  return (int)cudaGetLastError();
}
