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
// at 3.35 TB/s. What keeps a layer from it is latency: a phase that asks
// for its weights only after the barrier opening it waits on HBM, and an
// attention on one block per head leaves ~112 blocks waiting.
//
// Design: ONE cooperative launch (cudaLaunchCooperativeKernel) of one block
// per MLP tile (128 at the backbone; ops/fused_step.py `mega_plan`), with
// grid barriers between five phases, the whole-row dependencies of the
// layer. At entry every block asks the TMA for ALL the weight bytes it will
// read in phases A, C and D (an mbarrier each: layer_post.cuh), so the
// layer's weight stream is in flight during LN1, the attention and the
// barriers:
//   A  every block: LN1 of x into shared memory; its in_proj units (96
//      column tiles of 32 at d_model 1024, each in ks_in slices of its
//      stored rows) -> raw float32 partials of the q/k/v row
//   B  block h * nck + c: head h over chunk c of the live slots 0..read_end
//      (fused_step.chunk_bounds); the new row from the partials (rope'd,
//      rounded; for int8 caches its whole-row absmax scales); the flash
//      loop over the chunk (tiles of 64 slots staged as they are, 16 bytes a
//      load, four threads score a slot) skipping
//      the write slot and slots with pos < 0; its (m, l, acc[D]) partial in
//      float32 to scratch (an empty chunk: m = -inf, l = 0). Block (h, 0)
//      also writes its head's columns of the new row at the write slot
//      (block 0 the two scales), which no block reads, and the new row's
//      own partial (m = its logit, l = 1, acc = its dequantised V row;
//      m = -inf, l = 0 when cur_pos < 0), merged last
//   C  every block: the partials of the heads its out_proj units read
//      merged in chunk order (K1's guarded rule: a partial of m = -inf
//      weighs 0) and rounded -> attn in shared memory; its out_proj units
//      -> partials (layer_post.cuh)
//   D  every block: x1 = x + the out_proj partials summed in slice order *
//      s_o + b_o, LN2; its MLP tile -> a partial of up (layer_post.cuh)
//   E  y summed over the grid's partials in a fixed order (no atomics: the
//      result does not depend on scheduling)
// The int8 cache's whole-row absmax needs the whole K/V row, hence the
// barrier after A. Shared memory: the block's weights, then the larger of
// the attention phase's floats and the product phases' activations.
#include <cooperative_groups.h>

#include <type_traits>

#include "layer_post.cuh"

namespace coop = cooperative_groups;

namespace ptt {

constexpr int K8_TILE = 64;   // cache slots per attention tile
constexpr int K8_PART = 4 + 64;  // floats of a head partial: m, l, 2 spare,
                                 // acc[D]

struct MegaArgs {
  Tail t;                      // x (dm,), norm2, W_o, W1, W2, partials
  CUtensorMap tm_in;           // W_in (box 32 x rows of a slice)
  const void *n1s, *n1b;       // norm1 (dm,) or null
  Lin win;                     // (dm, 3 dm)
  const float *cosv, *sinv;    // (D/2,) rope tables of the new position
  const int* cur_pos;          // (1,) the new row's position (< 0: invalid)
  void *kc, *vc;               // (S, dm) caches, written at ws
  const int* pos;              // (S,) positions, post-insert
  float *ksc, *vsc;            // (S,) row scales of int8 caches, or null
  float* pa;                   // in_proj partials (ks_in, 3 dm)
  float* pb;                   // head partials (nh, nck + 1, K8_PART)
  void* y;                     // (dm,) out
  int nh, ks_in, nck, read_end, ws, o_win, o_act;
};

// Shared floats of the attention phase for caches of kvb-byte elements: the
// head's projected q, k, v columns (D, dm, dm), q and the new K row after
// the rope (D, dm), a tile's scores and per-slot scales and positions, its
// K and V rows as they are (rows padded by 16 bytes), the PV partials of
// QD_THREADS / D slot groups, warp maxima and scalars.
__host__ __device__ inline int attend_floats(int dm, int D, int kvb) {
  return 2 * D + 3 * dm + 4 * K8_TILE + 2 * K8_TILE * (D * kvb + 16) / 4 +
         (QD_THREADS / D) * D + 2 * QD_WARPS + 8;
}

// Shared floats of the merge: every head's nck + 1 partials.
__host__ __device__ inline int merge_floats(int nh, int nck) {
  return nh * (nck + 1) * K8_PART;
}

// columns 4 c4.. of the float32 projected q/k/v row: the in_proj partials
// summed in slice order, times the per-channel scale, plus the bias. Loads
// only: a caller's batch of them is in flight together.
template <typename T>
__device__ __forceinline__ float4 qkv_vec(const MegaArgs& a, int c4) {
  const int n3 = 3 * a.t.dm;
  float4 p[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)  // every slice's load before the first add
    if (q < a.ks_in) p[q] = ld4cg(a.pa + (size_t)q * n3 + 4 * c4);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (q < a.ks_in) v.x += p[q].x, v.y += p[q].y, v.z += p[q].z, v.w += p[q].w;
  const float4 s = load4((const float*)a.win.s + 4 * c4);
  const T* bias = (const T*)a.win.b;
  const float4 b =
      bias ? load4(bias + 4 * c4) : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(v.x * s.x + b.x, v.y * s.y + b.y, v.z * s.z + b.z,
                     v.w * s.w + b.w);
}

// rope of column j of a head whose projected values are `row` (D floats):
// the half-pair rounded to the working type, then re*cos - im*sin (first
// half) or re*sin + im*cos (second half), each product and sum rounded on
// its own
template <typename T, int D>
__device__ __forceinline__ float rope_at(const float* row, int j,
                                         const float* cosv,
                                         const float* sinv) {
  constexpr int half = D / 2;
  if (j < half) {
    const float re = rnd<T>(row[j]), im = rnd<T>(row[j + half]);
    return __fsub_rn(__fmul_rn(re, cosv[j]), __fmul_rn(im, sinv[j]));
  }
  const float re = rnd<T>(row[j - half]), im = rnd<T>(row[j]);
  return __fadd_rn(__fmul_rn(re, sinv[j - half]),
                   __fmul_rn(im, cosv[j - half]));
}

// n values of a staged cache row (shared memory, element type KV) from
// element j0 on, as floats (n a multiple of 16 / sizeof(KV))
template <typename KV>
__device__ __forceinline__ void row_floats(const unsigned char* row, int j0,
                                           float* out, int n) {
  for (int j = 0; j < n; j += 16 / (int)sizeof(KV))
    unpack16<KV>(*reinterpret_cast<const uint4*>(row + (j0 + j) * sizeof(KV)),
                 out + j);
}

// Phase B for block h * nck + c: head h over chunk c of the live slots; its
// partial to pb[h][c]; block (h, 0) also the new row's write and partial
// (pb[h][nck]).
template <typename T, typename KV, int D>
__device__ void mega_attend(const MegaArgs& a, float* smem) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int G = QD_THREADS / D;        // slot groups in the PV phase
  constexpr int ROWB = D * sizeof(KV) + 16;  // a staged row, padded
  constexpr int CPR = D * sizeof(KV) / 16;   // 16-byte chunks a row
  const int dm = a.t.dm, tid = threadIdx.x;
  const int h = blockIdx.x / a.nck, ck = blockIdx.x % a.nck;
  const int lane = tid & 31, warp = tid >> 5;
  const int ws = a.ws, nslots = a.read_end + 1;
  const int len = cdiv(nslots, a.nck);
  const int s0 = min(nslots, ck * len), s1 = min(nslots, s0 + len);
  float* rq = smem;               // D: the head's projected q columns
  float* rk = rq + D;             // dm: the projected k row (block (h, 0))
  float* rv = rk + dm;            // dm: ... v row, rounded in place
  float* qs = rv + dm;            // D: the head's query after the rope
  float* krow = qs + D;           // dm: the new K row after the rope
  float* ps = krow + dm;          // K8_TILE scores, then weights
  float* kscs = ps + K8_TILE;     // K8_TILE: int8 the tile's k scales
  float* vscs = kscs + K8_TILE;   // K8_TILE: int8 the tile's v scales
  int* posv = reinterpret_cast<int*>(vscs + K8_TILE);  // K8_TILE positions
  unsigned char* kt = reinterpret_cast<unsigned char*>(posv + K8_TILE);
  unsigned char* vt = kt + K8_TILE * ROWB;  // staged K and V rows
  float* red = reinterpret_cast<float*>(vt + K8_TILE * ROWB);  // G x D
  float* wmax = red + G * D;      // 2 x QD_WARPS absmax partials
  float* sh = wmax + 2 * QD_WARPS;  // scalars
  const float scale = 1.0f / sqrtf((float)D);
  const KV* kc = (const KV*)a.kc + h * D;
  const KV* vc = (const KV*)a.vc + h * D;
  float* part = a.pb + (size_t)h * (a.nck + 1) * K8_PART;

  // the projected row: the head's q columns; block (h, 0) also k and v
  {
    const int nq = D / 4, nkv = ck == 0 ? 2 * dm / 4 : 0;
    for (int b = tid; b < nq + nkv; b += QD_THREADS * 4) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = b + u * QD_THREADS;
        if (i < nq + nkv) v[u] = qkv_vec<T>(a, i < nq ? h * D / 4 + i
                                                      : dm / 4 + i - nq);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = b + u * QD_THREADS;
        if (i < nq + nkv)
          reinterpret_cast<float4*>(i < nq ? rq : rk)[i < nq ? i : i - nq] =
              v[u];
      }
    }
  }
  __syncthreads();
  mark(a.t.marks, 6);
  if (tid < D) qs[tid] = rnd<T>(rope_at<T, D>(rq, tid, a.cosv, a.sinv));
  if (ck == 0) {
    // the new row: its head columns at the write slot, and its partial
    for (int c = tid; c < dm; c += QD_THREADS) {
      krow[c] = rnd<T>(rope_at<T, D>(rk + c / D * D, c % D, a.cosv, a.sinv));
      rv[c] = rnd<T>(rv[c]);
    }
    __syncthreads();
    float sk = 1.f, sv = 1.f;
    if constexpr (QUANT) {
      float mk = 0.f, mv = 0.f;
      for (int c = tid; c < dm; c += QD_THREADS) {
        mk = fmaxf(mk, fabsf(krow[c]));
        mv = fmaxf(mv, fabsf(rv[c]));
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
      __syncthreads();
      sk = sh[0];
      sv = sh[1];
    }
    // the new row's value at column c as the cache stores it, as float
    auto kq = [&](int c) {
      return QUANT ? fminf(fmaxf(rintf(krow[c] / sk), -127.f), 127.f)
                   : krow[c];
    };
    auto vq = [&](int c) {
      return QUANT ? fminf(fmaxf(rintf(rv[c] / sv), -127.f), 127.f) : rv[c];
    };
    if (tid < D) {
      const int c = h * D + tid;
      KV* kw = (KV*)a.kc + (size_t)ws * dm + c;
      KV* vw = (KV*)a.vc + (size_t)ws * dm + c;
      if constexpr (QUANT) {
        *kw = (int8_t)kq(c);
        *vw = (int8_t)vq(c);
      } else {
        *kw = from_f<T>(krow[c]);
        *vw = from_f<T>(rv[c]);
      }
    }
    if (QUANT && h == 0 && tid == 0) {
      a.ksc[ws] = sk;
      a.vsc[ws] = sv;
    }
    const bool live = a.cur_pos[0] >= 0;
    if (tid < 32) {
      float dot = 0.f;
      for (int j = tid; j < D; j += 32) dot += qs[j] * (kq(h * D + j) * sk);
      dot = warp_sum(dot) * scale;
      if (tid == 0) {
        part[a.nck * K8_PART] = live ? dot : -INFINITY;
        part[a.nck * K8_PART + 1] = live ? 1.f : 0.f;
      }
    }
    if (tid < D)
      part[a.nck * K8_PART + 4 + tid] = live ? vq(h * D + tid) * sv : 0.f;
  }
  __syncthreads();

  float m = -INFINITY, l = 0.f;  // meaningful in warp 0
  float acc = 0.f;               // PV partial of (slot group g, lane d)
  const int d = tid % D, g = tid / D;
  for (int base = s0; base < s1; base += K8_TILE) {
    const int n = min(K8_TILE, s1 - base);
    // ---- stage the tile's K and V rows as they are (the write slot's as
    // zeros: never read), its positions and scales; loads, then stores ----
    {
      constexpr int PER = 2 * K8_TILE * CPR / QD_THREADS;  // chunks a thread
      uint4 v[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int e = tid + u * QD_THREADS, kv = e / (K8_TILE * CPR);
        const int i = (e / CPR) % K8_TILE, c = e % CPR;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < n && base + i != ws)
          v[u] = __ldcg(reinterpret_cast<const uint4*>(
                            (kv ? vc : kc) + (size_t)(base + i) * dm) + c);
      }
      int pv = -1;
      float kv_s = 0.f, vv_s = 0.f;
      if (tid < n) {
        pv = a.pos[base + tid];
        if constexpr (QUANT) {
          if (base + tid != ws) {  // block (0, 0) writes the slot's scales
            kv_s = a.ksc[base + tid];
            vv_s = a.vsc[base + tid];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int e = tid + u * QD_THREADS, kv = e / (K8_TILE * CPR);
        const int i = (e / CPR) % K8_TILE, c = e % CPR;
        *reinterpret_cast<uint4*>((kv ? vt : kt) + i * ROWB + c * 16) = v[u];
      }
      if (tid < K8_TILE) {
        posv[tid] = tid < n && base + tid != ws ? pv : -1;
        kscs[tid] = kv_s;
        vscs[tid] = vv_s;
      }
    }
    __syncthreads();
    // ---- scores: four threads a slot, 16 dimensions each ----
    {
      const int i = tid >> 2, qd = tid & 3;
      float kf[16];
      row_floats<KV>(kt + i * ROWB, qd * 16, kf, 16);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) dot += kf[j] * qs[qd * 16 + j];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if (qd == 0) {
        const bool ok = posv[i] >= 0;
        float lg = dot * scale;
        if constexpr (QUANT) lg = ok ? lg * kscs[i] : 0.f;
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
      float pv = 0.f;
      for (int j = g; j < n; j += G) {
        const float p = QUANT ? ps[j] * vscs[j] : ps[j];
        const KV* vr = reinterpret_cast<const KV*>(vt + j * ROWB);
        float vv;
        if constexpr (QUANT)
          vv = (float)vr[d];
        else
          vv = to_f(vr[d]);
        pv += rnd<T>(p) * vv;
      }
      acc = acc * corr + pv;
    }
    __syncthreads();
  }
  red[g * D + d] = acc;
  __syncthreads();
  float* mine = part + ck * K8_PART;
  if (tid == 0) {
    mine[0] = m;
    mine[1] = l;
  }
  if (tid < D) {
    float s = 0.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) s += red[gg * D + tid];
    mine[4 + tid] = s;
  }
}

// The heads whose attention columns this block's out_proj units read
// (a slice of stored rows: int8, its logical rows; packed int4, those and
// the high half's), as a bit mask (dm / D <= 32 heads).
template <int D>
__device__ __forceinline__ unsigned merge_heads(const Tail& t) {
  const int stored = packed(t.wo) ? t.dm / 2 : t.dm, srows = stored / t.ks_o;
  unsigned mask = 0;
  for (int u = blockIdx.x; u < t.dm / FL_TILE * t.ks_o; u += gridDim.x) {
    const int r0 = u % t.ks_o * srows;
    for (int r = r0; r < r0 + srows; r += D) {
      mask |= 1u << (r / D);
      if (packed(t.wo)) mask |= 1u << ((stored + r) / D);
    }
  }
  return mask;
}

// Phase C's prologue: attn[n] = round(the merge of head n / D's nck + 1
// partials in chunk order), into xs, for the heads this block's out_proj
// units read (merge_heads); their partials are staged in `st` by 1-D TMA
// copies on `bar` (the other blocks' stores, ordered by the grid barrier,
// made visible to the async proxy first)
template <typename T, int D>
__device__ void mega_merge(const MegaArgs& a, float* xs, float* st,
                           uint64_t* bar) {
  const int np = a.nck + 1;
  const unsigned mask = merge_heads<D>(a.t);
  const unsigned hb = 4u * np * K8_PART;  // bytes of a head's partials
  if (threadIdx.x == 0) {
    asm volatile("fence.proxy.async;" ::: "memory");
    mbar_expect(bar, hb * __popc(mask));
    for (int h = 0; h < a.nh; ++h)
      if (mask >> h & 1)
        tma_run(st + h * np * K8_PART, a.pb + (size_t)h * np * K8_PART, hb,
                bar);
  }
  mbar_wait(bar);
  for (int n = threadIdx.x; n < a.t.dm; n += QD_THREADS) {
    if (!(mask >> (n / D) & 1)) continue;
    const float* part = st + (n / D) * np * K8_PART;
    float mx = -INFINITY;
    for (int c = 0; c < np; ++c) mx = fmaxf(mx, part[c * K8_PART]);
    float l = 0.f, acc = 0.f;
    for (int c = 0; c < np; ++c) {
      const float* pc = part + c * K8_PART;
      const float w = mx == -INFINITY ? 0.f : expf(pc[0] - mx);
      l += pc[1] * w;
      acc += pc[4 + n % D] * w;
    }
    xs[n] = rnd<T>(acc / fmaxf(l, 1e-30f));
  }
  __syncthreads();
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(QD_THREADS)
    megalayer_kernel(const __grid_constant__ MegaArgs a) {
  extern __shared__ __align__(128) unsigned char mega_shared[];
  __shared__ __align__(8) uint64_t bars[5];  // W_in, W_o, W1, W2, merge
  unsigned char* smem = align128(mega_shared);
  coop::grid_group grid = coop::this_grid();
  const Tail& t = a.t;
  const int dm = t.dm;
  float* xs = reinterpret_cast<float*>(smem + a.o_act);  // dm
  float* hs = xs + dm;                                    // FL_TILE
  float* outs = hs + FL_TILE;                             // FL_TILE
  float* red = outs + FL_TILE;                            // CP_RED
  float* lnv = red + CP_RED;  // a LayerNorm's scale and bias (2 x dm)
  float* st = lnv + 2 * dm;                               // merge partials
  mark(t.marks, 0);
  if (threadIdx.x == 0) {
    prefetch_map(&a.tm_in);
    prefetch_map(&t.tm_wo);
    prefetch_map(&t.tm_w1);
  }
  mbar_setup(bars, 5);
  // per-channel scales only: no cp.async group, the mbarriers alone
  issue_cols(a.win, &a.tm_in, dm, 3 * dm, a.ks_in, smem + a.o_win, bars);
  issue_cols(t.wo, &t.tm_wo, dm, dm, t.ks_o, smem + t.o_wo, bars + 1);
  issue_w1(t, smem, bars + 2);
  issue_w2(t, smem, bars + 3);
  mark(t.marks, 1);

  // A: ln1, then the in_proj units -> pa
  stage_row_norm(xs, (const T*)t.x, dm, (const T*)a.n1s, (const T*)a.n1b,
                 lnv, dm);
  ln_rows<T>(xs, 1, dm, t.eps, lnv, lnv + dm, red);
  mark(t.marks, 2);
  wait_phase(bars, 0);
  mark(t.marks, 3);
  {
    float* pa = a.pa;
    cols_phase(a.win, dm, 3 * dm, a.ks_in, smem + a.o_win, xs, nullptr, dm,
               1, red, outs,
               [&](int q, int, int n, float v) { pa[q * 3 * dm + n] = v; });
  }
  mark(t.marks, 4);
  grid.sync();
  mark(t.marks, 5);

  // B: (head, chunk) blocks
  if ((int)blockIdx.x < a.nh * a.nck)
    mega_attend<T, KV, D>(a, reinterpret_cast<float*>(smem + a.o_act));
  mark(t.marks, 7);
  grid.sync();
  mark(t.marks, 8);

  // C: the merge, then out_proj's units
  mega_merge<T, D>(a, xs, st, bars + 4);
  mark(t.marks, 9);
  wait_phase(bars + 1, 0);
  mark(t.marks, 10);
  out_proj_phase(t, smem, xs, nullptr, red, outs);
  mark(t.marks, 11);
  grid.sync();
  mark(t.marks, 12);

  // D: x1, LN2, this block's MLP tiles
  mlp_phase<T>(t, smem, xs, hs, red, nullptr, lnv, bars + 2, 0, 13);
  mark(t.marks, 18);
  grid.sync();
  mark(t.marks, 19);

  // E: y = round(x1 + up)
  T* y = (T*)a.y;
  mlp_finish<T>(t, [&](int i, float v) { y[i] = from_f<T>(v); });
  mark(t.marks, 20);
}

}  // namespace ptt

static bool mega_lin_ok(const ptt::Lin& l, int K) {
  return (l.kind == ptt::LIN_INT8 || (l.kind == ptt::LIN_INT4 && K % 2 == 0))
         && l.s != nullptr;
}

#define PTT_K8_KERNEL(T_, quant)                                   \
  ((quant) ? (const void*)ptt::megalayer_kernel<T_, int8_t, 64>    \
           : (const void*)ptt::megalayer_kernel<T_, T_, 64>)

// Blocks of K8 the card holds at once with `smem` bytes of dynamic shared
// memory (the bf16-cache and int8-cache kernels alike: the smaller count).
// 0 on error. Called by fused_layer.cu's ptt_coop_max_blocks.
int ptt_megalayer_max_blocks(int smem, int dtype) {
  int dev = 0, sms = 0, least = 1 << 30;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return 0;
  for (int quant = 0; quant < 2; ++quant) {
    int per_sm = 0;
    PTT_DISPATCH(dtype, T_, {
      const void* kern = PTT_K8_KERNEL(T_, quant);
      if (cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem) ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, kern, ptt::QD_THREADS, smem))
        return 0;
    });
    least = per_sm < least ? per_sm : least;
  }
  return least * sms;
}

// p (device pointers; optional ones null): x, norm1 scale, norm1 bias,
//   in_proj (w, scale, bias), cos, sin, cur_pos, k_cache, v_cache, pos,
//   k_scale, v_scale (int8 caches, else null), out_proj (w, scale, bias),
//   norm2 scale, norm2 bias, linear1 (w, scale, bias), linear2 (w, scale,
//   bias), the float32 scratch: in_proj partials (ks_in, 3 dm), head
//   partials (dm / 64, nck + 1, 68), out_proj partials (ks_o, dm), MLP
//   partials (grid, dm); y; the x1 scratch (dm,).
// kinds: the weight kind of in_proj, out_proj, linear1, linear2 (all int8 or
//   all per-channel int4). plan (ops/fused_step.py mega_plan,
//   MEGA_PLAN_KEYS): grid, ks_in, ks_o, nck, fin_e, the shared memory in
//   bytes and the offsets o_win, o_wo, o_w1, o_w2, o_act of its regions,
//   which must hold what the kernel puts there. D = 64;
//   0 <= ws <= read_end < S. marks: int64 (grid, CP_MARKS) or null.
extern "C" int ptt_megalayer(void* const* p, const int* kinds,
                             const int* plan, int dm, int H, int D, int S,
                             int read_end, int ws, float eps, int approx,
                             void* marks, int dtype, void* stream) {
  using namespace ptt;
  const bool quant = p[12] != nullptr;
  const int grid = plan[0];
  Tail t{{},
         {},
         p[0],
         nullptr,
         nullptr,
         p[17],
         p[18],
         {p[14], p[15], p[16], kinds[1], 0},
         {p[19], p[20], p[21], kinds[2], 0},
         {p[22], p[23], p[24], kinds[3], 0},
         (float*)p[27],
         (float*)p[28],
         (float*)p[30],
         (unsigned long long*)marks,
         1,
         dm,
         H,
         plan[2],
         plan[4],
         approx,
         kinds[3] == LIN_INT8,
         eps,
         plan[7],
         plan[8],
         plan[9]};
  MegaArgs a{t,
             {},
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
             (float*)p[25],
             (float*)p[26],
             p[29],
             dm / 64,
             plan[1],
             plan[3],
             read_end,
             ws,
             plan[6],
             plan[10]};
  auto ks_ok = [](int k) { return k == 1 || k == 2 || k == 4 || k == 8; };
  const int stored = kinds[0] == LIN_INT8 ? dm : dm / 2;
  if (D != 64 || dm % 64 || dm < 64 || H % FL_TILE || ws < 0 ||
      ws > read_end || read_end >= S || (p[13] != nullptr) != quant ||
      grid < a.nh || grid > H / FL_TILE || !ks_ok(plan[1]) ||
      !ks_ok(plan[2]) || !ks_ok(plan[4]) || plan[3] < 1 ||
      a.nh * plan[3] > grid || a.nh > 32 || (stored / plan[1]) % 32 ||
      (stored / plan[2]) % 32 || (quant && dm % 16) ||
      !mega_lin_ok(a.win, dm) || !mega_lin_ok(t.wo, dm) ||
      !mega_lin_ok(t.w1, dm) || !mega_lin_ok(t.w2, H) ||
      kinds[1] != kinds[0] || kinds[2] != kinds[0] || kinds[3] != kinds[0])
    return (int)cudaErrorInvalidValue;
  const int at = 4 * attend_floats(dm, D, quant ? 1 : dtype ? 2 : 4);
  const int mm = act_bytes(1, dm) + 4 * merge_floats(a.nh, a.nck);
  const int smem = plan[5];
  Region r[5];
  tail_regions(a.t, grid, r);
  r[3] = {a.o_win, cdiv(3 * dm / FL_TILE * a.ks_in, grid),
          col_unit_bytes(kinds[0], dm, a.ks_in, 0)};
  r[4] = {a.o_act, 1, mm > at ? mm : at};
  if (!regions_ok(r, 5, smem) ||
      encode_lin(&a.tm_in, a.win, dm, 3 * dm, a.ks_in, 32) ||
      encode_lin(&a.t.tm_wo, a.t.wo, dm, dm, a.t.ks_o, 32) ||
      encode_lin(&a.t.tm_w1, a.t.w1, dm, H, 1, packed(a.t.w1) ? 16 : 32))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&a};
  PTT_DISPATCH(dtype, T_, {
    const void* kern = PTT_K8_KERNEL(T_, quant);
    int rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc) return rc;
    rc = (int)cudaLaunchCooperativeKernel(kern, dim3(grid),
                                          dim3(QD_THREADS), args, smem,
                                          (cudaStream_t)stream);
    if (rc) return rc;
  });
  return (int)cudaGetLastError();
}
