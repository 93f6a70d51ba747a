// K7: fused KV-row insert + T=1 flash-decode attention over B lanes.
//
// Replaces the TPU kernel `pocket_tts_tpu/ops/pallas_attn.py:
// decode_insert_attention` (`_decode_insert_attention_batched` ->
// `_insert_attn_kernel`, `_flash_main_block` with a write slot), over caches
// of the working type or int8 caches with per-row float32 scales (`quant`),
// with or without the flash statistics (`stats`).
//
// What it computes, per lane b and head h: the new K/V row (k_new[b],
// v_new[b], head h's D columns) goes into the caches at the batch-uniform
// slot `ws`, and the query q[b, h] attends over slots 0..read_end of the
// lane's cache. Slot s counts iff pos[b, s] >= 0, except the write slot,
// which counts iff the new row is valid (cur_pos[b] >= 0): in ring mode the
// write slot's cache bytes are a stale row of an earlier frame, and they
// are never read (the kernel takes slot ws's K and V from the new row).
// Logits and softmax statistics are float32 with scale 1/sqrt(D); each
// softmax weight is rounded to the cache type before the PV product,
// relative to the running max it was taken against, and PV accumulates in
// float32 (the TPU kernel accumulates PV in bf16 on its MXU; that is not
// reproduced).
//
// int8 caches: the new row arrives quantized, with its scales ks_new[b],
// vs_new[b]; its bytes go to the write slot and its scales to k_scale[b,
// ws] and v_scale[b, ws]. The other slots score (q . k) * scale *
// k_scale[s], and their weights times v_scale[s] are rounded to the
// working type before they meet the int8 rows. The write slot is left out
// of the chunks (its stale bytes and stale scale are never read) and
// merged after them, as the TPU kernel does (`pallas_attn.py:663-688`):
// from the new row times its scale, in float32, unrounded.
// stats: the post-merge running max m and normaliser l of each (lane, head)
// are written out, for the external merge with the shared-prefix partial.
// A masked slot is skipped (the TPU kernel adds a finite -1e9): a lane with
// no attended slot gives out 0, m = -inf and l = 0, which the merge turns
// into the prefix partial alone.
//
// What bounds it on the H100: bytes. A call streams each lane's K and V
// rows 0..read_end once (B * 2 * (read_end+1) * H*D elements: 134 MB in
// bf16 at B=32, S=1024, H*D=1024, ~40 us at 3.35 TB/s; 59 MB of int8 at
// S=896) and does ~4 flops per element, far below the card's ~295
// flop/byte ridge. The first port (one block per (head, lane), the same
// loop as the first K1) read bf16 rows two bytes at a time, staged V one
// element per thread, ran the online softmax in one warp while seven
// waited and met three barriers per 128-slot tile: 132.56 us at B=32,
// S=1024, 2.3x SDPA (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W).
//
// Design: K1's (csrc/decode_attn.cu) with the insert, and with the heads of
// a lane side by side. The live range [0, read_end] is split into `splits`
// chunks (ops/insert_attn.py `k7_split`); units of K7_UNIT slots are dealt
// out to the chunks in turn (ops/decode_attn.py `chunk_units`). The split
// is a function of read_end, S and the lane count B: one lane takes up to
// 8 chunks, many lanes (the card full already) 2. A lane's result depends
// only on its own inputs: the count only changes how its slots are summed.
// Grid (splits, H / 4, B); the `splits` blocks of one (4 heads, lane) form
// a thread-block cluster (at most 8). A block reads its chunk's positions
// (and int8 scales) into shared memory once for its 4 heads; then warp w
// walks every slot of the chunk for head 4y + w, streaming its rows through
// a ring in shared memory with 16-byte `cp.async` copies, two steps ahead
// of their use, so the block's warps read neighbouring 128-byte pieces of
// the same cache rows together (with one head a block, as K1 has it, the
// blocks read 128 bytes of each 2 KB row at a time, and the kernel ran at
// SDPA's pace, ~2.3 TB/s; PERF.md has both designs' times). A masked row
// is zero-filled, never read. Each lane group
// (D * size / 16 lanes a row) scores its two rows of a step with shuffles
// and folds both into its running max, sum and accumulator in registers
// (logits in log2 units, weights by exp2), so no warp waits on another's
// softmax. The partials merge in fixed order: lane groups by shuffles,
// then each head's partials of the cluster's blocks through distributed
// shared memory after `cluster.sync()`, where block 0 writes out (and m,
// l). Each merge weighs a partial by 2^(m - max m), 0 for one with no
// attended slot (`partial_weight`), so a chunk, a block or a whole lane
// without one never makes NaN.
//
// The write slot. Working type: the chunk that owns slot ws copies its K
// and V rows from k_new, v_new instead of the cache, and counts it iff
// cur_pos[b] >= 0. int8: no chunk reads slot ws (its position counts as
// masked and its scales as 0), and block 0 merges the new row after the
// cluster merge. The last block of each cluster writes its 4 heads'
// columns of the new rows into slot ws (the blocks of heads 0-3 also the
// lane's two scales), at its start: no block reads slot ws from the cache,
// so no read depends on the write and the write needs no barrier; each
// (lane, head) is written once. One launch per call, no workspace, no
// memset. Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W):
// 52.38 us at B=32, S=1024 in the ring (SDPA 59.09, bound 39.91), 30.04
// in linear mode to slot 700, 33.20 over int8 caches at S=896 (34.86 with
// the statistics).
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace ptt {

constexpr int K7_WARPS = 4;
constexpr int K7_THREADS = 32 * K7_WARPS;
constexpr int K7_MAX_SPLITS = 8;
constexpr int K7_SLOTS = 3;   // cp.async ring of each warp, in steps
constexpr int K7_UNIT = 8;    // slots dealt out to the chunks in turn

// dynamic shared memory of one block: the K/V ring, then the chunk's
// positions (and, int8 caches, its k and v scales)
inline size_t k7_smem(int chunk, bool quant) {
  return sizeof(uint4) * K7_WARPS * K7_SLOTS * 4 * 32 +
         (size_t)chunk * (quant ? 12 : 4);
}

template <typename T, typename KV, bool STATS, int D>
__global__ void __launch_bounds__(K7_THREADS)
insert_attn_kernel(const T* __restrict__ q, const KV* __restrict__ kn,
                   const KV* __restrict__ vn, const int* __restrict__ cpos,
                   KV* kc, KV* vc, const int* __restrict__ pos, float* ksc,
                   float* vsc, const float* __restrict__ ksn,
                   const float* __restrict__ vsn, T* __restrict__ out,
                   float* __restrict__ st, const int* __restrict__ ws_dev,
                   int nh, int s_len, int read_end, int ws, float scale) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int VEC = 16 / (int)sizeof(KV);  // values per 16-byte load
  constexpr int LPR = D / VEC;               // lanes per row
  constexpr int RPW = 32 / LPR;              // rows per warp step
  static_assert(D % VEC == 0 && 32 % LPR == 0, "bad head dim");
  cg::cluster_group cluster = cg::this_cluster();
  if (ws_dev) ws = *ws_dev;  // the batch's write slot, kept on the device
  const int n = gridDim.x, c = blockIdx.x, b = blockIdx.z;
  const int live = read_end + 1, ld = nh * D;
  // this chunk: units c, c + n, ... of K7_UNIT slots; local slot t is
  // cache slot slot_of(t), and t < nloc (the last unit may pass read_end)
  const int nloc = ((live + K7_UNIT - 1) / K7_UNIT - c + n - 1) / n * K7_UNIT;
  auto slot_of = [&](int t) {
    return (c + n * (t / K7_UNIT)) * K7_UNIT + t % K7_UNIT;
  };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPR, sub = lane % LPR;
  const int h0 = blockIdx.y * K7_WARPS, h = h0 + warp;  // this warp's head
  const bool head_ok = h < nh;
  const bool new_ok = cpos[b] >= 0;
  const size_t row0 = (size_t)b * s_len * ld;  // the lane's slot 0
  const size_t nrow = (size_t)b * ld;          // the lane's new row
  pos += (size_t)b * s_len;
  if constexpr (QUANT) {
    ksc += (size_t)b * s_len;
    vsc += (size_t)b * s_len;
  }

  // ---- the insert (last block; see the header): this block's heads'
  // columns of the new rows at slot ws ----
  if (c == n - 1) {
    const int cols = min(K7_WARPS, nh - h0) * D;
    for (int e = tid; e < cols; e += K7_THREADS) {
      kc[row0 + (size_t)ws * ld + h0 * D + e] = kn[nrow + h0 * D + e];
      vc[row0 + (size_t)ws * ld + h0 * D + e] = vn[nrow + h0 * D + e];
    }
    if (QUANT && blockIdx.y == 0 && tid == 0) {
      ksc[ws] = ksn[b];
      vsc[ws] = vsn[b];
    }
  }

  // the chunk's positions (and scales), read once for the block's heads
  // with coalesced loads; slot ws: the new row's validity (working type)
  // or masked (int8)
  extern __shared__ __align__(16) unsigned char k7_shared[];
  uint4* ring = reinterpret_cast<uint4*>(k7_shared);
  int* pos_s = reinterpret_cast<int*>(ring + K7_WARPS * K7_SLOTS * 4 * 32);
  float* ks_s = reinterpret_cast<float*>(pos_s + nloc);
  float* vs_s = ks_s + nloc;
#pragma unroll 4
  for (int t = tid; t < nloc; t += K7_THREADS) {
    const int s = slot_of(t);
    const bool in = s < live && s != ws;
    pos_s[t] = s == ws ? (!QUANT && new_ok ? 0 : -1) : in ? pos[s] : -1;
    if constexpr (QUANT) {
      ks_s[t] = in ? ksc[s] : 0.f;
      vs_s[t] = in ? vsc[s] : 0.f;
    }
  }
  float qv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    qv[i] = head_ok ? to_f(q[((size_t)b * nh + h) * D + sub * VEC + i]) : 0.f;
  // int8: each head's new-row logit (q . k_new * ks_new), for block 0's
  // merge
  __shared__ float lnew[K7_WARPS];
  if constexpr (QUANT) {
    if (c == 0 && head_ok) {
      float dot = 0.f;
      for (int j = lane; j < D; j += 32)
        dot += to_f(q[((size_t)b * nh + h) * D + j]) *
               ((float)kn[nrow + h * D + j] * ksn[b]);
      dot = warp_sum(dot);
      if (lane == 0) lnew[warp] = dot;
    }
  }
  __syncthreads();

  // Warp w walks every slot of the chunk for its head h0 + w, so the
  // block's warps read neighbouring 128-byte pieces of the same cache rows
  // together. Step i covers local slots t and t + RPW, t = i * 2 RPW + grp.
  // Each lane copies its 16 bytes of the step's K and V rows into its own
  // slots of the warp's ring (zeros for a masked row, which is never read;
  // the new row for slot ws) and later reads back only those, so the ring
  // needs no barrier.
  constexpr int R2 = 2 * RPW;
  const int nsteps = head_ok ? (nloc + R2 - 1) / R2 : 0;
  uint4* my = ring + warp * K7_SLOTS * 4 * 32 + lane;
  const KV* kr = kc + row0 + h * D + sub * VEC;
  const KV* vr = vc + row0 + h * D + sub * VEC;
  const KV* knr = kn + nrow + h * D + sub * VEC;
  const KV* vnr = vn + nrow + h * D + sub * VEC;
  auto issue = [&](int i) {
    if (i < nsteps) {
      const int slot = i % K7_SLOTS;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = i * R2 + grp + u * RPW;
        const bool ok = t < nloc && pos_s[t] >= 0;
        const int s = ok ? slot_of(t) : 0;
        cp_async16(my + (4 * slot + 2 * u) * 32,
                   s == ws ? knr : kr + (size_t)s * ld, ok);
        cp_async16(my + (4 * slot + 2 * u + 1) * 32,
                   s == ws ? vnr : vr + (size_t)s * ld, ok);
      }
    }
    cp_async_commit();  // one group per step, empty past the end
  };
#pragma unroll
  for (int i = 0; i < K7_SLOTS - 1; ++i) issue(i);
  const float sc2 = scale * LOG2E;  // logits in log2 units
  float m = -INFINITY, l = 0.f, acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  // nsteps is warp-uniform, so every lane takes part in the shuffles
  for (int i = 0; i < nsteps; ++i) {
    issue(i + K7_SLOTS - 1);
    cp_async_wait<K7_SLOTS - 1>();  // step i has landed
    const int t0 = i * R2 + grp, slot = i % K7_SLOTS;
    float lg[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float kf[VEC];
      unpack16<KV>(my[(4 * slot + 2 * u) * 32], kf);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) dot += qv[j] * kf[j];
      lg[u] = dot;
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) {
      lg[0] += __shfl_xor_sync(0xffffffffu, lg[0], o);
      lg[1] += __shfl_xor_sync(0xffffffffu, lg[1], o);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = t0 + u * RPW;
      float x = lg[u] * sc2;
      if constexpr (QUANT) x *= (t < nloc ? ks_s[t] : 0.f);
      lg[u] = t < nloc && pos_s[t] >= 0 ? x : -INFINITY;
    }
    // both rows folded into the running max, sum and accumulator at once;
    // each weight is rounded to the working type against that max
    const float m_new = fmaxf(m, fmaxf(lg[0], lg[1]));
    if (m_new != -INFINITY) {  // uniform over the lane group
      const float corr = exp2f(m - m_new);
      float w[2];
      l *= corr;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float p = exp2f(lg[u] - m_new);
        l += p;
        float pw = p;
        if constexpr (QUANT)
          pw *= t0 + u * RPW < nloc ? vs_s[t0 + u * RPW] : 0.f;
        w[u] = rnd<T>(pw);
      }
      float v0[VEC], v1[VEC];
      unpack16<KV>(my[(4 * slot + 1) * 32], v0);
      unpack16<KV>(my[(4 * slot + 3) * 32], v1);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] = acc[j] * corr + w[0] * v0[j] + w[1] * v1[j];
      m = m_new;
    }
  }

  // ---- merge: lane groups (shuffles), then the cluster's blocks for each
  // head (distributed shared memory), in fixed order ----
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    const float mx = fmaxf(m, m2);
    const float w1 = partial_weight(m, mx), w2 = partial_weight(m2, mx);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float a2 = __shfl_xor_sync(0xffffffffu, acc[j], o);
      acc[j] = acc[j] * w1 + a2 * w2;
    }
    l = l * w1 + l2 * w2;
    m = mx;
  }
  __shared__ float wm[K7_WARPS], wl[K7_WARPS];
  __shared__ __align__(16) float wacc[K7_WARPS][D];
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) wacc[warp][sub * VEC + j] = acc[j];
    if (sub == 0) {
      wm[warp] = m;
      wl[warp] = l;
    }
  }
  cluster.sync();  // every block's partials are in its shared memory
  if (c == 0 && head_ok) {
    // lane L: columns CPL * L .. CPL * L + CPL - 1 of head h (two at
    // D = 64, four at D = 128); all remote reads issued before the first
    // is used
    constexpr int CPL = D / 32;
    static_assert(D == 64 || D == 128, "two or four columns a lane");
    float mr[K7_MAX_SPLITS], lr[K7_MAX_SPLITS], ar[K7_MAX_SPLITS][CPL];
#pragma unroll
    for (int r = 0; r < K7_MAX_SPLITS; ++r) {
      if (r < n) {
        mr[r] = cluster.map_shared_rank(wm, r)[warp];
        lr[r] = cluster.map_shared_rank(wl, r)[warp];
        const float* src =
            &cluster.map_shared_rank(&wacc[0][0], r)[warp * D + CPL * lane];
#pragma unroll
        for (int j = 0; j < CPL; j += 2) {
          const float2 a2 = *reinterpret_cast<const float2*>(src + j);
          ar[r][j] = a2.x;
          ar[r][j + 1] = a2.y;
        }
      }
    }
    float mx = mr[0];
#pragma unroll
    for (int r = 1; r < K7_MAX_SPLITS; ++r)
      if (r < n) mx = fmaxf(mx, mr[r]);
    float a[CPL], ll = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) a[j] = 0.f;
#pragma unroll
    for (int r = 0; r < K7_MAX_SPLITS; ++r) {
      if (r < n) {
        const float f = partial_weight(mr[r], mx);
#pragma unroll
        for (int j = 0; j < CPL; ++j) a[j] += ar[r][j] * f;
        ll += lr[r] * f;
      }
    }
    // int8: the new row, float32 and unrounded, after the cluster merge
    if constexpr (QUANT) {
      if (new_ok) {
        const float lg = lnew[warp] * sc2;
        const float m_fin = fmaxf(mx, lg);
        const float corr = exp2f(mx - m_fin), pn = exp2f(lg - m_fin);
        const size_t vi = nrow + h * D + CPL * lane;
        ll = ll * corr + pn;
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          a[j] = a[j] * corr + pn * ((float)vn[vi + j] * vsn[b]);
        mx = m_fin;
      }
    }
    const size_t i = (size_t)b * nh + h;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      out[i * D + CPL * lane + j] = from_f<T>(ll > 0.f ? a[j] / ll : 0.f);
    if (STATS && lane == 0) {
      st[i] = mx * LN2;  // back to natural-log units
      st[(size_t)gridDim.z * nh + i] = ll;
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its partials
}

}  // namespace ptt

// q (B, H, D); k_new, v_new (B, H*D); cur_pos (B,) int32; k_cache, v_cache
// (B, S, H*D) pre-insert, written in place at slot ws; pos (B, S) int32
// post-insert; out (B, H, D). Caches and new rows of q's type, or int8 when
// k_scale, v_scale ((B, S) float32, written at ws) and ks_new, vs_new
// ((B,) float32) are given; caches and new rows 16-byte aligned. stats (or
// null): (2, B, H) float32, m then l. Requires 0 <= ws <= read_end < S.
// ws_dev (or null): a device int32 that holds the write slot, read by each
// block at entry in place of ws (ws is then its host mirror, checked here):
// the slot a CUDA graph's frame advanced on the device.
// splits: chunks of [0, read_end], one block each in a cluster (1 to 8, at
// most ceil((read_end + 1) / 8)).
extern "C" int ptt_insert_attn(const void* q, const void* k_new,
                               const void* v_new, const void* cur_pos,
                               void* k_cache, void* v_cache, const void* pos,
                               void* k_scale, void* v_scale,
                               const void* ks_new, const void* vs_new,
                               void* out, void* stats, const void* ws_dev,
                               int B, int H, int D, int S, int read_end,
                               int ws, int splits, int dtype, void* stream) {
  const bool quant = k_scale != nullptr;
  if ((D != 64 && D != 128) || B < 1 || H < 1 || ws < 0 || ws > read_end ||
      read_end >= S || splits < 1 || splits > ptt::K7_MAX_SPLITS ||
      splits > (read_end + ptt::K7_UNIT) / ptt::K7_UNIT ||
      (v_scale != nullptr) != quant || (ks_new != nullptr) != quant ||
      (vs_new != nullptr) != quant ||
      (H * D * (quant ? 1 : dtype ? 2 : 4)) % 16 ||
      ((uintptr_t)k_cache | (uintptr_t)v_cache | (uintptr_t)k_new |
       (uintptr_t)v_new) % 16)
    return (int)cudaErrorInvalidValue;
  const int units = (read_end + ptt::K7_UNIT) / ptt::K7_UNIT;
  const size_t smem = ptt::k7_smem(
      (units + splits - 1) / splits * ptt::K7_UNIT, quant);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(splits, (H + ptt::K7_WARPS - 1) / ptt::K7_WARPS, B);
#define PTT_K7_D(KV, STATS, D_)                                              \
  rc = ptt::launch_clustered(                                                \
      ptt::insert_attn_kernel<T, KV, STATS, D_>, grid, dim3(ptt::K7_THREADS), \
      splits, smem, st, (const T*)q, (const KV*)k_new, (const KV*)v_new,     \
      (const int*)cur_pos, (KV*)k_cache, (KV*)v_cache, (const int*)pos,      \
      (float*)k_scale, (float*)v_scale, (const float*)ks_new,                \
      (const float*)vs_new, (T*)out, (float*)stats, (const int*)ws_dev, H,   \
      S, read_end, ws, scale)
#define PTT_K7(KV, STATS)                                                    \
  do {                                                                       \
    if (D == 64) PTT_K7_D(KV, STATS, 64);                                    \
    else PTT_K7_D(KV, STATS, 128);                                           \
  } while (0)
  cudaError_t rc = cudaSuccess;
  PTT_DISPATCH(dtype, T, {
    if (quant) {
      if (stats) PTT_K7(int8_t, true); else PTT_K7(int8_t, false);
    } else {
      if (stats) PTT_K7(T, true); else PTT_K7(T, false);
    }
  });
#undef PTT_K7
#undef PTT_K7_D
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}
