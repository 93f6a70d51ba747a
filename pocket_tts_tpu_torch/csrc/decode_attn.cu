// K1: T=1 flash-decode attention over the backbone's flat KV cache, solo or
// over B lanes.
//
// Replaces the TPU kernel `pocket_tts_tpu/ops/pallas_attn.py:
// decode_attention` (`_decode_attention_batched` -> `_decode_attn_kernel`,
// `_flash_main_block`, `_collapse_out`) over caches of the working type or,
// as `_make_decode_attention_q`, int8 caches with one float32 scale per
// row; with or without the flash statistics (`stats`, `:326`/`:353`) that
// the shared-prefix serving merges with the prompt partial. The lane axis is
// the JAX package's vmap over B streams with a batch-uniform `end`.
//
// What it computes, per lane b and head h: one query q[b, h] (D) over the
// lane's cache rows k[b, s, h*D : h*D+D] for the live slots s <= end,
// skipping slots whose recorded position pos[b, s] < 0. Logits and softmax
// statistics are float32 with scale 1/sqrt(D); each softmax weight is
// rounded to the cache type before the PV product (as the TPU kernel does),
// relative to the running max it was taken against, and PV accumulates in
// float32. Output (B, H, D) in the working type. int8 caches
// (`_flash_main_block` with `quant`): logit = (q . k_int8) * scale *
// k_scale[s], and the weight times v_scale[s] is rounded to the working
// type before it meets the int8 row, so the dequantised cache never exists.
// stats: the max m and normaliser l of each (lane, head) are written out; a
// masked slot is skipped (the TPU kernel adds a finite -1e9), so a lane with
// no live slot gives out 0, m = -inf and l = 0, which merge_attn_partials
// turns into the prefix partial alone (K7's convention, insert_attn.cu).
//
// What bounds it on the H100: bytes, and at batch 1 latency. A call reads
// the K and V rows of the live slots once (2 * D elements per slot and
// head) and does ~4 flops per element, far below the card's ~295 flop/byte
// ridge: at S = 384, end = 300 that is 1.2 MB (~0.4 us at 3.35 TB/s), at 32
// lanes and S = 1024 ~72 MB of live rows (~22 us). One block per (head,
// lane), as the first port had it, put 16 blocks on 132 SMs solo and read
// bf16 rows two bytes at a time.
//
// Design. The live range [0, end] is split into `splits` chunks (ops/
// decode_attn.py `k1_split`: a function of end and S only, never of B, so a
// lane gives the solo call's bits). The slots are cut into units of
// K1_UNIT and unit u goes to chunk u % splits (ops/decode_attn.py
// `chunk_units`): dealt out in turn, a lane's masked prefix or a run of
// holes spreads over all chunks, so no block of a cluster idles at the
// barrier while another works. Grid (splits, H, B); the `splits` blocks of one
// (head, lane) form a thread-block cluster (at most 8, the portable size),
// so a solo call at end = 300 runs 4 x 16 = 64 blocks (k1_split stops at
// four: more chunks gain the solo call nothing and cost 32 lanes ~1-2 us
// each; chip_smoke.py `time_splits` times each count). Each block of 4
// warps walks its chunk. It first reads the chunk's positions (and int8
// scales) into shared memory with coalesced loads. Then each warp streams
// its rows through a ring in shared memory with 16-byte `cp.async` copies
// (D*size/16 lanes a row: a bf16 row is 8 lanes, so a warp copies 8 whole
// 128-byte rows a step, two per lane group), two steps ahead of their use;
// a masked row (pos < 0) is zero-filled, never read. The copies hold no
// registers, so many warps per SM keep many rows in flight. Each lane
// reads back only the bytes it copied (no barrier), scores its two rows
// with shuffle reductions inside the lane group, and folds both at once
// into that lane group's running max, sum and accumulator in registers
// (logits in log2 units, weights by exp2). The partials
// then merge in fixed order: lane groups by shuffles, warps through shared
// memory, the cluster's blocks through distributed shared memory after
// `cluster.sync()`, where block 0 writes out (and m, l), with every remote
// read issued before the first is used. A merge weighs each partial by
// 2^(m - max m) and gives 0 to one with no live slot (`partial_weight`),
// so a chunk, a block or a whole lane without one never makes NaN.
// One launch per call, no workspace, no memset.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace ptt {

constexpr int K1_WARPS = 4;
constexpr int K1_THREADS = 32 * K1_WARPS;
constexpr int K1_MAX_SPLITS = 8;
// cp.async ring of each warp, in steps: a slot holds the K and V bytes of
// a step's two rows, 4 x 16 bytes a lane
constexpr int K1_SLOTS = 3;
constexpr int K1_UNIT = 8;    // slots dealt out to the chunks in turn

// dynamic shared memory of one block: the K/V ring, then the chunk's
// positions (and, int8 caches, its k and v scales)
inline size_t k1_smem(int chunk, bool quant) {
  return sizeof(uint4) * K1_WARPS * K1_SLOTS * 4 * 32 +
         (size_t)chunk * (quant ? 12 : 4);
}

template <typename T, typename KV, bool STATS, int D>
__global__ void __launch_bounds__(K1_THREADS)
decode_attn_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                   const KV* __restrict__ v, const int* __restrict__ pos,
                   const float* __restrict__ ksc,
                   const float* __restrict__ vsc, T* __restrict__ out,
                   float* __restrict__ st, int nh, int s_len, int ld,
                   int end, float scale) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int VEC = 16 / (int)sizeof(KV);  // values per 16-byte load
  constexpr int LPR = D / VEC;               // lanes per row
  constexpr int RPW = 32 / LPR;              // rows per warp step
  static_assert(D % VEC == 0 && 32 % LPR == 0, "bad head dim");
  cg::cluster_group cluster = cg::this_cluster();
  const int n = gridDim.x, c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int live = end + 1;
  // this chunk: units c, c + n, ... of K1_UNIT slots; local slot t is
  // cache slot slot_of(t), and t < nloc (the last unit may pass end)
  const int nloc = ((live + K1_UNIT - 1) / K1_UNIT - c + n - 1) / n * K1_UNIT;
  auto slot_of = [&](int t) {
    return (c + n * (t / K1_UNIT)) * K1_UNIT + t % K1_UNIT;
  };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPR, sub = lane % LPR;
  q += ((size_t)b * nh + h) * D;
  k += (size_t)b * s_len * ld + h * D + sub * VEC;
  v += (size_t)b * s_len * ld + h * D + sub * VEC;
  pos += (size_t)b * s_len;
  if constexpr (QUANT) {
    ksc += (size_t)b * s_len;
    vsc += (size_t)b * s_len;
  }

  // the chunk's positions (and scales), read once with coalesced loads, so
  // that no row copy waits on a position
  extern __shared__ __align__(16) unsigned char k1_shared[];
  uint4* ring = reinterpret_cast<uint4*>(k1_shared);
  int* pos_s = reinterpret_cast<int*>(ring + K1_WARPS * K1_SLOTS * 4 * 32);
  float* ks_s = reinterpret_cast<float*>(pos_s + nloc);
  float* vs_s = ks_s + nloc;
#pragma unroll 4
  for (int t = tid; t < nloc; t += K1_THREADS) {
    const int s = slot_of(t);
    pos_s[t] = s < live ? pos[s] : -1;
    if constexpr (QUANT) {
      ks_s[t] = s < live ? ksc[s] : 0.f;
      vs_s[t] = s < live ? vsc[s] : 0.f;
    }
  }
  float qv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) qv[i] = to_f(q[sub * VEC + i]);
  __syncthreads();

  // Warp step i covers local slots t and t + RPW, t = (i * K1_WARPS +
  // warp) * 2 RPW + grp. Each lane copies its 16 bytes of the step's K and
  // V rows into its own slots of the warp's ring (zeros for a masked row,
  // which is never read) and later reads back only those, so the ring
  // needs no barrier.
  constexpr int R2 = 2 * RPW;   // rows a warp step covers
  const int nsteps =
      max(0, (nloc - warp * R2 + K1_WARPS * R2 - 1) / (K1_WARPS * R2));
  uint4* my = ring + warp * K1_SLOTS * 4 * 32 + lane;
  auto local_of = [&](int i) { return (i * K1_WARPS + warp) * R2 + grp; };
  auto issue = [&](int i) {
    if (i < nsteps) {
      const int slot = i % K1_SLOTS;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = local_of(i) + u * RPW;
        const bool ok = t < nloc && pos_s[t] >= 0;
        const size_t o = ok ? (size_t)slot_of(t) * ld : 0;
        cp_async16(my + (4 * slot + 2 * u) * 32, k + o, ok);
        cp_async16(my + (4 * slot + 2 * u + 1) * 32, v + o, ok);
      }
    }
    cp_async_commit();  // one group per step, empty past the end
  };
#pragma unroll
  for (int i = 0; i < K1_SLOTS - 1; ++i) issue(i);
  // logits in log2 units: the softmax weights exp2(x - max) are exp(...)
  const float sc2 = scale * LOG2E;
  float m = -INFINITY, l = 0.f, acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  // nsteps is warp-uniform, so every lane takes part in the shuffles
  for (int i = 0; i < nsteps; ++i) {
    issue(i + K1_SLOTS - 1);
    cp_async_wait<K1_SLOTS - 1>();  // step i has landed
    const int t0 = local_of(i), slot = i % K1_SLOTS;
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

  // ---- merge: lane groups (shuffles), warps (shared memory), the
  // cluster's blocks (distributed shared memory), all in fixed order ----
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
  __shared__ float wm[K1_WARPS], wl[K1_WARPS], wacc[K1_WARPS][D];
  __shared__ float bm, bl, bacc[D];  // this block's partial
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) wacc[warp][sub * VEC + j] = acc[j];
    if (sub == 0) {
      wm[warp] = m;
      wl[warp] = l;
    }
  }
  __syncthreads();
  if (tid < D) {
    float mx = wm[0];
#pragma unroll
    for (int w = 1; w < K1_WARPS; ++w) mx = fmaxf(mx, wm[w]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < K1_WARPS; ++w) {
      const float f = partial_weight(wm[w], mx);
      a += wacc[w][tid] * f;
      ll += wl[w] * f;
    }
    bacc[tid] = a;
    if (tid == 0) {
      bm = mx;
      bl = ll;
    }
  }
  cluster.sync();  // every block's partial is in its shared memory
  if (c == 0 && tid < D) {
    // all remote reads issued before the first is used
    float mr[K1_MAX_SPLITS], lr[K1_MAX_SPLITS], ar[K1_MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < K1_MAX_SPLITS; ++r) {
      if (r < n) {
        mr[r] = *cluster.map_shared_rank(&bm, r);
        lr[r] = *cluster.map_shared_rank(&bl, r);
        ar[r] = cluster.map_shared_rank(bacc, r)[tid];
      }
    }
    float mx = mr[0];
#pragma unroll
    for (int r = 1; r < K1_MAX_SPLITS; ++r)
      if (r < n) mx = fmaxf(mx, mr[r]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int r = 0; r < K1_MAX_SPLITS; ++r) {
      if (r < n) {
        const float f = partial_weight(mr[r], mx);
        a += ar[r] * f;
        ll += lr[r] * f;
      }
    }
    const size_t i = (size_t)b * nh + h;
    out[i * D + tid] = from_f<T>(ll > 0.f ? a / ll : 0.f);
    if (STATS && tid == 0) {
      st[i] = mx * LN2;  // back to natural-log units
      st[(size_t)gridDim.z * nh + i] = ll;
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its partial
}

}  // namespace ptt

// q (B, H, D); k, v (B, S, ld) flat rows with ld = H*D, of q's type, or
// int8 when k_scale and v_scale ((B, S) float32) are given; 16-byte
// aligned; pos (B, S) int32; out (B, H, D); stats (or null): (2, B, H)
// float32, m then l. end: last slot read, shared by the lanes (0 <= end <
// S). splits: chunks of [0, end], one block each in a cluster (1 to 8, at
// most ceil((end + 1) / 8)). B = 1 is the solo call.
extern "C" int ptt_decode_attn(const void* q, const void* k, const void* v,
                               const void* pos, const void* k_scale,
                               const void* v_scale, void* out, void* stats,
                               int B, int H, int D, int S, int ld, int end,
                               int splits, int dtype, void* stream) {
  const bool quant = k_scale != nullptr;
  if (D != 64 || B < 1 || H < 1 || ld < H * D || end < 0 || end >= S ||
      splits < 1 || splits > ptt::K1_MAX_SPLITS ||
      splits > (end + ptt::K1_UNIT) / ptt::K1_UNIT ||
      quant != (v_scale != nullptr) || (ld * (quant ? 1 : dtype ? 2 : 4)) % 16
      || ((uintptr_t)k | (uintptr_t)v) % 16)
    return (int)cudaErrorInvalidValue;
  const int units = (end + ptt::K1_UNIT) / ptt::K1_UNIT;
  const size_t smem = ptt::k1_smem(
      (units + splits - 1) / splits * ptt::K1_UNIT, quant);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(splits, H, B);
#define PTT_K1(KV, STATS)                                                    \
  rc = ptt::launch_clustered(ptt::decode_attn_kernel<T, KV, STATS, 64>, grid, \
                             dim3(ptt::K1_THREADS), splits, smem, st,        \
                             (const T*)q, (const KV*)k, (const KV*)v,        \
                             (const int*)pos, (const float*)k_scale,         \
                             (const float*)v_scale, (T*)out, (float*)stats,  \
                             H, S, ld, end, scale)
  cudaError_t rc = cudaSuccess;
  PTT_DISPATCH(dtype, T, {
    if (quant) {
      if (stats) PTT_K1(int8_t, true); else PTT_K1(int8_t, false);
    } else {
      if (stats) PTT_K1(T, true); else PTT_K1(T, false);
    }
  });
#undef PTT_K1
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}
