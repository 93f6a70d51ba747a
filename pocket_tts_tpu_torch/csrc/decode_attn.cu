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
// skipping slots whose recorded position pos[b, s] < 0. Logits and softmax statistics are float32
// with scale 1/sqrt(D); the softmax weights are rounded to the cache type
// before the PV product (as the TPU kernel does) and PV accumulates in
// float32. Output (B, H, D) in the working type. int8 caches (`_flash_main_
// block` with `quant`): logit = (q . k_int8) * scale * k_scale[s], and the
// weight times v_scale[s] is rounded to the working type before it meets
// the int8 row, so the dequantised cache never exists. stats: the running
// max m and normaliser l of each (lane, head) are written out; a masked
// slot is skipped (the TPU kernel adds a finite -1e9), so a lane with no
// live slot gives out 0, m = -inf and l = 0, which merge_attn_partials
// turns into the prefix partial alone (K7's convention, insert_attn.cu).
//
// What bounds it on the H100: bytes. Each call streams 2 * (end+1) * D
// elements per head from HBM and does ~4 flops per element, far below the
// card's ~295 flop/byte ridge (1.2 MB at S=384 would take ~0.4 us at full
// bandwidth; half that with int8 rows). The design reads only the live
// prefix [0, end] (never the whole capacity), reads every K and V element
// once (int8 rows in 16-byte vector loads), and keeps scores, the running
// max/sum and the accumulator on chip. With one block per head, 16 blocks
// cannot draw the card's bandwidth, so this version is bound by per-block
// latency instead; splitting S across more blocks is the next step.
//
// Layout: one thread block per (head, lane) (16 solo, 512 at B = 32, H =
// 16), 256 threads. The block
// walks the live slots in tiles of 128: two threads score one slot (each a
// half of the D-dot, joined by a shuffle), warp 0 folds the tile into the
// online max/sum, and all 256 threads (4 slot groups x D lanes) accumulate
// PV from the tile's V rows, which the block stages in shared memory with
// coalesced loads while it scores the tile. A split-S second pass, for
// more blocks than heads, is later work.
#include <type_traits>

#include "common.cuh"

namespace ptt {

constexpr int K1_THREADS = 256;
constexpr int K1_TILE = 128;

template <typename T, typename KV, bool STATS, int D>
__global__ void __launch_bounds__(K1_THREADS)
decode_attn_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                   const KV* __restrict__ v, const int* __restrict__ pos,
                   const float* __restrict__ ksc,
                   const float* __restrict__ vsc, T* __restrict__ out,
                   float* __restrict__ st, int nh, int s_len, int ld,
                   int end, float scale) {
  static_assert(K1_THREADS % D == 0 && D % 32 == 0, "bad head dim");
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int G = K1_THREADS / D;  // slot groups in the PV phase
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  q += ((size_t)b * nh + h) * D;
  out += ((size_t)b * nh + h) * D;
  k += (size_t)b * s_len * ld + h * D;
  v += (size_t)b * s_len * ld + h * D;
  pos += (size_t)b * s_len;
  if constexpr (QUANT) {
    ksc += (size_t)b * s_len;
    vsc += (size_t)b * s_len;
  }

  __shared__ float qs[D];
  __shared__ float ps[K1_TILE];
  __shared__ float vscs[K1_TILE];  // int8: the tile's v scales
  __shared__ float vs[K1_TILE][D];
  __shared__ float red[G][D];
  __shared__ float corr_sh, l_sh;

  if (tid < D) qs[tid] = to_f(q[tid]);
  __syncthreads();

  float m = -INFINITY, l = 0.f;  // meaningful in warp 0
  float acc = 0.f;               // PV partial of (slot group g, lane d)
  const int d = tid % D, g = tid / D;

  for (int base = 0; base <= end; base += K1_TILE) {
    const int n = min(K1_TILE, end - base + 1);
    // ---- stage the tile's V rows in shared memory (coalesced, all loads
    // in flight at once; int8 rows 16 bytes a thread) ----
    if constexpr (QUANT) {
      for (int e = tid; e < n * (D / 16); e += K1_THREADS) {
        const int i = e / (D / 16), c0 = (e % (D / 16)) * 16;
        load16(v + (size_t)(base + i) * ld + c0, &vs[i][c0]);
      }
      if (tid < n) vscs[tid] = vsc[base + tid];
    } else {
      for (int e = tid; e < n * D; e += K1_THREADS)
        vs[e / D][e % D] = to_f(v[(size_t)(base + e / D) * ld + e % D]);
    }
    // ---- scores: two threads per slot ----
    {
      const int i = tid >> 1, half = tid & 1, s = base + i;
      float dot = 0.f;
      bool ok = false;
      if (s <= end) {
        ok = pos[s] >= 0;
        const KV* kr = k + (size_t)s * ld + half * (D / 2);
        const float* qh = qs + half * (D / 2);
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
      if (half == 0) {
        float lg = dot * scale;
        if constexpr (QUANT) lg = ok ? lg * ksc[s] : 0.f;
        ps[i] = ok ? lg : -INFINITY;
      }
    }
    __syncthreads();
    // ---- online softmax statistics: warp 0 ----
    if (tid < 32) {
      float tmax = -INFINITY;
      for (int j = tid; j < K1_TILE; j += 32) tmax = fmaxf(tmax, ps[j]);
      tmax = warp_max(tmax);
      const float m_new = fmaxf(m, tmax);
      float corr = 1.f, sum = 0.f;
      if (m_new != -INFINITY) {
        corr = expf(m - m_new);
        for (int j = tid; j < K1_TILE; j += 32) {
          const float p = expf(ps[j] - m_new);
          ps[j] = p;
          sum += p;
        }
      } else {
        for (int j = tid; j < K1_TILE; j += 32) ps[j] = 0.f;
      }
      sum = warp_sum(sum);
      l = l * corr + sum;
      m = m_new;
      if (tid == 0) corr_sh = corr;
    }
    __syncthreads();
    // ---- PV: p (times the v scale) rounded to the working type, f32
    // accumulation ----
    {
      const float corr = corr_sh;
      float part = 0.f;
      for (int j = g; j < n; j += G) {
        const float p = QUANT ? ps[j] * vscs[j] : ps[j];
        part += rnd<T>(p) * vs[j][d];
      }
      acc = acc * corr + part;
    }
    __syncthreads();
  }
  red[g][d] = acc;
  if (tid == 0) l_sh = l;
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) s += red[gg][tid];
    out[tid] = from_f<T>(s / fmaxf(l_sh, 1e-30f));
  }
  if (STATS && tid == 0) {  // thread 0 holds warp 0's m and l
    const size_t i = (size_t)b * nh + h;
    st[i] = m;
    st[(size_t)gridDim.y * nh + i] = l;
  }
}

}  // namespace ptt

// q (B, H, D); k, v (B, S, ld) flat rows with ld = H*D, of q's type, or
// int8 when k_scale and v_scale ((B, S) float32) are given; pos (B, S)
// int32; out (B, H, D); stats (or null): (2, B, H) float32, m then l.
// end: last slot read, shared by the lanes (0 <= end < S). B = 1 is the
// solo call.
extern "C" int ptt_decode_attn(const void* q, const void* k, const void* v,
                               const void* pos, const void* k_scale,
                               const void* v_scale, void* out, void* stats,
                               int B, int H, int D, int S, int ld, int end,
                               int dtype, void* stream) {
  const bool quant = k_scale != nullptr;
  if (D != 64 || B < 1 || H < 1 || ld < H * D || end < 0 || end >= S ||
      quant != (v_scale != nullptr) || (quant && ld % 16))
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(H, B);
#define PTT_K1(KV, STATS)                                                   \
  ptt::decode_attn_kernel<T, KV, STATS, 64><<<grid, ptt::K1_THREADS, 0, st>>>( \
      (const T*)q, (const KV*)k, (const KV*)v, (const int*)pos,           \
      (const float*)k_scale, (const float*)v_scale, (T*)out, (float*)stats, \
      H, S, ld, end, scale)
  PTT_DISPATCH(dtype, T, {
    if (quant) {
      if (stats) PTT_K1(int8_t, true); else PTT_K1(int8_t, false);
    } else {
      if (stats) PTT_K1(T, true); else PTT_K1(T, false);
    }
  });
#undef PTT_K1
  return (int)cudaGetLastError();
}
