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
// Logits and softmax statistics are float32 with scale 1/sqrt(D); the
// softmax weights are rounded to the cache type before the PV product and
// PV accumulates in float32 (the TPU kernel accumulates PV in bf16 on its
// MXU; that is not reproduced).
//
// int8 caches: the new row arrives quantized, with its scales ks_new[b],
// vs_new[b]; its bytes go to the write slot and its scales to k_scale[b,
// ws] and v_scale[b, ws]. The other slots score (q . k) * scale *
// k_scale[s], and their weights times v_scale[s] are rounded to the
// working type before they meet the int8 rows. The write slot is left out
// of the block loop (its stale bytes and stale scale are never read) and
// merged after it, as the TPU kernel does (`pallas_attn.py:663-688`): from
// the new row times its scale, in float32, unrounded.
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
// flop/byte ridge. The design reads every K and V element once (int8 rows
// in 16-byte vector loads), keeps scores, the running max/sum and the
// accumulator on chip, and launches B*H blocks (512 at B=32, H=16), so the
// whole card streams at once. The TPU kernel's aligned-window DMA, 0/1 MXU
// expansion masks and lane-group stacking are TPU workarounds and are not
// carried over.
//
// Layout: one block per (head, lane), 256 threads; the same loop as K1
// (csrc/decode_attn.cu): tiles of 128 slots, two threads score a slot, warp
// 0 folds the tile into the online max/sum, all threads accumulate PV from
// the tile's V rows staged in shared memory. Thread d < D first writes
// column d of its head's new K and V row at the write slot (block h = 0 the
// lane's two scales): a block writes only its own (lane, head) columns and
// reads the write slot only from the new row, so no block races another
// and no read depends on the write.
#include <type_traits>

#include "common.cuh"

namespace ptt {

constexpr int K7_THREADS = 256;
constexpr int K7_TILE = 128;

template <typename T, typename KV, bool STATS, int D>
__global__ void __launch_bounds__(K7_THREADS)
insert_attn_kernel(const T* __restrict__ q, const KV* __restrict__ kn,
                   const KV* __restrict__ vn, const int* __restrict__ cpos,
                   KV* kc, KV* vc, const int* __restrict__ pos, float* ksc,
                   float* vsc, const float* __restrict__ ksn,
                   const float* __restrict__ vsn, T* __restrict__ out,
                   float* __restrict__ st, int nh, int s_len, int read_end,
                   int ws, float scale) {
  static_assert(K7_THREADS % D == 0 && D % 32 == 0, "bad head dim");
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int G = K7_THREADS / D;  // slot groups in the PV phase
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ld = nh * D;
  q += ((size_t)b * nh + h) * D;
  out += ((size_t)b * nh + h) * D;
  kn += (size_t)b * ld + h * D;
  vn += (size_t)b * ld + h * D;
  kc += (size_t)b * s_len * ld + h * D;
  vc += (size_t)b * s_len * ld + h * D;
  pos += (size_t)b * s_len;
  if constexpr (QUANT) {
    ksc += (size_t)b * s_len;
    vsc += (size_t)b * s_len;
  }
  const bool new_ok = cpos[b] >= 0;

  __shared__ float qs[D];
  __shared__ float ps[K7_TILE];
  __shared__ float vscs[K7_TILE];  // int8: the tile's v scales
  __shared__ float vs[K7_TILE][D];
  __shared__ float red[G][D];
  __shared__ float corr_sh, pn_sh, m_sh, l_sh;

  if (tid < D) {
    qs[tid] = to_f(q[tid]);
    kc[(size_t)ws * ld + tid] = kn[tid];
    vc[(size_t)ws * ld + tid] = vn[tid];
  }
  if (QUANT && h == 0 && tid == 0) {  // the lane's scales, once
    ksc[ws] = ksn[b];
    vsc[ws] = vsn[b];
  }
  __syncthreads();

  float m = -INFINITY, l = 0.f;  // meaningful in warp 0
  float acc = 0.f;               // PV partial of (slot group g, lane d)
  const int d = tid % D, g = tid / D;

  for (int base = 0; base <= read_end; base += K7_TILE) {
    const int n = min(K7_TILE, read_end - base + 1);
    // ---- stage the tile's V rows (working type: slot ws from the new
    // row; int8: slot ws left out, 16 bytes a thread) ----
    if constexpr (QUANT) {
      for (int e = tid; e < n * (D / 16); e += K7_THREADS) {
        const int i = e / (D / 16), c0 = (e % (D / 16)) * 16;
        if (base + i == ws) {
#pragma unroll
          for (int j = 0; j < 16; ++j) vs[i][c0 + j] = 0.f;
        } else {
          load16(vc + (size_t)(base + i) * ld + c0, &vs[i][c0]);
        }
      }
      if (tid < n) vscs[tid] = base + tid == ws ? 0.f : vsc[base + tid];
    } else {
      for (int e = tid; e < n * D; e += K7_THREADS) {
        const int s = base + e / D;
        vs[e / D][e % D] = to_f(s == ws ? vn[e % D]
                                        : vc[(size_t)s * ld + e % D]);
      }
    }
    // ---- scores: two threads per slot ----
    {
      const int i = tid >> 1, half = tid & 1, s = base + i;
      float dot = 0.f;
      bool ok = false;
      if (s <= read_end) {
        if constexpr (QUANT) {
          ok = s != ws && pos[s] >= 0;
          if (s != ws) {
            float kf[D / 2];
            const KV* kr = kc + (size_t)s * ld + half * (D / 2);
#pragma unroll
            for (int c = 0; c < D / 2; c += 16) load16(kr + c, kf + c);
            const float* qh = qs + half * (D / 2);
#pragma unroll
            for (int j = 0; j < D / 2; ++j) dot += kf[j] * qh[j];
          }
        } else {
          ok = s == ws ? new_ok : pos[s] >= 0;
          const T* kr = (s == ws ? kn : kc + (size_t)s * ld) + half * (D / 2);
          const float* qh = qs + half * (D / 2);
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
      for (int j = tid; j < K7_TILE; j += 32) tmax = fmaxf(tmax, ps[j]);
      tmax = warp_max(tmax);
      const float m_new = fmaxf(m, tmax);
      float corr = 1.f, sum = 0.f;
      if (m_new != -INFINITY) {
        corr = expf(m - m_new);
        for (int j = tid; j < K7_TILE; j += 32) {
          const float p = expf(ps[j] - m_new);
          ps[j] = p;
          sum += p;
        }
      } else {
        for (int j = tid; j < K7_TILE; j += 32) ps[j] = 0.f;
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
  // ---- int8: merge the new row (float32, unrounded) ----
  if (tid < 32) {
    float corr = 1.f, pn = 0.f;
    if constexpr (QUANT) {
      if (new_ok) {
        const float ks = ksn[b];
        float dot = 0.f;
        for (int j = tid; j < D; j += 32)
          dot += qs[j] * ((float)kn[j] * ks);
        const float lg = warp_sum(dot) * scale;
        const float m_fin = fmaxf(m, lg);
        corr = expf(m - m_fin);
        pn = expf(lg - m_fin);
        l = l * corr + pn;
        m = m_fin;
      }
    }
    if (tid == 0) {
      corr_sh = corr;
      pn_sh = pn;
      m_sh = m;
      l_sh = l;
    }
  }
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) s += red[gg][tid];
    if constexpr (QUANT) s = s * corr_sh + pn_sh * ((float)vn[tid] * vsn[b]);
    out[tid] = from_f<T>(s / fmaxf(l_sh, 1e-30f));
  }
  if (STATS && tid == 0) {
    const size_t i = (size_t)b * nh + h;
    st[i] = m_sh;
    st[(size_t)gridDim.y * nh + i] = l_sh;
  }
}

}  // namespace ptt

// q (B, H, D); k_new, v_new (B, H*D); cur_pos (B,) int32; k_cache, v_cache
// (B, S, H*D) pre-insert, written in place at slot ws; pos (B, S) int32
// post-insert; out (B, H, D). Caches and new rows of q's type, or int8 when
// k_scale, v_scale ((B, S) float32, written at ws) and ks_new, vs_new
// ((B,) float32) are given. stats (or null): (2, B, H) float32, m then l.
// Requires 0 <= ws <= read_end < S.
extern "C" int ptt_insert_attn(const void* q, const void* k_new,
                               const void* v_new, const void* cur_pos,
                               void* k_cache, void* v_cache, const void* pos,
                               void* k_scale, void* v_scale,
                               const void* ks_new, const void* vs_new,
                               void* out, void* stats, int B, int H, int D,
                               int S, int read_end, int ws, int dtype,
                               void* stream) {
  const bool quant = k_scale != nullptr;
  if (D != 64 || B < 1 || H < 1 || ws < 0 || ws > read_end ||
      read_end >= S ||
      (v_scale != nullptr) != quant || (ks_new != nullptr) != quant ||
      (vs_new != nullptr) != quant || (quant && (H * D) % 16))
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(H, B);
#define PTT_K7(KV, STATS)                                                   \
  ptt::insert_attn_kernel<T, KV, STATS, 64>                                 \
      <<<grid, ptt::K7_THREADS, 0, st>>>(                                   \
          (const T*)q, (const KV*)k_new, (const KV*)v_new,                  \
          (const int*)cur_pos, (KV*)k_cache, (KV*)v_cache, (const int*)pos, \
          (float*)k_scale, (float*)v_scale, (const float*)ks_new,           \
          (const float*)vs_new, (T*)out, (float*)stats, H, S, read_end, ws, \
          scale)
  PTT_DISPATCH(dtype, T, {
    if (quant) {
      if (stats) PTT_K7(int8_t, true); else PTT_K7(int8_t, false);
    } else {
      if (stats) PTT_K7(T, true); else PTT_K7(T, false);
    }
  });
#undef PTT_K7
  return (int)cudaGetLastError();
}
