// K2: mimi ring-cache insert + T=16 attention, in place, over rings of the
// working type or (K2-q) int8 rings with one float32 scale per row.
//
// Replaces the TPU kernel `pocket_tts_tpu/ops/pallas_mimi.py:
// ring_insert_attention` (`_make_ring_attention.batched` -> `_kernel`),
// unquantized and with `quant` (`mimi.transformer.quantize_kv`).
//
// What it computes, per lane b and head h: T new rows (q, k_new, v_new;
// positions off .. off+T-1) attend over the PRE-insert ring (cap slots)
// plus the new block, then the new K/V rows are written into the ring at
// slot0 = ((off / T) % (cap / T)) * T. The mask is arithmetic, exactly the
// TPU kernel's (pallas_mimi.py:130-145): an old slot j holds ring position
// pk(j) and is visible to query position pq iff it was written (j < off),
// is not among the slots this frame overwrites, pk >= start (the lane's
// admission fence), pq >= pk and pq - pk < context; a new row j' is
// visible iff pq >= off + j' (causal inside the block). The lanes share
// the ring offset, so every lane writes the same slots, and each has its
// own start: the continuous-batching fence of `pallas_mimi.py`, by which a
// lane that joined a running batch sees only its own rows. Logits and
// softmax are float32 with scale 1/sqrt(D); weights are rounded to the
// cache type before PV, which accumulates in float32.
//
// K2-q (`pallas_mimi.py:154-198`): the T new rows arrive quantized (int8
// bytes, one float32 scale per row: ks_new, vs_new), the ring holds int8
// rows with scales k_scale, v_scale (cap,) per lane. A key's logit is
// (q . k_int8) * scale * its k scale, an old slot's from the ring and a new
// row's from its bytes and ks_new; the softmax weight times the key's v
// scale is rounded to the working type before it meets the int8 V row. The
// T rows' bytes and scales are written at the ring slots [slot0, slot0+T)
// in place. The TPU kernel's 32-row aligned window and its selection
// matmuls (`:80-116`, `:207-224`) work around the int8 (32, 128) tiling
// of Mosaic; here each block writes its own columns of the 16 rows
// directly, and block h = 0 the scales.
//
// What bounds it on the H100: latency. A call reads the two ring caches
// (2 * cap * H*D elements per lane, 512 KB in bf16 at the default sizes,
// 256 KB of int8) once and writes 2 * T rows; its ~0.3 MFLOP per head are negligible, and
// 512 KB would stream in ~0.2 us. At B = 1 eight blocks (one per head)
// walk three dependent phases (scores, softmax, PV), so per-block latency
// sets the time; B lanes run 8 * B blocks side by side. Each block reads
// its head's columns of every ring row once, keeps the (T, cap + T) scores
// in shared memory, and never writes a score or probability to HBM.
//
// Layout: one block per (head, lane), 8 x B, 256 threads; B = 1 is the
// solo call. Thread j scores key j for all T queries (its K row in
// registers), one warp per query row does the softmax, and (T/4 rows x D
// lanes) threads accumulate PV from V rows staged in shared memory 64 at a
// time with coalesced loads. Each block finally writes ITS OWN (lane,
// head) columns of the new rows: blocks touch disjoint columns, and the
// overwritten slots are masked for every query, so no block races another.
#include <type_traits>

#include "common.cuh"

namespace ptt {

constexpr int K2_THREADS = 256;
constexpr int K2_MAXT = 16;
constexpr int K2_VCHUNK = 64;

// D values of one row (a head's columns) as floats: int8 rows in 16-byte
// vector loads
template <int D, typename KV>
__device__ __forceinline__ void load_row(const KV* p, float* out) {
  if constexpr (std::is_same<KV, int8_t>::value) {
#pragma unroll
    for (int e = 0; e < D; e += 16) load16(p + e, out + e);
  } else {
#pragma unroll
    for (int e = 0; e < D; ++e) out[e] = to_f(p[e]);
  }
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(K2_THREADS)
ring_attn_kernel(const T* __restrict__ q, const KV* __restrict__ kn,
                 const KV* __restrict__ vn, KV* __restrict__ kc,
                 KV* __restrict__ vc, T* __restrict__ out,
                 const int* __restrict__ starts,
                 const float* __restrict__ ksn, const float* __restrict__ vsn,
                 float* __restrict__ ksc, float* __restrict__ vsc, int nt,
                 int ld, int cap, int off, int start, int context,
                 float scale) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int G = K2_THREADS / D;          // query-row groups in PV
  constexpr int R = (K2_MAXT + G - 1) / G;   // rows per thread in PV
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nk = cap + nt;
  q += (size_t)b * nt * ld;
  kn += (size_t)b * nt * ld;
  vn += (size_t)b * nt * ld;
  out += (size_t)b * nt * ld;
  kc += (size_t)b * cap * ld;
  vc += (size_t)b * cap * ld;
  if constexpr (QUANT) {
    ksn += (size_t)b * nt;
    vsn += (size_t)b * nt;
    ksc += (size_t)b * cap;
    vsc += (size_t)b * cap;
  }
  if (starts) start = starts[b];
  extern __shared__ float sm[];
  float* qs = sm;                 // (nt, D)
  float* sc = qs + nt * D;        // (nt, nk) scores, then probabilities
  float* ls = sc + nt * nk;       // (nt,) softmax denominators
  float* vs = ls + K2_MAXT;       // (K2_VCHUNK, D) staged V rows
  float* vsk = vs + K2_VCHUNK * D;  // (nk,) int8: each key's v scale

  for (int i = tid; i < nt * D; i += K2_THREADS)
    qs[i] = to_f(q[(size_t)(i / D) * ld + h * D + i % D]);
  if constexpr (QUANT) {
    for (int j = tid; j < nk; j += K2_THREADS)
      vsk[j] = j < cap ? vsc[j] : vsn[j - cap];
  }
  __syncthreads();

  const int slot0 = ((off / nt) % (cap / nt)) * nt;
  const int last = off - 1;
  const int end_index = ((last % cap) + cap) % cap;  // floor mod, as jnp

  // ---- scores: thread j owns key j (old ring slot, then new row) ----
  for (int j = tid; j < nk; j += K2_THREADS) {
    const bool is_new = j >= cap;
    const int jn = j - cap;
    const KV* kr = is_new ? kn + (size_t)jn * ld + h * D
                          : kc + (size_t)j * ld + h * D;
    float kv[D];
    load_row<D>(kr, kv);
    float ks = 1.f;
    if constexpr (QUANT) ks = is_new ? ksn[jn] : ksc[j];
    int pk = 0;
    bool base_ok = true;
    if (!is_new) {
      const int delta = j - end_index;
      pk = last + delta - (delta > 0 ? cap : 0);
      const bool written = j < off;
      const bool overwrite = (((j - slot0) % cap) + cap) % cap < nt;
      base_ok = written && !overwrite && pk >= start;
    }
    for (int t = 0; t < nt; ++t) {
      const int pq = off + t;
      const bool ok = is_new ? (t >= jn)
                             : (base_ok && pq >= pk && pq - pk < context);
      float dot = 0.f;
      const float* qt = qs + t * D;
#pragma unroll
      for (int e = 0; e < D; ++e) dot += qt[e] * kv[e];
      float lg = dot * scale;
      if constexpr (QUANT) lg = lg * ks;
      sc[t * nk + j] = ok ? lg : -INFINITY;
    }
  }
  __syncthreads();

  // ---- softmax: one warp per query row ----
  const int warp = tid / 32, lane = tid % 32;
  for (int t = warp; t < nt; t += K2_THREADS / 32) {
    float* row = sc + t * nk;
    float mx = -INFINITY;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);  // finite: query t always sees new row t
    float s = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float p = expf(row[j] - mx);
      row[j] = p;
      s += p;
    }
    s = warp_sum(s);
    if (lane == 0) ls[t] = s;
  }
  __syncthreads();

  // ---- PV: thread (row group g, lane d), rows g, g+G, ...; V staged
  // through shared memory in chunks of K2_VCHUNK rows (coalesced loads;
  // int8 rows 16 bytes a thread) ----
  {
    const int d = tid % D, g = tid / D;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int j0 = 0; j0 < nk; j0 += K2_VCHUNK) {
      const int n = min(K2_VCHUNK, nk - j0);
      __syncthreads();  // the previous chunk is consumed
      if constexpr (QUANT) {
        for (int e = tid; e < n * (D / 16); e += K2_THREADS) {
          const int j = j0 + e / (D / 16), c0 = (e % (D / 16)) * 16;
          load16(j < cap ? vc + (size_t)j * ld + h * D + c0
                         : vn + (size_t)(j - cap) * ld + h * D + c0,
                 vs + (e / (D / 16)) * D + c0);
        }
      } else {
        for (int e = tid; e < n * D; e += K2_THREADS) {
          const int j = j0 + e / D;
          vs[e] = to_f(j < cap ? vc[(size_t)j * ld + h * D + e % D]
                               : vn[(size_t)(j - cap) * ld + h * D + e % D]);
        }
      }
      __syncthreads();
      for (int jj = 0; jj < n; ++jj) {
        const float vv = vs[jj * D + d];
        const float vk = QUANT ? vsk[j0 + jj] : 1.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int t = g + r * G;
          if (t < nt) {
            const float p = sc[t * nk + j0 + jj];
            acc[r] += rnd<T>(QUANT ? p * vk : p) * vv;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = g + r * G;
      if (t < nt)
        out[(size_t)t * ld + h * D + d] =
            from_f<T>(acc[r] / fmaxf(ls[t], 1e-30f));
    }
  }
  __syncthreads();  // every read of this head's cache columns is done

  // ---- insert: this head's columns of the new rows (and, block h = 0,
  // their scales), at slot0 ----
  for (int i = tid; i < nt * D; i += K2_THREADS) {
    const size_t src = (size_t)(i / D) * ld + h * D + i % D;
    const size_t dst = (size_t)(slot0 + i / D) * ld + h * D + i % D;
    kc[dst] = kn[src];
    vc[dst] = vn[src];
  }
  if constexpr (QUANT) {
    if (h == 0 && tid < nt) {
      ksc[slot0 + tid] = ksn[tid];
      vsc[slot0 + tid] = vsn[tid];
    }
  }
}

}  // namespace ptt

// q, k_new, v_new, out (B, T, ld); k_cache, v_cache (B, cap, ld),
// ld = H*D, updated in place. off: timesteps written so far (a multiple of
// T), shared by the lanes; starts: (B,) int32 on the device, each lane's
// first timestep, or null to give every lane `start`. int8 rings (K2-q):
// k_new, v_new and the caches int8, with ks_new, vs_new (B, T) and
// k_scale, v_scale (B, cap) float32 (the latter written in place); all
// four null otherwise.
extern "C" int ptt_ring_attn(const void* q, const void* k_new,
                             const void* v_new, void* k_cache, void* v_cache,
                             void* out, const void* starts,
                             const void* ks_new, const void* vs_new,
                             void* k_scale, void* v_scale, int B, int T,
                             int H, int D, int cap, int off, int start,
                             int context, int dtype, void* stream) {
  const bool quant = k_scale != nullptr;
  if (D != 64 || B < 1 || T < 1 || T > ptt::K2_MAXT || cap % T || off % T
      || off < 0 || (v_scale != nullptr) != quant ||
      (ks_new != nullptr) != quant || (vs_new != nullptr) != quant ||
      (quant && (H * D) % 16))
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)D);
  const size_t smem =
      sizeof(float) * ((size_t)T * D + (size_t)T * (cap + T) + ptt::K2_MAXT
                       + (size_t)ptt::K2_VCHUNK * D + (quant ? cap + T : 0));
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(H, B);
#define PTT_K2(KV)                                                          \
  ptt::ring_attn_kernel<Ty, KV, 64><<<grid, ptt::K2_THREADS, smem, st>>>(   \
      (const Ty*)q, (const KV*)k_new, (const KV*)v_new, (KV*)k_cache,       \
      (KV*)v_cache, (Ty*)out, (const int*)starts, (const float*)ks_new,     \
      (const float*)vs_new, (float*)k_scale, (float*)v_scale, T, H * D, cap, \
      off, start, context, scale)
  PTT_DISPATCH(dtype, Ty, {
    if (quant) PTT_K2(int8_t); else PTT_K2(Ty);
  });
#undef PTT_K2
  return (int)cudaGetLastError();
}
