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
// (q . k_int8) * scale * its k scale; the softmax weight times the key's v
// scale is rounded to the working type before it meets the int8 V row. The
// T rows' bytes and scales are written at the ring slots [slot0, slot0+T)
// in place, without the TPU kernel's 32-row window and selection matmuls
// (`:80-116`, `:207-224`), which work around Mosaic's int8 (32, 128) tiling.
//
// What bounds it on the H100: bytes, and at batch 1 latency. A call reads
// the ring's live rows (at most 2 * cap * H*D elements per lane, 512 KB in
// bf16 at the default sizes, 256 KB of int8) and the new rows once, and
// writes T rows; its 2 x 16 x 272 x 64 multiply-adds per head are nothing
// to the tensor cores. The first port ran one block per (head, lane), 8
// blocks solo, thread j scoring key j with scalar loads in SIMT.
//
// Design. The cap + T keys of each (head, lane) are cut into 16-key tiles,
// and tile u goes to chunk u % splits (ops/ring_attn.py `k2_split`, a
// function of cap and T only, never of B, so a lane gives the solo call's
// bits; ops/decode_attn.py `chunk_units` is the rule): dealt out in turn,
// a fenced stretch of the ring spreads over all chunks. Grid (splits, H,
// B) of 4-warp blocks, warp w taking tiles w, w + 4, ...; the blocks of
// one (head, lane) form a thread-block cluster (at most 8): 2 x 8 = 16
// blocks solo at cap 256, each with 8 or 9 tiles (more chunks run the solo
// call faster and 32 lanes slower; chip_smoke.py `time_splits` times each
// count).
// A block marks each key with the query rows that see it (the mask's
// integer arithmetic once per key and piece, not per score) while it
// stages the keys'
// K and V rows in shared memory, the whole chunk in one pass up to 256
// keys (128 in float32; more take several passes, so that the dynamic
// shared memory stays bounded at any cap, opted in above 48 KB): 16-byte
// `cp.async` copies, int8 rows through registers widened exactly to the
// staged type. A key that no row sees stays zeros and is never read: the
// slots this frame overwrites, unwritten slots, slots fenced by `start`
// and slots past the context. Each warp takes 16-key tiles. With a bf16
// working type both products run on the tensor cores, `mma.sync.m16n8k16`
// bf16 -> f32: the 16 queries are the MMA's M, S = Q.K^T comes out in the
// accumulator layout that the P.V product takes as its A operand, and P
// enters it as bf16 (B operands by `ldmatrix`, `.trans` for V), which is
// the TPU kernel's rounding of the weights to the cache type (for K2-q, p
// times the key's v scale). With a float32
// working type the same structure runs on SIMT FMAs (TF32 would break
// float32's tolerance). Each warp keeps its query rows' running max and sum
// in registers; the warps' partials (m, l, acc) merge through shared
// memory, the blocks' through distributed shared memory after
// `cluster.sync()` (block c the output rows c, c + splits, ..., all remote
// reads issued before the first is used). A chunk that a fence masks for
// a row gives m = -inf, l = 0 and drops out: each partial is weighed by
// 2^(m - max m) (logits in log2 units, weights by exp2), 0 for one with no
// key (`partial_weight`). The insert:
// no block reads the T slots being overwritten, so no read can race the
// writes; the kernel still writes the new rows (and, head 0, their scales)
// only after that barrier, block c the rows c, c + splits, ... of its
// head's columns. One launch per call.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace ptt {

constexpr int K2_MAXT = 16;
constexpr int K2_MAX_SPLITS = 8;
constexpr int K2_WARPS = 4;
constexpr int K2_THREADS = 32 * K2_WARPS;

// Keys staged per pass: the whole chunk (its tiles, dealt out in turn)
// up to 256 keys (128 in float32).
__host__ __device__ inline int k2_pass_keys(int tiles, int splits,
                                            bool mma) {
  const int chunk = (tiles + splits - 1) / splits * 16, most = mma ? 256 : 128;
  return chunk < most ? chunk : most;
}

// Dynamic shared memory of one block (D = 64): the pass's K and V rows
// (padded by 16 bytes), each key's query rows and scales, and for float32
// Q and the warps' P tiles; the warps' partials reuse it after the last
// pass.
__host__ __device__ inline size_t k2_smem(int tiles, int splits, bool mma) {
  const int p = k2_pass_keys(tiles, splits, mma);
  const size_t row = mma ? 2 * (64 + 8) : 4 * (64 + 4);
  const size_t simt = 4 * (K2_MAXT * 64 + K2_WARPS * K2_MAXT * 17);
  const size_t stage = 2 * p * row + 12 * (size_t)p + (mma ? 0 : simt);
  const size_t part = 4 * (size_t)K2_WARPS * K2_MAXT * 64;
  return stage > part ? stage : part;
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(K2_THREADS, 5)
ring_attn_kernel(const T* __restrict__ q, const KV* __restrict__ kn,
                 const KV* __restrict__ vn, KV* __restrict__ kc,
                 KV* __restrict__ vc, T* __restrict__ out,
                 const int* __restrict__ starts,
                 const float* __restrict__ ksn, const float* __restrict__ vsn,
                 float* __restrict__ ksc, float* __restrict__ vsc,
                 const int* __restrict__ off_dev, int nq, int ld, int cap,
                 int off, int start, int context, float scale) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr bool MMA = std::is_same<T, bf16>::value;
  typedef typename std::conditional<MMA, bf16, float>::type ST;  // staged
  constexpr int LDS = D + 16 / (int)sizeof(ST);    // padded staged row
  static_assert(D == 64, "k2_smem counts D = 64");
  constexpr int EPV = 16 / (int)sizeof(KV);        // values per 16 bytes
  constexpr int VPR = D / EPV;                     // 16-byte pieces a row
  constexpr int NJ = D / 8;                        // n8 tiles over D
  constexpr int NT = K2_THREADS;
  cg::cluster_group cluster = cg::this_cluster();
  if (off_dev) off = *off_dev;  // the ring offset, kept on the device
  const int n = gridDim.x, c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  // logits in log2 units (the softmax weights exp2(x - max) are exp(...))
  const float scale2 = scale * LOG2E;
  const int nk = cap + nq;
  // this chunk: tiles c, c + n, ... of 16 keys; local key t is key
  // key_of(t) (past nk in the last tile: no key)
  const int tiles = (nk + 15) / 16;
  const int nloc = (tiles - c + n - 1) / n * 16;
  auto key_of = [&](int t) { return 16 * (c + n * (t >> 4)) + (t & 15); };
  q += (size_t)b * nq * ld + h * D;
  kn += (size_t)b * nq * ld + h * D;
  vn += (size_t)b * nq * ld + h * D;
  out += (size_t)b * nq * ld + h * D;
  kc += (size_t)b * cap * ld + h * D;
  vc += (size_t)b * cap * ld + h * D;
  if constexpr (QUANT) {
    ksn += (size_t)b * nq;
    vsn += (size_t)b * nq;
    ksc += (size_t)b * cap;
    vsc += (size_t)b * cap;
  }
  if (starts) start = starts[b];
  // This block inserts the new rows c, c + n, ... (this head's columns):
  // their bytes (and, head 0, scales) are read now, so that no load waits
  // after the barrier that allows the writes.
  const int mine = (nq - c + n - 1) / n;
  static_assert(K2_MAXT * (D / EPV) <= 2 * NT, "two pieces a thread");
  uint4 ins_k[2], ins_v[2];
  float ins_ks = 0.f, ins_vs = 0.f;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = tid + u * NT;
    ins_k[u] = ins_v[u] = make_uint4(0u, 0u, 0u, 0u);
    if (e < mine * VPR) {
      const size_t o = (size_t)(c + n * (e / VPR)) * ld + (e % VPR) * EPV;
      ins_k[u] = ld16(kn + o);
      ins_v[u] = ld16(vn + o);
    }
  }
  if constexpr (QUANT) {
    if (h == 0 && tid < mine) {
      ins_ks = ksn[c + n * tid];
      ins_vs = vsn[c + n * tid];
    }
  }
  const int slot0 = ((off / nq) % (cap / nq)) * nq;
  const int last = off - 1;
  const int end_index = ((last % cap) + cap) % cap;  // floor mod, as jnp

  // The query rows [tlo, thi) that see key j: the TPU kernel's mask. An
  // old slot j holds ring position pk and needs written && !overwritten &&
  // pk >= start; then query position off + tq sees it iff off + tq - pk <
  // context (off + tq >= pk always: pk <= off - 1). New row j' is seen by
  // rows tq >= j'. Packed as tlo | thi << 16; 0 for a key no row sees.
  auto key_rows = [&](int j) -> int {
    if (j >= nk) return 0;
    if (j >= cap) return (j - cap) | (nq << 16);
    const int delta = j - end_index;
    const int pk = last + delta - (delta > 0 ? cap : 0);
    const bool written = j < off;
    const int d0 = j - slot0;  // both in [0, cap): no modulo needed
    const bool overwrite = (d0 >= 0 ? d0 : d0 + cap) < nq;
    if (!written || overwrite || pk < start) return 0;
    const int thi = min(nq, context - (off - pk));
    return thi > 0 ? thi << 16 : 0;
  };

  const int PK = k2_pass_keys(tiles, n, MMA);
  extern __shared__ __align__(16) unsigned char k2_shared[];
  ST(*Ks)[LDS] = reinterpret_cast<ST(*)[LDS]>(k2_shared);
  ST(*Vs)[LDS] = Ks + PK;
  int* krows = reinterpret_cast<int*>(Vs + PK);
  float* ksk = reinterpret_cast<float*>(krows + PK);
  float* vsk = ksk + PK;
  float(*Qs)[D] = reinterpret_cast<float(*)[D]>(vsk + PK);  // float32 only
  float(*Ps)[K2_MAXT][17] =
      reinterpret_cast<float(*)[K2_MAXT][17]>(Qs + K2_MAXT);
  // the warps' partials, over the staged rows once the last pass is done
  float(*wacc)[K2_MAXT][D] = reinterpret_cast<float(*)[K2_MAXT][D]>(k2_shared);
  __shared__ float wm[K2_WARPS][K2_MAXT], wl[K2_WARPS][K2_MAXT];
  __shared__ float fw[K2_WARPS][K2_MAXT];      // the warps' merge weights
  __shared__ float bm[K2_MAXT], bl[K2_MAXT];  // this block's partial (acc
                                              // in wacc[0])

  // Q: MMA A fragments (rows g, g + 8; bf16 pairs), or f32 rows in shared
  uint32_t qa[D / 16][4];
  if constexpr (MMA) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = g + 8 * (r & 1), col = 16 * ks + 2 * t4 + 8 * (r >> 1);
        qa[ks][r] = row < nq ? *reinterpret_cast<const uint32_t*>(
                                   q + (size_t)row * ld + col)
                             : 0u;
      }
    }
  } else {
    for (int i = tid; i < K2_MAXT * D; i += NT)
      Qs[i / D][i % D] = i / D < nq ? to_f(q[(size_t)(i / D) * ld + i % D])
                                    : 0.f;
  }

  // the flash state of query rows g (index 0) and g + 8 (index 1) over
  // this warp's tiles; acc in the MMA accumulator layout: acc[j][0..1] row
  // g, columns 8j + 2 t4 + 0..1, acc[j][2..3] row g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int p0 = 0; p0 < nloc; p0 += PK) {
    const int nrow = min(PK, nloc - p0);  // whole tiles
    __syncthreads();  // the previous pass is consumed
    // ---- stage the pass's K and V rows; keys no row sees stay zeros and
    // are never read. The thread that copies a row's first piece records
    // the rows that see the key (and, int8, its scales); the others work
    // the same mask out for themselves, so no barrier stands between the
    // mask and the copies ----
    if constexpr (!QUANT) {
      for (int e = tid; e < nrow * VPR; e += NT) {
        const int r = e / VPR, piece = e % VPR, j = key_of(p0 + r);
        const int kr = key_rows(j);
        if (piece == 0) krows[r] = kr;
        const size_t off_row = j < cap ? (size_t)j * ld
                                       : (size_t)min(j - cap, nq - 1) * ld;
        cp_async16(&Ks[r][piece * EPV],
                   (j < cap ? kc : kn) + off_row + piece * EPV, kr != 0);
        cp_async16(&Vs[r][piece * EPV],
                   (j < cap ? vc : vn) + off_row + piece * EPV, kr != 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      constexpr int SB = 4;  // pieces per thread in flight (K and V each)
      for (int e0 = tid; e0 < nrow * VPR; e0 += SB * NT) {
        uint4 bk[SB], bv[SB];
#pragma unroll
        for (int u = 0; u < SB; ++u) {
          const int e = e0 + u * NT, r = e / VPR, piece = e % VPR;
          const int j = key_of(p0 + r);
          bk[u] = bv[u] = make_uint4(0u, 0u, 0u, 0u);
          if (e < nrow * VPR) {
            const int kr = key_rows(j);
            if (piece == 0) {
              krows[r] = kr;
              ksk[r] = kr ? (j < cap ? ksc[j] : ksn[j - cap]) : 0.f;
              vsk[r] = kr ? (j < cap ? vsc[j] : vsn[j - cap]) : 0.f;
            }
            if (kr) {
              const size_t o = (size_t)(j < cap ? j : j - cap) * ld
                               + piece * EPV;
              bk[u] = ld16((j < cap ? kc : kn) + o);
              bv[u] = ld16((j < cap ? vc : vn) + o);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < SB; ++u) {
          const int e = e0 + u * NT, r = e / VPR, piece = e % VPR;
          if (e < nrow * VPR) {
            float f[EPV];
            unpack16<KV>(bk[u], f);  // int8 -> exact in bf16 and f32
#pragma unroll
            for (int i = 0; i < EPV; ++i)
              Ks[r][piece * EPV + i] = from_f<ST>(f[i]);
            unpack16<KV>(bv[u], f);
#pragma unroll
            for (int i = 0; i < EPV; ++i)
              Vs[r][piece * EPV + i] = from_f<ST>(f[i]);
          }
        }
      }
    }
    __syncthreads();

    // each warp takes the pass's 16-key tiles warp, warp + K2_WARPS, ...
    for (int kk = 16 * warp; kk < nrow; kk += 16 * K2_WARPS) {
      // ---- S = Q K^T over the tile's 16 keys: s[ni][e] is row g + 8 *
      // (e >> 1), key kk + 8 ni + 2 t4 + (e & 1) ----
      float s[2][4];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        s[ni][0] = s[ni][1] = s[ni][2] = s[ni][3] = 0.f;
        if constexpr (MMA) {
          // B fragments by ldmatrix: lane L addresses key kk + L % 8 +
          // 8 (L / 16), columns 16 ks + 8 ((L / 8) % 2); registers 2 ni
          // and 2 ni + 1 are this n-tile's b0, b1
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            uint32_t bk[4];
            ldmatrix_x4(bk, &Ks[kk + (lane & 7) + 8 * (lane >> 4)]
                               [16 * ks + 8 * ((lane >> 3) & 1)]);
            mma_bf16_16816(s[ni], qa[ks], bk[2 * ni], bk[2 * ni + 1]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4* qr =
                reinterpret_cast<const float4*>(Qs[g + 8 * (e >> 1)]);
            const float4* kr = reinterpret_cast<const float4*>(
                Ks[kk + 8 * ni + 2 * t4 + (e & 1)]);
            float dot = 0.f;
#pragma unroll
            for (int d = 0; d < D / 4; ++d) {
              const float4 a = qr[d], k4 = kr[d];
              dot += a.x * k4.x;
              dot += a.y * k4.y;
              dot += a.z * k4.z;
              dot += a.w * k4.w;
            }
            s[ni][e] = dot;
          }
        }
      }
      // ---- mask and scale, online softmax per row ----
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kk + 8 * ni + 2 * t4 + (e & 1);
          const int kr = krows[key], tq = g + 8 * (e >> 1);
          float lg = s[ni][e] * scale2;
          if constexpr (QUANT) lg *= ksk[key];
          s[ni][e] = tq >= (kr & 0xffff) && tq < (kr >> 16) ? lg : -INFINITY;
        }
      }
      float w[2][4];
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        float tmax = fmaxf(fmaxf(s[0][2 * ri], s[0][2 * ri + 1]),
                           fmaxf(s[1][2 * ri], s[1][2 * ri + 1]));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m[ri], tmax);
        const bool any = m_new != -INFINITY;
        const float corr = any ? exp2f(m[ri] - m_new) : 1.f;
        float psum = 0.f;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const float p = any ? exp2f(s[ni][2 * ri + e2] - m_new) : 0.f;
            psum += p;
            float pw = p;
            if constexpr (QUANT) pw *= vsk[kk + 8 * ni + 2 * t4 + e2];
            w[ni][2 * ri + e2] = pw;
          }
        }
        l[ri] = l[ri] * corr + psum;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[j][2 * ri] *= corr;
          acc[j][2 * ri + 1] *= corr;
        }
        m[ri] = m_new;
      }
      // ---- acc += round(P) V ----
      if constexpr (MMA) {
        const uint32_t a[4] = {pack_bf16(w[0][0], w[0][1]),
                               pack_bf16(w[0][2], w[0][3]),
                               pack_bf16(w[1][0], w[1][1]),
                               pack_bf16(w[1][2], w[1][3])};
        // B fragments by ldmatrix.trans: lane L addresses key kk + L % 8
        // + 8 ((L / 8) % 2), columns 8 (j + L / 16); registers 0, 1 are
        // n-tile j's b0, b1 and 2, 3 n-tile j + 1's
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, &Vs[kk + (lane & 7) + 8 * ((lane >> 3) & 1)]
                                   [8 * (j + (lane >> 4))]);
          mma_bf16_16816(acc[j], a, bv[0], bv[1]);
          mma_bf16_16816(acc[j + 1], a, bv[2], bv[3]);
        }
      } else {
        float(*ps)[17] = Ps[warp];
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ps[g + 8 * (e >> 1)][8 * ni + 2 * t4 + (e & 1)] =
                rnd<T>(w[ni][e]);
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* pr = ps[g + 8 * (e >> 1)];
            const int col = 8 * j + 2 * t4 + (e & 1);
            float sum = 0.f;
#pragma unroll
            for (int key = 0; key < 16; ++key)
              sum += pr[key] * to_f(Vs[kk + key][col]);
            acc[j][e] += sum;
          }
        }
        __syncwarp();
      }
    }
  }

  // ---- merge: the warps' partials (shared memory, over the staged rows:
  // every warp is done with them), then the cluster's blocks (distributed
  // shared memory), all in fixed order ----
  __syncthreads();
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 1);
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 2);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wacc[warp][g + 8 * (e >> 1)][8 * j + 2 * t4 + (e & 1)] = acc[j][e];
  }
  if (t4 == 0) {
    wm[warp][g] = m[0];
    wm[warp][g + 8] = m[1];
    wl[warp][g] = l[0];
    wl[warp][g + 8] = l[1];
  }
  __syncthreads();
  if (tid < K2_MAXT) {  // each row's block max and the warps' weights
    float mx = wm[0][tid];
#pragma unroll
    for (int w = 1; w < K2_WARPS; ++w) mx = fmaxf(mx, wm[w][tid]);
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < K2_WARPS; ++w) {
      const float f = partial_weight(wm[w][tid], mx);
      fw[w][tid] = f;
      ll += wl[w][tid] * f;
    }
    bm[tid] = mx;
    bl[tid] = ll;
  }
  __syncthreads();
  for (int e = tid; e < K2_MAXT * D; e += NT) {
    const int row = e / D, col = e % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < K2_WARPS; ++w) a += wacc[w][row][col] * fw[w][row];
    wacc[0][row][col] = a;
  }
  cluster.sync();  // every partial is written; every ring read is done
  // block c: output rows c, c + n, ...; two columns a thread
  for (int it = tid; it < mine * (D / 2); it += NT) {
    const int row = c + n * (it / (D / 2)), col = 2 * (it % (D / 2));
    float mr[K2_MAX_SPLITS], lr[K2_MAX_SPLITS];
    float2 ar[K2_MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < K2_MAX_SPLITS; ++r) {
      if (r < n) {  // all remote reads issued before the first is used
        mr[r] = cluster.map_shared_rank(&bm[0], r)[row];
        lr[r] = cluster.map_shared_rank(&bl[0], r)[row];
        ar[r] = *reinterpret_cast<const float2*>(
            cluster.map_shared_rank(&wacc[0][row][col], r));
      }
    }
    float mx = mr[0];
#pragma unroll
    for (int r = 1; r < K2_MAX_SPLITS; ++r)
      if (r < n) mx = fmaxf(mx, mr[r]);
    float ll = 0.f;
    float2 a = make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < K2_MAX_SPLITS; ++r) {
      if (r < n) {
        const float f = partial_weight(mr[r], mx);
        a.x += ar[r].x * f;
        a.y += ar[r].y * f;
        ll += lr[r] * f;
      }
    }
    T* o = out + (size_t)row * ld + col;
    o[0] = from_f<T>(ll > 0.f ? a.x / ll : 0.f);
    o[1] = from_f<T>(ll > 0.f ? a.y / ll : 0.f);
  }
  // ---- insert: this head's columns of the new rows c, c + n, ... at
  // slot0 (and, head 0, their scales) ----
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = tid + u * NT;
    if (e < mine * VPR) {
      const size_t o = (size_t)(slot0 + c + n * (e / VPR)) * ld
                       + (e % VPR) * EPV;
      *reinterpret_cast<uint4*>(kc + o) = ins_k[u];
      *reinterpret_cast<uint4*>(vc + o) = ins_v[u];
    }
  }
  if constexpr (QUANT) {
    if (h == 0 && tid < mine) {
      ksc[slot0 + c + n * tid] = ins_ks;
      vsc[slot0 + c + n * tid] = ins_vs;
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

}  // namespace ptt

// q, k_new, v_new, out (B, T, ld); k_cache, v_cache (B, cap, ld),
// ld = H*D, updated in place; the K/V rows 16-byte aligned. off:
// timesteps written so far (a multiple of T), shared by the lanes;
// starts: (B,) int32 on the device, each lane's first timestep, or null
// to give every lane `start`. off_dev (or null): a device int32 that holds
// the offset, read by each block at entry in place of off (off is then its
// host mirror, checked here): the offset a CUDA graph's frame advanced on
// the device.
// int8 rings (K2-q): k_new, v_new and the caches int8, with ks_new, vs_new
// (B, T) and k_scale, v_scale (B, cap) float32 (the latter written in
// place); all four null otherwise. splits: chunks of the cap + T keys (16-
// key tiles dealt out in turn), one block each in a cluster (1 to 8, at
// most the tiles).
extern "C" int ptt_ring_attn(const void* q, const void* k_new,
                             const void* v_new, void* k_cache, void* v_cache,
                             void* out, const void* starts,
                             const void* ks_new, const void* vs_new,
                             void* k_scale, void* v_scale, const void* off_dev,
                             int B, int T, int H, int D, int cap, int off,
                             int start, int context, int splits, int dtype,
                             void* stream) {
  const bool quant = k_scale != nullptr;
  const int tiles = (cap + T + 15) / 16;
  if (D != 64 || B < 1 || T < 1 || T > ptt::K2_MAXT || cap % T || off % T
      || off < 0 || (v_scale != nullptr) != quant ||
      (ks_new != nullptr) != quant || (vs_new != nullptr) != quant ||
      splits < 1 || splits > ptt::K2_MAX_SPLITS || splits > tiles ||
      (H * D * (quant ? 1 : dtype ? 2 : 4)) % 16 ||
      ((uintptr_t)k_new | (uintptr_t)v_new | (uintptr_t)k_cache |
       (uintptr_t)v_cache) % 16 || (uintptr_t)q % 4)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(splits, H, B);
  const size_t smem = ptt::k2_smem(tiles, splits, dtype == 1);
  cudaError_t rc = cudaSuccess;
#define PTT_K2(KV)                                                           \
  rc = ptt::launch_clustered(                                                \
      ptt::ring_attn_kernel<Ty, KV, 64>, grid, dim3(ptt::K2_THREADS), splits, \
      smem, st,                                                              \
      (const Ty*)q, (const KV*)k_new, (const KV*)v_new, (KV*)k_cache,        \
      (KV*)v_cache, (Ty*)out, (const int*)starts, (const float*)ks_new,      \
      (const float*)vs_new, (float*)k_scale, (float*)v_scale,                \
      (const int*)off_dev, T, H * D, cap, off, start, context, scale)
  PTT_DISPATCH(dtype, Ty, {
    if (quant) PTT_K2(int8_t); else PTT_K2(Ty);
  });
#undef PTT_K2
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}
