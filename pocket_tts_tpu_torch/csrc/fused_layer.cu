// K5a and K5b: one transformer layer's quantized linears, fused around the
// attention, for the backbone decode step (T = 1 row per lane) and the mimi
// decoder transformer (T = 16 rows per frame and lane), solo or over B
// lanes (B * T rows: 32 and 512 at 32 lanes); int8 weights, or int4
// (packed halves) with per-channel or K-grouped (q4_0) scales (qdot.cuh).
//
// K5a replaces `pocket_tts_tpu/ops/fused_layer.py:_pre_call`
// (`_pre_kernel`):
//   qkv = round(round(LN(x)) @ W_in + b_in)
// LN in float32 over d_model with eps, times norm scale plus bias, rounded
// to the working type before the dot, as the TPU kernel stages it.
//
// K5c replaces `pocket_tts_tpu/ops/fused_layer.py:_bilayer_call`
// (`_bilayer_kernel`, `:595-641`): K5b of layer l and K5a of layer l + 1 in
// one launch, for solo (T = 1) int4 decode:
//   x_next = x1 + ls2 * up                              float32
//   out    = round(x_next)
//   qkv    = round(round(LN1_{l+1}(x_next)) @ W_in_{l+1} + b_in_{l+1})
// with LN1 taken from the UNROUNDED float32 x_next, as the TPU kernel does
// (`:628-635`); a separate K5a would read the rounded row. So K5c equals K5b
// followed by K5a in float32 and differs from them by bf16 rounding.
//
// K5b replaces `pocket_tts_tpu/ops/fused_layer.py:_post_call`
// (`_post_kernel`, `_post_x1_ln`, `_mlp_add`, `_post_tail`):
//   x1  = x + ls1 * (attn @ W_o + b_o)                  float32, kept so
//   ln  = round(LN(x1) * n2s + n2b)
//   h   = round(gelu(ln @ W_1 + b_1))                   per hidden unit
//   up  = (sum over hidden of h @ q_2) * s_2 + b_2     per-channel s_2
//                                                       once, on the
//                                                       float32 sum;
//                                                       grouped s_2 inside
//   out = round(x1 + ls2 * up)
// "v @ W" is the float32 product with the weight's scales: per-channel
// scales on the sum, grouped scales on each nibble. Absent biases read as
// zeros, absent layer scales as ones. GELU is erf (erff, correctly rounded
// to ~1 ulp; the TPU kernel uses a 1.5e-7 polynomial) or tanh. The TPU
// kernels' int4 MXU workarounds (INT4_SCHEME rawf32m, the block-diagonal
// grouped T == 1 path, the 0/1 scale-expansion matmul) round in other
// places; they are not carried over: the exact math is computed in f32.
//
// What bounds them on the H100: bytes. At T = 1 each weight element feeds
// one multiply-add per row: 3 MB of int8 (1.5 MB of int4, plus 0.1 MB of
// bf16 group scales under q4_0) for the backbone's in_proj, 9 MB (4.5 MB)
// for out_proj + the MLP, i.e. ~1 us and ~3 us at full HBM bandwidth for
// int8. What keeps the cooperative kernels from it is latency: barriers,
// round trips to L2, and every block reading the same rows.
//
// Design. K5a is one launch of the row-block product of its route
// (ops/fused_layer.py `rows_route`): `skinny_kernel` for a bf16 call of
// fewer than MMA_ROWS rows (the backbone's T = 1), `rows_mma_kernel` from
// MMA_ROWS rows (below), `rows_kernel` for float32. The skinny kernel takes
// the layer tail's way with weights (layer_post.cuh): a block per (32-column
// tile, slice of the stored rows; 96 blocks of 32 KB of int8 or 16 KB of
// int4 for the backbone's in_proj), one thread asking the TMA for the
// block's whole weight slab at entry, so the call's 3 MB are in flight at
// once while every block takes the LayerNorm of its rows; the products
// run on SIMT from shared memory and the slices of a tile, the blocks of
// one cluster, sum through distributed shared memory in rank order.
// `rows_kernel` (SIMT, float32):
// one ordinary launch over (32-column tiles) x (row blocks of at most
// FL_ROW_FLOATS activations: 16 rows at dm 1024, 32 at dm 512); each block
// computes the LayerNorm of its rows into shared memory, then streams its
// tile of W_in. K4b (ops/quant_matmul.py) is the same three kernels with the
// plain load prologue and the rounding epilogue, and so is K4a below
// WGMMA_ROWS rows and in float32 (from WGMMA_ROWS bf16 rows K4a runs
// wgmma_matmul.cu).
// K5b has two dependencies across blocks that the TPU kernel met by walking
// its hidden tiles in order with scratch carried between grid steps: the
// LayerNorm of x1 needs all of out_proj, and the W2 sum runs over every
// hidden tile. Here it is one COOPERATIVE launch of one block per 32-unit
// MLP tile (ops/fused_layer.py `post_plan`) with two grid barriers; at
// entry every block asks the TMA for all the weight bytes it will read
// (layer_post.cuh):
//   phase 1  out_proj units (32-column tiles, at T = 1 in slices of their
//            stored rows so every block has one) -> float32 partials
//   sync
//   phase 2  every block: x1 = x + ls1 * (the partials summed in slice
//            order * s_o + b_o), LN(x1) into shared memory; then its MLP
//            tile: h = round(gelu(ln @ W_1 + b_1)), its partial of up =
//            h @ q_2 to HBM. int8: W2 rows h0..h0+31. int4: packed W2
//            row j holds hidden units j and j + H/2, so a tile is 16
//            packed rows and the block first computes BOTH h halves (W1
//            columns h0.. and H/2 + h0.., 16 each) into one h tile, whose
//            low half meets the low nibbles and high half the high ones.
//   sync
//   phase 3  the grid's partials summed per element by a warp in a fixed
//            order (no float atomics: the result does not depend on
//            scheduling), then s_2 (per-channel), b_2, ls2 and the residual.
// One row runs the products on SIMT from shared memory; more rows (the
// mimi decoder's 16) in bf16 on the tensor cores (layer_post.cuh
// `cols_mma`, `w2_mma`). K5c is K5b's cooperative kernel with a tail: after
// the final residual (x_next written rounded, and in float32 to a scratch
// row), a third grid barrier, then every block takes LN1 of layer l + 1 of
// the float32 row and its in_proj(l + 1) column tiles (3072 columns at the
// backbone's width), whose weights it also asked for at entry. It reads
// layer l + 1's weights from their own (stacked) layer view, like K5a.
// Scratch (the partials, x1) is allocated by the caller. The cooperative
// launch holds at most FL_ROW_FLOATS activations, and its per-block
// partials of `up` (grid x T x dm floats) grow with the rows. More rows
// (the lanes of a batch: 32 backbone rows, up to 512 mimi rows) take three
// ordinary launches of `rows_kernel`, K5a's kernel with other prologues and
// epilogues, with x1 (float32) and h (the working type) in HBM between
// them: x1 = x + ls1 * (attn @ W_o + b_o); h = round(gelu(round(LN(x1))
// @ W_1 + b_1)); out = round(x1 + ls2 * (h @ W_2 + b_2)). Splitting the W2
// product by output columns once h is in HBM needs no cross-block sum, and
// each launch spreads (column tiles) x (row blocks) over the card.
//
// Many rows on the tensor cores (rows_mma_kernel, ptt_rows_mma). On SIMT
// those launches ran at ~1% of their bound: rows_kernel walks its rows 8 at
// a time through tile_dot, one FMA per weight element and row, its row
// blocks capped at FL_ROW_FLOATS activations (4 rows at K = 4096), so the
// weight tile is re-read per pass and per row block (K5b over 512 rows:
// 221 us for 2.4 GFLOP; PERF.md section 6). A bf16 call of at least
// ops/fused_layer.py MMA_ROWS rows runs rows_mma_kernel instead: the same
// prologues and epilogues, with m16n8k16 bf16 products, f32 accumulators,
// weights widened to bf16 in registers (exact for int8 and for nibbles;
// q4_0's group scales applied per k16 partial in float32: qmma.cuh), a
// block per (64 columns) x (bm rows) x (reduction slice), the slices of a
// tile summed through distributed shared memory in rank order.
// ops/fused_layer.py `rows_plan` picks bm and the split.
#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "layer_post.cuh"
#include "qmma.cuh"

// activations a K5a block or a K5b launch holds in shared memory
constexpr int FL_ROW_FLOATS = 16384;

namespace coop = cooperative_groups;

namespace ptt {

// How a rows_kernel block stages its rows of A in shared memory, and what
// it writes for output (r, n) from v = A @ W + b (float32, scales applied).
enum { ROWS_LOAD = 0, ROWS_LN = 1, ROWS_LN_F32 = 2 };
enum { EPI_ROUND = 0, EPI_RESID_F32 = 1, EPI_GELU = 2, EPI_RESID = 3 };

struct RowsArgs {
  const void *a, *ns, *nb;  // A (T, K): working type, float32 for
                            // ROWS_LN_F32; norm scale/bias (K,) or null
  Lin w;                    // (K, N)
  const void* res;          // residual (T, N): x of the working type
                            // (EPI_RESID_F32) or x1 float32 (EPI_RESID)
  const void* ls;           // layer scale (N,) or null
  void* out;                // (T, N): float32 for EPI_RESID_F32
  int T, K, N, rows, prologue, epilogue, approx;
  float eps;
};

// One skinny product over (32-column tiles) x (row blocks of `rows` rows,
// blockIdx.y): the block stages its rows (ROWS_LOAD: as they are; ROWS_LN:
// round(LN(x) * ns + nb) of working-type rows; ROWS_LN_F32: the same of
// float32 rows), streams its weight tile and writes
//   EPI_ROUND      out = round(v)                       K5a's qkv
//   EPI_RESID_F32  out = res + ls * v  (float32)        K5b's x1
//   EPI_GELU       out = round(gelu(v))                 K5b's h
//   EPI_RESID      out = round(res + ls * v)            K5b's output
template <typename T>
__global__ void __launch_bounds__(QD_THREADS) rows_kernel(RowsArgs a) {
  extern __shared__ float smem[];
  float* red = smem;            // QD_RED
  float* xs = smem + QD_RED;    // rows x K
  const int K = a.K, N = a.N;
  const int r0 = blockIdx.y * a.rows, nrows = min(a.rows, a.T - r0);
  const T* ns = (const T*)a.ns;
  const T* nb = (const T*)a.nb;
  const T* ls = (const T*)a.ls;
  auto store = [&](int r, int i, float v) {
    xs[r * K + i] = rnd<T>(v * opt(ns, i, 1.f) + opt(nb, i, 0.f));
  };
  if (a.prologue == ROWS_LN_F32) {
    const float* x = (const float*)a.a + (size_t)r0 * K;
    block_layernorm(nrows, K, a.eps, [&](int r, int i) { return x[r * K + i]; },
                    store);
  } else {
    const T* x = (const T*)a.a + (size_t)r0 * K;
    if (a.prologue == ROWS_LN) {
      block_layernorm(nrows, K, a.eps,
                      [&](int r, int i) { return to_f(x[r * K + i]); }, store);
    } else {
      for (int i = threadIdx.x; i < nrows * K; i += QD_THREADS)
        xs[i] = to_f(x[i]);
      __syncthreads();
    }
  }
  const int ntiles = (N + FL_TILE - 1) / FL_TILE;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int n0 = t * FL_TILE;
    lin_tile<T>(xs, K, nrows, K, a.w, N, n0, min(FL_TILE, N - n0),
                FL_TILE / 4, red, [&](int r, int n, float v) {
                  const size_t i = (size_t)(r0 + r) * N + n;
                  switch (a.epilogue) {
                    case EPI_ROUND: ((T*)a.out)[i] = from_f<T>(v); break;
                    case EPI_RESID_F32:
                      ((float*)a.out)[i] = to_f(((const T*)a.res)[i]) +
                                           opt(ls, n, 1.f) * v;
                      break;
                    case EPI_GELU:
                      ((T*)a.out)[i] = from_f<T>(gelu_f(v, a.approx));
                      break;
                    default:
                      ((T*)a.out)[i] = from_f<T>(((const float*)a.res)[i] +
                                                 opt(ls, n, 1.f) * v);
                  }
                });
  }
}

struct RowsMmaArgs {
  RowsArgs a;       // rows_kernel's function: operands, T, K, N,
                    // prologue, epilogue (rows unused)
  int bm;           // rows a block: 16, 32 or 64
  int splits;       // reduction slices, the blocks of a cluster (grid.x)
  int kt_per;       // k-tiles a slice
};

// shared memory of a block: A (bm rows of the slice's logical columns, bf16),
// the ring of raw k-tiles, the float32 output tile
// and, for the LayerNorm prologues, RM_LN_BUFS chunks of RM_LN_ROWS whole
// rows of A as they are (K values of ln_size bytes; 0: no LayerNorm)
inline size_t rows_mma_smem(int bm, int kt_per, bool packed_w, int K,
                            int ln_size) {
  const size_t lda = (size_t)kt_per * RM_BKS * (packed_w ? 2 : 1) + 8;
  return 2 * (size_t)bm * lda + (size_t)RM_STAGES * RM_BKS * RM_RING_LD +
         4 * (size_t)bm * RM_CS_LD +
         (size_t)RM_LN_BUFS * RM_LN_ROWS * K * ln_size;
}

// Block (z, y, x): output rows [x * bm, ..) and columns [y * 64, ..) over
// reduction slice z of `splits`, the z-th block of its cluster. The slice
// is k-tiles [z * kt_per, ..) of 32 stored weight rows: int8 rows k.., or
// packed int4 rows p.., which hold logical rows p.. (low nibbles) and
// K/2 + p.. (high nibbles). The block stages the bf16 A columns its slice
// meets once (int8: [k0, k1); int4: [p0, p1) then [K/2 + p0, K/2 + p1)),
// applying the LayerNorm prologue from whole rows; streams its raw k-tiles
// through a RM_STAGES-deep cp.async ring (16 bytes a thread) and runs the
// m16n8k16 products (warp w: columns 8w.. of every m16 tile) with its B
// fragments read from the raw k-tile and widened to bf16 in registers.
// Split slices leave their float32 tiles in shared memory; after
// cluster.sync() block z sums rows z, z + splits, ... over the cluster in
// rank order (distributed shared memory) and applies the scales, bias and
// epilogue.
// GROUPED: q4_0's K-grouped scales (a separate instantiation, so that the
// per-channel kinds carry none of their registers). Two blocks an SM (at
// most 128 registers a thread): at 155 registers the per-channel kernel ran
// one block an SM, and a split plan's clusters of 4 (K4b's out_proj at 128
// rows) fell into a second wave: 15.3 us against 11.1 at 128 registers
// (chip_smoke.py --kernel-times on the H100).
template <int BM, bool GROUPED>
__global__ void __launch_bounds__(RM_THREADS, 2)
rows_mma_kernel(const RowsMmaArgs g) {
  constexpr int NI = BM / 16;
  const RowsArgs& a = g.a;
  extern __shared__ __align__(16) unsigned char rm_shared[];
  coop::cluster_group cluster = coop::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int z = blockIdx.x, nsplit = gridDim.x;
  const int n0 = blockIdx.y * RM_BN, m0 = blockIdx.z * BM;
  const int nrows = min(BM, a.T - m0);
  const bool p4 = packed(a.w);
  const int S = p4 ? a.K / 2 : a.K;                // stored rows
  // k-tiles of RM_BKS stored rows; the last may hold only 16 (K4b's
  // input_linear: K = 32, 16 packed rows)
  const int ktiles = (S + RM_BKS - 1) / RM_BKS;
  const int kt0 = z * g.kt_per, kt1 = min(ktiles, kt0 + g.kt_per);
  const int p0 = kt0 * RM_BKS, w = min((kt1 - kt0) * RM_BKS, S - p0);
  const int aw = p4 ? 2 * w : w;                   // staged A columns
  const int lda = g.kt_per * RM_BKS * (p4 ? 2 : 1) + 8;
  bf16* As = reinterpret_cast<bf16*>(rm_shared);
  int8_t* ring = reinterpret_cast<int8_t*>(As + (size_t)BM * lda);
  float* Cs = reinterpret_cast<float*>(ring + RM_STAGES * RM_BKS * RM_RING_LD);
  unsigned char* lnbuf = reinterpret_cast<unsigned char*>(Cs + BM * RM_CS_LD);
  const int8_t* wq = (const int8_t*)a.w.w;
  constexpr int RM_KS = RM_BKS / 16;   // k16 steps a stored k-tile

  // the logical column of staged A column c
  auto a_col = [&](int c) {
    return c < w ? p0 + c : S + p0 + (c - w);
  };
  // raw k-tile kt (32 stored rows x 64 columns of bytes) into ring slot buf
  auto load_tile = [&](int kt, int buf) {
    if (tid < RM_BKS * RM_BN / 16) {
      const int r = tid / (RM_BN / 16), c = tid % (RM_BN / 16) * 16;
      const bool ok = n0 + c < a.N && kt * RM_BKS + r < S;
      cp_async16(ring + buf * RM_BKS * RM_RING_LD + r * RM_RING_LD + c,
                 wq + (ok ? (size_t)(kt * RM_BKS + r) * a.N + n0 + c : 0), ok);
    }
  };

  // ---- A: rows as they are by cp.async (with the first ring group), or
  // the LayerNorm of whole rows, rounded to bf16; rows past T are zeros ----
  if (a.prologue == ROWS_LOAD) {
    const bf16* x = (const bf16*)a.a;
    for (int i = tid; i < BM * (aw / 8); i += RM_THREADS) {
      const int r = i / (aw / 8), c = (i - r * (aw / 8)) * 8;
      const bool ok = r < nrows;
      cp_async16(As + (size_t)r * lda + c,
                 x + (ok ? (size_t)(m0 + r) * a.K + a_col(c) : 0), ok);
    }
  }
  for (int i = 0; i < RM_STAGES - 1; ++i) {
    if (kt0 + i < kt1) load_tile(kt0 + i, i);
    cp_async_commit();  // one group a stage, empty past the end
  }
  if (a.prologue != ROWS_LOAD) {
    const bf16* ns = (const bf16*)a.ns;
    const bf16* nb = (const bf16*)a.nb;
    for (int i = tid; i < (BM - nrows) * aw; i += RM_THREADS)
      As[(size_t)(nrows + i / aw) * lda + i % aw] = from_f<bf16>(0.f);
    // whole rows RM_LN_ROWS at a time, as they are, by cp.async into
    // RM_LN_BUFS buffers (the next chunks land while a warp a row
    // normalizes this one); only the slice's columns are stored
    const int esz = a.prologue == ROWS_LN_F32 ? 4 : 2;
    const size_t rowb = (size_t)a.K * esz;
    const int per = (int)(rowb / 16);
    const unsigned char* src = (const unsigned char*)a.a + (size_t)m0 * rowb;
    const int nch = (nrows + RM_LN_ROWS - 1) / RM_LN_ROWS;
    auto issue = [&](int c) {
      unsigned char* dst =
          lnbuf + (size_t)(c % RM_LN_BUFS) * RM_LN_ROWS * rowb;
      const int rows = min(RM_LN_ROWS, nrows - c * RM_LN_ROWS);
      for (int e = tid; e < rows * per; e += RM_THREADS) {
        const int r = e / per, o = (e - r * per) * 16;
        cp_async16(dst + r * rowb + o,
                   src + (size_t)(c * RM_LN_ROWS + r) * rowb + o, true);
      }
      cp_async_commit();
    };
    for (int c = 0; c < min(nch, RM_LN_BUFS); ++c) issue(c);
    // A lane takes the 4-column groups lane, lane + 32, ... of a row
    // (passes of 128 columns; K a multiple of 128, at most 1024): a group
    // lies wholly in the slice or out of it (the slice's ranges start at
    // multiples of 32). The norm's scale and bias of this lane's groups in
    // the slice, in registers for every row.
    constexpr int LNP = 8;
    const int np = a.K / 128;
    auto slice_col = [&](int i0) {   // staged column of group i0, or -1
      if (i0 >= p0 && i0 < p0 + w) return i0 - p0;
      if (p4 && i0 >= S + p0 && i0 < S + p0 + w) return w + i0 - S - p0;
      return -1;
    };
    float4 gam[LNP], bet[LNP];
#pragma unroll
    for (int q = 0; q < LNP; ++q) {
      const int i0 = q * 128 + lane * 4;
      const bool in = q < np && slice_col(i0) >= 0;
      gam[q] = in && ns ? load4(ns + i0) : make_float4(1.f, 1.f, 1.f, 1.f);
      bet[q] = in && nb ? load4(nb + i0) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int c = 0; c < nch; ++c) {
      // chunk c has landed: at most the chunks issued after it in flight
      switch (min(nch, c + RM_LN_BUFS) - 1 - c) {
        case 0: cp_async_wait<0>(); break;
        case 1: cp_async_wait<1>(); break;
        default: cp_async_wait<RM_LN_BUFS - 1>();
      }
      __syncthreads();
      const int r = c * RM_LN_ROWS + warp;
      if (warp < RM_LN_ROWS && r < nrows) {
        const unsigned char* row =
            lnbuf + (size_t)(c % RM_LN_BUFS) * RM_LN_ROWS * rowb +
            warp * rowb;
        float4 v[LNP];
#pragma unroll
        for (int q = 0; q < LNP; ++q) {
          const int i0 = q * 128 + lane * 4;
          if (q < np)
            v[q] = esz == 4 ? load4(reinterpret_cast<const float*>(row) + i0)
                            : load4(reinterpret_cast<const bf16*>(row) + i0);
          else
            v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < LNP; ++q)
          sum += (v[q].x + v[q].y) + (v[q].z + v[q].w);
        const float mean = warp_sum(sum) / (float)a.K;
        float var = 0.f;
#pragma unroll
        for (int q = 0; q < LNP; ++q) {
          if (q >= np) break;
          const float d0 = v[q].x - mean, d1 = v[q].y - mean;
          const float d2 = v[q].z - mean, d3 = v[q].w - mean;
          var += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
        }
        const float rstd = 1.0f / sqrtf(warp_sum(var) / (float)a.K + a.eps);
#pragma unroll
        for (int q = 0; q < LNP; ++q) {
          const int cc = q < np ? slice_col(q * 128 + lane * 4) : -1;
          if (cc < 0) continue;
          const float4 g = gam[q], b = bet[q];
          *reinterpret_cast<uint2*>(As + (size_t)r * lda + cc) = make_uint2(
              pack_bf16x2((v[q].x - mean) * rstd * g.x + b.x,
                          (v[q].y - mean) * rstd * g.y + b.y),
              pack_bf16x2((v[q].z - mean) * rstd * g.z + b.z,
                          (v[q].w - mean) * rstd * g.w + b.w));
        }
      }
      __syncthreads();  // buffer c % RM_LN_BUFS is consumed
      if (c + RM_LN_BUFS < nch) issue(c + RM_LN_BUFS);
    }
  }

  // ---- main loop over the slice's k-tiles: B fragments straight from the
  // raw k-tile (warp w: columns 8w..; lane: rows 2 (lane % 4) + 0, 1, 8, 9
  // of each k16 step at column lane / 4), widened to bf16 in registers;
  // an int4 byte feeds the low step (logical row p) and the high step
  // (logical row K/2 + p) ----
  float acc[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  constexpr bool grouped = GROUPED;
  const bf16* gs = (const bf16*)a.w.s;
  const int fq = lane & 3, fn = warp * 8 + (lane >> 2);
  const int cn = n0 + warp * 8 + 2 * fq;   // this thread's output columns
  // q4_0: the group scales of a k-tile's low and high half at this
  // thread's two columns (a k-tile of 32 stored rows lies in one group of
  // each half), asked for one k-tile ahead of their use
  auto tile_scales = [&](int kt, float (&sc)[2][2]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t g = ((half ? S : 0) + kt * RM_BKS) / a.w.group;
      sc[half][0] = cn < a.N ? __bfloat162float(gs[g * a.N + cn]) : 0.f;
      sc[half][1] = cn + 1 < a.N ? __bfloat162float(gs[g * a.N + cn + 1])
                                 : 0.f;
    }
  };
  float sc[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
  if constexpr (grouped) {
    if (kt0 < kt1) tile_scales(kt0, sc);
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int j = kt - kt0, cur = j % RM_STAGES;
    float sn[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
    if constexpr (grouped) {
      if (kt + 1 < kt1) tile_scales(kt + 1, sn);
    }
    cp_async_wait<RM_STAGES - 2>();  // k-tile kt (and A) has landed
    __syncthreads();  // ... for every thread; slot kt - 1 consumed
    if (kt + RM_STAGES - 1 < kt1)
      load_tile(kt + RM_STAGES - 1, (cur + RM_STAGES - 1) % RM_STAGES);
    cp_async_commit();
    const uint8_t* raw = reinterpret_cast<const uint8_t*>(
                             ring + cur * RM_BKS * RM_RING_LD) + fn;
    const int pk = kt * RM_BKS;       // first stored row of the tile
#pragma unroll
    for (int ks = 0; ks < RM_KS; ++ks) {
      if (pk + ks * 16 >= S) break;   // a k-tile of 16 stored rows
      const uint8_t* rb = raw + (ks * 16 + 2 * fq) * RM_RING_LD;
      const int x[4] = {(int8_t)rb[0], (int8_t)rb[RM_RING_LD],
                        (int8_t)rb[8 * RM_RING_LD],
                        (int8_t)rb[9 * RM_RING_LD]};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half && !p4) break;
        float f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f[e] = (float)(!p4 ? x[e] : half ? x[e] >> 4 : (x[e] & 15) - 8);
        const uint32_t b0 = pack_bf16x2(f[0], f[1]);
        const uint32_t b1 = pack_bf16x2(f[2], f[3]);
        const int ak = (half ? w : 0) + j * RM_BKS + ks * 16;
        const float s0 = sc[half][0], s1 = sc[half][1];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          uint32_t af[4];
          ldmatrix_x4(af, As + (size_t)(i * 16 + (lane & 15)) * lda + ak +
                              (lane >> 4) * 8);
          if constexpr (grouped) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16_16816(t, af, b0, b1);
            acc[i][0] = fmaf(s0, t[0], acc[i][0]);
            acc[i][1] = fmaf(s1, t[1], acc[i][1]);
            acc[i][2] = fmaf(s0, t[2], acc[i][2]);
            acc[i][3] = fmaf(s1, t[3], acc[i][3]);
          } else {
            mma_bf16_16816(acc[i], af, b0, b1);
          }
        }
      }
    }
    if constexpr (grouped) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        sc[half][0] = sn[half][0], sc[half][1] = sn[half][1];
    }
  }

  // ---- float32 tile to shared memory; the cluster's sum in rank order ----
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = i * 16 + lane / 4, c = warp * 8 + 2 * (lane & 3);
    *reinterpret_cast<float2*>(Cs + r * RM_CS_LD + c) =
        make_float2(acc[i][0], acc[i][1]);
    *reinterpret_cast<float2*>(Cs + (r + 8) * RM_CS_LD + c) =
        make_float2(acc[i][2], acc[i][3]);
  }
  if (nsplit > 1) cluster.sync(); else __syncthreads();
  const float* pc = (a.w.kind == LIN_INT8 || a.w.kind == LIN_INT4)
                        ? (const float*)a.w.s : nullptr;
  const bf16* bias = (const bf16*)a.w.b;
  const bf16* ls = (const bf16*)a.ls;
  const int nr = (BM - z + nsplit - 1) / nsplit;
  // four outputs a thread at once: every load before the first store
  for (int e0 = tid; e0 < nr * RM_BN; e0 += 4 * RM_THREADS) {
    float v[4], sc[4], bv[4], lv[4], rv[4];
    bool ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * RM_THREADS;
      const int row = z + nsplit * (e / RM_BN), c = e % RM_BN;
      const int m = m0 + row, n = n0 + c;
      ok[u] = e < nr * RM_BN && m < a.T && n < a.N;
      v[u] = bv[u] = rv[u] = 0.f;
      sc[u] = lv[u] = 1.f;
      if (!ok[u]) continue;
      for (int q = 0; q < nsplit; ++q)
        v[u] += (nsplit > 1 ? cluster.map_shared_rank(Cs, q)
                            : Cs)[row * RM_CS_LD + c];
      if (pc) sc[u] = pc[n];
      bv[u] = opt(bias, n, 0.f);
      lv[u] = opt(ls, n, 1.f);
      const size_t i = (size_t)m * a.N + n;
      if (a.epilogue == EPI_RESID_F32)
        rv[u] = to_f(((const bf16*)a.res)[i]);
      else if (a.epilogue == EPI_RESID)
        rv[u] = ((const float*)a.res)[i];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (!ok[u]) continue;
      const int e = e0 + u * RM_THREADS;
      const size_t i = (size_t)(m0 + z + nsplit * (e / RM_BN)) * a.N + n0 +
                       e % RM_BN;
      const float y = v[u] * sc[u] + bv[u];
      switch (a.epilogue) {
        case EPI_ROUND: ((bf16*)a.out)[i] = from_f<bf16>(y); break;
        case EPI_RESID_F32: ((float*)a.out)[i] = rv[u] + lv[u] * y; break;
        case EPI_GELU:
          ((bf16*)a.out)[i] = from_f<bf16>(gelu_f(y, a.approx));
          break;
        default: ((bf16*)a.out)[i] = from_f<bf16>(rv[u] + lv[u] * y);
      }
    }
  }
  if (nsplit > 1) cluster.sync();  // no block leaves while read
}

// A bf16 call of fewer rows than rows_mma_kernel takes (skinny_kernel,
// ptt_rows_skinny): K5a at T = 1, K4b below 16 rows, K5b's row-block
// launches below 16 rows. The plan (ops/fused_layer.py `skinny_plan`) cuts
// the stored weight into units of 32 columns x a slice of its stored rows,
// one unit a block; the ks slices of a column tile are the blocks of one
// cluster. Its offsets place the regions of a block's shared memory.
struct SkinnyArgs {
  CUtensorMap tm;   // the stored (rows, N) bytes, boxes of 32 columns
  RowsArgs a;       // rows_kernel's function (rows unused)
  int ks;           // slices of the stored rows, the blocks of a cluster
  int o_w, o_x, o_lnv, o_red, o_out;  // shared-memory offsets (bytes)
};

// Block u: column tile u / ks (32 stored columns from c0), slice q = u % ks
// of the stored rows (its cluster rank). At entry thread 0 asks the TMA for
// the unit's whole weight slab (issue_cols: q4_0's scale rows by cp.async);
// while it is in flight the block stages its rows (ROWS_LOAD: the slice's
// columns only, int4: [p0, p0 + srows) then [K/2 + p0, ..); the LayerNorm
// prologues: whole rows, normalised by ln_rows and rounded to bf16 where
// K5a rounds). Then the unit's raw sums for every row from shared memory on
// SIMT (cols_dot: int8 and nibbles widened at full rate, q4_0 nibbles times
// their group's scale), to a T x 32 float32 partial. After cluster.sync()
// block q sums outputs q, q + ks, ... over the cluster's partials in rank
// order (distributed shared memory, no float atomics) and applies the
// per-channel scales, the bias and the epilogue.
__global__ void __launch_bounds__(QD_THREADS)
    skinny_kernel(const __grid_constant__ SkinnyArgs g) {
  extern __shared__ __align__(128) unsigned char sk_shared[];
  __shared__ __align__(8) uint64_t bar;
  unsigned char* smem = align128(sk_shared);
  coop::cluster_group cluster = coop::this_cluster();
  const RowsArgs& a = g.a;
  const int ks = g.ks, rows = a.T, K = a.K, N = a.N, tid = threadIdx.x;
  const bool p4 = packed(a.w);
  const int S = p4 ? K / 2 : K, srows = S / ks;
  const int q = blockIdx.x % ks, c0 = blockIdx.x / ks * FL_TILE;
  const int p0 = q * srows;
  if (tid == 0) prefetch_map(&g.tm);
  mbar_setup(&bar, 1);
  issue_cols(a.w, &g.tm, K, N, ks, smem + g.o_w, &bar);
  cp_async_commit();
  // this thread's outputs e = q + ks * tid, + ks * QD_THREADS, ... all lie
  // in column c0 + e % 32: its scale, bias and layer scale, asked for now
  const int n = c0 + (q + ks * tid) % FL_TILE;
  const float sc = (a.w.kind == LIN_INT8 || a.w.kind == LIN_INT4)
                       ? ((const float*)a.w.s)[n] : 1.f;
  const float bv = opt((const bf16*)a.w.b, n, 0.f);
  const float lv = opt((const bf16*)a.ls, n, 1.f);
  float* xs = reinterpret_cast<float*>(smem + g.o_x);
  float* red = reinterpret_cast<float*>(smem + g.o_red);
  float* out = reinterpret_cast<float*>(smem + g.o_out);
  int ldx, xp0, half;   // cols_dot's view of xs
  if (a.prologue == ROWS_LOAD) {
    const int aw = p4 ? 2 * srows : srows;
    const bf16* x = (const bf16*)a.a;
    for (int i = tid; i < rows * aw; i += QD_THREADS) {
      const int r = i / aw, c = i - r * aw;
      xs[i] = to_f(x[(size_t)r * K + (c < srows ? p0 + c
                                                : S + p0 + c - srows)]);
    }
    __syncthreads();
    ldx = aw, xp0 = 0, half = srows;
  } else {
    float* lnv = reinterpret_cast<float*>(smem + g.o_lnv);
    NormVecs nv;
    load_norm(nv, (const bf16*)a.ns, (const bf16*)a.nb, K);
    if (a.prologue == ROWS_LN_F32)
      stage_floats(xs, (const float*)a.a, rows * K);
    else
      stage_floats(xs, (const bf16*)a.a, rows * K);
    store_norm(nv, lnv, K);
    __syncthreads();
    ln_rows<bf16>(xs, rows, K, a.eps, lnv, lnv + K, red);
    ldx = K, xp0 = p0, half = S;
  }
  wait_phase(&bar, 0);
  if (rows == 1)
    cols_dot<1>(xs, ldx, 1, smem + g.o_w, 32, a.w.kind, xp0, srows, half,
                a.w.group, red, out);
  else
    cols_dot<CP_ROWS>(xs, ldx, rows, smem + g.o_w, 32, a.w.kind, xp0, srows,
                      half, a.w.group, red, out);
  if (ks > 1) cluster.sync();
  for (int e = q + ks * tid; e < rows * FL_TILE; e += ks * QD_THREADS) {
    float v = 0.f;
    for (int j = 0; j < ks; ++j)
      v += (ks > 1 ? cluster.map_shared_rank(out, j) : out)[e];
    const size_t i = (size_t)(e / FL_TILE) * N + n;
    const float y = v * sc + bv;
    switch (a.epilogue) {
      case EPI_ROUND: ((bf16*)a.out)[i] = from_f<bf16>(y); break;
      case EPI_RESID_F32:
        ((float*)a.out)[i] = to_f(((const bf16*)a.res)[i]) + lv * y;
        break;
      case EPI_GELU:
        ((bf16*)a.out)[i] = from_f<bf16>(gelu_f(y, a.approx));
        break;
      default:
        ((bf16*)a.out)[i] = from_f<bf16>(((const float*)a.res)[i] + lv * y);
    }
  }
  if (ks > 1) cluster.sync();  // no block leaves while read
}

struct PostArgs {
  Tail t;                        // x (T, dm), ls1, ls2, norm2, the linears,
                                 // partial scratch, plan, offsets
  const void* attn;              // (T, dm)
  void* out;                     // (T, dm)
  int o_nx, o_act;               // shared-memory offsets (bytes)
};

// K5c's tail: layer l + 1's norm1 and in_proj.
struct NextArgs {
  CUtensorMap tm_nx;             // layer l + 1's in_proj (whole tiles)
  const void *ns, *nb;           // norm1 of layer l + 1 (dm,) or null
  Lin win;                       // (dm, N)
  float* xn;                     // scratch (dm,): x_next in float32
  void* qkv;                     // (N,)
  int N;
};

// K5b (next == nullptr) and K5c: the phases of layer_post.cuh with two grid
// barriers; K5c then a third barrier and its tail. Marks (ops/fused_layer.py
// POST_MARKS, BILAYER_MARKS): entry, issued, staged, W_o landed, out_proj,
// sync 1, x1, ln, W1 landed, h, W2 landed, mlp, sync 2, finish (K5c: sync
// 3, next ln, next landed, next in_proj).
template <typename T>
__device__ void post_phases(const PostArgs& a, const NextArgs* next) {
  extern __shared__ __align__(128) unsigned char post_shared[];
  __shared__ __align__(8) uint64_t bars[4];  // W_o, W1, W2, next in_proj
  unsigned char* smem = align128(post_shared);
  const Tail& t = a.t;
  const int T_ = t.T, dm = t.dm;
  float* xs = reinterpret_cast<float*>(smem + a.o_act);  // T x dm
  float* hs = xs + T_ * dm;                               // T x FL_TILE
  float* outs = hs + T_ * FL_TILE;                        // T x FL_TILE
  float* red = outs + T_ * FL_TILE;                       // CP_RED
  // bf16 rows for the tensor cores (bf16 above one row), else null
  float* lnv = red + CP_RED;  // a LayerNorm's scale and bias (2 x dm)
  bf16* xb = std::is_same<T, bf16>::value && T_ > 1
                 ? reinterpret_cast<bf16*>(lnv + 2 * dm) : nullptr;
  coop::grid_group grid = coop::this_grid();
  mark(t.marks, 0);

  // every weight byte this block reads: a TMA phase on an mbarrier each
  // (and a cp.async group for q4_0's scales)
  if (threadIdx.x == 0) {
    prefetch_map(&t.tm_wo);
    prefetch_map(&t.tm_w1);
    if (next) prefetch_map(&next->tm_nx);
  }
  mbar_setup(bars, next ? 4 : 3);
  issue_cols(t.wo, &t.tm_wo, dm, dm, t.ks_o, smem + t.o_wo, bars);
  cp_async_commit();
  issue_w1(t, smem, bars + 1);
  cp_async_commit();
  issue_w2(t, smem, bars + 2);
  cp_async_commit();
  const int after = next ? 1 : 0;  // groups committed after W2's
  if (next) {
    issue_cols(next->win, &next->tm_nx, dm, next->N, 1, smem + a.o_nx,
               bars + 3);
    cp_async_commit();
  }
  mark(t.marks, 1);

  // phase 1: out_proj's units -> p1
  stage_floats(xs, (const T*)a.attn, T_ * dm);
  if (xb) to_bf16_rows(xs, dm, T_, (T_ + 15) / 16 * 16, xb, dm + 8);
  mark(t.marks, 2);
  wait_phase(bars, after + 2);
  mark(t.marks, 3);
  out_proj_phase(t, smem, xs, xb, red, outs);
  mark(t.marks, 4);
  grid.sync();
  mark(t.marks, 5);

  // phase 2: x1, LN, this block's MLP tiles -> p2
  mlp_phase<T>(t, smem, xs, hs, red, xb, lnv, bars + 1, after, 6);
  mark(t.marks, 11);
  grid.sync();
  mark(t.marks, 12);

  // phase 3: out = round(x1 + ls2 * up)
  T* out = (T*)a.out;
  float* xn = next ? next->xn : nullptr;
  mlp_finish<T>(t, [&](int i, float v) {
    out[i] = from_f<T>(v);
    if (xn) xn[i] = v;
  });
  mark(t.marks, 13);
  if (!next) return;
  grid.sync();
  mark(t.marks, 14);

  // K5c's tail: qkv = round(round(LN1(x_next)) @ W_in + b_in), layer l + 1,
  // whole column tiles (one slice): the sums are final here
  stage_row_norm(xs, (const float*)xn, dm, (const T*)next->ns,
                 (const T*)next->nb, lnv, dm);
  ln_rows<T>(xs, 1, dm, t.eps, lnv, lnv + dm, red);
  mark(t.marks, 15);
  wait_phase(bars + 3, 0);
  mark(t.marks, 16);
  T* qkv = (T*)next->qkv;
  const Lin& w = next->win;
  const float* pc = w.kind == LIN_INT4_G ? nullptr : (const float*)w.s;
  const T* bias = (const T*)w.b;
  cols_phase(w, dm, next->N, 1, smem + a.o_nx, xs, nullptr, dm, 1, red, outs,
             [&](int, int, int n, float v) {
               qkv[n] = from_f<T>(v * (pc ? pc[n] : 1.f) + opt(bias, n, 0.f));
             });
  mark(t.marks, 17);
}

template <typename T>
__global__ void __launch_bounds__(QD_THREADS)
    fused_post_kernel(const __grid_constant__ PostArgs a) {
  post_phases<T>(a, nullptr);
}

template <typename T>
__global__ void __launch_bounds__(QD_THREADS)
    bilayer_kernel(const __grid_constant__ PostArgs a,
                   const __grid_constant__ NextArgs next) {
  post_phases<T>(a, &next);
}

template <typename K>
static int set_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace ptt

// A linear of logical shape (K, N) the fused kernels take: quantized, with
// its scales, and whole scale groups in each half of K for grouped int4.
static bool lin_ok(const ptt::Lin& l, int K) {
  switch (l.kind) {
    case ptt::LIN_INT8: return l.s != nullptr;
    case ptt::LIN_INT4: return l.s != nullptr && K % 2 == 0;
    case ptt::LIN_INT4_G:
      return l.s != nullptr && l.group > 0 && K % 2 == 0 &&
             (K / 2) % l.group == 0;
    default: return false;
  }
}

// Launch rows_kernel over all T rows: row blocks of at most FL_ROW_FLOATS
// activations (16 rows at K 1024, 32 at 512, 4 at 4096), one per
// blockIdx.y.
static int launch_rows(ptt::RowsArgs a, int dtype, cudaStream_t st) {
  if (a.T < 1 || a.K < 1 || a.N < 1 || a.N % 4 || !lin_ok(a.w, a.K))
    return (int)cudaErrorInvalidValue;
  a.rows = std::max(1, std::min(a.T, FL_ROW_FLOATS / a.K));
  const size_t smem = sizeof(float) * (ptt::QD_RED + (size_t)a.rows * a.K);
  const dim3 grid((a.N + ptt::FL_TILE - 1) / ptt::FL_TILE,
                  (a.T + a.rows - 1) / a.rows);
  PTT_DISPATCH(dtype, T_, {
    auto kern = ptt::rows_kernel<T_>;
    int rc = ptt::set_smem(kern, smem);
    if (rc) return rc;
    kern<<<grid, ptt::QD_THREADS, smem, st>>>(a);
  });
  return (int)cudaGetLastError();
}

// K5a (ROWS_LN, EPI_ROUND) or one step of K5b over many rows
// (rows_kernel), any dtype: a (T, K) (float32 when
// prologue is ROWS_LN_F32), the linear (w, s, b; kind, group) of logical
// shape (K, N), norm (ns, nb) for the LN prologues, residual `res` and
// layer scale `ls` for the residual epilogues, out (T, N).
extern "C" int ptt_fused_rows(const void* a, const void* ns, const void* nb,
                              const void* w, const void* s, const void* b,
                              const void* res, const void* ls, void* out,
                              int T, int K, int N, int kind, int group,
                              int prologue, int epilogue, int approx,
                              float eps, int dtype, void* stream) {
  if (prologue < ptt::ROWS_LOAD || prologue > ptt::ROWS_LN_F32 ||
      epilogue < ptt::EPI_ROUND || epilogue > ptt::EPI_RESID ||
      ((epilogue == ptt::EPI_RESID_F32 || epilogue == ptt::EPI_RESID) &&
       res == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_rows({a, ns, nb, {w, s, b, kind, group}, res, ls, out, T, K,
                      N, 0, prologue, epilogue, approx, eps},
                     dtype, (cudaStream_t)stream);
}

// K5a or one step of K5b over many rows on the tensor cores
// (rows_mma_kernel): ptt_fused_rows' operands for a bf16 working type, and
// the plan (ops/fused_layer.py `rows_plan`): bm rows a block (16, 32 or
// 64), `splits` reduction slices of kt_per k-tiles (32 stored weight rows;
// the last may hold 16) over a cluster. Takes int8 and int4 weights
// (per-channel, or grouped scales in groups of a multiple of 32 rows) whose
// stored rows are a multiple of 16, K a multiple of 16 (under a LayerNorm
// a multiple of 128, at most 1024) and N of 16.
extern "C" int ptt_rows_mma(const void* a, const void* ns, const void* nb,
                            const void* w, const void* s, const void* b,
                            const void* res, const void* ls, void* out, int T,
                            int K, int N, int kind, int group, int prologue,
                            int epilogue, int approx, float eps, int bm,
                            int splits, int kt_per, void* stream) {
  ptt::RowsMmaArgs g{{a, ns, nb, {w, s, b, kind, group}, res, ls, out, T, K,
                      N, 0, prologue, epilogue, approx, eps},
                     bm, splits, kt_per};
  const bool p4 = ptt::packed(g.a.w);
  const int stored = p4 ? K / 2 : K;
  const int ktiles = (stored + ptt::RM_BKS - 1) / ptt::RM_BKS;
  if (T < 1 || K < 16 || K % 16 || N < 16 || N % 16 || !lin_ok(g.a.w, K) ||
      stored % 16 || (kind == ptt::LIN_INT4_G && group % 32) ||
      prologue < ptt::ROWS_LOAD || prologue > ptt::ROWS_LN_F32 ||
      epilogue < ptt::EPI_ROUND || epilogue > ptt::EPI_RESID ||
      ((epilogue == ptt::EPI_RESID_F32 || epilogue == ptt::EPI_RESID) &&
       res == nullptr) ||
      (prologue != ptt::ROWS_LOAD && (K > 1024 || K % 128)) ||
      !(bm == 16 || bm == 32 || bm == 64) || splits < 1 ||
      splits > ptt::RM_MAX_SPLITS || kt_per < 1 ||
      (long)splits * kt_per < ktiles || (long)(splits - 1) * kt_per >= ktiles)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ptt::rows_mma_smem(
      bm, kt_per, p4, K,
      prologue == ptt::ROWS_LOAD ? 0 : prologue == ptt::ROWS_LN_F32 ? 4 : 2);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const dim3 grid(splits, (N + ptt::RM_BN - 1) / ptt::RM_BN,
                  (T + bm - 1) / bm);
  cudaStream_t st = (cudaStream_t)stream;
  // the kernel's dynamic shared memory is set on every launch: a smaller
  // figure left by an earlier launch would refuse this one
  auto run = [&](auto kern) {
    int rc = ptt::set_smem(kern, smem);
    if (rc) return rc;
    if (splits == 1)  // one block a reduction: an ordinary launch
      kern<<<grid, ptt::RM_THREADS, smem, st>>>(g);
    else
      rc = (int)ptt::launch_clustered(kern, grid, dim3(ptt::RM_THREADS),
                                      splits, smem, st, g);
    return rc ? rc : (int)cudaGetLastError();
  };
  if (kind == ptt::LIN_INT4_G)
    return bm == 16 ? run(ptt::rows_mma_kernel<16, true>)
         : bm == 32 ? run(ptt::rows_mma_kernel<32, true>)
                    : run(ptt::rows_mma_kernel<64, true>);
  return bm == 16 ? run(ptt::rows_mma_kernel<16, false>)
       : bm == 32 ? run(ptt::rows_mma_kernel<32, false>)
                  : run(ptt::rows_mma_kernel<64, false>);
}

// K5a, K4b or one step of K5b below MMA_ROWS rows (skinny_kernel):
// ptt_fused_rows' operands for a bf16 working type, and the plan
// (ops/fused_layer.py `skinny_plan`, SKINNY_PLAN_KEYS): ks, the shared
// memory in bytes and the offsets o_w, o_x, o_lnv, o_red, o_out of its
// regions, which must hold what the kernel puts there. Takes int8 and int4
// weights (per-channel, or grouped with whole groups in a slice), N a
// multiple of 32, slices of the stored rows in 1, 2, 4 or 8 (more than one:
// multiples of 32 rows; above 256 rows multiples of 256, the TMA's box),
// the weight (and q4_0's scales) 16-byte aligned; under a LayerNorm K a
// multiple of 4 up to 4096 and `a` 8-byte (bf16) or 16-byte (float32)
// aligned.
extern "C" int ptt_rows_skinny(const void* a, const void* ns, const void* nb,
                               const void* w, const void* s, const void* b,
                               const void* res, const void* ls, void* out,
                               int T, int K, int N, int kind, int group,
                               int prologue, int epilogue, int approx,
                               float eps, const int* plan, void* stream) {
  using namespace ptt;
  SkinnyArgs g{{}, {a, ns, nb, {w, s, b, kind, group}, res, ls, out, T, K,
                    N, 0, prologue, epilogue, approx, eps},
               plan[0], plan[2], plan[3], plan[4], plan[5], plan[6]};
  const int ks = g.ks, smem = plan[1];
  const bool p4 = packed(g.a.w), ln = prologue != ROWS_LOAD;
  const int stored = p4 ? K / 2 : K;
  const int srows = ks > 0 ? stored / ks : 0;
  if (T < 1 || K < 2 || N < FL_TILE || N % FL_TILE || !lin_ok(g.a.w, K) ||
      prologue < ROWS_LOAD || prologue > ROWS_LN_F32 ||
      epilogue < EPI_ROUND || epilogue > EPI_RESID ||
      ((epilogue == EPI_RESID_F32 || epilogue == EPI_RESID) &&
       res == nullptr) ||
      !(ks == 1 || ks == 2 || ks == 4 || ks == 8) || stored % ks ||
      (ks > 1 && srows % 32) ||
      (kind == LIN_INT4_G && (srows % group || (uintptr_t)s % 16)) ||
      (srows > TMA_ROWS && srows % TMA_ROWS) ||
      (ln && (K % 4 || K > 4096 ||
              (uintptr_t)a % (prologue == ROWS_LN_F32 ? 16 : 8))))
    return (int)cudaErrorInvalidValue;
  Region r[5] = {{g.o_w, 1, col_unit_bytes(kind, K, ks, group)},
                 {g.o_x, 1, 4 * T * (ln ? K : (p4 ? 2 : 1) * srows)},
                 {g.o_lnv, 1, ln ? 8 * K : 0},
                 {g.o_red, 1, 4 * CP_RED},
                 {g.o_out, 1, 4 * T * FL_TILE}};
  if (!regions_ok(r, 5, smem) || encode_lin(&g.tm, g.a.w, K, N, ks, 32))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / FL_TILE * ks);
  cudaStream_t st = (cudaStream_t)stream;
  // set on every launch: a smaller figure left by an earlier launch would
  // refuse this one
  int rc = set_smem(skinny_kernel, smem);
  if (rc) return rc;
  if (ks == 1)
    skinny_kernel<<<grid, QD_THREADS, smem, st>>>(g);
  else
    rc = (int)launch_clustered(skinny_kernel, grid, dim3(QD_THREADS), ks,
                               smem, st, g);
  return rc ? rc : (int)cudaGetLastError();
}

// Blocks of K5b (which 0), K5c (1) or K8 (2, megalayer.cu) the card holds
// at once with `smem` bytes of dynamic shared memory: blocks resident per
// SM times the SM count. 0 on error.
int ptt_megalayer_max_blocks(int smem, int dtype);
extern "C" int ptt_coop_max_blocks(int smem, int which, int dtype) {
  if (which == 2) return ptt_megalayer_max_blocks(smem, dtype);
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return 0;
  PTT_DISPATCH(dtype, T_, {
    const void* kern = which ? (const void*)ptt::bilayer_kernel<T_>
                             : (const void*)ptt::fused_post_kernel<T_>;
    if (cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kern, ptt::QD_THREADS, smem))
      return 0;
  });
  return per_sm * sms;
}

// p: x, attn, ls1, ls2, norm2 scale, norm2 bias, then (w, scale, bias) of
// out_proj, linear1, linear2, then the out_proj partials (ks_o, T, dm), the
// MLP partials (grid, T, dm), out and the x1 scratch (T, dm). lin: (kind,
// group) of the three (one layout: int8, or int4 in either scale layout).
// plan (ops/fused_layer.py post_plan, PLAN_KEYS): grid, ks_o, fin_e, the
// shared memory in bytes and the offsets o_wo, o_w1, o_w2, o_nx, o_act of
// its regions, which must hold what the kernel puts there.
static bool post_args(void* const* p, const int* lin, const int* plan, int T,
                      int dm, int H, float eps, int approx, int n_next,
                      void* marks, ptt::PostArgs* a) {
  using namespace ptt;
  Tail t{{}, {}, p[0], p[2], p[3], p[4], p[5],
         {p[6], p[7], p[8], lin[0], lin[1]},
         {p[9], p[10], p[11], lin[2], lin[3]},
         {p[12], p[13], p[14], lin[4], lin[5]},
         (float*)p[15], (float*)p[16], (float*)p[18],
         (unsigned long long*)marks, T, dm, H, plan[1], plan[2], approx, 1,
         eps, plan[4], plan[5], plan[6]};
  const int grid = plan[0];
  if (T < 1 || dm < FL_TILE || dm % FL_TILE || H % FL_TILE || grid < 1 ||
      grid > H / FL_TILE || !(plan[1] == 1 || plan[1] == 2 ||
                              plan[1] == 4 || plan[1] == 8) ||
      !(plan[2] == 1 || plan[2] == 2 || plan[2] == 4 || plan[2] == 8) ||
      !lin_ok(t.wo, dm) || !lin_ok(t.w1, dm) || !lin_ok(t.w2, H) ||
      lin[0] != lin[2] || lin[0] != lin[4] || lin[1] != lin[3] ||
      lin[1] != lin[5] || (lin[0] == LIN_INT4_G && lin[1] % 32) ||
      ((packed(t.wo) ? dm / 2 : dm) / plan[1]) % 32 ||
      (lin[0] == LIN_INT4_G &&
       ((packed(t.wo) ? dm / 2 : dm) / plan[1]) % lin[1]))
    return false;
  Region r[5];
  tail_regions(t, grid, r);
  r[3] = {plan[7], cdiv(n_next / FL_TILE, grid),
          col_unit_bytes(lin[0], dm, 1, lin[1])};
  r[4] = {plan[8], 1, act_bytes(T, dm)};
  if (!regions_ok(r, 5, plan[3]) ||
      encode_lin(&t.tm_wo, t.wo, dm, dm, t.ks_o, 32) ||
      encode_lin(&t.tm_w1, t.w1, dm, H, 1, packed(t.w1) ? 16 : 32))
    return false;
  *a = PostArgs{t, p[1], p[17], plan[7], plan[8]};
  return true;
}

template <typename K>
static int launch_coop(K kern, int grid, void** args, int smem,
                       void* stream) {
  int rc = ptt::set_smem(kern, smem);
  if (rc) return rc;
  rc = (int)cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                        dim3(ptt::QD_THREADS), args, smem,
                                        (cudaStream_t)stream);
  return rc ? rc : (int)cudaGetLastError();
}

// K5b: p, lin and plan as post_args; marks: int64 (grid, CP_MARKS) or null.
extern "C" int ptt_fused_post(void* const* p, const int* lin, const int* plan,
                              int T, int dm, int H, float eps, int approx,
                              void* marks, int dtype, void* stream) {
  ptt::PostArgs a;
  if (!post_args(p, lin, plan, T, dm, H, eps, approx, 0, marks, &a))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&a};
  PTT_DISPATCH(dtype, T_, {
    return launch_coop(ptt::fused_post_kernel<T_>, plan[0], args, plan[3],
                       stream);
  });
  return (int)cudaErrorInvalidValue;
}

// K5c, T = 1: p, lin and plan as ptt_fused_post for layer l (p[17] = x_next
// out; the plan's shared memory holds layer l + 1's in_proj units too),
// then q: norm1 scale, norm1 bias, (w, scale, bias) of layer l + 1's
// in_proj, the x_next float32 scratch (dm,) and qkv out (N,); qlin: the
// in_proj's (kind, group), the same as layer l's.
extern "C" int ptt_bilayer(void* const* p, const int* lin, void* const* q,
                           const int* qlin, const int* plan, int dm, int H,
                           int N, float eps, int approx, void* marks,
                           int dtype, void* stream) {
  ptt::PostArgs a;
  ptt::NextArgs next{{}, q[0], q[1], {q[2], q[3], q[4], qlin[0], qlin[1]},
                     (float*)q[5], q[6], N};
  if (N < ptt::FL_TILE || N % ptt::FL_TILE || !lin_ok(next.win, dm) ||
      qlin[0] != lin[0] || qlin[1] != lin[1] ||
      !post_args(p, lin, plan, 1, dm, H, eps, approx, N, marks, &a) ||
      ptt::encode_lin(&next.tm_nx, next.win, dm, N, 1, 32))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&a, &next};
  PTT_DISPATCH(dtype, T_, {
    return launch_coop(ptt::bilayer_kernel<T_>, plan[0], args, plan[3],
                       stream);
  });
  return (int)cudaErrorInvalidValue;
}
