// The phases of a transformer layer's tail after attention, as device
// functions that one cooperative kernel runs with grid barriers between
// them: K5b (fused_layer.cu `fused_post_kernel`), K5c (fused_layer.cu
// `bilayer_kernel`) and K8 (megalayer.cu). Every block of the grid calls
// each function (they synchronise the block):
//
//   out_proj_phase  this block's out_proj units: raw sums of attn @ W_o over
//                   a column tile and a slice of its stored rows, to the
//                   slice's float32 partial p1[slice]
//   mlp_phase       x1 = x + ls1 * ((sum of the p1 slices, in slice order)
//                   * s_o + b_o) and ln = round(LN(x1) * ns + nb) into
//                   shared memory; then this block's MLP tiles: h =
//                   gelu(ln @ W_1 + b_1) (rounded to the working type, or
//                   float32), and the tile's partial of up = h @ q_2
//                   (grouped W2 scales applied per nibble) to p2[block]
//   mlp_finish      v = x1 + ls2 * ((sum of the grid's p2 partials) * s_2 +
//                   b_2), handed to the caller per element
//
// What bounds these phases on the H100 is the weight stream (every weight
// element meets one activation row at T = 1) and latency. So a block knows
// every weight byte it will read before the launch (ops/fused_layer.py
// `post_plan`, `fused_step.mega_plan`: column tiles of 32 columns, i.e. 32
// bytes a stored row, cut into slices of stored rows; MLP tiles of 32
// hidden units, whose W2 rows are one contiguous run of bytes), and at
// entry, before any LayerNorm, attention or grid barrier, one thread asks
// the Tensor Memory Accelerator for all of it: 2-D boxes of a tensor map
// for column tiles, one 1-D copy for W2's rows, an mbarrier a phase
// (`issue_*`; q4_0's few scale rows by cp.async, a commit group a phase).
// A phase waits for its own mbarrier only, so the layer's whole weight
// stream is in flight while the first phases run, and no thread spends
// instructions on it. The products then read weights from shared memory
// (`cols_dot`, `w2_dot` at one row; `cols_mma`, `w2_mma` on the tensor
// cores above one row in bf16); each walks its rows in a fixed order, and
// every sum across threads, slices and blocks runs in a fixed order too
// (no float atomics): a call gives the same bits run to run. Loads of
// data other blocks wrote (partials, x1) are issued in batches before
// their first use, so a phase waits for one round trip to L2, not one a
// load; a LayerNorm's scale and bias come with its phase's first batch.
//
// Instrumentation: given a marks array (grid x CP_MARKS int64), thread 0
// of each block writes %globaltimer (ns) at each mark point of its kernel
// (ops/fused_layer.py POST_MARKS, BILAYER_MARKS; fused_step.py MEGA_MARKS).
// Without one (the default) the marks cost a predicated-off store.
//
// Column units of out_proj spread the phase over the grid (1024 columns at
// the backbone are 32 tiles; in 4 slices, 128 units for 128 blocks). The
// cross-block sum of the MLP partials reads them as float4 vectors: a
// warp's lanes cover fin_e vectors and walk the partials g = lane / fin_e,
// + 32 / fin_e, ... in order, then combine those sums in a butterfly of xor
// shuffles (`mlp_finish`), instead of one thread walking all G partials of
// an element.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include "qmma.cuh"

namespace ptt {

constexpr int FL_TILE = 32;      // columns of a column tile, units an MLP tile
constexpr int CP_SLICES = QD_THREADS / 8;  // row slices of a column product
constexpr int CP_ROWS = 8;       // activation rows a pass of a product
constexpr int CP_RED = QD_WARPS * CP_ROWS * FL_TILE;  // cross-warp sums
constexpr int CP_MARKS = 24;     // globaltimer marks a block

__host__ __device__ __forceinline__ bool packed(const Lin& l) {
  return l.kind == LIN_INT4 || l.kind == LIN_INT4_G;
}
__host__ __device__ __forceinline__ bool packed_kind(int kind) {
  return kind == LIN_INT4 || kind == LIN_INT4_G;
}

// ---------------------------------------------------------------- plan ---
// The wrapper's plan (ops/fused_layer.py post_plan, fused_step.mega_plan) is
// the one source of the shared-memory layout: it hands the kernels each
// region's offset. What a region holds is the kernel's: the byte counts of
// a unit below (ops/fused_layer.py col_unit_bytes, mlp_tile_bytes) and of
// the activations, which the entry points check each region against
// (`regions_ok`).

__host__ __device__ inline int col_unit_bytes(int kind, int K, int ks,
                                              int group) {
  const int srows = (packed_kind(kind) ? K / 2 : K) / ks;
  return srows * 32 + (kind == LIN_INT4_G ? 2 * (srows / group) * 64 : 0);
}
__host__ __device__ inline int w1_tile_bytes(int kind, int dm, int group) {
  return (packed_kind(kind) ? dm / 2 : dm) * 32 +
         (kind == LIN_INT4_G ? dm / group * 64 : 0);
}
__host__ __device__ inline int w2_tile_bytes(int kind, int dm) {
  return (packed_kind(kind) ? 16 : 32) * dm + (kind == LIN_INT4_G ? 4 * dm
                                                                   : 0);
}
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Where a block's tail weights sit in shared memory (bytes) and what a
// product phase needs to know.
struct Tail {
  CUtensorMap tm_wo, tm_w1;             // W_o (box 32 x rows of a slice),
                                        // W1 (box 32 or 16 x rows)
  const void *x, *ls1, *ls2, *ns, *nb;  // x (T, dm); layer scales and
                                        // norm2 (dm,) or null
  Lin wo, w1, w2;                       // (dm, dm), (dm, H), (H, dm)
  float* p1;    // out_proj partials (ks_o, T, dm)
  float* p2;    // MLP partials (grid, T, dm)
  float* x1;    // x1 (T, dm), each block writing its share
  unsigned long long* marks;            // (grid, CP_MARKS) or null
  int T, dm, H, ks_o, fin_e, approx, round_h;
  float eps;
  int o_wo, o_w1, o_w2;                 // shared-memory offsets
};

// bytes a kernel's dynamic shared memory may need to reach 128-byte
// alignment (the TMA's destinations), and the most a block may have
constexpr int SMEM_SLACK = 128;
constexpr int SMEM_MAX = 232448;

// n units of `unit` bytes from offset `off` of a block's shared memory
struct Region {
  int off, n, unit;
};

// The plan's regions hold what the kernel puts there: each 128-byte
// aligned, its units too where there are several (the TMA's destinations),
// none overlapping another, all below smem - SMEM_SLACK; smem <= SMEM_MAX.
inline bool regions_ok(const Region* r, int nr, int smem) {
  if (smem > SMEM_MAX) return false;
  for (int i = 0; i < nr; ++i) {
    const long long end = r[i].off + (long long)r[i].n * r[i].unit;
    if (r[i].off < 0 || r[i].off % 128 || r[i].n < 0 || r[i].unit < 0 ||
        (r[i].n > 1 && r[i].unit % 128) || end > smem - SMEM_SLACK)
      return false;
    for (int j = 0; j < i; ++j)
      if (r[i].off < r[j].off + (long long)r[j].n * r[j].unit &&
          r[j].off < end)
        return false;
  }
  return true;
}

// the layer tail's weight regions of a block: out_proj units, W1 tiles, W2
// tiles
inline void tail_regions(const Tail& t, int grid, Region* r) {
  const int kind = t.wo.kind, group = t.wo.group;
  const int nb_h = cdiv(t.H / FL_TILE, grid);
  r[0] = {t.o_wo, cdiv(t.dm / FL_TILE * t.ks_o, grid),
          col_unit_bytes(kind, t.dm, t.ks_o, group)};
  r[1] = {t.o_w1, nb_h, w1_tile_bytes(kind, t.dm, group)};
  r[2] = {t.o_w2, nb_h, w2_tile_bytes(kind, t.dm)};
}

// a block's activations: T x dm floats (attention rows, then the LayerNorm),
// T x 32 (an h tile), T x 32 (a column unit's sums), the cross-warp sums,
// a LayerNorm's scale and bias as floats (2 x dm);
// above one row also the tensor cores' bf16 copies of the rows and of the h
// tile, in row blocks of 16 (padded: ldmatrix reads distinct banks)
__host__ __device__ inline int act_bytes(int T, int dm) {
  const int mp = (T + 15) / 16 * 16;
  return 4 * (T * dm + 2 * T * FL_TILE + CP_RED + 2 * dm) +
         (T > 1 ? 2 * mp * (dm + 8 + FL_TILE + 8) : 0);
}

constexpr int TMA_ROWS = 256;  // rows of a 2-D TMA box at most

__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return p + ((128 - ((unsigned)__cvta_generic_to_shared(p) & 127)) & 127);
}

// A 2-D tensor map of a (rows, cols) byte matrix with row stride ld bytes,
// read in boxes of box_cols x box_rows (host; cuTensorMapEncodeTiled through
// the runtime's driver entry point). 0 on success.
inline int encode_map(CUtensorMap* m, const void* base, int cols, int rows,
                      size_t ld, int box_cols, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 enc = nullptr;
  if (!enc) {
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", (void**)&enc,
                                cudaEnableDefault, &q) != cudaSuccess ||
        !enc)
      return (int)cudaErrorNotSupported;
  }
  if (rows < 1 || box_rows < 1 || rows % box_rows || (uintptr_t)base % 16 ||
      ld % 16)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
             dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

// the tensor map of a column-tile phase's (K, N) linear in ks slices, or
// of W1's tiles (pw: 32-byte or 16-byte pieces, whole stored rows)
inline int encode_lin(CUtensorMap* m, const Lin& w, int K, int N, int ks,
                      int pw) {
  const int stored = packed_kind(w.kind) ? K / 2 : K, srows = stored / ks;
  const int box = srows < TMA_ROWS ? srows : TMA_ROWS;
  if (srows % box) return (int)cudaErrorInvalidValue;
  return encode_map(m, w.w, N, stored, (size_t)N, pw, box);
}

// ------------------------------------------------------- instrumentation ---

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// %globaltimer (ns) at mark point i of this block, when marks are asked for
__device__ __forceinline__ void mark(unsigned long long* marks, int i) {
  if (marks && threadIdx.x == 0)
    marks[blockIdx.x * CP_MARKS + i] = globaltimer();
}

// wait until at most n (0..4) of this thread's commit groups are in flight,
// then for every thread of the block
__device__ __forceinline__ void wait_groups(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>();
  }
  __syncthreads();
}

// ------------------------------------------------------ batched loads ---
// A thread's global loads in these phases are issued together, before the
// first store to shared memory, so that a loop of them costs one round trip
// to L2 and not one per iteration.

constexpr int LD_BATCH = 8;  // 16-byte loads a thread keeps in flight

// four values at p as floats, read through L2 (data other blocks wrote)
__device__ __forceinline__ float4 ld4cg(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4cg(const bf16* p) {
  const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// dst[i] = float(src[i]) for i < n (n a multiple of 4; src 8-byte aligned
// for bf16, 16-byte for float); every thread of the block, then a barrier
template <typename T>
__device__ void stage_floats(float* dst, const T* src, int n) {
  const int n4 = n / 4;
  for (int b = threadIdx.x; b < n4; b += QD_THREADS * LD_BATCH) {
    float4 v[LD_BATCH];
#pragma unroll
    for (int u = 0; u < LD_BATCH; ++u)
      if (b + u * QD_THREADS < n4) v[u] = ld4cg(src + 4 * (b + u * QD_THREADS));
#pragma unroll
    for (int u = 0; u < LD_BATCH; ++u)
      if (b + u * QD_THREADS < n4)
        *reinterpret_cast<float4*>(dst + 4 * (b + u * QD_THREADS)) = v[u];
  }
  __syncthreads();
}

// A LayerNorm's scale and bias as floats (1 and 0 where absent), for the
// vectors i4 = tid, tid + QD_THREADS, ... < dm / 4 (dm <= 4096): loaded
// with a phase's first batch of row loads, stored after it, so the
// LayerNorm reads them from shared memory without another round trip.
struct NormVecs {
  float4 s[4], b[4];
};
template <typename T>
__device__ __forceinline__ void load_norm(NormVecs& v, const T* ns,
                                          const T* nb, int dm) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i4 = threadIdx.x + k * QD_THREADS;
    if (i4 < dm / 4) {
      v.s[k] = ns ? load4(ns + 4 * i4) : make_float4(1.f, 1.f, 1.f, 1.f);
      v.b[k] = nb ? load4(nb + 4 * i4) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}
// lnv[0, dm) = scale, lnv[dm, 2 dm) = bias
__device__ __forceinline__ void store_norm(const NormVecs& v, float* lnv,
                                           int dm) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i4 = threadIdx.x + k * QD_THREADS;
    if (i4 < dm / 4) {
      reinterpret_cast<float4*>(lnv)[i4] = v.s[k];
      reinterpret_cast<float4*>(lnv + dm)[i4] = v.b[k];
    }
  }
}

// xs[i] = float(src[i]) for i < n (a multiple of 4, n / 4 <= 4 QD_THREADS)
// and the norm's vectors into lnv, one batch of loads; then a barrier
template <typename T, typename N>
__device__ void stage_row_norm(float* xs, const T* src, int n, const N* ns,
                               const N* nb, float* lnv, int dm) {
  NormVecs nv;
  load_norm(nv, ns, nb, dm);
  float4 v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i4 = threadIdx.x + k * QD_THREADS;
    if (i4 < n / 4) v[k] = ld4cg(src + 4 * i4);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i4 = threadIdx.x + k * QD_THREADS;
    if (i4 < n / 4) reinterpret_cast<float4*>(xs)[i4] = v[k];
  }
  store_norm(nv, lnv, dm);
  __syncthreads();
}

// block-wide sum of one float per thread, in a fixed order (shuffles, then
// the warps' sums in index order); every thread gets it. red: QD_WARPS
// floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < QD_WARPS; ++w) t += red[w];
  return t;
}

// xs (T rows of dm floats, shared memory) <- round(LN(xs) * ns + nb) in
// place (ns, nb: dm floats of shared memory, store_norm), mean and variance
// (divisor dm) in float32: below QD_WARPS rows the
// whole block takes a row (block_sum), else a warp a row
// (block_layernorm). Ends with a barrier.
template <typename T>
__device__ void ln_rows(float* xs, int T_, int dm, float eps, const float* ns,
                        const float* nb, float* red) {
  auto store = [&](int r, int i, float v) {
    xs[r * dm + i] = rnd<T>(v * ns[i] + nb[i]);
  };
  if (T_ >= QD_WARPS) {
    block_layernorm(
        T_, dm, eps, [&](int r, int i) { return xs[r * dm + i]; }, store);
    return;
  }
  for (int r = 0; r < T_; ++r) {
    float* row = xs + r * dm;
    float s = 0.f;
    for (int i = threadIdx.x; i < dm; i += QD_THREADS) s += row[i];
    const float mean = block_sum(s, red) / (float)dm;
    float v = 0.f;
    for (int i = threadIdx.x; i < dm; i += QD_THREADS) {
      const float d = row[i] - mean;
      v += d * d;
    }
    const float rstd = 1.0f / sqrtf(block_sum(v, red) / (float)dm + eps);
    for (int i = threadIdx.x; i < dm; i += QD_THREADS)
      store(r, i, (row[i] - mean) * rstd);
  }
  __syncthreads();
}

// ------------------------------------------------------------- copies ---

// ---- the Tensor Memory Accelerator: one thread asks for a whole box (2-D,
// from a tensor map) or a contiguous run (1-D) of bytes; completion counts
// bytes on an mbarrier in shared memory, one a phase, used once a launch
// (parity 0).


__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared.b64 [%0], 1;" ::"r"(smem_u32(b)));
}
// this thread's arrival, expecting `bytes` of copies to land
__device__ __forceinline__ void mbar_expect(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b) {
  asm volatile(
      "{\n .reg .pred p;\n W: mbarrier.try_wait.parity.shared.b64 p, [%0], "
      "0;\n @!p bra W;\n}" ::"r"(smem_u32(b))
      : "memory");
}
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* m,
                                        int col, int row, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(m), "r"(col), "r"(row), "r"(smem_u32(b))
      : "memory");
}
__device__ __forceinline__ void tma_run(void* dst, const void* src,
                                        unsigned bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}
// ask for a tensor map's descriptor ahead of its first copy
__device__ __forceinline__ void prefetch_map(const CUtensorMap* m) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(m) : "memory");
}

// the launch's mbarriers, by thread 0, before the block's first barrier
__device__ __forceinline__ void mbar_setup(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// A phase's weights have landed: its mbarrier, then the q4_0 scales'
// cp.async groups (at most n of this thread's still in flight); the
// block's barrier makes both visible to every thread.
__device__ __forceinline__ void wait_phase(uint64_t* bar, int n) {
  mbar_wait(bar);
  wait_groups(n);
}

// rows of np pieces of pw bytes (pw a multiple of 16; piece j at src + j *
// off1 of each source row, rows ld bytes apart) -> dst, rows np * pw bytes
__device__ __forceinline__ void copy_rows(unsigned char* dst,
                                          const unsigned char* src, int rows,
                                          size_t ld, int pw, int np,
                                          size_t off1) {
  const int per = np * pw / 16;
  for (int i = threadIdx.x; i < rows * per; i += QD_THREADS) {
    const int r = i / per, q = i - r * per;
    const int j = q * 16 / pw, o = q * 16 - j * pw;
    cp_async16(dst + (size_t)r * np * pw + q * 16,
               src + r * ld + j * off1 + o, true);
  }
}

// This block's units of a column-tile phase of a (K, N) linear in ks
// slices: unit u = (tile u / ks, slice u % ks) for u = blockIdx.x, + grid,
// ...; the i-th at dst + i * col_unit_bytes: the slice's stored rows of the
// tile's 32 columns (2-D boxes of the tensor map `tm`, thread 0, on `bar`),
// then (q4_0, cp.async, every thread) the slice's scale rows of the low
// half and of the high half.
__device__ inline void issue_cols(const Lin& w, const CUtensorMap* tm, int K,
                                  int N, int ks, unsigned char* dst,
                                  uint64_t* bar) {
  const int stored = packed(w) ? K / 2 : K, srows = stored / ks;
  const int ub = col_unit_bytes(w.kind, K, ks, w.group);
  const int box = min(TMA_ROWS, srows), nunits = N / FL_TILE * ks;
  if (threadIdx.x == 0) {
    const int mine = blockIdx.x < nunits
                         ? (nunits - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    mbar_expect(bar, (unsigned)(mine * srows * 32));
  }
  int i = 0;
  for (int u = blockIdx.x; u < nunits; u += gridDim.x, ++i) {
    const int c0 = u / ks * FL_TILE, p0 = u % ks * srows;
    unsigned char* d = dst + (size_t)i * ub;
    if (threadIdx.x == 0)
      for (int r = 0; r < srows; r += box)
        tma_box(d + r * 32, tm, c0, p0 + r, bar);
    if (w.kind == LIN_INT4_G) {
      const int ng = srows / w.group;
      const unsigned char* gs = (const unsigned char*)w.s;
      // the low half's groups p0 / group.., the high half's (K/2 + p0) /
      // group..: rows ng apart in dst
      copy_rows(d + srows * 32, gs + ((size_t)(p0 / w.group) * N + c0) * 2,
                ng, (size_t)N * 2, 64, 1, 0);
      copy_rows(d + srows * 32 + ng * 64,
                gs + ((size_t)((stored + p0) / w.group) * N + c0) * 2, ng,
                (size_t)N * 2, 64, 1, 0);
    }
  }
}

// This block's MLP tiles t = blockIdx.x, + grid, ...: W1's columns over its
// stored rows (int8: 32t..; int4: 16t.. and then H/2 + 16t.., two pieces
// of 16 bytes a row one after the other), then (q4_0) its dm / group scale
// rows of those columns (32 bf16 a row: the two pieces side by side).
__device__ inline void issue_w1(const Tail& a, unsigned char* smem,
                                uint64_t* bar) {
  const bool p = packed(a.w1);
  const int H = a.H, stored = p ? a.dm / 2 : a.dm;
  const int tb = w1_tile_bytes(a.w1.kind, a.dm, a.w1.group);
  const int box = min(TMA_ROWS, stored), nt = H / FL_TILE;
  if (threadIdx.x == 0) {
    const int mine =
        blockIdx.x < nt ? (nt - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    mbar_expect(bar, (unsigned)(mine * stored * 32));
  }
  int i = 0;
  for (int t = blockIdx.x; t < nt; t += gridDim.x, ++i) {
    unsigned char* d = smem + a.o_w1 + (size_t)i * tb;
    if (threadIdx.x == 0) {
      for (int r = 0; r < stored; r += box) {
        if (p) {
          tma_box(d + r * 16, &a.tm_w1, 16 * t, r, bar);
          tma_box(d + stored * 16 + r * 16, &a.tm_w1, H / 2 + 16 * t, r, bar);
        } else {
          tma_box(d + r * 32, &a.tm_w1, 32 * t, r, bar);
        }
      }
    }
    if (a.w1.kind == LIN_INT4_G)
      copy_rows(d + stored * 32, (const unsigned char*)a.w1.s + 32 * t,
                a.dm / a.w1.group, (size_t)H * 2, 32, 2, H);
  }
}

// ... and W2's rows of the tile (int8: rows 32t.. ; int4: packed rows
// 16t..: one contiguous run of bytes, one 1-D copy), then (q4_0) the two
// scale rows of the tile's low and high hidden units.
__device__ inline void issue_w2(const Tail& a, unsigned char* smem,
                                uint64_t* bar) {
  const bool p = packed(a.w2);
  const int dm = a.dm, rows = p ? 16 : 32, nt = a.H / FL_TILE;
  const int tb = w2_tile_bytes(a.w2.kind, dm);
  const unsigned char* q = (const unsigned char*)a.w2.w;
  if (threadIdx.x == 0) {
    const int mine =
        blockIdx.x < nt ? (nt - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    mbar_expect(bar, (unsigned)(mine * rows * dm));
  }
  int i = 0;
  for (int t = blockIdx.x; t < nt; t += gridDim.x, ++i) {
    unsigned char* d = smem + a.o_w2 + (size_t)i * tb;
    if (threadIdx.x == 0)
      tma_run(d, q + (size_t)rows * t * dm, rows * dm, bar);
    if (a.w2.kind == LIN_INT4_G) {
      const int g = a.w2.group, lo = 16 * t / g, hi = (a.H / 2 + 16 * t) / g;
      copy_rows(d + rows * dm,
                (const unsigned char*)a.w2.s + (size_t)lo * dm * 2, 1, 0,
                dm * 2, 2, (size_t)(hi - lo) * dm * 2);
    }
  }
}

// ----------------------------------------------------------- products ---

// four int8 values (byte c of v) as floats: byte + 128 becomes the low
// mantissa byte of 2^23 (one permute), minus 2^23 + 128 (exact; two
// full-rate instructions a value, as common.cuh's unpack16)
__device__ __forceinline__ void int8x4(uint32_t v, float* f) {
  const uint32_t u = v ^ 0x80808080u;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    f[c] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + c)) -
           8388736.f;
}

// the low nibbles (b & 15) - 8 and the high nibbles b >> 4 (arithmetic) of
// four bytes, the same way: (b & 15) and ((b ^ 0x80) >> 4) = (b >> 4) + 8
// are 0..15
__device__ __forceinline__ void int4x4(uint32_t v, float* lo, float* hi) {
  const uint32_t l = v & 0x0F0F0F0Fu;
  const uint32_t h = ((v ^ 0x80808080u) >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    lo[c] = __uint_as_float(__byte_perm(l, 0x4B000000u, 0x7540 + c)) -
            8388616.f;
    hi[c] = __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7540 + c)) -
            8388616.f;
  }
}

// A column unit's product from shared memory:
//   out[r][c] (r < T, c < 32; shared memory) = the sum over the unit's stored
//   rows p0 + j (j < srows) of xs[r][p0 + j] w[j][c] (packed int4: +
//   xs[r][half + p0 + j] hi[j][c]; q4_0: nibbles times their group's scale)
// xs: float rows of ldx in shared memory; tile: the unit's weights, in
// 32 / pw pieces of srows rows of pw bytes (pw 32: one piece; 16: columns
// 0..15, then 16..31), then (q4_0) the low half's and the high half's scale
// rows (32 bf16 each). Thread (g = tid % 8, s = tid / 8) takes columns 4g..
// and rows j = s, s + 32, ... (a warp reads consecutive words); a column's
// sum runs over the thread's rows in order, then over the 4 threads of a
// warp that share it (xor shuffles 8, 16), then over the warps in index
// order. R: rows a pass (1, or CP_ROWS); red: CP_RED floats. Not inlined:
// every phase runs the same code (a launch runs each phase once, so its
// time follows the instructions it fetches).
template <int R>
__device__ __noinline__ void cols_dot(const float* xs, int ldx, int T,
                                      const unsigned char* tile, int pw,
                                      int kind, int p0, int srows, int half,
                                      int group, float* red, float* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid & 7, s = tid >> 3;
  const bool p4 = packed_kind(kind);
  const bf16* gs = kind == LIN_INT4_G ? (const bf16*)(tile + srows * 32)
                                      : nullptr;
  const int ng = gs ? srows / group : 0;
  const unsigned char* wcol =
      tile + (size_t)(4 * g / pw) * srows * pw + (4 * g) % pw;
  for (int r0 = 0; r0 < T; r0 += R) {
    const int nr = min(R, T - r0);
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    const float* xr = xs + (size_t)r0 * ldx + p0;
#pragma unroll(R == 1 ? 4 : 1)
    for (int j = s; j < srows; j += CP_SLICES) {
      const uint32_t wv = *reinterpret_cast<const uint32_t*>(wcol + j * pw);
      float lo[4], hi[4];
      if (!p4) {
        int8x4(wv, lo);
      } else {
        int4x4(wv, lo, hi);
        if (gs) {
          const float4 sl = load4(gs + (j / group) * 32 + 4 * g);
          const float4 sh = load4(gs + (ng + j / group) * 32 + 4 * g);
          lo[0] *= sl.x, lo[1] *= sl.y, lo[2] *= sl.z, lo[3] *= sl.w;
          hi[0] *= sh.x, hi[1] *= sh.y, hi[2] *= sh.z, hi[3] *= sh.w;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (R == 1 || r < nr) {
          const float xl = xr[r * ldx + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xl, lo[c], acc[r][c]);
          if (p4) {
            const float xh = xr[r * ldx + half + j];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xh, hi[c], acc[r][c]);
          }
        }
      }
    }
#pragma unroll
    for (int off = 8; off < 32; off <<= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (R == 1 || r < nr) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
        }
      }
    }
    if (lane < 8) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (R == 1 || r < nr) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            red[(warp * CP_ROWS + r) * FL_TILE + 4 * g + c] = acc[r][c];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < nr * FL_TILE; i += QD_THREADS) {
      const int r = i / FL_TILE, c = i - r * FL_TILE;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < QD_WARPS; ++w)
        v += red[(w * CP_ROWS + r) * FL_TILE + c];
      out[(r0 + r) * FL_TILE + c] = v;
    }
    __syncthreads();
  }
}

// The tensor-core products of the same units, for a bf16 working type at T
// > 1 (the mimi decoder's 16 rows a frame): m16n8k16 bf16 products with
// float32 accumulators, A = the rows in bf16 (xb: row blocks of 16, row
// stride ldb elements, rows past T zero), B = the raw weight bytes widened
// to bf16 in registers (exact for int8 values and nibbles), q4_0's group
// scales applied to each k16 step's partial in float32 (qmma.cuh's rule).
// A warp takes (row block, 8-column tile) pairs and walks the k16 steps in
// order: no cross-warp sum.

// the four B values (rows 2q, 2q + 1, 2q + 8, 2q + 9 of a k16 step) as
// floats: int8 (mode 0), low nibbles (1) or high nibbles (2)
__device__ __forceinline__ void b_frag(const int* x, int mode, uint32_t& b0,
                                       uint32_t& b1) {
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = (float)(mode == 0 ? x[e] : mode == 1 ? (x[e] & 15) - 8 : x[e] >> 4);
  b0 = pack_bf16x2(f[0], f[1]);
  b1 = pack_bf16x2(f[2], f[3]);
}

// cols_dot's function on the tensor cores: out[r][c] for r < T, c < 32.
// Warp w takes the 8-column tile w % 4 and half w / 4 of the k16 steps (the
// low or high nibbles of packed rows; for int8 the first or second half of
// the slice's rows); the high half's sums land in red and are added to the
// low half's in that order.
static __device__ __noinline__ void cols_mma(const bf16* xb, int ldb, int T,
                                             const unsigned char* tile,
                                             int pw, int kind, int p0,
                                             int srows, int half, int group,
                                             float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane & 3, fn = lane >> 2, nmt = (T + 15) / 16;
  const int nt = warp & 3, kh = warp >> 2;
  const bool p4 = packed_kind(kind);
  const bf16* gs = kind == LIN_INT4_G ? (const bf16*)(tile + srows * 32)
                                      : nullptr;
  const int ng = gs ? srows / group : 0;
  const int n = nt * 8 + fn, cn = nt * 8 + 2 * q;
  const unsigned char* col = tile + (size_t)(n / pw) * srows * pw + n % pw;
  // int8: rows [kh * srows / 2, ..); packed: every row, nibble kh
  const int j_lo = p4 ? 0 : kh * srows / 2;
  const int j_hi = p4 ? srows : j_lo + srows / 2;
  for (int mt = 0; mt < nmt; ++mt) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j0 = j_lo; j0 < j_hi; j0 += 16) {
      const int x[4] = {(int8_t)col[(j0 + 2 * q) * pw],
                        (int8_t)col[(j0 + 2 * q + 1) * pw],
                        (int8_t)col[(j0 + 2 * q + 8) * pw],
                        (int8_t)col[(j0 + 2 * q + 9) * pw]};
      uint32_t b0, b1, a[4];
      b_frag(x, p4 ? 1 + kh : 0, b0, b1);
      ldmatrix_x4(a, xb + (size_t)(mt * 16 + (lane & 15)) * ldb +
                         (p4 && kh ? half : 0) + p0 + j0 + (lane >> 4) * 8);
      if (gs) {
        const bf16* sr = gs + ((kh ? ng : 0) + j0 / group) * 32;
        const float s0 = __bfloat162float(sr[cn]);
        const float s1 = __bfloat162float(sr[cn + 1]);
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16_16816(t, a, b0, b1);
        acc[0] = fmaf(s0, t[0], acc[0]);
        acc[1] = fmaf(s1, t[1], acc[1]);
        acc[2] = fmaf(s0, t[2], acc[2]);
        acc[3] = fmaf(s1, t[3], acc[3]);
      } else {
        mma_bf16_16816(acc, a, b0, b1);
      }
    }
    if (kh) {
      red[fn * FL_TILE + cn] = acc[0], red[fn * FL_TILE + cn + 1] = acc[1];
      red[(fn + 8) * FL_TILE + cn] = acc[2];
      red[(fn + 8) * FL_TILE + cn + 1] = acc[3];
    }
    __syncthreads();
    if (!kh) {
      const int r = mt * 16 + fn;
      if (r < T) {
        out[r * FL_TILE + cn] = acc[0] + red[fn * FL_TILE + cn];
        out[r * FL_TILE + cn + 1] = acc[1] + red[fn * FL_TILE + cn + 1];
      }
      if (r + 8 < T) {
        out[(r + 8) * FL_TILE + cn] = acc[2] + red[(fn + 8) * FL_TILE + cn];
        out[(r + 8) * FL_TILE + cn + 1] =
            acc[3] + red[(fn + 8) * FL_TILE + cn + 1];
      }
    }
    __syncthreads();
  }
}

// w2_dot's function on the tensor cores: hb the h tile in bf16 (row blocks
// of 16, row stride FL_TILE + 8); dst[r][n] for r < T (first: =, else +=)
static __device__ __noinline__ void w2_mma(const bf16* hb, int T, int dm,
                                    const unsigned char* tile, int kind,
                                    float* dst, bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane & 3, fn = lane >> 2, nmt = (T + 15) / 16;
  const int ntn = dm / 8;
  const bool p4 = packed_kind(kind);
  const bf16* gs = kind == LIN_INT4_G ? (const bf16*)(tile + 16 * dm)
                                      : nullptr;
  for (int pair = warp; pair < nmt * ntn; pair += QD_WARPS) {
    const int mt = pair / ntn, nt = pair - mt * ntn;
    const int n = nt * 8 + fn, cn = nt * 8 + 2 * q;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int r0 = p4 ? 0 : 16 * ks;  // packed: both steps read rows 0..15
      const int x[4] = {(int8_t)tile[(size_t)(r0 + 2 * q) * dm + n],
                        (int8_t)tile[(size_t)(r0 + 2 * q + 1) * dm + n],
                        (int8_t)tile[(size_t)(r0 + 2 * q + 8) * dm + n],
                        (int8_t)tile[(size_t)(r0 + 2 * q + 9) * dm + n]};
      uint32_t b0, b1, a[4];
      b_frag(x, p4 ? 1 + ks : 0, b0, b1);
      ldmatrix_x4(a, hb + (size_t)(mt * 16 + (lane & 15)) * (FL_TILE + 8) +
                         16 * ks + (lane >> 4) * 8);
      if (gs) {
        const float s0 = __bfloat162float(gs[ks * dm + cn]);
        const float s1 = __bfloat162float(gs[ks * dm + cn + 1]);
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16_16816(t, a, b0, b1);
        acc[0] = fmaf(s0, t[0], acc[0]);
        acc[1] = fmaf(s1, t[1], acc[1]);
        acc[2] = fmaf(s0, t[2], acc[2]);
        acc[3] = fmaf(s1, t[3], acc[3]);
      } else {
        mma_bf16_16816(acc, a, b0, b1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + fn + 8 * h;
      if (r < T) {
        float2* o = reinterpret_cast<float2*>(dst + (size_t)r * dm + cn);
        float2 v = make_float2(acc[2 * h], acc[2 * h + 1]);
        if (!first) {
          const float2 u = *o;
          v = make_float2(u.x + v.x, u.y + v.y);
        }
        *o = v;
      }
    }
  }
  __syncthreads();
}

// rows r < mp of xs (T x ld floats; rows past T as zeros) -> xb in bf16,
// row stride ldb
__device__ __forceinline__ void to_bf16_rows(const float* xs, int ld, int T,
                                             int mp, bf16* xb, int ldb) {
  for (int i = threadIdx.x; i < mp * ld; i += QD_THREADS) {
    const int r = i / ld, c = i - r * ld;
    xb[(size_t)r * ldb + c] = __float2bfloat16_rn(r < T ? xs[i] : 0.f);
  }
  __syncthreads();
}

// a column unit's product for T rows: one row on SIMT (cols_dot<1>); more
// on the tensor cores when xb (their bf16 copy, row stride ldx + 8) is
// given, else cols_dot<CP_ROWS> (float32 rows)
__device__ __forceinline__ void cols_dot_t(const float* xs, const bf16* xb,
                                           int ldx, int T,
                                           const unsigned char* tile, int pw,
                                           int kind, int p0, int srows,
                                           int half, int group, float* red,
                                           float* out) {
  if (T == 1)
    cols_dot<1>(xs, ldx, T, tile, pw, kind, p0, srows, half, group, red, out);
  else if (xb)
    cols_mma(xb, ldx + 8, T, tile, pw, kind, p0, srows, half, group, red,
             out);
  else
    cols_dot<CP_ROWS>(xs, ldx, T, tile, pw, kind, p0, srows, half, group,
                      red, out);
}

// One MLP tile's partial of up from shared memory: dst[r][n] (first: =,
// else +=) for r < T, n < dm of the sum over the tile's W2 rows j of
// hs[r][j] w[j][n] (int8: 32 rows; packed: 16 rows, hs[r][j] with the low
// nibbles and hs[r][16 + j] with the high ones, q4_0 each times its row's
// scale). Thread: 4 columns (consecutive words across a warp) and the rows
// set, set + nsets, ... in passes of R, the tile's rows in order.
template <int R>
__device__ __noinline__ void w2_dot(const float* hs, int T, int dm,
                                    const unsigned char* tile, int kind,
                                    float* dst, bool first) {
  const bool p4 = packed_kind(kind);
  const int nrow = p4 ? 16 : 32;
  const bf16* gs = kind == LIN_INT4_G ? (const bf16*)(tile + nrow * dm)
                                      : nullptr;
  const int ng4 = dm / 4;
  const int nsets = ng4 >= QD_THREADS ? 1 : QD_THREADS / ng4;
  for (int item = threadIdx.x; item < ng4 * nsets; item += QD_THREADS) {
    const int g = item % ng4, set = item / ng4;
    float sl[4] = {1.f, 1.f, 1.f, 1.f}, sh[4] = {1.f, 1.f, 1.f, 1.f};
    if (gs) {
      const float4 a = load4(gs + 4 * g), b = load4(gs + dm + 4 * g);
      sl[0] = a.x, sl[1] = a.y, sl[2] = a.z, sl[3] = a.w;
      sh[0] = b.x, sh[1] = b.y, sh[2] = b.z, sh[3] = b.w;
    }
    for (int rb = set; rb < T; rb += nsets * R) {
      const int nr = min(R, (T - rb + nsets - 1) / nsets);
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll(R == 1 ? 4 : 1)
      for (int j = 0; j < nrow; ++j) {
        const uint32_t wv =
            *reinterpret_cast<const uint32_t*>(tile + j * dm + 4 * g);
        if (!p4) {
          float w[4];
          int8x4(wv, w);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (R == 1 || r < nr) {
              const float hv = hs[(rb + r * nsets) * FL_TILE + j];
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[r][c] = fmaf(hv, w[c], acc[r][c]);
            }
          }
        } else {
          float lo[4], hi[4];
          int4x4(wv, lo, hi);
#pragma unroll
          for (int c = 0; c < 4; ++c) lo[c] *= sl[c], hi[c] *= sh[c];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (R == 1 || r < nr) {
              const float* hr = hs + (rb + r * nsets) * FL_TILE;
              const float hl = hr[j], hh = hr[16 + j];
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[r][c] = fmaf(hh, hi[c], fmaf(hl, lo[c], acc[r][c]));
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (R == 1 || r < nr) {
          float4* o = reinterpret_cast<float4*>(
              dst + (size_t)(rb + r * nsets) * dm + 4 * g);
          float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          if (!first) {
            const float4 u = *o;
            v = make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
          }
          *o = v;
        }
      }
    }
  }
}

// ------------------------------------------------------------- phases ---

// Column phase of a (K, N) linear in ks slices over the xs rows: for each
// of this block's units (issue_cols' order), epi(slice, r, n, raw sum).
// out: T x FL_TILE floats of shared memory.
template <typename Epi>
__device__ void cols_phase(const Lin& w, int K, int N, int ks,
                           const unsigned char* tiles, const float* xs,
                           const bf16* xb, int ldx, int T, float* red,
                           float* out, Epi epi) {
  const int stored = packed(w) ? K / 2 : K, srows = stored / ks;
  const int ub = col_unit_bytes(w.kind, K, ks, w.group);
  int i = 0;
  for (int u = blockIdx.x; u < N / FL_TILE * ks; u += gridDim.x, ++i) {
    const int c0 = u / ks * FL_TILE, q = u % ks;
    cols_dot_t(xs, xb, ldx, T, tiles + (size_t)i * ub, 32, w.kind, q * srows,
               srows, stored, w.group, red, out);
    for (int e = threadIdx.x; e < T * FL_TILE; e += QD_THREADS)
      epi(q, e / FL_TILE, c0 + e % FL_TILE, out[e]);
    __syncthreads();
  }
}

// out_proj's units: xs holds the T attention rows as floats; raw sums to
// p1[slice][r][n]
__device__ inline void out_proj_phase(const Tail& a, const unsigned char* smem,
                                      const float* xs, const bf16* xb,
                                      float* red, float* out) {
  float* p1 = a.p1;
  const int tdm = a.T * a.dm, dm = a.dm;
  cols_phase(a.wo, dm, dm, a.ks_o, smem + a.o_wo, xs, xb, dm, a.T, red, out,
             [&](int q, int r, int n, float v) {
               p1[(size_t)q * tdm + r * dm + n] = v;
             });
}

// x1 at the four elements 4 i4.. of (T, dm): x + ls1 * ((p1 slices summed
// in slice order) * s_o + b_o), float32. Loads only: a caller's batch of
// them is in flight together.
template <typename T>
__device__ __forceinline__ float4 x1_vec(const Tail& a, int i4) {
  const int tdm = a.T * a.dm, n = (4 * i4) % a.dm;
  float4 p[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)  // every slice's load before the first add
    if (q < a.ks_o)
      p[q] = __ldcg(reinterpret_cast<const float4*>(a.p1 + (size_t)q * tdm) +
                    i4);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (q < a.ks_o) v.x += p[q].x, v.y += p[q].y, v.z += p[q].z, v.w += p[q].w;
  const float* so = a.wo.kind == LIN_INT4_G ? nullptr : (const float*)a.wo.s;
  const float4 s = so ? load4(so + n) : make_float4(1.f, 1.f, 1.f, 1.f);
  const T* bo = (const T*)a.wo.b;
  const T* ls = (const T*)a.ls1;
  const float4 b = bo ? load4(bo + n) : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 l = ls ? load4(ls + n) : make_float4(1.f, 1.f, 1.f, 1.f);
  const float4 x = load4((const T*)a.x + 4 * i4);
  return make_float4(x.x + l.x * (v.x * s.x + b.x),
                     x.y + l.y * (v.y * s.y + b.y),
                     x.z + l.z * (v.z * s.z + b.z),
                     x.w + l.w * (v.w * s.w + b.w));
}

// LN(x1) into xs, then this block's MLP tiles into p2[block]; the block also
// writes its share of x1 (vectors i4 = block, + grid, ...) for mlp_finish.
// xb (bf16 working type, T > 1): room for the tensor cores' copies of the
// LayerNorm rows and of the h tile (act_bytes), else null; lnv: room for
// norm2's scale and bias as floats (2 x dm).
// bars: W1's and W2's mbarriers; `after`: the cp.async groups committed
// after W2's; marks mk.. : x1, ln, W1 landed, h, W2 landed.
template <typename T>
__device__ void mlp_phase(const Tail& a, const unsigned char* smem,
                          float* xs, float* hs, float* red, bf16* xb,
                          float* lnv, uint64_t* bars, int after, int mk) {
  const int T_ = a.T, dm = a.dm, H = a.H, tid = threadIdx.x;
  const int n4 = T_ * dm / 4;
  NormVecs nv;
  load_norm(nv, (const T*)a.ns, (const T*)a.nb, dm);
  for (int b = tid; b < n4; b += QD_THREADS * LD_BATCH) {
    float4 v[LD_BATCH];
#pragma unroll
    for (int u = 0; u < LD_BATCH; ++u)
      if (b + u * QD_THREADS < n4) v[u] = x1_vec<T>(a, b + u * QD_THREADS);
#pragma unroll
    for (int u = 0; u < LD_BATCH; ++u) {
      const int i4 = b + u * QD_THREADS;
      if (i4 < n4) {
        reinterpret_cast<float4*>(xs)[i4] = v[u];
        if (i4 % gridDim.x == blockIdx.x)
          reinterpret_cast<float4*>(a.x1)[i4] = v[u];
      }
    }
  }
  store_norm(nv, lnv, dm);
  __syncthreads();
  mark(a.marks, mk);
  ln_rows<T>(xs, T_, dm, a.eps, lnv, lnv + dm, red);
  const int mp = (T_ + 15) / 16 * 16;
  bf16* hb = xb ? xb + (size_t)mp * (dm + 8) : nullptr;
  if (xb) to_bf16_rows(xs, dm, T_, mp, xb, dm + 8);
  mark(a.marks, mk + 1);
  const bool p4 = packed(a.w1);
  const int stored = p4 ? dm / 2 : dm;
  const int b1 = w1_tile_bytes(a.w1.kind, dm, a.w1.group);
  const int b2 = w2_tile_bytes(a.w2.kind, dm);
  const float* s1 = a.w1.kind == LIN_INT4_G ? nullptr : (const float*)a.w1.s;
  const T* bias1 = (const T*)a.w1.b;
  float* mine = a.p2 + (size_t)blockIdx.x * T_ * dm;
  wait_phase(bars, after + 1);  // W1 has landed
  mark(a.marks, mk + 2);
  int i = 0;
  const int c = tid % FL_TILE;  // the h column of every element a thread takes
  for (int t = blockIdx.x; t < H / FL_TILE; t += gridDim.x, ++i) {
    const int n = p4 ? (c < 16 ? 16 * t + c : H / 2 + 16 * t + c - 16)
                     : 32 * t + c;
    const float sc = s1 ? s1[n] : 1.f, bc = opt(bias1, n, 0.f);  // early
    cols_dot_t(xs, xb, dm, T_, smem + a.o_w1 + (size_t)i * b1, p4 ? 16 : 32,
               a.w1.kind, 0, stored, stored, a.w1.group, red, hs);
    for (int e = tid; e < T_ * FL_TILE; e += QD_THREADS) {
      const float g = gelu_f(hs[e] * sc + bc, a.approx);
      hs[e] = a.round_h ? rnd<T>(g) : g;
    }
    __syncthreads();
    if (i == 0) {
      mark(a.marks, mk + 3);
      wait_phase(bars + 1, after);  // W2 has landed
      mark(a.marks, mk + 4);
    }
    if (T_ == 1) {
      w2_dot<1>(hs, T_, dm, smem + a.o_w2 + (size_t)i * b2, a.w2.kind, mine,
                i == 0);
    } else if (hb) {
      to_bf16_rows(hs, FL_TILE, T_, mp, hb, FL_TILE + 8);
      w2_mma(hb, T_, dm, smem + a.o_w2 + (size_t)i * b2, a.w2.kind, mine,
             i == 0);
    } else {
      w2_dot<CP_ROWS>(hs, T_, dm, smem + a.o_w2 + (size_t)i * b2, a.w2.kind,
                      mine, i == 0);
    }
    __syncthreads();  // hs is read before the next tile writes it
  }
  if (i == 0)  // no tile: a zero partial
    for (int j = tid; j < T_ * dm; j += QD_THREADS) mine[j] = 0.f;
}

// fin(i, v) for every element i < T x dm, spread over the grid's warps (a
// chunk of fin_e float4 vectors a warp): v = x1 + ls2 * ((sum of the grid's
// partials) * s_2 + b_2), s_2 per channel (grouped W2 scales were applied
// in mlp_phase). Lane = gq * fin_e + e sums partials gq, gq + 32 / fin_e,
// ... of vector e in order; the lanes' sums of a vector meet in a butterfly
// of xor shuffles, which gives every lane the same bits.
template <typename T, typename Fin>
__device__ void mlp_finish(const Tail& a, Fin fin) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = gridDim.x, E = a.fin_e, GQ = 32 / E;
  const int gq = lane / E, e = lane - gq * E;
  const int tdm = a.T * a.dm, ne4 = tdm / 4;
  const float* s2 = a.w2.kind == LIN_INT4_G ? nullptr : (const float*)a.w2.s;
  const T* b2 = (const T*)a.w2.b;
  const T* ls2 = (const T*)a.ls2;
  for (int c = warp * G + blockIdx.x; c * E < ne4; c += G * QD_WARPS) {
    const int i4 = c * E + e;
    const bool ok = i4 < ne4, fin_lane = ok && gq == 0;
    const int n = (4 * i4) % a.dm;
    float4 x1 = make_float4(0.f, 0.f, 0.f, 0.f), s = x1, b = x1, l = x1;
    if (fin_lane) {
      x1 = __ldcg(reinterpret_cast<const float4*>(a.x1) + i4);
      s = s2 ? load4(s2 + n) : make_float4(1.f, 1.f, 1.f, 1.f);
      b = b2 ? load4(b2 + n) : make_float4(0.f, 0.f, 0.f, 0.f);
      l = ls2 ? load4(ls2 + n) : make_float4(1.f, 1.f, 1.f, 1.f);
    }
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    // partials gq, gq + GQ, ... in batches of 8 loads, then their sum in
    // order
    for (int g0 = gq; ok && g0 < G; g0 += 8 * GQ) {
      float4 p[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (g0 + u * GQ < G)
          p[u] = __ldcg(reinterpret_cast<const float4*>(
                            a.p2 + (size_t)(g0 + u * GQ) * tdm) + i4);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (g0 + u * GQ < G)
          v.x += p[u].x, v.y += p[u].y, v.z += p[u].z, v.w += p[u].w;
    }
    for (int off = E; off < 32; off <<= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
      v.z += __shfl_xor_sync(0xffffffffu, v.z, off);
      v.w += __shfl_xor_sync(0xffffffffu, v.w, off);
    }
    if (fin_lane) {
      fin(4 * i4, x1.x + l.x * (v.x * s.x + b.x));
      fin(4 * i4 + 1, x1.y + l.y * (v.y * s.y + b.y));
      fin(4 * i4 + 2, x1.z + l.z * (v.z * s.z + b.z));
      fin(4 * i4 + 3, x1.w + l.w * (v.w * s.w + b.w));
    }
  }
}

}  // namespace ptt
