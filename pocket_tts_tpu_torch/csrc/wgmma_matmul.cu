// K4a from WGMMA_ROWS (64) rows in bf16: y (T, N) = round((x (T, K) @
// q (K, N) widened to bf16) * scale (N,)), on Hopper's warpgroup products.
//
// Replaces the TPU kernel `pocket_tts_tpu/ops/quant_matmul.py:
// int8_matmul_pallas` (the pallas_call at :118, `_int8_kernel` at :99-103)
// for the calls of many rows: the backbone prefill's in_proj, out_proj,
// linear1 and linear2 at the 64, 128 and 256-row buckets (the voice
// prompt's 128 rows, each sentence's text). Per output: the float32 sum of
// x[t, k] * q[k, n] (x bf16, q widened to bf16 exactly: |q| <= 127), times
// the per-channel float32 scale once, rounded once to bf16; rows past T
// read as zeros and are never stored. Below WGMMA_ROWS rows, and in
// float32, K4a runs the row-block family (fused_layer.cu: rows_mma_kernel,
// skinny_kernel, rows_kernel; ops/quant_matmul.py `int8_route`).
//
// What bounds it on the H100: at 128-256 rows the call sits near the
// card's ridge. A 128-row in_proj (1024 x 3072) moves 4.2 MB (1.26 us at
// 3.35 TB/s) for 0.8 GFLOP (0.81 us at 989 TFLOP/s); the 256-row linear1
// does 2.1 GFLOP. The row-block kernel (mma.sync from one k-tile at a
// time, a block of 64 columns) reaches a few percent of the tensor cores'
// rate there: its products wait on its own loads and conversions.
//
// Design: the products run as wgmma.mma_async.m64n{bt}k16.f32.bf16.bf16
// with A and B swapped (y^T = W^T x^T): the bf16 weight W^T is A (128
// channels a block, two m64 tiles), x is B (bt = 64 or 128 token rows),
// both K-major in shared memory with the 128-byte swizzle, float32
// accumulators in registers. Three roles a block, a ring of `stages`
// k-blocks of 64 between them, an mbarrier a stage and hand-off:
//   producer warp (warp 8)   one thread asks the TMA for a k-block's x box
//                            (bt rows x 128 bytes, swizzled: the layout
//                            wgmma reads) and its int8 weight box (64 rows
//                            x 128 channel bytes, as io/quant.py stores
//                            it) on `full`, once `empty` says the stage is
//                            free;
//   widening warpgroup       (warps 4-7) on `full`, widens the int8 box to
//                            bf16 and transposes it to K-major rows of the
//                            swizzled layout (`widen_stage`), then hands the
//                            stage over on `wide`: one stage ahead of the
//                            products, as far as the ring lets it;
//   consumer warpgroup       (warps 0-3) on `wide`, the k-block's eight
//                            products as one commit group, keeping one
//                            group in flight (wgmma.wait_group 1) and
//                            freeing a stage on `empty` once the next
//                            k-block's group is issued and its own is done.
// The widening runs in shared memory, not in the consumers' registers
// (route (b) of the design notes, PERF.md): with A in registers, ptxas
// serialized every product against the next step's widening (C7513),
// whatever the fences.
// The epilogue stages the float32 tile (tokens x channels) over the rings,
// and the `splits` blocks of a cluster that share an output tile (split
// K) sum their tiles through distributed shared memory in rank order
// (block z takes token rows z, z + splits, ...), so the result does not
// depend on timing; then the scale, one rounding, and a guarded store.
// With `marks` each block records %globaltimer instants and the time each
// role waited on the ring (WG_MARKS; chip_smoke.py `k4a_marks`).
//
// The plan (ops/quant_matmul.py `wgmma_plan`: bt, splits, k-blocks a
// slice, stages, the shared-memory layout) is computed in Python and is
// the one source of the grid and the layout; the entry point checks the
// regions (`regions_ok`) and the swizzle's 1024-byte alignment, and sets
// the dynamic shared memory before every launch. The widening is one
// device function (`widen_stage`), the place for a later int4 or q4_0
// kind.
#include <cooperative_groups.h>

#include "layer_post.cuh"

namespace coop = cooperative_groups;

namespace ptt {

constexpr int WG_BK = 64;        // k a stage: 128 bytes of bf16 rows
constexpr int WG_BN = 128;       // output channels a block: two m64 tiles
constexpr int WG_Q_BYTES = WG_BK * WG_BN;      // a stage's int8 box
constexpr int WG_W_BYTES = 2 * WG_BK * WG_BN;  // ... widened, K-major
constexpr int WG_THREADS = 288;  // consumers, wideners, producer warp
constexpr int WG_CS_LD = WG_BN + 4;        // a row of the float32 tile
constexpr int WG_ALIGN = 1024;   // the 128-byte swizzle's period
constexpr int WG_MAX_SPLITS = 8;  // blocks of a cluster: the portable size
// %globaltimer marks a block (ops/quant_matmul.py WGMMA_MARKS): entry, the
// first k-block landed, the products done, exit (ns since an epoch), then
// the ns the consumers waited on `full` and on `wide`, the wideners on
// `full`, the producer on `empty`, and the ns the wideners spent widening
constexpr int WG_MARKS = 9;

struct WgArgs {
  CUtensorMap tm_x;   // x (T, K) bf16: boxes of 64 k x bt rows, swizzled
  CUtensorMap tm_q;   // q (K, N) int8: boxes of 128 channels x 64 rows
  const float* scale;
  bf16* y;
  int T, K, N;
  int splits, kb_per, stages;
  // from the 1024-aligned base of the block: the x ring, the int8 ring,
  // the bf16 ring, the mbarriers (full, wide, empty), the float32 tile
  int o_x, o_q, o_w, o_bar, o_c;
  unsigned long long* marks;  // (blocks, WG_MARKS) or null
};

__device__ __forceinline__ void mbar_init_n(uint64_t* b, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(n));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}
// until the phase of parity `parity` of the barrier has completed; a
// wait that has not ended after 2 s of %globaltimer traps (the launch
// fails) instead of holding the card
__device__ __forceinline__ void mbar_wait_parity(uint64_t* b,
                                                 unsigned parity) {
  unsigned long long t0 = 0;
  for (unsigned n = 0;; ++n) {
    unsigned ok;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, "
        "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
    if (ok) return;
    if ((n & 1023) == 1023) {
      const unsigned long long t = globaltimer();
      if (t0 == 0) t0 = t;
      else if (t - t0 > 2000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// a wait on one of the ring's mbarriers; with `on` (marks asked for, the
// role's first thread) its ns added to `ns`
__device__ __forceinline__ void ring_wait(uint64_t* b, unsigned parity,
                                          bool on,
                                          unsigned long long& ns) {
  const unsigned long long t = on ? globaltimer() : 0;
  mbar_wait_parity(b, parity);
  if (on) ns += globaltimer() - t;
}

// keep a register's value where it is up to this point: the asynchronous
// products read and write registers the compiler does not see them use,
// and ptxas serializes them when an instruction defines one of their
// inputs after the fence
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void pin(uint64_t& r) {
  asm volatile("" : "+l"(r)::"memory");
}

// wgmma's descriptor of a K-major bf16 tile with the 128-byte swizzle:
// rows of 128 bytes (64 k), 8-row groups 1024 bytes apart (SBO), the
// address advanced by 32 bytes a k16 step within the swizzle's span
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x N, float32, in registers) += A (64 x 16) . B (16 x N), both bf16
// from shared memory (descriptors da, db): one asynchronous warpgroup
// product
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// byte ch of u0 and of u1 (each byte already XORed with 0x80) widened to a
// bf16 pair, u0's in the low half: 2^23 + (q + 128) is exact in float32
// (unpack16's trick), minus 2^23 + 128 the integer q, whose bf16 bits are
// the high half of its float32 bits
__device__ __forceinline__ uint32_t widen2(uint32_t u0, uint32_t u1,
                                           unsigned ch) {
  const float f0 =
      __uint_as_float(__byte_perm(u0, 0x4B000000u, 0x7540 + ch)) - 8388736.f;
  const float f1 =
      __uint_as_float(__byte_perm(u1, 0x4B000000u, 0x7540 + ch)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// A stage's int8 box qs (64 rows k of 128 channel bytes) -> its bf16
// W^T tile ws: 128 rows (channels) of 64 k, 128 bytes a row, the 8-byte
// chunk c of row n at n * 128 + ((c ^ (n % 8)) * 16), the TMA's 128-byte
// swizzle. Thread i of the widening warpgroup takes, per pass, four
// channels 4 (i % 32).. and the k chunk i / 32 + 4 pass: eight 4-byte
// loads (a warp reads whole 128-byte rows), four 16-byte stores (the lanes
// of a quarter warp store to eight distinct swizzled chunks: lane l
// starts at channel (l / 2) % 4 of its four). Then each thread's stores
// are made visible to the products (an async proxy) before its arrival.
__device__ __forceinline__ void widen_stage(const uint8_t* qs, uint8_t* ws,
                                            int i) {
  const int lane = i & 31, cg = lane;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int c = (i >> 5) + 4 * pass;   // k chunk: rows 8c .. 8c + 7
    uint32_t u[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      u[j] = *reinterpret_cast<const uint32_t*>(qs + (8 * c + j) * 128 +
                                                4 * cg) ^
             0x80808080u;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const unsigned ch = (s + (lane >> 1)) & 3;
      const int n = 4 * cg + ch;
      *reinterpret_cast<uint4*>(ws + n * 128 + ((c ^ (n & 7)) << 4)) =
          make_uint4(widen2(u[0], u[1], ch), widen2(u[2], u[3], ch),
                     widen2(u[4], u[5], ch), widen2(u[6], u[7], ch));
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Block (z, y, x): output channels [y * 128, ..) and token rows
// [x * BT, ..) over k-blocks [z * kb_per, ..) of 64, the z-th block of its
// cluster of `splits`.
template <int BT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wgmma_int8_kernel(const __grid_constant__ WgArgs g) {
  extern __shared__ __align__(16) unsigned char wg_raw[];
  unsigned char* base =
      wg_raw + ((WG_ALIGN - (smem_u32(wg_raw) & (WG_ALIGN - 1))) &
                (WG_ALIGN - 1));
  unsigned char* xs = base + g.o_x;
  unsigned char* qs = base + g.o_q;
  unsigned char* ws = base + g.o_w;
  const int S = g.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + g.o_bar);
  uint64_t* wide = full + S;
  uint64_t* empty = wide + S;
  float* cs = reinterpret_cast<float*>(base + g.o_c);
  coop::cluster_group cluster = coop::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int z = blockIdx.x, nsplit = gridDim.x;
  const int n0 = blockIdx.y * WG_BN, t0 = blockIdx.z * BT;
  const int kblocks = (g.K + WG_BK - 1) / WG_BK;
  const int kb0 = z * g.kb_per, nkb = min(kblocks, kb0 + g.kb_per) - kb0;
  unsigned long long* mk =
      g.marks ? g.marks + (size_t)WG_MARKS *
                              (blockIdx.x + gridDim.x * (blockIdx.y +
                                                         gridDim.y *
                                                             blockIdx.z))
              : nullptr;
  const bool lead = mk != nullptr && (tid & 127) == 0;  // a role's first
  unsigned long long waited[2] = {0, 0}, widening = 0;
  if (mk && tid == 0) mk[0] = globaltimer();
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init_n(full + s, 1);     // the producer's arrival and its bytes
      mbar_init_n(wide + s, 4);     // one arrival a widening warp
      mbar_init_n(empty + s, 4);    // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the consumers' accumulators: m64 tile i's 64 x BT float32 tile
  float acc[2][BT / 2];
  if (warp == 8) {
    // ---- producer: k-block j into stage j % S once its last reader is
    // done (the first S pass at once: parity 1 of a fresh barrier) ----
    if (lane == 0) {
      prefetch_map(&g.tm_x);
      prefetch_map(&g.tm_q);
      for (int j = 0; j < nkb; ++j) {
        const int s = j % S;
        ring_wait(empty + s, ((j / S) & 1) ^ 1, lead, waited[0]);
        mbar_expect(full + s, BT * 128 + WG_Q_BYTES);
        const int k0 = (kb0 + j) * WG_BK;
        tma_box(xs + s * BT * 128, &g.tm_x, k0, t0, full + s);
        tma_box(qs + s * WG_Q_BYTES, &g.tm_q, n0, k0, full + s);
      }
    }
  } else if (warp >= 4) {
    // ---- widening warpgroup ----
    for (int j = 0; j < nkb; ++j) {
      const int s = j % S;
      ring_wait(full + s, (j / S) & 1, lead, waited[0]);
      const unsigned long long t = lead ? globaltimer() : 0;
      widen_stage(qs + s * WG_Q_BYTES, ws + s * WG_W_BYTES, tid - 128);
      __syncwarp();  // the warp's stores, each fenced, before its arrival
      if (lane == 0) mbar_arrive(wide + s);
      if (lead) widening += globaltimer() - t;
    }
  } else {
    // ---- consumers: acc[i] in the wgmma accumulator layout (chunk j of
    // 8 token columns: rows 16 warp + g, + 8; columns 8j + 2t, + 1, for
    // lane (g, t) = (lane / 4, lane % 4))
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < BT / 2; ++e) {
        acc[i][e] = 0.f;
        pin(acc[i][e]);
      }
    for (int j = 0; j < nkb; ++j) {
      const int s = j % S;
      ring_wait(full + s, (j / S) & 1, lead, waited[0]);   // x landed
      if (lead && j == 0) mk[1] = globaltimer();
      ring_wait(wide + s, (j / S) & 1, lead, waited[1]);   // W^T widened
      __syncwarp();  // the warpgroup's products take converged warps
      // the descriptors of the four k16 steps (32 bytes apart) of m64
      // tile 0, tile 1 (channels 64.., 64 rows of 128 bytes on) and x
      const uint64_t da = sw128_desc(ws + s * WG_W_BYTES);
      const uint64_t db = sw128_desc(xs + s * BT * 128);
      uint64_t d0[WG_BK / 16], d1[WG_BK / 16], dx[WG_BK / 16];
#pragma unroll
      for (int ks = 0; ks < WG_BK / 16; ++ks) {
        d0[ks] = da + 2 * ks;
        d1[ks] = da + 2 * ks + (64 * 128 >> 4);
        dx[ks] = db + 2 * ks;
        pin(d0[ks]);
        pin(d1[ks]);
        pin(dx[ks]);
      }
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < WG_BK / 16; ++ks) {
        wgmma_ss<BT>(acc[0], d0[ks], dx[ks]);
        wgmma_ss<BT>(acc[1], d1[ks], dx[ks]);
      }
      wg_commit();
      // the previous k-block's products are done: its stage is free
      wg_wait<1>();
      if (j > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + (j - 1) % S);
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < BT / 2; ++e) pin(acc[i][e]);
    if (lead) {
      mk[2] = globaltimer();
      mk[4] = waited[0];
      mk[5] = waited[1];
    }
  }
  if (lead && warp == 4) {
    mk[6] = waited[0];
    mk[8] = widening;
  }
  if (lead && warp == 8) mk[7] = waited[0];
  // every role is done with the rings (the last products waited for, every
  // box landed and widened): the float32 tile goes over them
  __syncthreads();
  if (warp < 4) {
    const int r0 = 16 * warp + (lane >> 2), tc = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < BT / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cs[(8 * jj + tc + (e & 1)) * WG_CS_LD + 64 * i + r0 +
             8 * (e >> 1)] = acc[i][4 * jj + e];
  }

  // ---- the cluster's tiles summed in rank order (block z: token rows z,
  // z + splits, ...), the per-channel scale, one rounding, guarded stores.
  // A thread's four columns are the same in every pass (WG_THREADS is a
  // multiple of the 32 column vectors): their scales are loaded once,
  // before the barrier. One block reads its own tile with shared loads;
  // a cluster's tiles are read with ld.shared::cluster at the ranks'
  // mapped addresses, every rank's load in flight before the sum (generic
  // loads through map_shared_rank were slower)
  constexpr int C4 = WG_BN / 4;
  static_assert(WG_THREADS % C4 == 0, "a thread's columns change");
  const int nc = n0 + 4 * (tid % C4);
  const float4 sc = nc < g.N
                        ? *reinterpret_cast<const float4*>(g.scale + nc)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  if (nsplit > 1) cluster.sync(); else __syncthreads();
  const unsigned cs_at = smem_u32(cs);
  unsigned rank_at[WG_MAX_SPLITS];
#pragma unroll
  for (int q = 0; q < WG_MAX_SPLITS; ++q) {
    rank_at[q] = cs_at;
    if (nsplit > 1 && q < nsplit)
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(rank_at[q])
                   : "r"(cs_at), "r"(q));
  }
  const int nr = (BT - z + nsplit - 1) / nsplit;
  for (int e = tid; e < nr * C4; e += WG_THREADS) {
    const int r = z + nsplit * (e / C4);
    if (t0 + r >= g.T || nc >= g.N) continue;
    const int off = r * WG_CS_LD + 4 * (e % C4);
    float4 v;
    if (nsplit == 1) {
      v = *reinterpret_cast<const float4*>(cs + off);
    } else {
      float4 p[WG_MAX_SPLITS];
#pragma unroll
      for (int q = 0; q < WG_MAX_SPLITS; ++q)
        if (q < nsplit)
          asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
                       : "=f"(p[q].x), "=f"(p[q].y), "=f"(p[q].z),
                         "=f"(p[q].w)
                       : "r"(rank_at[q] + 4u * off)
                       : "memory");
      v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < WG_MAX_SPLITS; ++q) {
        if (q < nsplit) {
          v.x += p[q].x;
          v.y += p[q].y;
          v.z += p[q].z;
          v.w += p[q].w;
        }
      }
    }
    *reinterpret_cast<uint2*>(g.y + (size_t)(t0 + r) * g.N + nc) =
        make_uint2(pack_bf16x2(v.x * sc.x, v.y * sc.y),
                   pack_bf16x2(v.z * sc.z, v.w * sc.w));
  }
  // no block leaves while a peer reads its tile: the peers' loads are done
  // once they arrive, so the barrier orders nothing else (a release here
  // would wait for this block's stores of y)
  if (nsplit > 1) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }
  if (mk && tid == 0) mk[3] = globaltimer();
}

}  // namespace ptt

// A 2-D tensor map (host) of a (rows, cols) matrix of `dt` elements of
// `esize` bytes, rows ld bytes apart, read in boxes of box_cols x
// box_rows (box_cols x esize = 128 bytes) with the 128-byte swizzle or
// none; elements past an edge read as zeros. 0 on success.
static int encode_box(CUtensorMap* m, CUtensorMapDataType dt, int esize,
                      const void* base, int cols, int rows, size_t ld,
                      int box_cols, int box_rows,
                      CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 enc = nullptr;
  if (!enc) {
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", (void**)&enc,
                                cudaEnableDefault, &q) != cudaSuccess ||
        !enc)
      return (int)cudaErrorNotSupported;
  }
  if (rows < 1 || cols < 1 || (uintptr_t)base % 16 || ld % 16 ||
      box_cols * esize != 128 || box_rows < 1 || box_rows > 256)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  return enc(m, dt, 2, const_cast<void*>(base), dims, strides, box, es,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

// K4a on the warpgroup products: x (T, K) bf16, q (K, N) int8, scale (N,)
// float32, y (T, N) bf16; the plan (ops/quant_matmul.py `wgmma_plan`,
// WGMMA_PLAN_KEYS): bt (64 or 128 token rows a block), splits (the
// blocks of a cluster over K), k-blocks of 64 a slice, stages, the shared
// memory in bytes, and the offsets of the x ring, the int8 ring, the bf16
// ring, the mbarriers and the float32 tile (over the rings) from the
// 1024-aligned base. Takes K a multiple of 8 and N of 16 (the TMA's
// 16-byte strides), x, q and scale 16-byte aligned; rows and columns past
// T, K and N read as zeros. marks: int64 (blocks of the grid, WG_MARKS), block
// (z, y, x) at row z + splits (y + grid.y x), or null.
extern "C" int ptt_wgmma_int8(const void* x, const void* q,
                              const void* scale, void* y, int T, int K,
                              int N, const int* plan, void* marks,
                              void* stream) {
  using namespace ptt;
  const int bt = plan[0], splits = plan[1], kb_per = plan[2];
  const int stages = plan[3], smem = plan[4];
  WgArgs g{{},     {},     (const float*)scale, (bf16*)y, T,
           K,      N,      splits, kb_per, stages,
           plan[5], plan[6], plan[7], plan[8], plan[9],
           (unsigned long long*)marks};
  const int kblocks = (K + WG_BK - 1) / WG_BK;
  if (T < 1 || K < 8 || K % 8 || N < 16 || N % 16 || scale == nullptr ||
      smem > SMEM_MAX || (uintptr_t)x % 16 || (uintptr_t)q % 16 ||
      (uintptr_t)scale % 16 ||
      !(bt == 64 || bt == 128) || splits < 1 || splits > WG_MAX_SPLITS ||
      kb_per < 1 ||
      (long)splits * kb_per < kblocks ||
      (long)(splits - 1) * kb_per >= kblocks || stages < 3 || stages > 8 ||
      g.o_x % WG_ALIGN || g.o_w % WG_ALIGN)
    return (int)cudaErrorInvalidValue;
  // the regions within the shared memory left once the base is aligned to
  // 1024 (regions_ok keeps SMEM_SLACK of it); the float32 tile lies in the
  // rings (used once every role is done with them), clear of the mbarriers
  Region r[4] = {{g.o_x, stages, bt * 128},
                 {g.o_q, stages, WG_Q_BYTES},
                 {g.o_w, stages, WG_W_BYTES},
                 {g.o_bar, 1, 24 * stages}};
  long lo = g.o_x, hi = 0;
  for (int i = 0; i < 3; ++i) {
    lo = r[i].off < lo ? r[i].off : lo;
    const long end = r[i].off + (long)r[i].n * r[i].unit;
    hi = end > hi ? end : hi;
  }
  const long c_end = g.o_c + (long)bt * WG_CS_LD * 4;
  if (!regions_ok(r, 4, smem - WG_ALIGN + SMEM_SLACK) || g.o_c % 128 ||
      g.o_c < lo || c_end > hi ||
      (g.o_c < g.o_bar + 24 * stages && g.o_bar < c_end) ||
      encode_box(&g.tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, T,
                 (size_t)K * 2, WG_BK, bt, CU_TENSOR_MAP_SWIZZLE_128B) ||
      encode_box(&g.tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, N, K,
                 (size_t)N, WG_BN, WG_BK, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(splits, (N + WG_BN - 1) / WG_BN, (T + bt - 1) / bt);
  cudaStream_t st = (cudaStream_t)stream;
  auto run = [&](auto kern) {
    // set on every launch: a smaller figure left by an earlier launch
    // would refuse this one
    int rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc) return rc;
    if (splits == 1)
      kern<<<grid, WG_THREADS, smem, st>>>(g);
    else
      rc = (int)launch_clustered(kern, grid, dim3(WG_THREADS), splits, smem,
                                 st, g);
    return rc ? rc : (int)cudaGetLastError();
  };
  return bt == 64 ? run(wgmma_int8_kernel<64>) : run(wgmma_int8_kernel<128>);
}

// Clusters of `splits` blocks of the bt-row kernel with `smem` bytes of
// dynamic shared memory the card holds at once (blocks at once when
// splits is 1); 0 when it cannot place one, or on error.
extern "C" int ptt_wgmma_max_clusters(int bt, int splits, int smem) {
  using namespace ptt;
  if (!(bt == 64 || bt == 128) || splits < 1 || splits > WG_MAX_SPLITS)
    return 0;
  auto query = [&](auto kern) {
    if (cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return 0;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    cfg.gridDim = dim3(splits);
    cfg.blockDim = dim3(WG_THREADS);
    cfg.dynamicSmemBytes = smem;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess)
      return 0;
    return n;
  };
  const int n = bt == 64 ? query(wgmma_int8_kernel<64>)
                         : query(wgmma_int8_kernel<128>);
  cudaGetLastError();  // a refused size is an answer, not a sticky error
  return n;
}
