// K3: the SEANet decoder for one frame, as a fixed sequence of launches.
//
// Replaces the TPU kernel `pocket_tts_tpu/ops/pallas_seanet.py:
// seanet_frame` (`_seanet_batched` -> `_kernel`; weight transforms
// `_prep_weights`). The Python wrapper (ops/seanet_frame.py) launches, per
// frame: conv k7 -> ELU -> 3 or 4 x [convtr k=2s (+ overlap-add carry) ->
// resnet (ELU, causal conv k3, ELU, 1x1, residual) -> ELU] -> final conv k3,
// reading and writing the 8 streaming carries in place. Values are rounded
// to the working type at the TPU kernel's points (pallas_seanet.py:76-92):
// after each conv's bias add, after each ELU, after the residual add, and
// for the transposed convs after each half-product.
//
// What bounds it on the H100. A frame is ~0.16 GMAC per lane over ~7.9 MB
// of bf16 weights, in GEMMs of M = 16 to 1920 rows per lane: solo the
// weights stream in ~2.4 us, and at 32 lanes the 10.4 GFLOP take ~10.5 us
// on the bf16 tensor cores. Neither bound is near: solo the frame is a
// chain of dependent launches, each a few memory round trips deep, and at
// 32 lanes every launch is small enough (0.2 to 2 GFLOP) that latency and
// the activations' traffic (~60 MB a frame, mostly in L2) set its time.
// The first port lost more: every product ran as SIMT FMAs on 16 x 32
// tiles that read shared memory more than they computed, its operands came
// in as 2-byte scalar loads with a divide per element, and the frame was 22
// dependent launches (separate split-K epilogues, overlap-adds and carry
// copies): 211.46 us solo, 1468.54 us at 32 lanes (chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at 700 W).
//
// Design. Each conv is one GEMM launch of `seanet_gemm_kernel`, 4 warps a
// block, over a tile of BM x BN outputs (`k3_plan` in ops/seanet_frame.py
// picks the tile and the reduction slices from M, N and K so that at least
// two blocks land on each SM): with a bf16 working type the products run on
// the tensor cores (`mma.sync.m16n8k16`, operands by `ldmatrix`, float32
// accumulators); with float32 the same structure runs on SIMT FMAs (TF32
// would break float32's tolerance). Both operands come in by 16-byte
// `cp.async` through a ring of 3 to 8 stages (as many as fit in ~40 KB):
// the weights (K x N row-major, as `prep_weights` lays them out) and the A
// rows, which are the input rows themselves (the transposed convs' (Cin,
// 2s*Cout) GEMMs, the 1x1 convs) or the causal window over [carry; x] (the
// k7 and k3 convs), each row's lane and offset found once per block, the
// tap once per 16 bytes. Bias, ELU, residual add and stage ELU run in the
// epilogue, 16 bytes a load and a store. Where the tile grid is small, the
// reduction is split over the `splits` blocks of a thread-block cluster (at
// most 8): each block leaves its float32 tile in shared memory, and after
// `cluster.sync()` block z sums rows z, z + splits, ... over the cluster in
// rank order through distributed shared memory and applies the epilogue. No
// second launch, no workspace.
//
// The overlap-add stays a launch of its own (`seanet_overlap_kernel`, one
// per stage): y[i*s + j] = rnd(u[i, j] + u[i-1, s+j] + bias) needs the
// previous row's second half, which another block of the transposed conv
// computes, and the resnet conv reads ELU(y) three times (its taps) in
// every column tile. Built inside the k3 conv's A operand (as an earlier
// version of this kernel did), the ELU ran up to six times per value and that
// conv took 60-100 us at 32 lanes; the elementwise pass writes y and ELU(y)
// once, and its thread that reads the carry of a row also writes the new
// carry, so the in-place update has no race.
//
// The carries. A carry may be overwritten only after every block that
// reads the old one has read it. The first conv's carry (the last 6 latent
// rows) and each resnet conv's (the last rows of ELU(y)) are written by the
// next launch of the frame that does not read them (a "tail", copied with
// the grid's threads beside their tiles): by the first transposed conv and
// by the stage's 1x1 conv. The convtr carries are the overlap kernel's. The
// final conv (64 -> 1 channel, N = 1) is its own small kernel, four
// threads an output row over rows staged in shared memory; only its first
// block of a lane reads the old carry, and that block writes the new one
// once it has staged its rows.
// 14 launches per frame (4 per stage, the first and the final conv), at
// any lane count. Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3 at
// 700 W): 78.64 us solo and 279.11 us at 32 lanes in bf16, 102-105 us and
// 808-817 us in float32 (the first port: 208.8 and 1480 us in the same
// call).
//
// Lanes: B streams stack on the GEMMs' M axis (B * T rows, the weights read
// once for all of them), as the TPU kernel's batched grid shares its
// weights. Row m belongs to lane m / T; each lane's window reads its own
// carry.
//
// The TPU kernel's blocked-time layout for the narrow last stage,
// xb[t, j*C + c] == x[t*s + j, c], is byte-for-byte the flat time-major
// (T*s, C) tensor, so here it is simply that flat tensor: the carries keep
// their (1, s*C) shapes and are read as (s, C) rows, and the block-diagonal
// kron taps the TPU needed to fill its 128 lanes (s times the FLOPs) are
// not needed.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace ptt {

constexpr int K3_THREADS = 128;
constexpr int K3_BK = 32;
constexpr int K3_MAX_SPLITS = 8;
constexpr int K3_EW_THREADS = 256;
constexpr int K3_LAST_THREADS = 256;
enum { A_ROWS = 0, A_WINDOW = 1 };

// k-tiles in flight: a ring of 3 to 8 stages of the A and B tiles, as many
// as fit in ~40 KB
__host__ __device__ constexpr int k3_clamp(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}
template <typename T, int BM, int BN>
__host__ __device__ constexpr int k3_stages() {
  return k3_clamp(40960 / ((BM * (K3_BK + 16 / (int)sizeof(T)) +
                            K3_BK * (BN + 16 / (int)sizeof(T))) *
                           (int)sizeof(T)),
                  3, 8);
}

template <typename T>
struct K3Gemm {
  const T* src;     // A_ROWS (M, K); A_WINDOW the conv input (M, cin)
  const T* carry;   // A_WINDOW: (B, pc, cin)
  const T* w;       // (K, N)
  const T* bias;    // (N) or null
  const T* res;     // (M, N) or null
  T* out;           // (M, N)
  // tail (or null): dst[lane, r, e] = src[(lane*nt + nt - rows + r) *
  // width + e], r < rows, e < width: the last rows of each lane of src;
  // with rows > nt, dst's rows move up by nt and src's nt rows follow
  const T* tail_src;
  T* tail_dst;
  int tail_width, tail_rows, tail_nt;
  int mode, M, N, K, cin, nt, kw, pc, out_elu, res_elu;
  int kt_split;     // k-tiles per reduction slice
  int a_vec, b_vec; // 16-byte copies for the A rows, the B rows
  int o_vec;        // 16-byte loads and stores in the epilogue
};

// the 16 / sizeof(T) values of a vector, packed back
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* v);
template <>
__device__ __forceinline__ uint4 pack16<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
template <>
__device__ __forceinline__ uint4 pack16<bf16>(const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A[m, kg] for row t of lane `lane`: the path for shapes whose channels
// are not a whole number of 16-byte vectors
template <typename T>
__device__ T k3_a_elem(const K3Gemm<T>& g, int lane, int t, int kg) {
  if (kg >= g.K) return from_f<T>(0.f);
  if (g.mode == A_ROWS) return g.src[((size_t)lane * g.nt + t) * g.K + kg];
  const int j = kg / g.cin, c = kg - j * g.cin, r = t + j - (g.kw - 1);
  return r < 0 ? g.carry[((size_t)lane * g.pc + g.pc + r) * g.cin + c]
               : g.src[((size_t)lane * g.nt + r) * g.cin + c];
}

// ELU before a rounding to T: float32 takes expm1f; bf16 exp(x) - 1 by the
// fast exponential (an absolute error ~1e-7, far below the bf16 rounding
// that follows, at a tenth of the instructions)
template <typename T>
__device__ __forceinline__ float k3_elu(float x) {
  if constexpr (std::is_same<T, bf16>::value)
    return x > 0.f ? x : __expf(x) - 1.f;
  else
    return elu(x);
}

// y = rnd(acc + bias); out_elu: rnd(elu(y)); res: rnd(res + y), then
// res_elu: rnd(elu(y))
template <typename T>
__device__ __forceinline__ float k3_epi(const K3Gemm<T>& g, float acc,
                                        float b, float r) {
  float y = rnd<T>(acc + b);
  if (g.out_elu) y = rnd<T>(k3_elu<T>(y));
  if (g.res) {
    y = rnd<T>(r + y);
    if (g.res_elu) y = rnd<T>(k3_elu<T>(y));
  }
  return y;
}

template <typename T, int BM, int BN>
inline size_t k3_smem() {
  const size_t vec = 16 / sizeof(T);
  const size_t stages = k3_stages<T, BM, BN>() *
      (BM * (K3_BK + vec) + K3_BK * (BN + vec)) * sizeof(T);
  const size_t tile = (size_t)BM * (BN + 4) * 4;
  return stages > tile ? stages : tile;
}

// Block (z, y, x): output tile (x, y) over reduction slice z, the z-th
// block of its cluster (gridDim.x = splits).
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(K3_THREADS)
seanet_gemm_kernel(const K3Gemm<T> g) {
  constexpr bool MMA = std::is_same<T, bf16>::value;
  constexpr int VEC = 16 / sizeof(T), ST = k3_stages<T, BM, BN>();
  constexpr int AST = K3_BK + VEC, BST = BN + VEC, CST = BN + 4;
  constexpr int CPR = K3_BK / VEC;   // 16-byte pieces of an A tile row
  constexpr int ACH = (BM * CPR + K3_THREADS - 1) / K3_THREADS;
  constexpr int BCPR = BN / VEC;     // 16-byte pieces of a B tile row
  constexpr int BCH = (K3_BK * BCPR + K3_THREADS - 1) / K3_THREADS;
  static_assert(K3_THREADS % CPR == 0, "A tile pieces");
  extern __shared__ __align__(16) unsigned char k3_shared[];
  T* As = reinterpret_cast<T*>(k3_shared);  // [ST][BM][AST]
  T* Bs = As + ST * BM * AST;               // [ST][BK][BST]
  float* Cs = reinterpret_cast<float*>(k3_shared);  // [BM][CST]
  cg::cluster_group cluster = cg::this_cluster();
  const int z = blockIdx.x, nsplit = gridDim.x;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // ---- the tail: a carry that no block of this launch reads ----
  if (g.tail_dst) {
    const long nth = (long)gridDim.x * gridDim.y * gridDim.z * K3_THREADS;
    const long gid =
        (((long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + z) *
            K3_THREADS + tid;
    const long per = (long)g.tail_rows * g.tail_width;
    const int keep = g.tail_rows - g.tail_nt;  // carry rows that stay
    if (keep <= 0) {
      for (long e = gid; e < (long)(g.M / g.nt) * per; e += nth) {
        const long ln = e / per, r = e % per / g.tail_width;
        g.tail_dst[e] = g.tail_src[(ln * g.tail_nt + g.tail_nt -
                                    g.tail_rows + r) * g.tail_width +
                                   e % g.tail_width];
      }
    } else {
      // a carry longer than the frame's rows (the k7 conv over 2 rows a
      // frame): it moves up by nt rows and takes the frame's rows at its
      // end; one thread walks a (lane, column) down its rows, so each row
      // is read before it is written over
      for (long e = gid; e < (long)(g.M / g.nt) * g.tail_width; e += nth) {
        const long ln = e / g.tail_width, col = e % g.tail_width;
        T* dst = g.tail_dst + ln * per + col;
        for (int r = 0; r < g.tail_rows; ++r)
          dst[(long)r * g.tail_width] =
              r < keep ? dst[(long)(r + g.tail_nt) * g.tail_width]
                       : g.tail_src[(ln * g.tail_nt + r - keep) *
                                        g.tail_width + col];
      }
    }
  }

  // ---- this thread's A pieces: fixed rows; for each, the offsets of its
  // window's first row in x and in the carry (A[m, kg] lies at offset + kg
  // of the carry while kg's tap j has t + j < kw - 1, of x after) ----
  const int a_col = tid % CPR * VEC, lead = g.kw - 1;
  int a_lane[ACH], a_t[ACH], a_row[ACH];
  long long a_xo[ACH], a_co[ACH];
  bool a_ok[ACH];
#pragma unroll
  for (int i = 0; i < ACH; ++i) {
    const int e = tid + i * K3_THREADS, m = m0 + e / CPR;
    a_row[i] = e / CPR;
    a_ok[i] = e < BM * CPR && m < g.M;
    a_lane[i] = a_ok[i] ? m / g.nt : 0;
    a_t[i] = m - a_lane[i] * g.nt;
    a_xo[i] = ((long long)a_lane[i] * g.nt + a_t[i] - lead) * g.cin;
    a_co[i] = ((long long)a_lane[i] * g.pc + g.pc + a_t[i] - lead) * g.cin;
  }
  const int ktiles = (g.K + K3_BK - 1) / K3_BK;
  const int kt0 = z * g.kt_split, kt1 = min(ktiles, kt0 + g.kt_split);

  // A and B of k-tile kt into stage buf: 16-byte `cp.async` copies (zeros,
  // and no read, past the edges), or one value at a time
  auto load_stage = [&](int kt, int buf) {
    T* a = As + buf * BM * AST;
    const int kg = kt * K3_BK + a_col, j = kg / g.cin;
#pragma unroll
    for (int i = 0; i < ACH; ++i) {
      if (i * K3_THREADS + tid >= BM * CPR) continue;
      T* dst = a + a_row[i] * AST + a_col;
      if (g.a_vec) {
        const bool ok = a_ok[i] && kg < g.K;
        const T* src = !ok ? g.src
                       : a_t[i] + j < lead ? g.carry + (a_co[i] + kg)
                                           : g.src + (a_xo[i] + kg);
        cp_async16(dst, src, ok);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          dst[e] = a_ok[i] ? k3_a_elem<T>(g, a_lane[i], a_t[i], kg + e)
                           : from_f<T>(0.f);
      }
    }
    T* bs = Bs + buf * K3_BK * BST;
#pragma unroll
    for (int i = 0; i < BCH; ++i) {
      const int e = tid + i * K3_THREADS;
      if (e >= K3_BK * BCPR) continue;
      const int kk = e / BCPR, nn = e % BCPR * VEC;
      const int kg = kt * K3_BK + kk, n = n0 + nn;
      if (g.b_vec) {
        const bool ok = kg < g.K && n < g.N;
        cp_async16(bs + kk * BST + nn,
                   g.w + (ok ? (size_t)kg * g.N + n : 0), ok);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          bs[kk * BST + nn + q] = kg < g.K && n + q < g.N
                                      ? g.w[(size_t)kg * g.N + n + q]
                                      : from_f<T>(0.f);
      }
    }
  };

  // ---- main loop: a ring of ST stages, ST - 1 k-tiles in flight ----
  constexpr int WM = (BM >= 64 && BN == 32) ? 4 : (BM >= 32 ? 2 : 1);
  constexpr int WN = 4 / WM;
  constexpr int FM = BM / (16 * WM), FN = BN / (8 * WN);  // MMA fragments
  constexpr int TNT = BN / 4, TM = BM / (K3_THREADS / TNT);  // SIMT tile
  float acc[MMA ? FM * FN * 4 : TM * 4];
#pragma unroll
  for (int i = 0; i < (MMA ? FM * FN * 4 : TM * 4); ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (kt0 + i < kt1) load_stage(kt0 + i, i);
    cp_async_commit();  // one group a stage, empty past the end
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int cur = (kt - kt0) % ST;
    cp_async_wait<ST - 2>();  // stage kt has landed
    __syncthreads();  // ... for every thread; all done with stage kt - 1
    if (kt + ST - 1 < kt1)    // into the stage kt - 1 used
      load_stage(kt + ST - 1, (cur + ST - 1) % ST);
    cp_async_commit();
    const T* a = As + cur * BM * AST;
    const T* bs = Bs + cur * K3_BK * BST;
    if constexpr (MMA) {
      const int wm = warp / WN, wn = warp % WN;
#pragma unroll
      for (int ks = 0; ks < K3_BK / 16; ++ks) {
        uint32_t af[FM][4], bfr[FN][2];
#pragma unroll
        for (int fm = 0; fm < FM; ++fm)
          ldmatrix_x4(af[fm], a + ((wm * FM + fm) * 16 + (lane & 15)) * AST +
                                  ks * 16 + (lane >> 4) * 8);
        if constexpr (FN == 1) {
          ldmatrix_x2_trans(bfr[0],
                            bs + (ks * 16 + (lane & 15)) * BST + wn * 8);
        } else {
#pragma unroll
          for (int fp = 0; fp < FN / 2; ++fp) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, bs + (ks * 16 + (lane & 15)) * BST +
                                     (wn * FN + 2 * fp) * 8 +
                                     (lane >> 4) * 8);
            bfr[2 * fp][0] = r[0];
            bfr[2 * fp][1] = r[1];
            bfr[2 * fp + 1][0] = r[2];
            bfr[2 * fp + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int fm = 0; fm < FM; ++fm)
#pragma unroll
          for (int fn = 0; fn < FN; ++fn)
            mma_bf16_16816(acc + (fm * FN + fn) * 4, af[fm], bfr[fn][0],
                           bfr[fn][1]);
      }
    } else {
      const int tn = tid % TNT, tm = tid / TNT;
#pragma unroll 8
      for (int kk = 0; kk < K3_BK; ++kk) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(bs + kk * BST + tn * 4);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = to_f(a[(tm * TM + i) * AST + kk]);
          acc[i * 4 + 0] += av * b4.x;
          acc[i * 4 + 1] += av * b4.y;
          acc[i * 4 + 2] += av * b4.z;
          acc[i * 4 + 3] += av * b4.w;
        }
      }
    }
  }

  // ---- the float32 tile to shared memory, then the cluster's reduction
  // and the epilogue: block z the rows z, z + splits, ... ----
  cp_async_wait<0>();
  __syncthreads();  // every thread done with the stages Cs reuses
  if constexpr (MMA) {
    const int wm = warp / WN, wn = warp % WN;
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
#pragma unroll
      for (int fn = 0; fn < FN; ++fn) {
        const int r = (wm * FM + fm) * 16 + lane / 4;
        const int cc = (wn * FN + fn) * 8 + 2 * (lane % 4);
        const float* c4 = acc + (fm * FN + fn) * 4;
        *reinterpret_cast<float2*>(Cs + r * CST + cc) =
            make_float2(c4[0], c4[1]);
        *reinterpret_cast<float2*>(Cs + (r + 8) * CST + cc) =
            make_float2(c4[2], c4[3]);
      }
  } else {
    const int tn = tid % TNT, tm = tid / TNT;
#pragma unroll
    for (int i = 0; i < TM; ++i)
      *reinterpret_cast<float4*>(Cs + (tm * TM + i) * CST + tn * 4) =
          make_float4(acc[i * 4], acc[i * 4 + 1], acc[i * 4 + 2],
                      acc[i * 4 + 3]);
  }
  if (nsplit > 1) cluster.sync(); else __syncthreads();
  // pieces of VEC outputs (16 bytes of the working type), EB a thread at
  // once: their tile sums (the cluster's in rank order), bias and residual
  // loaded first, then the epilogue and the stores
  constexpr int PPR = BN / VEC, EB = 2;
  const int np = (BM - z + nsplit - 1) / nsplit * PPR;
  for (int p0 = tid; p0 < np; p0 += EB * K3_THREADS) {
    float v[EB][VEC];
    uint4 rv[EB], bv[EB];
#pragma unroll
    for (int u = 0; u < EB; ++u) {
      const int p = p0 + u * K3_THREADS;
      const int row = z + nsplit * (p / PPR), col = p % PPR * VEC;
      const int m = m0 + row, n = n0 + col;
      rv[u] = bv[u] = make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[u][e] = 0.f;
      if (p >= np || m >= g.M || n >= g.N) continue;
      for (int r = 0; r < nsplit; ++r) {
        const float* cr =
            (nsplit > 1 ? cluster.map_shared_rank(Cs, r) : Cs) + row * CST +
            col;
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 f = *reinterpret_cast<const float4*>(cr + e);
          v[u][e] += f.x;
          v[u][e + 1] += f.y;
          v[u][e + 2] += f.z;
          v[u][e + 3] += f.w;
        }
      }
      if (g.o_vec) {
        if (g.res) rv[u] = ld16(g.res + (size_t)m * g.N + n);
        if (g.bias) bv[u] = ld16(g.bias + n);
      }
    }
#pragma unroll
    for (int u = 0; u < EB; ++u) {
      const int p = p0 + u * K3_THREADS;
      const int row = z + nsplit * (p / PPR), col = p % PPR * VEC;
      const int m = m0 + row, n = n0 + col;
      if (p >= np || m >= g.M || n >= g.N) continue;
      if (!g.o_vec) {
        for (int e = 0; e < VEC && n + e < g.N; ++e) {
          const size_t i = (size_t)m * g.N + n + e;
          g.out[i] = from_f<T>(k3_epi<T>(
              g, v[u][e], g.bias ? to_f(g.bias[n + e]) : 0.f,
              g.res ? to_f(g.res[i]) : 0.f));
        }
        continue;
      }
      float rr[VEC], bb[VEC];
      unpack16<T>(rv[u], rr);
      unpack16<T>(bv[u], bb);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[u][e] = k3_epi<T>(g, v[u][e], bb[e],
                                                        rr[e]);
      *reinterpret_cast<uint4*>(g.out + (size_t)m * g.N + n) =
          pack16<T>(v[u]);
    }
  }
  if (nsplit > 1) cluster.sync();  // no block leaves while read
}

// The overlap-add of a K == 2s transposed conv from its GEMM output u (B*nu,
// 2s*c), rounded halves: y[i*s + j] = rnd(u[i, j] + u[i-1, s + j] + bias),
// u[-1, s + j] being the lane's carry[j], and ye = rnd(elu(y)), the resnet
// conv's input. A thread takes VEC channels of one y row (`vec`: c a whole
// number of 16-byte vectors, aligned; else one channel); the thread of row
// i = 0 reads carry[j] and then writes its new value, u[nu - 1, s + j], so
// the in-place update has no race.
template <typename T>
__global__ void __launch_bounds__(K3_EW_THREADS)
seanet_overlap_kernel(const T* __restrict__ u, T* carry,
                      const T* __restrict__ bias, T* __restrict__ y,
                      T* __restrict__ ye, int nb, int nu, int s, int c,
                      int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int w = vec ? VEC : 1, per = c / w;  // pieces a row
  const long p = (long)blockIdx.x * K3_EW_THREADS + threadIdx.x;
  if (p >= (long)nb * nu * s * per) return;
  const long row = p / per;
  const int cc = (int)(p - row * per) * w;
  const int lane = (int)(row / ((long)nu * s)), r = (int)(row % ((long)nu * s));
  const int i = r / s, j = r - i * s;
  const size_t ldu = (size_t)2 * s * c;
  const size_t ua = ((size_t)lane * nu + i) * ldu + (size_t)j * c + cc;
  const size_t ci = ((size_t)lane * s + j) * c + cc;
  const size_t yi = (size_t)row * c + cc;
  if (vec) {
    float a[VEC], b[VEC], bb[VEC];
    unpack16<T>(ld16(u + ua), a);
    unpack16<T>(i > 0 ? ld16(u + ua - ldu + (size_t)s * c) : ld16(carry + ci),
                b);
    if (bias) {
      unpack16<T>(ld16(bias + cc), bb);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) bb[e] = 0.f;
    }
    if (i == 0)
      *reinterpret_cast<uint4*>(carry + ci) =
          ld16(u + ((size_t)lane * nu + nu - 1) * ldu + (size_t)(s + j) * c +
               cc);
#pragma unroll
    for (int e = 0; e < VEC; ++e) a[e] = rnd<T>(a[e] + b[e] + bb[e]);
    *reinterpret_cast<uint4*>(y + yi) = pack16<T>(a);
#pragma unroll
    for (int e = 0; e < VEC; ++e) a[e] = rnd<T>(k3_elu<T>(a[e]));
    *reinterpret_cast<uint4*>(ye + yi) = pack16<T>(a);
  } else {
    const float prev =
        to_f(i > 0 ? u[ua - ldu + (size_t)s * c] : carry[ci]);
    if (i == 0)
      carry[ci] = u[((size_t)lane * nu + nu - 1) * ldu + (size_t)(s + j) * c +
                    cc];
    const float v = rnd<T>(to_f(u[ua]) + prev +
                           (bias ? to_f(bias[cc]) : 0.f));
    y[yi] = from_f<T>(v);
    ye[yi] = from_f<T>(rnd<T>(k3_elu<T>(v)));
  }
}

// The final conv, out_ch = 1: out[lane*nt + t] = rnd(sum_{j, c} xc[t + j,
// c] * w[j*cin + c] + bias), xc = [carry (last kw-1 of pc rows); h]. Grid
// (ceil(nt / K3_LAST_ROWS), B): block g stages rows [g*R, (g+1)*R) of lane
// blockIdx.y and the kw-1 before them in shared memory (float32, rows
// padded by one value), 16 bytes a load, then K3_LAST_SPLIT threads a row
// sum their share of its kw * cin products and meet by shuffles. Only
// block 0 of a lane reads the old carry (its first rows' window), so it
// alone writes the new one, the lane's last pc rows of h, once its block
// has staged: no other block reads or writes a carry.
constexpr int K3_LAST_ROWS = 64;
constexpr int K3_LAST_SPLIT = K3_LAST_THREADS / K3_LAST_ROWS;

inline size_t k3_last_smem(int cin, int kw) {
  return sizeof(float) *
         ((size_t)kw * cin + (size_t)(K3_LAST_ROWS + kw - 1) * (cin + 1));
}

template <typename T>
__global__ void __launch_bounds__(K3_LAST_THREADS)
seanet_last_kernel(const T* __restrict__ h, T* carry,
                   const T* __restrict__ w, const T* __restrict__ bias,
                   T* __restrict__ out, int nt, int cin, int kw, int pc,
                   int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int g = blockIdx.x, lane = blockIdx.y;
  const int tid = threadIdx.x, lead = kw - 1, ldx = cin + 1;
  extern __shared__ float k3_last_s[];
  float* wsm = k3_last_s;          // [kw * cin]
  float* xs = wsm + kw * cin;      // [R + lead][cin + 1]
  for (int e = tid; e < kw * cin; e += K3_LAST_THREADS) wsm[e] = to_f(w[e]);
  const int r0 = g * K3_LAST_ROWS, rows = min(K3_LAST_ROWS, nt - r0);
  const int wv = vec ? VEC : 1, per = cin / wv;
  const int np = (rows + lead) * per;
#pragma unroll 4
  for (int e = tid; e < np; e += K3_LAST_THREADS) {
    const int rr = e / per, c = (e - rr * per) * wv, r = r0 - lead + rr;
    const T* src = r < 0 ? carry + ((size_t)lane * pc + pc + r) * cin + c
                         : h + ((size_t)lane * nt + r) * cin + c;
    if (vec) {
      float v[VEC];
      unpack16<T>(ld16(src), v);
#pragma unroll
      for (int q = 0; q < VEC; ++q) xs[rr * ldx + c + q] = v[q];
    } else {
      xs[rr * ldx + c] = to_f(*src);
    }
  }
  __syncthreads();
  if (g == 0) {  // every read of the old carry is done
    for (int e = tid; e < pc * cin; e += K3_LAST_THREADS)
      carry[(size_t)lane * pc * cin + e] =
          h[((size_t)lane * nt + nt - pc) * cin + e];
  }
  const int t = tid / K3_LAST_SPLIT, q = tid % K3_LAST_SPLIT;
  const int c0 = q * cin / K3_LAST_SPLIT, c1 = (q + 1) * cin / K3_LAST_SPLIT;
  float acc = 0.f;
  if (t < rows) {
    for (int j = 0; j < kw; ++j) {
      const float* xr = xs + (t + j) * ldx;
      const float* wj = wsm + j * cin;
#pragma unroll 8
      for (int c = c0; c < c1; ++c) acc += xr[c] * wj[c];
    }
  }
#pragma unroll
  for (int o = 1; o < K3_LAST_SPLIT; o <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (t < rows && q == 0)
    out[(size_t)lane * nt + r0 + t] =
        from_f<T>(acc + (bias ? to_f(bias[0]) : 0.f));
}

template <typename T, int BM, int BN>
cudaError_t k3_launch(const K3Gemm<T>& g, int splits, cudaStream_t st) {
  const dim3 grid(splits, (g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  return launch_clustered(seanet_gemm_kernel<T, BM, BN>, grid,
                          dim3(K3_THREADS), splits, k3_smem<T, BM, BN>(), st,
                          g);
}

inline bool k3_aligned(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

template <typename T>
int k3_gemm(void* const* p, const int* d, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  K3Gemm<T> g;
  g.src = (const T*)p[0];
  g.carry = (const T*)p[1];
  g.w = (const T*)p[2];
  g.bias = (const T*)p[3];
  g.res = (const T*)p[4];
  g.out = (T*)p[5];
  g.tail_src = (const T*)p[6];
  g.tail_dst = (T*)p[7];
  const int nb = d[1];
  g.mode = d[0];
  g.nt = d[2];
  g.cin = d[3];
  g.N = d[4];
  g.kw = d[5];
  g.pc = d[6];
  g.out_elu = d[7];
  g.res_elu = d[8];
  const int bm = d[9], bn = d[10], splits = d[11];
  g.tail_width = d[12];
  g.tail_rows = d[13];
  g.tail_nt = d[14];
  g.M = nb * g.nt;
  g.K = g.kw * g.cin;
  if (nb < 1 || g.nt < 1 || g.cin < 1 || g.N < 1 || g.kw < 1 ||
      (g.mode != A_ROWS && g.mode != A_WINDOW) ||
      (g.mode == A_ROWS) != (g.kw == 1) || !g.src || !g.w || !g.out ||
      splits < 1 || splits > K3_MAX_SPLITS ||
      (g.mode == A_WINDOW && (!g.carry || g.pc < g.kw - 1)) ||
      (g.tail_dst && (!g.tail_src || g.tail_rows < 1 ||
                      g.tail_width < 1)))
    return (int)cudaErrorInvalidValue;
  const int ktiles = (g.K + K3_BK - 1) / K3_BK;
  g.kt_split = (ktiles + splits - 1) / splits;
  if ((splits - 1) * g.kt_split >= ktiles) return (int)cudaErrorInvalidValue;
  g.a_vec = g.cin % VEC == 0 && k3_aligned(g.src) && k3_aligned(g.carry);
  g.b_vec = g.N % VEC == 0 && k3_aligned(g.w);
  g.o_vec = g.N % VEC == 0 && k3_aligned(g.bias) && k3_aligned(g.res) &&
            k3_aligned(g.out);
  cudaError_t rc = cudaErrorInvalidValue;
#define PTT_K3(BM_, BN_) \
  if (bm == BM_ && bn == BN_) rc = k3_launch<T, BM_, BN_>(g, splits, st)
  PTT_K3(128, 64); PTT_K3(128, 32); PTT_K3(64, 64); PTT_K3(64, 32);
  PTT_K3(32, 64); PTT_K3(32, 32); PTT_K3(16, 64); PTT_K3(16, 32);
#undef PTT_K3
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

}  // namespace ptt

// One conv-GEMM of the frame. ptrs (8): src, carry, w, bias, res, out, the
// tail's src and dst (null where unused). dims (15): mode (0 rows, 1
// window), B, T (rows per lane), Cin, N, K (taps), P (carry rows),
// out_elu, res_elu, BM, BN, splits, the tail's width, rows and T. The
// reduction K*Cin is split into `splits` slices of ceil(k-tiles / splits)
// k-tiles, none empty.
extern "C" int ptt_seanet_gemm(void* const* ptrs, const int* dims, int dtype,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  PTT_DISPATCH(dtype, T, return ptt::k3_gemm<T>(ptrs, dims, st));
  return (int)cudaErrorInvalidValue;
}

// The overlap-add of a transposed conv: u (B*nu, 2s*C), carry (B, s, C)
// read and written in place, bias (C) or null; y and ye (B*nu*s, C).
extern "C" int ptt_seanet_overlap(const void* u, void* carry,
                                  const void* bias, void* y, void* ye, int B,
                                  int nu, int s, int C, int dtype,
                                  void* stream) {
  if (B < 1 || nu < 1 || s < 1 || C < 1 || !u || !carry || !y || !ye)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  PTT_DISPATCH(dtype, T, {
    const int vec = C % (16 / (int)sizeof(T)) == 0 && ptt::k3_aligned(u) &&
                    ptt::k3_aligned(carry) && ptt::k3_aligned(bias) &&
                    ptt::k3_aligned(y) && ptt::k3_aligned(ye);
    const long n = (long)B * nu * s * (vec ? C / (16 / (int)sizeof(T)) : C);
    ptt::seanet_overlap_kernel<T>
        <<<(unsigned)((n + ptt::K3_EW_THREADS - 1) / ptt::K3_EW_THREADS),
           ptt::K3_EW_THREADS, 0, st>>>((const T*)u, (T*)carry,
                                        (const T*)bias, (T*)y, (T*)ye, B, nu,
                                        s, C, vec);
  });
  return (int)cudaGetLastError();
}

// The final conv (one output channel): h (B*T, C), carry (B, P, C) read and
// then written in place, w (K*C, 1) window-stacked, bias (1) or null, out
// (B*T, 1), T = nt rows a lane; G = ceil(nt / 64) blocks a lane.
extern "C" int ptt_seanet_last(const void* h, void* carry, const void* w,
                               const void* bias, void* out, int B, int nt,
                               int C, int K, int P, int G, int dtype,
                               void* stream) {
  if (B < 1 || nt < P || C < 1 || K < 1 || P < K - 1 ||
      G != (nt + ptt::K3_LAST_ROWS - 1) / ptt::K3_LAST_ROWS || !h ||
      !carry || !w || !out)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = ptt::k3_last_smem(C, K);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  PTT_DISPATCH(dtype, T, {
    const int vec = C % (16 / (int)sizeof(T)) == 0 && ptt::k3_aligned(h) &&
                    ptt::k3_aligned(carry);
    if (smem > 46 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          ptt::seanet_last_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    ptt::seanet_last_kernel<T><<<dim3(G, B), ptt::K3_LAST_THREADS, smem, st>>>(
        (const T*)h, (T*)carry, (const T*)w, (const T*)bias, (T*)out, nt, C,
        K, P, vec);
  });
  return (int)cudaGetLastError();
}
