// K3: the SEANet decoder for one frame, as a fixed sequence of launches.
//
// Replaces the TPU kernel `pocket_tts_tpu/ops/pallas_seanet.py:
// seanet_frame` (`_seanet_batched` -> `_kernel`; weight transforms
// `_prep_weights`). The Python wrapper (ops/seanet_frame.py) launches, per
// frame: conv k7 -> ELU -> 3 x [convtr k=2s (+ overlap-add carry) ->
// resnet (ELU, causal conv k3, ELU, 1x1, residual) -> ELU] -> final conv k3,
// reading and writing the 8 streaming carries in place. Values are rounded
// to the working type at the TPU kernel's points (pallas_seanet.py:76-92):
// after each conv's bias add, after each ELU, after the residual add, and
// for the transposed convs after each half-product.
//
// What bounds it on the H100: small matmuls plus carries. A frame is
// ~0.16 GMAC over ~9 MB of bf16 weights with M between 16 and 1920 rows.
// At the card's peaks that is a few microseconds (the weights stream in
// ~3 us), but no stage is large enough to fill 132 SMs, so tile-grid size,
// launch count and, in this first version, SIMT FMA throughput (no tensor
// cores yet) set the time. Stages whose tile grid would leave most SMs idle
// split the reduction over more blocks (split-K). The design fuses bias,
// ELU, the input ELU of the resnet conv, the residual add and the stage
// ELU into the matmul prologue/epilogue (no elementwise launches), builds
// the im2col window on the fly from the carry and the input (no patch
// tensor), and takes its weight layouts (window-stacked conv, j-major
// convtr) once at load.
//
// The TPU kernel's blocked-time layout for the narrow last stage,
// xb[t, j*C + c] == x[t*s + j, c], is byte-for-byte the flat time-major
// (T*s, C) tensor, so here it is simply that flat tensor: the carries keep
// their (1, s*C) shapes and are read as (s, C) rows, and the block-diagonal
// kron taps the TPU needed to fill its 128 lanes (s times the FLOPs) are
// not needed.
//
// Lanes: B streams stack on the GEMMs' M axis (B * T rows, the weights
// read once for all of them), as the TPU kernel's batched grid shares its
// weights. Row m belongs to lane m / T; the conv-GEMM builds its window
// from that lane's carry, and the overlap-add and carry-tail kernels read
// and write each lane's own carry (B carries of P rows each, lane-major).
// The launch sequence is the same for every B.
#include "common.cuh"

namespace ptt {

constexpr int BM = 16, BN = 32, BK = 32, GEMM_THREADS = 128;

// out[m, n] = epilogue(sum_{j < K, c < Cin} xc[t + j, c] * w[j*Cin + c, n])
// for row m = b*T + t of lane b, where xc = [carry_b[P-(K-1):]; act(x_b)]
// and act is round(ELU) if in_elu.
// Epilogue: y = rnd(acc + bias); out_elu: y = rnd(elu(y));
// res: y = rnd(res + y), then res_elu: y = rnd(elu(y)).
template <typename T>
__device__ __forceinline__ void conv_epilogue(
    float acc, int m, int n, const T* __restrict__ bias,
    const T* __restrict__ res, T* __restrict__ out, int cout, int out_elu,
    int res_elu) {
  float y = rnd<T>(acc + (bias ? to_f(bias[n]) : 0.f));
  if (out_elu) y = rnd<T>(elu(y));
  if (res) {
    y = rnd<T>(to_f(res[(size_t)m * cout + n]) + y);
    if (res_elu) y = rnd<T>(elu(y));
  }
  out[(size_t)m * cout + n] = from_f<T>(y);
}

// Block (x, y, z) computes the BM x BN tile (y, x) over the z-th slice
// [z*kchunk, (z+1)*kchunk) of the reduction. With one slice it applies the
// epilogue itself; with several (split-K, for stages whose tile grid is too
// small to fill the card) it stores f32 partials to ws[z] and
// splitk_epilogue_kernel sums them in slice order.
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
conv_gemm_kernel(const T* __restrict__ x, const T* __restrict__ carry,
                 const T* __restrict__ w, const T* __restrict__ bias,
                 const T* __restrict__ res, T* __restrict__ out,
                 float* __restrict__ ws, int nt, int mt, int cin, int cout,
                 int kw, int pc, int kchunk, int in_elu, int out_elu,
                 int res_elu) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tr = tid / (BN / 4), tc = (tid % (BN / 4)) * 4;
  const int kbeg = blockIdx.z * kchunk;
  const int kk_total = min(kw * cin, kbeg + kchunk);
  const int lead = kw - 1;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  // A-tile loads: this thread fills column kk_a of rows mm_a + i * A_STEP;
  // each row's lane and its base offsets in x and the carry are fixed for
  // the whole reduction, so they are computed once here
  constexpr int A_STEP = GEMM_THREADS / BK, A_ROWS = BM / A_STEP;
  static_assert(GEMM_THREADS % BK == 0 && BM % A_STEP == 0, "A tile");
  const int kk_a = tid % BK, mm_a = tid / BK;
  int a_t[A_ROWS];          // row within its lane, or -1 past the last row
  long long a_x[A_ROWS], a_c[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int m = m0 + mm_a + i * A_STEP;
    const int lane = m / nt;
    a_t[i] = m < mt ? m - lane * nt : -1;
    a_x[i] = ((long long)lane * nt - lead) * cin;
    a_c[i] = ((long long)lane * pc + pc - lead) * cin;
  }

  for (int k0 = kbeg; k0 < kk_total; k0 += BK) {
    const int kg = k0 + kk_a;
    const bool k_ok = kg < kk_total;
    const int j = kg / cin, c = kg % cin;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      float val = 0.f;
      if (a_t[i] >= 0 && k_ok) {
        const int r = a_t[i] + j;
        if (r < lead) {
          val = to_f(carry[a_c[i] + (long long)r * cin + c]);
        } else {
          val = to_f(x[a_x[i] + (long long)r * cin + c]);
          if (in_elu) val = rnd<T>(elu(val));
        }
      }
      As[kk_a][mm_a + i * A_STEP] = val;
    }
    for (int e = tid; e < BK * BN; e += GEMM_THREADS) {
      const int kk = e / BN, nn = e % BN;
      const int kg = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (kg < kk_total && n < cout)
                       ? to_f(w[(size_t)kg * cout + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float a = As[kk][tr];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += a * Bs[kk][tc + c];
    }
    __syncthreads();
  }
  const int m = m0 + tr;
  if (m >= mt) return;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int n = n0 + tc + c;
    if (n >= cout) continue;
    if (ws)
      ws[((size_t)blockIdx.z * mt + m) * cout + n] = acc[c];
    else
      conv_epilogue<T>(acc[c], m, n, bias, res, out, cout, out_elu, res_elu);
  }
}

template <typename T>
__global__ void splitk_epilogue_kernel(const float* __restrict__ ws,
                                       int splits, const T* __restrict__ bias,
                                       const T* __restrict__ res,
                                       T* __restrict__ out, int mt, int cout,
                                       int out_elu, int res_elu) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mt * cout) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += ws[(size_t)z * mt * cout + idx];
  conv_epilogue<T>(acc, idx / cout, idx % cout, bias, res, out, cout,
                   out_elu, res_elu);
}

// Overlap-add of a K == 2s transposed conv from u = x @ w2 (T, 2s*Cout),
// already rounded: out[i*s + j, o] = rnd(u[i, j, o] + prev + bias[o]) with
// prev = u[i-1, s+j, o], or the lane's carry[j, o] for its first row i.
// The thread that reads carry[j, o] also writes its new value
// u[last row of the lane, s+j, o], so the in-place carry update has no
// race.
template <typename T>
__global__ void convtr_overlap_kernel(const T* __restrict__ u,
                                      T* __restrict__ carry,
                                      const T* __restrict__ bias,
                                      T* __restrict__ out, int nb, int nt,
                                      int s, int cout) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nb * nt * s * cout) return;
  const int o = idx % cout, r = idx / cout;
  const int ig = r / s, j = r % s;        // global input row, phase
  const int lane = ig / nt, i = ig % nt;  // lane, row within the lane
  const size_t ldu = (size_t)2 * s * cout;
  const size_t cidx = ((size_t)lane * s + j) * cout + o;
  const float a = to_f(u[ig * ldu + (size_t)j * cout + o]);
  float prev;
  if (i == 0) {
    prev = to_f(carry[cidx]);
  } else {
    prev = to_f(u[(ig - 1) * ldu + (size_t)(s + j) * cout + o]);
  }
  out[idx] = from_f<T>(a + prev + (bias ? to_f(bias[o]) : 0.f));
  if (i == 0)
    carry[cidx] = u[((size_t)lane * nt + nt - 1) * ldu
                    + (size_t)(s + j) * cout + o];
}

// carry_b[i, c] = act(x_b[T - P + i, c]) for i < P (T >= P), each lane b:
// the last P input rows of a causal conv, after its input ELU when elu is
// set.
template <typename T>
__global__ void carry_tail_kernel(const T* __restrict__ x,
                                  T* __restrict__ carry, int nb, int nt,
                                  int c, int pc, int use_elu) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nb * pc * c) return;
  const int lane = idx / (pc * c), rem = idx % (pc * c);
  float val = to_f(x[((size_t)lane * nt + nt - pc) * c + rem]);
  if (use_elu) val = rnd<T>(elu(val));
  carry[idx] = from_f<T>(val);
}

}  // namespace ptt

// x (B*T, Cin) lane-major; carry (B, P, Cin); res, out (B*T, Cout).
// ws: splits * B*T * Cout float32 scratch when splits > 1, else unused.
extern "C" int ptt_conv_gemm(const void* x, const void* carry, const void* w,
                             const void* bias, const void* res, void* out,
                             void* ws, int B, int T, int Cin, int Cout, int K,
                             int P, int splits, int in_elu, int out_elu,
                             int res_elu, int dtype, void* stream) {
  if (B < 1 || T < 1 || K < 1 || splits < 1 || (splits > 1 && ws == nullptr)
      || (K > 1 && (carry == nullptr || P < K - 1)))
    return (int)cudaErrorInvalidValue;
  const int M = B * T;
  const int ktiles = (K * Cin + ptt::BK - 1) / ptt::BK;
  const int kchunk = ((ktiles + splits - 1) / splits) * ptt::BK;
  dim3 grid((Cout + ptt::BN - 1) / ptt::BN, (M + ptt::BM - 1) / ptt::BM,
            splits);
  float* wsp = splits > 1 ? (float*)ws : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  PTT_DISPATCH(dtype, Ty,
               ptt::conv_gemm_kernel<Ty><<<grid, ptt::GEMM_THREADS, 0, st>>>(
                   (const Ty*)x, (const Ty*)carry, (const Ty*)w,
                   (const Ty*)bias, (const Ty*)res, (Ty*)out, wsp, T, M, Cin,
                   Cout, K, P, kchunk, in_elu, out_elu, res_elu));
  if (splits > 1) {
    const int n = M * Cout;
    PTT_DISPATCH(dtype, Ty,
                 ptt::splitk_epilogue_kernel<Ty>
                 <<<(n + 255) / 256, 256, 0, st>>>(
                     wsp, splits, (const Ty*)bias, (const Ty*)res, (Ty*)out,
                     M, Cout, out_elu, res_elu));
  }
  return (int)cudaGetLastError();
}

// u (B*T, 2s*Cout); carry (B, s, Cout); out (B*T*s, Cout).
extern "C" int ptt_convtr_overlap(const void* u, void* carry,
                                  const void* bias, void* out, int B, int T,
                                  int s, int Cout, int dtype, void* stream) {
  const int n = B * T * s * Cout;
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  PTT_DISPATCH(dtype, Ty,
               ptt::convtr_overlap_kernel<Ty><<<(n + 255) / 256, 256, 0, st>>>(
                   (const Ty*)u, (Ty*)carry, (const Ty*)bias, (Ty*)out, B, T,
                   s, Cout));
  return (int)cudaGetLastError();
}

// x (B*T, C); carry (B, P, C).
extern "C" int ptt_carry_tail(const void* x, void* carry, int B, int T,
                              int C, int P, int use_elu, int dtype,
                              void* stream) {
  if (B < 1 || P < 1 || T < P) return (int)cudaErrorInvalidValue;
  const int n = B * P * C;
  cudaStream_t st = (cudaStream_t)stream;
  PTT_DISPATCH(dtype, Ty,
               ptt::carry_tail_kernel<Ty><<<(n + 255) / 256, 256, 0, st>>>(
                   (const Ty*)x, (Ty*)carry, B, T, C, P, use_elu));
  return (int)cudaGetLastError();
}
