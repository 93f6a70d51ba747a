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
#include "common.cuh"

namespace ptt {

constexpr int BM = 16, BN = 32, BK = 32, GEMM_THREADS = 128;

// out[m, n] = epilogue(sum_{j < K, c < Cin} xc[m + j, c] * w[j*Cin + c, n])
// where xc = [carry[P-(K-1):]; act(x)] and act is round(ELU) if in_elu.
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
                 float* __restrict__ ws, int nt, int cin, int cout, int kw,
                 int pc, int kchunk, int in_elu, int out_elu, int res_elu) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tr = tid / (BN / 4), tc = (tid % (BN / 4)) * 4;
  const int kbeg = blockIdx.z * kchunk;
  const int kk_total = min(kw * cin, kbeg + kchunk);
  const int lead = kw - 1;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int k0 = kbeg; k0 < kk_total; k0 += BK) {
    for (int e = tid; e < BM * BK; e += GEMM_THREADS) {
      const int mm = e / BK, kk = e % BK;
      const int m = m0 + mm, kg = k0 + kk;
      float val = 0.f;
      if (m < nt && kg < kk_total) {
        const int j = kg / cin, c = kg % cin, r = m + j;
        if (r < lead) {
          val = to_f(carry[(size_t)(pc - lead + r) * cin + c]);
        } else {
          val = to_f(x[(size_t)(r - lead) * cin + c]);
          if (in_elu) val = rnd<T>(elu(val));
        }
      }
      As[kk][mm] = val;
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
  if (m >= nt) return;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int n = n0 + tc + c;
    if (n >= cout) continue;
    if (ws)
      ws[((size_t)blockIdx.z * nt + m) * cout + n] = acc[c];
    else
      conv_epilogue<T>(acc[c], m, n, bias, res, out, cout, out_elu, res_elu);
  }
}

template <typename T>
__global__ void splitk_epilogue_kernel(const float* __restrict__ ws,
                                       int splits, const T* __restrict__ bias,
                                       const T* __restrict__ res,
                                       T* __restrict__ out, int nt, int cout,
                                       int out_elu, int res_elu) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nt * cout) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += ws[(size_t)z * nt * cout + idx];
  conv_epilogue<T>(acc, idx / cout, idx % cout, bias, res, out, cout,
                   out_elu, res_elu);
}

// Overlap-add of a K == 2s transposed conv from u = x @ w2 (T, 2s*Cout),
// already rounded: out[i*s + j, o] = rnd(u[i, j, o] + prev + bias[o]) with
// prev = u[i-1, s+j, o], or carry[j, o] for i == 0. The thread that reads
// carry[j, o] also writes its new value u[T-1, s+j, o], so the in-place
// carry update has no race.
template <typename T>
__global__ void convtr_overlap_kernel(const T* __restrict__ u,
                                      T* __restrict__ carry,
                                      const T* __restrict__ bias,
                                      T* __restrict__ out, int nt, int s,
                                      int cout) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nt * s * cout) return;
  const int o = idx % cout, r = idx / cout;
  const int i = r / s, j = r % s;
  const size_t ldu = (size_t)2 * s * cout;
  const float a = to_f(u[i * ldu + (size_t)j * cout + o]);
  float prev;
  if (i == 0) {
    prev = to_f(carry[j * cout + o]);
  } else {
    prev = to_f(u[(i - 1) * ldu + (size_t)(s + j) * cout + o]);
  }
  out[idx] = from_f<T>(a + prev + (bias ? to_f(bias[o]) : 0.f));
  if (i == 0)
    carry[j * cout + o] = u[(nt - 1) * ldu + (size_t)(s + j) * cout + o];
}

// carry[i, c] = act(x[T - P + i, c]) for i < P (T >= P): the last P input
// rows of a causal conv, after its input ELU when elu is set.
template <typename T>
__global__ void carry_tail_kernel(const T* __restrict__ x,
                                  T* __restrict__ carry, int nt, int c,
                                  int pc, int use_elu) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= pc * c) return;
  float val = to_f(x[(size_t)(nt - pc) * c + idx]);
  if (use_elu) val = rnd<T>(elu(val));
  carry[idx] = from_f<T>(val);
}

}  // namespace ptt

// ws: splits * T * Cout float32 scratch when splits > 1, else unused.
extern "C" int ptt_conv_gemm(const void* x, const void* carry, const void* w,
                             const void* bias, const void* res, void* out,
                             void* ws, int T, int Cin, int Cout, int K, int P,
                             int splits, int in_elu, int out_elu, int res_elu,
                             int dtype, void* stream) {
  if (T < 1 || K < 1 || splits < 1 || (splits > 1 && ws == nullptr)
      || (K > 1 && (carry == nullptr || P < K - 1)))
    return (int)cudaErrorInvalidValue;
  const int ktiles = (K * Cin + ptt::BK - 1) / ptt::BK;
  const int kchunk = ((ktiles + splits - 1) / splits) * ptt::BK;
  dim3 grid((Cout + ptt::BN - 1) / ptt::BN, (T + ptt::BM - 1) / ptt::BM,
            splits);
  float* wsp = splits > 1 ? (float*)ws : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  PTT_DISPATCH(dtype, Ty,
               ptt::conv_gemm_kernel<Ty><<<grid, ptt::GEMM_THREADS, 0, st>>>(
                   (const Ty*)x, (const Ty*)carry, (const Ty*)w,
                   (const Ty*)bias, (const Ty*)res, (Ty*)out, wsp, T, Cin,
                   Cout, K, P, kchunk, in_elu, out_elu, res_elu));
  if (splits > 1) {
    const int n = T * Cout;
    PTT_DISPATCH(dtype, Ty,
                 ptt::splitk_epilogue_kernel<Ty>
                 <<<(n + 255) / 256, 256, 0, st>>>(
                     wsp, splits, (const Ty*)bias, (const Ty*)res, (Ty*)out,
                     T, Cout, out_elu, res_elu));
  }
  return (int)cudaGetLastError();
}

extern "C" int ptt_convtr_overlap(const void* u, void* carry,
                                  const void* bias, void* out, int T, int s,
                                  int Cout, int dtype, void* stream) {
  const int n = T * s * Cout;
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  PTT_DISPATCH(dtype, Ty,
               ptt::convtr_overlap_kernel<Ty><<<(n + 255) / 256, 256, 0, st>>>(
                   (const Ty*)u, (Ty*)carry, (const Ty*)bias, (Ty*)out, T, s,
                   Cout));
  return (int)cudaGetLastError();
}

extern "C" int ptt_carry_tail(const void* x, void* carry, int T, int C,
                              int P, int use_elu, int dtype, void* stream) {
  if (P < 1 || T < P) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  PTT_DISPATCH(dtype, Ty,
               ptt::carry_tail_kernel<Ty><<<(P * C + 255) / 256, 256, 0, st>>>(
                   (const Ty*)x, (Ty*)carry, T, C, P, use_elu));
  return (int)cudaGetLastError();
}
