// K7: the chunked RWKV6 recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rwkv6_scan/kernel.py:
// _rwkv6_kernel (rwkv6_scan_pallas), the time-mix scan of every rwkv6 layer
// at prefill.  r, k, v [B, H, T, N] (float32 or bfloat16, one dtype), the
// per-channel decay w [B, H, T, N] float32 in (0, 1] and the bonus u [H, N]
// float32; out o [B, H, T, N] in r's dtype and the final state S
// [B, H, N, N] float32.  The function is rwkv6_scan_ref of ref.py, the
// sequential recurrence
//   o_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j]),
//   S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j]     (S = 0 at t = 0).
//
// Chunked form.  Within a chunk of C tokens, logd[t][i] = sum_{s<=t}
// log w_s[i] (inclusive, from the chunk's start), and with S0 the state on
// entry:
//   a[t][s] = sum_i r[t][i] k[s][i] exp(logd[t-1][i] - logd[s][i])  (s < t)
//   o[t][j] = sum_i r[t][i] exp(logd[t-1][i]) S0[i][j]
//           + sum_{s<t} a[t][s] v[s][j] + (sum_i r[t][i] u[i] k[t][i]) v[t][j]
//   S[i][j] = exp(logd[C-1][i]) S0[i][j]
//           + sum_s k[s][i] exp(logd[C-1][i] - logd[s][i]) v[s][j]
// (logd[-1] = 0).  Every exponent is a difference logd[later] - logd[earlier]
// or a cumulative sum itself, so it is <= 0 and exp never overflows.  The TPU
// kernel forms k / d_s = k exp(-logd[s]) instead, which overflows float32
// once a channel's decay over the chunk passes exp(-88) (its docstring
// assumes w stays near 0.69); this kernel has no such assumption.  A decay
// of exactly 0 would make log w = -inf and a difference of infinities NaN,
// so log w is floored at -104 (exp(-104) is below float32's least normal
// value, so the floor changes no product).
//
// Layout: the TPU grid (B, H, T/C) walks chunks in order with S in VMEM
// scratch.  CUDA blocks carry nothing between them, so one block of 256
// threads owns one (b, h), keeps S [N][N] float32 in shared memory and loops
// over the chunks itself.  Per chunk, r, k, v and log w are staged as
// float32 in shared memory (rows of r, k and logd padded to N + 1 floats so
// that reads down a column hit distinct banks), logd is a prefix sum down
// each column, and the three products run as plain FMA loops on the float32
// cores: thread e of the block takes outputs e, e + 256, ... with the
// fastest index on consecutive threads.
//
// Bound on this card: at rwkv6-1.6b's prefill (B = 4, H = 32, T = 2048,
// N = 64, C = 32) the call moves ~203 MB (each input read once, o and S
// written once) and does ~5.3 GFLOP in the three products and the state
// update, so the bytes bound (~0.06 ms at 3.35 TB/s) and the float32 bound
// (~0.08 ms at 67 TFLOP/s) are close.  These FMA loops read two shared-memory
// operands per FMA and run 128 blocks, one per (b, h), on 132 SMs, so they
// sit well above both; wgmma on bf16 tiles and more than one block per
// (b, h) are later work (ROADMAP.md).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kLogFloor = -104.f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads) rwkv6_scan_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, T* __restrict__ o,
    float* __restrict__ s_out, int H, int T_len, int N, int C) {
  extern __shared__ __align__(16) float smem[];
  const int ld = N + 1;                     // padded row of r, k, logd
  float* S = smem;                          // [N][N]
  float* rq = S + N * N;                    // [C][ld]: r, then r exp(logd[t-1])
  float* kk = rq + C * ld;                  // [C][ld]: k, then k exp(logd[C-1] - logd[s])
  float* lg = kk + C * ld;                  // [C][ld]: log w, then logd
  float* vv = lg + C * ld;                  // [C][N]
  float* aa = vv + C * N;                   // [C][C]
  float* beta = aa + C * C;                 // [C]: sum_i r u k
  float* us = beta + C;                     // [N]

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t base = ((size_t)b * H + h) * T_len * N;

  for (int e = tid; e < N * N; e += kThreads) S[e] = 0.f;
  for (int i = tid; i < N; i += kThreads) us[i] = u[(size_t)h * N + i];

  for (int t0 = 0; t0 < T_len; t0 += C) {
    __syncthreads();                        // the previous chunk is consumed
    const size_t cb = base + (size_t)t0 * N;
    for (int e = tid; e < C * N; e += kThreads) {
      const int t = e / N, i = e - t * N;
      rq[t * ld + i] = to_f32(r[cb + e]);
      kk[t * ld + i] = to_f32(k[cb + e]);
      lg[t * ld + i] = fmaxf(logf(w[cb + e]), kLogFloor);
      vv[e] = to_f32(v[cb + e]);
    }
    __syncthreads();
    for (int i = tid; i < N; i += kThreads) {   // inclusive prefix sum per channel
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc += lg[t * ld + i];
        lg[t * ld + i] = acc;
      }
    }
    __syncthreads();

    // Intra-chunk weights (strictly causal) and the bonus.
    for (int e = tid; e < C * C; e += kThreads) {
      const int t = e / C, s = e - t * C;
      float acc = 0.f;
      if (s < t) {
        const float* rt = rq + t * ld;
        const float* ks = kk + s * ld;
        const float* lt = lg + (t - 1) * ld;
        const float* ls = lg + s * ld;
        for (int i = 0; i < N; ++i) acc = fmaf(rt[i] * ks[i], __expf(lt[i] - ls[i]), acc);
      }
      aa[e] = acc;
    }
    for (int t = tid; t < C; t += kThreads) {
      float acc = 0.f;
      for (int i = 0; i < N; ++i) acc = fmaf(rq[t * ld + i] * us[i], kk[t * ld + i], acc);
      beta[t] = acc;
    }
    __syncthreads();

    // r -> r exp(logd[t-1]) and k -> k exp(logd[C-1] - logd[s]).
    const float* llast = lg + (C - 1) * ld;
    for (int e = tid; e < C * N; e += kThreads) {
      const int t = e / N, i = e - t * N;
      if (t > 0) rq[t * ld + i] *= expf(lg[(t - 1) * ld + i]);
      kk[t * ld + i] *= expf(llast[i] - lg[t * ld + i]);
    }
    __syncthreads();

    // o = inter + intra + bonus, from the state on entry.
    for (int e = tid; e < C * N; e += kThreads) {
      const int t = e / N, j = e - t * N;
      const float* qt = rq + t * ld;
      float acc = 0.f;
      for (int i = 0; i < N; ++i) acc = fmaf(qt[i], S[i * N + j], acc);
      const float* at = aa + t * C;
      for (int s = 0; s < t; ++s) acc = fmaf(at[s], vv[s * N + j], acc);
      acc = fmaf(beta[t], vv[t * N + j], acc);
      store(o + cb + e, acc);
    }
    __syncthreads();

    // S = diag(exp(logd[C-1])) S + k_dec^T v.
    for (int e = tid; e < N * N; e += kThreads) {
      const int i = e / N, j = e - i * N;
      float acc = S[e] * expf(llast[i]);
      for (int s = 0; s < C; ++s) acc = fmaf(kk[s * ld + i], vv[s * N + j], acc);
      S[e] = acc;
    }
  }
  __syncthreads();
  float* so = s_out + ((size_t)b * H + h) * N * N;
  for (int e = tid; e < N * N; e += kThreads) so[e] = S[e];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           void* o, void* s, int B, int H, int T_len, int N, int C, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)N * N + 3 * (size_t)C * (N + 1) +
                                       (size_t)C * N + (size_t)C * C + C + N);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_scan_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w, (const float*)u, (T*)o,
      (float*)s, H, T_len, N, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and o).  The wrapper has checked
// the shapes, 0 < N <= 64, 0 < C <= 64, T % C == 0 and T > 0.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* o, void* s, int B,
                                 int H, int T_len, int N, int C, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(r, k, v, w, u, o, s, B, H, T_len, N, C, st);
  return launch<__nv_bfloat16>(r, k, v, w, u, o, s, B, H, T_len, N, C, st);
}
