// K8: the chunked Mamba2 SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/mamba2_scan/kernel.py:
// _mamba2_kernel (mamba2_scan_pallas), the SSM scan of every Mamba2 block of
// zamba2 at prefill.  x [B, H, T, P] (float32 or bfloat16), dt [B, H, T]
// float32 (> 0), A [H] float32 (< 0), Bm and C [B, T, N] float32 (shared by
// the heads), D [H] float32; out y [B, H, T, P] in x's dtype and the final
// state S [B, H, N, P] float32.  The function is mamba2_scan_ref of ref.py,
// the sequential recurrence
//   S = exp(A dt_t) S + dt_t B_t (x) x_t,   y_t = C_t^T S + D x_t   (S = 0 at t = 0).
//
// Chunked form.  Within a chunk of C tokens, logc[t] = sum_{s<=t} A dt_s
// (inclusive, from the chunk's start), and with S0 the state on entry:
//   att[t][s] = (C_t . B_s) dt_s exp(logc[t] - logc[s])          (s <= t)
//   y[t][p]   = sum_n C_t[n] exp(logc[t]) S0[n][p] + sum_{s<=t} att[t][s] x[s][p]
//             + D x[t][p]
//   S[n][p]   = exp(logc[C-1]) S0[n][p] + sum_s B_s[n] dt_s exp(logc[C-1] - logc[s]) x[s][p]
// Every exponent is a difference logc[later] - logc[earlier] or a cumulative
// sum itself, so it is <= 0 and exp never overflows.  The TPU kernel forms
// B_s dt_s / c_s = B_s dt_s exp(-logc[s]) instead: at zamba2's decays
// (A = -exp(A_log), A_log = log(linspace(1, 8, H)), dt = softplus of a
// projection with std ~0.63) logc reaches -100 ... -370 within a 64-token
// chunk, exp(370) overflows float32 and 0 * inf gives NaN, so that kernel
// returns NaN for nearly every head (tests/test_torch_ssm_kernels.py).  This
// kernel stays finite there.
//
// Layout: the TPU grid (B, H, T/C) walks chunks in order with S in VMEM
// scratch.  CUDA blocks carry nothing between them, so one block of 256
// threads owns one (b, h), keeps S [N][P] float32 in shared memory and loops
// over the chunks itself.  Per chunk, x, B and C are staged as float32 in
// shared memory (rows of B and C padded to N + 1 floats so that reads down a
// column hit distinct banks), logc is a prefix sum, and the three products
// run as plain FMA loops on the float32 cores: thread e of the block takes
// outputs e, e + 256, ... with the fastest index on consecutive threads.
//
// Bound on this card: at zamba2-7b's prefill (B = 4, H = 112, T = 2048,
// P = N = 64, C = 64) the call moves ~250 MB (each input read once, y and S
// written once) and does ~23 GFLOP in the three products and the state
// update (the causal triangle counted), so it is bound by the float32 rate
// (~0.34 ms at 67 TFLOP/s) more than by bytes (~0.07 ms).  These FMA loops
// read two shared-memory operands per FMA, so they sit several times above
// that bound; wgmma on bf16 tiles is later work (ROADMAP.md).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads) mamba2_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm, const float* __restrict__ Dv,
    T* __restrict__ y, float* __restrict__ s_out, int H, int T_len, int P, int N, int C) {
  extern __shared__ __align__(16) float smem[];
  const int ld = N + 1;                     // padded row of B and C
  float* S = smem;                          // [N][P]
  float* xs = S + N * P;                    // [C][P]
  float* bs = xs + C * P;                   // [C][ld]: B, then B dt exp(logc[C-1] - logc[s])
  float* cs = bs + C * ld;                  // [C][ld]: C, then C exp(logc[t])
  float* att = cs + C * ld;                 // [C][C]
  float* lc = att + C * C;                  // [C]: logc
  float* dts = lc + C;                      // [C]

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t xbase = ((size_t)b * H + h) * T_len * P;
  const size_t dbase = ((size_t)b * H + h) * T_len;
  const size_t bbase = (size_t)b * T_len * N;
  const float a_h = A[h], d_h = Dv[h];

  for (int e = tid; e < N * P; e += kThreads) S[e] = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += C) {
    __syncthreads();                        // the previous chunk is consumed
    const size_t xb = xbase + (size_t)t0 * P, bb = bbase + (size_t)t0 * N;
    for (int e = tid; e < C * P; e += kThreads) xs[e] = to_f32(x[xb + e]);
    for (int e = tid; e < C * N; e += kThreads) {
      const int t = e / N, n = e - t * N;
      bs[t * ld + n] = Bm[bb + e];
      cs[t * ld + n] = Cm[bb + e];
    }
    for (int t = tid; t < C; t += kThreads) dts[t] = dt[dbase + t0 + t];
    __syncthreads();
    if (tid == 0) {                         // inclusive prefix sum of A dt
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc += a_h * dts[t];
        lc[t] = acc;
      }
    }
    __syncthreads();

    // Intra-chunk weights, causal and inclusive.
    for (int e = tid; e < C * C; e += kThreads) {
      const int t = e / C, s = e - t * C;
      float acc = 0.f;
      if (s <= t) {
        const float* ct = cs + t * ld;
        const float* bsr = bs + s * ld;
        for (int n = 0; n < N; ++n) acc = fmaf(ct[n], bsr[n], acc);
        acc *= dts[s] * expf(lc[t] - lc[s]);
      }
      att[e] = acc;
    }
    __syncthreads();

    // C -> C exp(logc[t]) and B -> B dt exp(logc[C-1] - logc[s]).
    const float l_last = lc[C - 1];
    for (int e = tid; e < C * N; e += kThreads) {
      const int t = e / N, n = e - t * N;
      cs[t * ld + n] *= expf(lc[t]);
      bs[t * ld + n] *= dts[t] * expf(l_last - lc[t]);
    }
    __syncthreads();

    // y = inter + intra + D x, from the state on entry.
    for (int e = tid; e < C * P; e += kThreads) {
      const int t = e / P, p = e - t * P;
      const float* ct = cs + t * ld;
      float acc = 0.f;
      for (int n = 0; n < N; ++n) acc = fmaf(ct[n], S[n * P + p], acc);
      const float* at = att + t * C;
      for (int s = 0; s <= t; ++s) acc = fmaf(at[s], xs[s * P + p], acc);
      acc = fmaf(d_h, xs[e], acc);
      store(y + xb + e, acc);
    }
    __syncthreads();

    // S = exp(logc[C-1]) S + B_dec^T x.
    const float decay = expf(l_last);
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P, p = e - n * P;
      float acc = S[e] * decay;
      for (int s = 0; s < C; ++s) acc = fmaf(bs[s * ld + n], xs[s * P + p], acc);
      S[e] = acc;
    }
  }
  __syncthreads();
  float* so = s_out + ((size_t)b * H + h) * N * P;
  for (int e = tid; e < N * P; e += kThreads) so[e] = S[e];
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* D, void* y, void* s, int B, int H, int T_len, int P, int N, int C,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)N * P + (size_t)C * P +
                                       2 * (size_t)C * (N + 1) + (size_t)C * C + 2 * C);
  cudaError_t err = cudaFuncSetAttribute(mamba2_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  mamba2_scan_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const float*)Bm, (const float*)Cm,
      (const float*)D, (T*)y, (float*)s, H, T_len, P, N, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y).  The wrapper has checked the
// shapes, 0 < P, N <= 64, 0 < C <= 64, T % C == 0 and T > 0.
extern "C" int mamba2_scan_launch(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, const void* D, void* y,
                                  void* s, int B, int H, int T_len, int P, int N, int C,
                                  int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, dt, A, Bm, Cm, D, y, s, B, H, T_len, P, N, C, st);
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, s, B, H, T_len, P, N, C, st);
}
