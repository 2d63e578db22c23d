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
// bfloat16 r, k, v: the tensor-core kernel (rwkv6_mma_kernel).  CUDA blocks
// carry nothing between them, so a block walks the chunks of one (b, h) in
// order; the columns j of v, o and S are independent, so kernel.py's
// cols_plan may cut them into slices of NC = 16 or 64 columns, one
// block each (grid (slices, H, B)).  A block of eight warps keeps its
// slice of S [64 x NC] float32 in mma accumulators (warp w: rows
// 16 (w & 3) .. + 15, half of the columns).  Eight warps, not four: with
// one (b, h) a block, rwkv6's 128 blocks put one block on an SM, and a
// chunk's phases are chains of dependent loads, exponentials and shuffles
// that one warp per scheduler cannot hide.
// Per chunk, padded to CP = 32 or 64 tokens and N to 64 channels with zeros:
//   * r, k, v (the slice's columns) and w arrive by 16-byte cp.async into
//     one of two stages while the chunk before computes;
//   * log2 w, floored, and its prefix down the chunk: a warp scan, lane l of
//     warp w on channel 8w + (l & 7) over a quarter of the chunk, the
//     quarters' totals joined by shuffles;
//   * the operands, as bf16 high and low parts: r exp(logd[t-1]) and
//     k exp(logd[C-1] - logd[s]); and, per 16-token sub-block q with last
//     token e_q, r[t] exp(logd[t-1] - logd[e_q]) for t past the sub-block
//     and k[s] exp(logd[e_q] - logd[s]) for s in it: both exponents <= 0,
//     and their product is a[t][s] for t in a later sub-block p, s in q;
//   * the diagonal 16 x 16 sub-blocks of a on the FMA units, the exponential
//     evaluated once per (t, s, i) with s < t: a lane takes rows kk and
//     15 - kk of a sub-block (15 pairs between them) over 4 or 8 channels,
//     each pair's sum independent, and the channel groups meet by shuffles;
//     the bonus sum_i r u k is a's diagonal;
//   * on the tensor cores (mma.sync m16n8k16, bf16 -> float32, operands by
//     ldmatrix from rows padded to 72 bf16): the off-diagonal sub-blocks of
//     a (split x split), the inter-chunk (r exp(logd[t-1])) S0 (split x
//     split; S0's parts staged once a chunk), the state update
//     (k exp(logd[C-1] - logd[s]))^T v (split x exact v) and a v (split a,
//     causal sub-blocks only).  r, k and v are exact in bf16; a float32
//     operand is its bf16 high part plus its bf16 residual, and a product of
//     two split operands is hi hi + hi lo + lo hi (mma_bf16.cuh, shared with
//     K8), so the state holds the float32 checks.
//
// float32 r, k, v: the FMA kernel (rwkv6_scan_kernel), one block of 256
// threads a (b, h), S in shared memory, the three products as FMA loops on
// the float32 cores.
//
// Bound on this card (NVIDIA H100 80GB HBM3, 700 W): at rwkv6-1.6b's
// prefill (B = 4, H = 32, T = 2048, N = 64, C = 32, bf16) a call moves
// ~203 MB (each input read once, o and S written once): 0.061 ms at
// 3.35 TB/s.  The recurrence itself needs ~5.5
// GFLOP, 0.081 ms at the float32 rate and 0.006 ms at the bf16 tensor-core
// rate, so at the rate of the unit that does the products the bound is
// bytes (chip_smoke.py prints both).  What the tensor-core kernel spends
// beyond it: the exponentials of the operands and of the diagonal
// sub-blocks (~23.5 K a (b, h) chunk at C = 32, two thirds of them the
// diagonal's) on the special-function units, which every column slice
// recomputes, and the chunk's four block barriers.  Measured there (700 W):
// 7.09 ms over rwkv6's 24 prefill calls with one 64-column slice a (b, h),
// 4.9x the bytes bound; the FMA design it replaces took 42.3-43.1 ms.  At
// the prefill of one prompt (B = 1, 32 (b, h)) four 16-column slices a
// (b, h) take 6.04-6.23 ms over the 24 calls, one 64-column slice 7.08 ms.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../mamba2_scan/csrc/mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int kThreads = 256;
constexpr float kLogFloor = -104.f;

__global__ void __launch_bounds__(kThreads) rwkv6_scan_kernel(
    const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, float* __restrict__ o,
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
      rq[t * ld + i] = r[cb + e];
      kk[t * ld + i] = k[cb + e];
      lg[t * ld + i] = fmaxf(logf(w[cb + e]), kLogFloor);
      vv[e] = v[cb + e];
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
      o[cb + e] = acc;
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

// ---------------------------------------------------------------------------
// bfloat16 r, k, v: the tensor-core kernel.
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kRows = 64;                    // channels, padded
constexpr int kLdB = 72;                     // bf16 row of 64 channels, padded
constexpr int kLdW = 68;                     // float32 row of 64 channels, padded
constexpr float kLog2Floor = kLogFloor * 1.4426950408889634f;   // the floor, in log2
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float2 bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void put2(__nv_bfloat16* hi, __nv_bfloat16* lo, float x0, float x1) {
  uint32_t h, l;
  split2(x0, x1, h, l);
  *reinterpret_cast<uint32_t*>(hi) = h;
  *reinterpret_cast<uint32_t*>(lo) = l;
}

// Shared memory of one block, in bytes: two stages of r, k [CP][72] bf16,
// v [CP][NC + 8] bf16 and w [CP][68] float32 (log2 w's prefix in place);
// the operands r exp(logd[t-1]), k exp(logd[C-1] - logd[s]), the
// sub-blocks' factors R_q (rows past sub-block q) and K_q (rows of it), each
// as high and low bf16 tiles; a [CP][CP + 4] float32; S0's parts [64][NC +
// 8] bf16; u [64] float32.  kernel.py's shared_bytes mirrors kBytes.
template <int CP, int NC>
struct Layout {
  static constexpr int kLdV = NC + 8;
  static constexpr int kLdA = CP + 4;
  static constexpr int kNQ = CP / 16 - 1;                       // sub-blocks with a later one
  static constexpr int kRqRows = kNQ * CP - 8 * kNQ * (kNQ + 1);  // sum_q (CP - 16 (q + 1))
  static constexpr int kTile = CP * kLdB * 2;
  static constexpr int kStageK = kTile, kStageV = 2 * kTile;
  static constexpr int kStageW = kStageV + CP * kLdV * 2;
  static constexpr int kStage = kStageW + CP * kLdW * 4;
  static constexpr int kRd = 2 * kStage;
  static constexpr int kKd = kRd + 2 * kTile;
  static constexpr int kRq = kKd + 2 * kTile;
  static constexpr int kKq = kRq + 2 * kRqRows * kLdB * 2;
  static constexpr int kA = kKq + 2 * kNQ * 16 * kLdB * 2;
  static constexpr int kS = kA + CP * kLdA * 4;
  static constexpr int kU = kS + 2 * kRows * kLdV * 2;
  static constexpr int kBytes = kU + kRows * 4;
};

// First row of R_q in its buffer.
template <int CP>
__device__ __forceinline__ int rq_off(int q) {
  return q * CP - 8 * q * (q + 1);
}

// log2 w (0 outside the chunk's C tokens and N channels), floored, and its
// inclusive prefix down the chunk, in place, as a warp scan: warp w takes
// channels 8w..8w+7, lane l channel 8w + (l & 7) over the quarter l >> 3 of
// the chunk, a running sum in registers; the quarters' totals are scanned by
// two shuffles and each quarter adds the totals before it.
template <int CP>
__device__ __forceinline__ void log_decay_scan(float* ld, int C, int N, int w, int lane) {
  constexpr int TL = CP / 4;                   // tokens a lane
  const int i = 8 * w + (lane & 7), t0 = (lane >> 3) * TL;
  const bool col = i < N;
  float run[TL];
#pragma unroll
  for (int q = 0; q < TL; ++q) {
    const int t = t0 + q;
    const float x = (col && t < C) ? fmaxf(lg2(ld[t * kLdW + i]), kLog2Floor) : 0.f;
    run[q] = q ? run[q - 1] + x : x;
  }
  float incl = run[TL - 1];
#pragma unroll
  for (int o = 8; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const float carry = incl - run[TL - 1];      // the quarters before this one
#pragma unroll
  for (int q = 0; q < TL; ++q) ld[(t0 + q) * kLdW + i] = run[q] + carry;
}

// n bf16 (4 or 8, 8- or 16-byte aligned) as floats.
template <int n>
__device__ __forceinline__ void bf_load(const __nv_bfloat16* p, float* x) {
  uint32_t wd[n / 2];
  if constexpr (n == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    wd[0] = q.x, wd[1] = q.y, wd[2] = q.z, wd[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    wd[0] = q.x, wd[1] = q.y;
  }
#pragma unroll
  for (int e = 0; e < n / 2; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wd[e]));
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

// n float32 (4 or 8, 16-byte aligned).
template <int n>
__device__ __forceinline__ void f_load(const float* p, float* x) {
#pragma unroll
  for (int e = 0; e < n; e += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + e);
    x[e] = q.x, x[e + 1] = q.y, x[e + 2] = q.z, x[e + 3] = q.w;
  }
}

template <int CP, int NC>
__global__ void __launch_bounds__(kMmaThreads, CP == 32 ? 2 : 1) rwkv6_mma_kernel(
    const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, __nv_bfloat16* __restrict__ o, float* __restrict__ s_out,
    int H, int T_len, int N, int C, int vec) {
  using Lay = Layout<CP, NC>;
  constexpr int kLdV = Lay::kLdV, kLdA = Lay::kLdA, kNQ = Lay::kNQ;
  constexpr int MT = CP / 16;                  // 16-token sub-blocks
  constexpr int NT = NC / 8;                   // 8-column tiles of the slice
  constexpr int NTS = NT / 2;                  // the state's column tiles a warp holds
  constexpr int UNITS = MT * (NT / 2);         // o's (sub-block, pair of column tiles)
  constexpr int UPW = (UNITS + kWarps - 1) / kWarps;
  extern __shared__ __align__(128) unsigned char sm[];
  __nv_bfloat16* Rdh = reinterpret_cast<__nv_bfloat16*>(sm + Lay::kRd);
  __nv_bfloat16* Rdl = Rdh + CP * kLdB;
  __nv_bfloat16* Kdh = reinterpret_cast<__nv_bfloat16*>(sm + Lay::kKd);
  __nv_bfloat16* Kdl = Kdh + CP * kLdB;
  __nv_bfloat16* Rqh = reinterpret_cast<__nv_bfloat16*>(sm + Lay::kRq);
  __nv_bfloat16* Rql = Rqh + Lay::kRqRows * kLdB;
  __nv_bfloat16* Kqh = reinterpret_cast<__nv_bfloat16*>(sm + Lay::kKq);
  __nv_bfloat16* Kql = Kqh + kNQ * 16 * kLdB;
  float* Am = reinterpret_cast<float*>(sm + Lay::kA);
  __nv_bfloat16* Sh = reinterpret_cast<__nv_bfloat16*>(sm + Lay::kS);
  __nv_bfloat16* Sl = Sh + kRows * kLdV;
  float* us = reinterpret_cast<float*>(sm + Lay::kU);

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;       // mma fragment coordinates
  const int j0 = blockIdx.x * NC, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * T_len * N;
  const int vcols = min(NC, N - j0);           // the slice's columns

  // Both stages zeroed (the copies fill rows t < C and channels i < N only,
  // so the padding stays zero), a zeroed (its upper triangles are never
  // written), u.
  for (int e = tid; e < 2 * Lay::kStage / 16; e += kMmaThreads)
    reinterpret_cast<uint4*>(sm)[e] = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < CP * kLdA; e += kMmaThreads) Am[e] = 0.f;
  for (int i = tid; i < kRows; i += kMmaThreads) us[i] = i < N ? u[(size_t)h * N + i] : 0.f;
  __syncthreads();

  auto load_chunk = [&](int st, int t0) {
    unsigned char* sp = sm + st * Lay::kStage;
    __nv_bfloat16* rs = reinterpret_cast<__nv_bfloat16*>(sp);
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(sp + Lay::kStageK);
    __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(sp + Lay::kStageV);
    float* ws = reinterpret_cast<float*>(sp + Lay::kStageW);
    const size_t cb = base + (size_t)t0 * N;
    if (vec == 2) {                            // N = 64: whole rows, shifts only
      constexpr int V8 = NC / 8;
      for (int e = tid; e < C * 8; e += kMmaThreads) {
        const int t = e >> 3, q = e & 7;
        cp_async16(rs + t * kLdB + 8 * q, r + cb + (size_t)t * kRows + 8 * q);
        cp_async16(ks + t * kLdB + 8 * q, k + cb + (size_t)t * kRows + 8 * q);
      }
      for (int e = tid; e < C * 16; e += kMmaThreads) {
        const int t = e >> 4, q = e & 15;
        cp_async16(ws + t * kLdW + 4 * q, w + cb + (size_t)t * kRows + 4 * q);
      }
      for (int e = tid; e < C * V8; e += kMmaThreads) {
        const int t = e / V8, q = e % V8;
        cp_async16(vs + t * kLdV + 8 * q, v + cb + (size_t)t * kRows + j0 + 8 * q);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else if (vec) {                          // N % 8 == 0, 16-byte aligned bases
      const int n8 = N >> 3, n4 = N >> 2, v8 = vcols >> 3;
      for (int e = tid; e < C * n8; e += kMmaThreads) {
        const int t = e / n8, q = e - t * n8;
        cp_async16(rs + t * kLdB + 8 * q, r + cb + (size_t)t * N + 8 * q);
        cp_async16(ks + t * kLdB + 8 * q, k + cb + (size_t)t * N + 8 * q);
      }
      for (int e = tid; e < C * n4; e += kMmaThreads) {
        const int t = e / n4, q = e - t * n4;
        cp_async16(ws + t * kLdW + 4 * q, w + cb + (size_t)t * N + 4 * q);
      }
      for (int e = tid; e < C * v8; e += kMmaThreads) {
        const int t = e / v8, q = e - t * v8;
        cp_async16(vs + t * kLdV + 8 * q, v + cb + (size_t)t * N + j0 + 8 * q);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
      for (int e = tid; e < C * N; e += kMmaThreads) {
        const int t = e / N, i = e - t * N;
        rs[t * kLdB + i] = r[cb + e];
        ks[t * kLdB + i] = k[cb + e];
        ws[t * kLdW + i] = w[cb + e];
      }
      for (int e = tid; e < C * vcols; e += kMmaThreads) {
        const int t = e / vcols, q = e - t * vcols;
        vs[t * kLdV + q] = v[cb + (size_t)t * N + j0 + q];
      }
    }
  };

  // Warp wp holds the state's rows 16 sm .. 16 sm + 15 (sm = wp & 3) and
  // column tiles [sc NTS, sc NTS + NTS) (sc = wp >> 2): rows 16 sm + g (+ 8),
  // columns 8 j + 2c (+ 1).
  const int sm_ = wp & 3, sc = wp >> 2;
  float S[NTS][4];
#pragma unroll
  for (int j = 0; j < NTS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[j][e] = 0.f;

  const int nchunks = T_len / C;
  load_chunk(0, 0);
  for (int ci = 0; ci < nchunks; ++ci) {
    const int st = ci & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();                           // the chunk is in; the one before consumed
    if (ci + 1 < nchunks) load_chunk(st ^ 1, (ci + 1) * C);
    unsigned char* sp = sm + st * Lay::kStage;
    const __nv_bfloat16* rs = reinterpret_cast<const __nv_bfloat16*>(sp);
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(sp + Lay::kStageK);
    const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(sp + Lay::kStageV);
    float* ld = reinterpret_cast<float*>(sp + Lay::kStageW);

    // S0 as bf16 parts [i][j], the B operand of the inter-chunk product.
#pragma unroll
    for (int j = 0; j < NTS; ++j) {
      const int row = 16 * sm_ + g, col = 8 * (sc * NTS + j) + 2 * c;
      put2(Sh + row * kLdV + col, Sl + row * kLdV + col, S[j][0], S[j][1]);
      put2(Sh + (row + 8) * kLdV + col, Sl + (row + 8) * kLdV + col, S[j][2], S[j][3]);
    }
    log_decay_scan<CP>(ld, C, N, wp, lane);
    __syncthreads();

    // The operands, two channels an item (the 32 lanes of a warp share t):
    // r exp(logd[t-1]) and k exp(logd[C-1] - logd[t]) (logd past the
    // chunk's C tokens stays logd[C-1]); and the sub-blocks' factors through
    // e_q = 16 q + 15: k[t] exp(logd[e_q] - logd[t]) for t in sub-block q,
    // r[t] exp(logd[t-1] - logd[e_q]) for every q before t's sub-block.
    const float* llast = ld + (CP - 1) * kLdW;
#pragma unroll
    for (int it = 0; it < CP * 32 / kMmaThreads; ++it) {
      const int e = tid + it * kMmaThreads;
      const int t = e >> 5, i = 2 * (e & 31);
      const float2 rv = bf2(rs + t * kLdB + i), kv = bf2(ks + t * kLdB + i);
      const float2 lp = t > 0 ? *reinterpret_cast<const float2*>(ld + (t - 1) * kLdW + i)
                              : make_float2(0.f, 0.f);
      const float2 lt = *reinterpret_cast<const float2*>(ld + t * kLdW + i);
      const float2 ll = *reinterpret_cast<const float2*>(llast + i);
      put2(Rdh + t * kLdB + i, Rdl + t * kLdB + i, rv.x * ex2(lp.x), rv.y * ex2(lp.y));
      put2(Kdh + t * kLdB + i, Kdl + t * kLdB + i, kv.x * ex2(ll.x - lt.x),
           kv.y * ex2(ll.y - lt.y));
      const int qt = t >> 4;                   // t's sub-block
      if (qt < kNQ) {
        const float2 le = *reinterpret_cast<const float2*>(ld + (16 * qt + 15) * kLdW + i);
        put2(Kqh + t * kLdB + i, Kql + t * kLdB + i, kv.x * ex2(le.x - lt.x),
             kv.y * ex2(le.y - lt.y));
      }
#pragma unroll
      for (int q = 0; q < kNQ; ++q) {
        if (q < qt) {
          const float2 le = *reinterpret_cast<const float2*>(ld + (16 * q + 15) * kLdW + i);
          const int row = rq_off<CP>(q) + t - 16 * (q + 1);
          put2(Rqh + row * kLdB + i, Rql + row * kLdB + i, rv.x * ex2(lp.x - le.x),
               rv.y * ex2(lp.y - le.y));
        }
      }
    }
    // The diagonal sub-blocks of a, s < t, and the bonus on a's diagonal: a
    // lane takes rows kk and 15 - kk of sub-block d (15 pairs) over CPL
    // channels, the row's r and logd[t-1] in registers (row kk first, row
    // 15 - kk from the pair m = kk on), each pair's sum independent of the
    // others; then the G lanes of a row pair add theirs up by shuffles, all
    // pairs together.
    {
      constexpr int G = CP == 32 ? 16 : 8;     // lanes of a row pair
      constexpr int CPL = 64 / G;              // channels a lane
      const int d = CP == 32 ? (wp >> 2) : (wp >> 1);
      const int kk = CP == 32 ? (((wp & 3) << 1) + (lane >> 4))
                              : (((wp & 1) << 2) + (lane >> 3));
      const int gi = lane & (G - 1), i0 = gi * CPL;
      const int tA = 16 * d + kk, tB = 16 * d + 15 - kk;
      float rc[CPL], lc[CPL];                  // the current row: r[t], logd[t-1]
      auto load_row = [&](int t) {
        bf_load<CPL>(rs + t * kLdB + i0, rc);
        f_load<CPL>(ld + max(t - 1, 0) * kLdW + i0, lc);
      };
      float part[17];                          // 15 pairs, then the two rows' bonus
      load_row(tA);
#pragma unroll
      for (int m = 0; m < 15; ++m) {
        if (m == kk) load_row(tB);
        const int s = 16 * d + (m < kk ? m : m - kk);
        float kv[CPL], ls[CPL];
        bf_load<CPL>(ks + s * kLdB + i0, kv);
        f_load<CPL>(ld + s * kLdW + i0, ls);
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int e = 0; e < CPL; e += 2) {
          p0 += rc[e] * kv[e] * ex2(lc[e] - ls[e]);
          p1 += rc[e + 1] * kv[e + 1] * ex2(lc[e + 1] - ls[e + 1]);
        }
        part[m] = p0 + p1;
      }
#pragma unroll
      for (int m = 15; m < 17; ++m) {
        const int t = m == 15 ? tA : tB;
        float rv[CPL], kv[CPL];
        bf_load<CPL>(rs + t * kLdB + i0, rv);
        bf_load<CPL>(ks + t * kLdB + i0, kv);
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int e = 0; e < CPL; e += 2) {
          p0 += rv[e] * us[i0 + e] * kv[e];
          p1 += rv[e + 1] * us[i0 + e + 1] * kv[e + 1];
        }
        part[m] = p0 + p1;
      }
#pragma unroll
      for (int off = 1; off < G; off <<= 1)
#pragma unroll
        for (int m = 0; m < 17; ++m) part[m] += __shfl_xor_sync(kFull, part[m], off);
      if (gi == 0) {
#pragma unroll
        for (int m = 0; m < 17; ++m) {
          const int t = m < 15 ? (m < kk ? tA : tB) : (m == 15 ? tA : tB);
          const int s = m < 15 ? 16 * d + (m < kk ? m : m - kk) : t;
          Am[t * kLdA + s] = part[m];
        }
      }
    }
    __syncthreads();

    // The off-diagonal sub-blocks of a: (p, q), q < p, R_q K_q^T.
    {
      int job = 0;
#pragma unroll
      for (int q = 0; q < kNQ; ++q) {
#pragma unroll
        for (int p = q + 1; p < MT; ++p, ++job) {
          if ((job % kWarps) != wp) continue;
          float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          const int arow = rq_off<CP>(q) + 16 * (p - q - 1);
#pragma unroll
          for (int kq = 0; kq < 4; ++kq) {
            uint32_t ah[4], al[4], bh[4], bl[4];
            const int ar = arow + (lane & 7) + ((lane >> 3) & 1) * 8;
            const int ac = 16 * kq + (lane >> 4) * 8;
            ldsm_x4(smem_addr(Rqh + ar * kLdB + ac), ah);
            ldsm_x4(smem_addr(Rql + ar * kLdB + ac), al);
            const int br = 16 * q + (lane & 7) + (lane >> 4) * 8;
            const int bc = 16 * kq + ((lane >> 3) & 1) * 8;
            ldsm_x4(smem_addr(Kqh + br * kLdB + bc), bh);
            ldsm_x4(smem_addr(Kql + br * kLdB + bc), bl);
            mma(acc[0], ah, bh[0], bh[1]);
            mma(acc[0], ah, bl[0], bl[1]);
            mma(acc[0], al, bh[0], bh[1]);
            mma(acc[1], ah, bh[2], bh[3]);
            mma(acc[1], ah, bl[2], bl[3]);
            mma(acc[1], al, bh[2], bh[3]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int row = 16 * p + g, col = 16 * q + 8 * nt + 2 * c;
            *reinterpret_cast<float2*>(Am + row * kLdA + col) = make_float2(acc[nt][0], acc[nt][1]);
            *reinterpret_cast<float2*>(Am + (row + 8) * kLdA + col) =
                make_float2(acc[nt][2], acc[nt][3]);
          }
        }
      }
    }

    // o's units: a 16-row sub-block mt by a pair of 8-column tiles np; warp
    // wp takes units wp, wp + 8, ...  First o = (r exp(logd[t-1])) S0: A =
    // the operand's parts, B = S0's parts [i][j].
    float oacc[UPW][2][4];
#pragma unroll
    for (int q = 0; q < UPW; ++q)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[q][j][e] = 0.f;
#pragma unroll
    for (int q = 0; q < UPW; ++q) {
      const int unit = wp + kWarps * q;
      if (unit >= UNITS) break;
      const int mt = unit / (NT / 2), np = unit % (NT / 2);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        uint32_t ah[4], al[4], bh[4], bl[4];
        const int ar = 16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int ac = 16 * kq + (lane >> 4) * 8;
        ldsm_x4(smem_addr(Rdh + ar * kLdB + ac), ah);
        ldsm_x4(smem_addr(Rdl + ar * kLdB + ac), al);
        const int br = 16 * kq + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int bc = 16 * np + (lane >> 4) * 8;
        ldsm_x4_t(smem_addr(Sh + br * kLdV + bc), bh);
        ldsm_x4_t(smem_addr(Sl + br * kLdV + bc), bl);
        mma(oacc[q][0], ah, bh[0], bh[1]);
        mma(oacc[q][0], ah, bl[0], bl[1]);
        mma(oacc[q][0], al, bh[0], bh[1]);
        mma(oacc[q][1], ah, bh[2], bh[3]);
        mma(oacc[q][1], ah, bl[2], bl[3]);
        mma(oacc[q][1], al, bh[2], bh[3]);
      }
    }

    // S = exp(logd[C-1]) S + (k exp(logd[C-1] - logd[s]))^T v: A = the
    // operand^T (rows i) by transposed loads from [s][i], B = v [s][j].
    {
      const float d0 = ex2(llast[16 * sm_ + g]), d1 = ex2(llast[16 * sm_ + g + 8]);
#pragma unroll
      for (int j = 0; j < NTS; ++j) {
        S[j][0] *= d0;
        S[j][1] *= d0;
        S[j][2] *= d1;
        S[j][3] *= d1;
      }
#pragma unroll
      for (int kq = 0; kq < MT; ++kq) {
        uint32_t ah[4], al[4];
        const int mi = lane >> 3;
        const int ar = 16 * kq + (lane & 7) + (mi >> 1) * 8;
        const int ac = 16 * sm_ + (mi & 1) * 8;
        ldsm_x4_t(smem_addr(Kdh + ar * kLdB + ac), ah);
        ldsm_x4_t(smem_addr(Kdl + ar * kLdB + ac), al);
        const int br = 16 * kq + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int j = 0; j < NTS; j += 2) {
          uint32_t bx[4];       // tiles j and j + 1 (the next 8 columns are padding at NTS = 1)
          ldsm_x4_t(smem_addr(vs + br * kLdV + 8 * (sc * NTS + j) + (lane >> 4) * 8), bx);
          mma(S[j], ah, bx[0], bx[1]);
          mma(S[j], al, bx[0], bx[1]);
          if (j + 1 < NTS) {
            mma(S[j + 1], ah, bx[2], bx[3]);
            mma(S[j + 1], al, bx[2], bx[3]);
          }
        }
      }
    }
    __syncthreads();                           // a is complete

    // o += a v over the causal sub-blocks kq <= mt: a's rows split into
    // bf16 parts as the A operand, B = v [s][j]; then o to device memory.
#pragma unroll
    for (int q = 0; q < UPW; ++q) {
      const int unit = wp + kWarps * q;
      if (unit >= UNITS) break;
      const int mt = unit / (NT / 2), np = unit % (NT / 2);
#pragma unroll
      for (int kq = 0; kq < MT; ++kq) {
        if (kq > mt) break;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s0 = 16 * kq + 8 * half + 2 * c;
          const float2 a0 = *reinterpret_cast<const float2*>(Am + (16 * mt + g) * kLdA + s0);
          const float2 a1 =
              *reinterpret_cast<const float2*>(Am + (16 * mt + g + 8) * kLdA + s0);
          split2(a0.x, a0.y, ah[2 * half], al[2 * half]);
          split2(a1.x, a1.y, ah[2 * half + 1], al[2 * half + 1]);
        }
        const int br = 16 * kq + (lane & 7) + ((lane >> 3) & 1) * 8;
        uint32_t bx[4];
        ldsm_x4_t(smem_addr(vs + br * kLdV + 16 * np + (lane >> 4) * 8), bx);
        mma(oacc[q][0], ah, bx[0], bx[1]);
        mma(oacc[q][0], al, bx[0], bx[1]);
        mma(oacc[q][1], ah, bx[2], bx[3]);
        mma(oacc[q][1], al, bx[2], bx[3]);
      }
      const size_t ob = base + (size_t)ci * C * N;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = j0 + 16 * np + 8 * j + 2 * c;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = 16 * mt + g + 8 * hr;
          if (t < C && col < N) {
            __nv_bfloat16* dst = o + ob + (size_t)t * N + col;
            const float v0 = oacc[q][j][2 * hr], v1 = oacc[q][j][2 * hr + 1];
            if (col + 1 < N && (N & 1) == 0) {
              *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
            } else {
              dst[0] = __float2bfloat16(v0);
              if (col + 1 < N) dst[1] = __float2bfloat16(v1);
            }
          }
        }
      }
    }
  }

  float* so = s_out + ((size_t)b * H + h) * N * N;
#pragma unroll
  for (int j = 0; j < NTS; ++j) {
    const int col = j0 + 8 * (sc * NTS + j) + 2 * c;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = 16 * sm_ + g + 8 * hr;
      if (i < N && col < N) so[(size_t)i * N + col] = S[j][2 * hr];
      if (i < N && col + 1 < N) so[(size_t)i * N + col + 1] = S[j][2 * hr + 1];
    }
  }
}

template <int CP, int NC>
int launch_mma(const void* r, const void* k, const void* v, const void* w, const void* u,
               void* o, void* s, int B, int H, int T_len, int N, int C, int smem,
               cudaStream_t stream) {
  if (smem != Layout<CP, NC>::kBytes) return (int)cudaErrorInvalidValue;
  static bool attr = false;                 // the attribute, once per instance
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(rwkv6_mma_kernel<CP, NC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  // 16-byte copies for rows of whole 16-byte pieces from aligned bases;
  // 2: N = 64, the loader's indices by shifts.
  const int vec = (N % 8 == 0 && aligned(r) && aligned(k) && aligned(v) && aligned(w))
                      ? (N == kRows ? 2 : 1) : 0;
  rwkv6_mma_kernel<CP, NC><<<dim3((N + NC - 1) / NC, H, B), kMmaThreads, smem, stream>>>(
      (const __nv_bfloat16*)r, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)w, (const float*)u, (__nv_bfloat16*)o, (float*)s, H, T_len, N, C, vec);
  return (int)cudaGetLastError();
}

int launch_fma(const void* r, const void* k, const void* v, const void* w, const void* u,
               void* o, void* s, int B, int H, int T_len, int N, int C, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)N * N + 3 * (size_t)C * (N + 1) +
                                       (size_t)C * N + (size_t)C * C + C + N);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_scan_kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w, (const float*)u,
      (float*)o, (float*)s, H, T_len, N, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core
// kernel, with kernel.py's cols_plan: columns a block and shared memory a
// block, which this side checks against its layout).  The wrapper has
// checked the shapes, 0 < N <= 64, 0 < C <= 64, T % C == 0 and T > 0.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* o, void* s, int B,
                                 int H, int T_len, int N, int C, int dtype,
                                 int cols_per_block, int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_fma(r, k, v, w, u, o, s, B, H, T_len, N, C, st);
#define K7_LAUNCH(NC)                                                                    \
  (C > 32 ? launch_mma<64, NC>(r, k, v, w, u, o, s, B, H, T_len, N, C, smem, st)        \
          : launch_mma<32, NC>(r, k, v, w, u, o, s, B, H, T_len, N, C, smem, st))
  switch (cols_per_block) {
    case 16: return K7_LAUNCH(16);
    case 64: return K7_LAUNCH(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K7_LAUNCH
}
