// K5: flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention/
// kernel.py: _flash_kernel (flash_attention_pallas), the attention of every
// layer of the serving engine's prefill.  q [B, Hq, Tq, D] and k, v
// [B, Hkv, Tk, D], contiguous, all float32 or all bfloat16; query head h
// reads KV head h / (Hq / Hkv).  Blocked online softmax with float32
// statistics (m, l, acc): per KV tile,
//   s = (q . k) * scale, masked to NEG_INF = -1e30 where the key is past Tk
//       or (causal) past the query's decode-aligned position i + Tk - Tq
//   m' = max(m, max s);  p = exp(s - m') (0 where masked)
//   l = l * exp(m - m') + sum p;  acc = acc * exp(m - m') + p @ v
// and o = acc / l (0 where l == 0), stored in q's dtype.  This is
// flash_attention_ref of ref.py, whose arithmetic is float32 throughout.
//
// Layout: the TPU grid (B, Hq, Tq/Bq, Tk/Bk) walks KV blocks sequentially
// with (m, l, acc) in VMEM scratch that persists across grid steps.  CUDA
// blocks do not carry state, so one block of 4 warps takes 32 query rows of
// one (batch, head) and loops over the KV tiles itself; tiles wholly above
// the causal diagonal of its last row are never loaded (the loop ends).
// Each warp owns 8 query rows; a tile has 32 keys, one per lane.  The query
// tile and the K and V tiles are staged through shared memory as float32
// (bf16 is converted once on load); K rows are padded to D + 1 floats so
// the 32 lanes' column reads hit 32 banks.  A lane scores its key against
// the warp's 8 rows (the rows are read as float4 broadcasts), the warp
// reduces max and sum with shuffles, and in the P @ V step each lane owns
// the columns lane, lane + 32, ... of its rows' accumulators, in registers.
//
// Bound on this card: a prefill of T tokens does 2 * 2 * Hq * T^2 / 2 * D
// FLOPs causal, far above the bytes it moves (each of q, k, v, o once), so
// the bound is the tensor cores' rate.  This first kernel does the
// products on the float32 cores (exact for the float32 engine runs, and
// simple), so it sits well above that bound; wgmma on bf16 tiles fed by
// TMA is the next step (ROADMAP.md).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;                  // query rows per warp
constexpr int kBlockQ = kWarps * kRows;   // query rows per block
constexpr int kBlockK = 32;               // keys per tile, one per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// MAXPER: accumulator columns per lane (D <= 32 * MAXPER).
template <typename T, int MAXPER>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Hq, int Hkv, int Tq, int Tk, int D, float scale,
    int causal) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                         // [kBlockQ][D]
  float* ks = qs + kBlockQ * D;             // [kBlockK][D + 1]
  float* vs = ks + kBlockK * (D + 1);       // [kBlockK][D]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_base = ((size_t)b * Hq + h) * Tq * D;
  const size_t kv_base = ((size_t)b * Hkv + hk) * Tk * D;
  const int shift = Tk - Tq;                // decode alignment

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D;
    qs[e] = q0 + r < Tq ? to_f32(q[q_base + (size_t)q0 * D + e]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][MAXPER];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < MAXPER; ++i) acc[r][i] = 0.f;
  }

  // Keys past the last row's diagonal are masked for every row: stop there.
  const int last_q = min(q0 + kBlockQ, Tq) - 1;
  const int k_end = causal ? min(Tk, last_q + shift + 1) : Tk;
  const float* qrow = qs + warp * kRows * D;
  const float* krow = ks + lane * (D + 1);

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();                        // the previous tile is consumed
#pragma unroll 4
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int j = e / D, d = e - j * D;
      const bool in = k0 + j < Tk;
      const size_t g = kv_base + (size_t)k0 * D + e;
      ks[j * (D + 1) + d] = in ? to_f32(k[g]) : 0.f;
      vs[e] = in ? to_f32(v[g]) : 0.f;      // padded V rows are 0, never NaN
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    for (int d = 0; d < D; d += 4) {        // D % 8 == 0
      const float k_0 = krow[d], k_1 = krow[d + 1], k_2 = krow[d + 2], k_3 = krow[d + 3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + r * D + d);
        s[r] = fmaf(qv.x, k_0, s[r]);
        s[r] = fmaf(qv.y, k_1, s[r]);
        s[r] = fmaf(qv.z, k_2, s[r]);
        s[r] = fmaf(qv.w, k_3, s[r]);
      }
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + warp * kRows + r;
      const bool valid = kpos < Tk && (!causal || kpos <= qi + shift);
      const float sr = valid ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);
      const float p = valid ? expf(sr - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < MAXPER; ++i) acc[r][i] *= alpha;
      m[r] = m_new;
      s[r] = p;                             // this lane's probability
    }

    const int nk = min(kBlockK, Tk - k0);
    for (int j = 0; j < nk; ++j) {
      float pj[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pj[r] = __shfl_sync(kFull, s[r], j);
      const float* vrow = vs + j * D;
#pragma unroll
      for (int i = 0; i < MAXPER; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float vd = vrow[d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][i] = fmaf(pj[r], vd, acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi < Tq) {
      const float denom = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
      for (int i = 0; i < MAXPER; ++i) {
        const int d = lane + 32 * i;
        if (d < D) store(o + q_base + (size_t)qi * D + d, acc[r][i] / denom);
      }
    }
  }
}

template <typename T, int MAXPER>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
           int Hkv, int Tq, int Tk, int D, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kBlockQ * D + (size_t)kBlockK * (D + 1) +
                                       (size_t)kBlockK * D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, MAXPER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_fwd_kernel<T, MAXPER><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hkv, Tq, Tk, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The wrapper has checked D % 8 == 0,
// D <= 256, Hq % Hkv == 0 and non-empty shapes.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int Hq, int Hkv, int Tq, int Tk,
                                      int D, float scale, int causal, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return D <= 128 ? launch<float, 4>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, s)
                    : launch<float, 8>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, s);
  }
  return D <= 128
             ? launch<__nv_bfloat16, 4>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, s)
             : launch<__nv_bfloat16, 8>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, s);
}
