// K6: SPARTA paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/paged_attention/
// kernel.py: _paged_kernel (paged_attention_pallas), the attention of every
// layer of the serving engine's decode step.  One new query token per
// sequence, q [B, Hq, D] (float32 or bfloat16), attends over a paged KV pool
// k_pool, v_pool [slots, page, Hkv, D] (float32) through a block table
// [B, pages] int32 (logical page -> pool slot, -1 = unmapped) and ctx_len
// [B]: position t of sequence b is valid when t < ctx_len[b] and
// table[b, t / page] >= 0.  The result is the flash residuals in float32,
// acc [B, Hq, D] (un-normalised), m and l [B, Hq]; a sequence with no valid
// position returns m = -1e30, l = 0, acc = 0, which merge_partials (the
// decode path's hot-tail merge) needs.  This is paged_attention_ref of
// ref.py with return_residuals.
//
// The paper's idea in the kernel: the block table is the per-partition page
// table, and translation rides with the fetch.  On the TPU the table is a
// scalar-prefetch operand whose values program the DMA of the KV page.
// Here a block reads its own row of the table: each lane of a warp owns one
// key of the 32-key tile and translates it (its page's slot), and the lanes
// read the slots of the warp's next tile before this tile is fetched and
// computed, so the lookup for page p + 1 is in flight while page p is.
// Tiles whose keys are all invalid (past ctx, or on an unmapped page) are
// not loaded.
//
// Layout: one block per (sequence, KV head), so the G = Hq / Hkv query heads
// that share a KV head share each K and V row read from device memory.  The
// block's warps split the keys (warp w takes tiles w, w + W, ...), each with
// its own (m, l, acc) for all G heads in registers and its own K and V tile
// in shared memory, copied with cp.async (all of a tile's 16-byte copies in
// flight at once; K rows padded to D + 4 floats, so the lanes' float4 reads
// of their keys' rows hit distinct banks); at the end the warps' partials
// are merged through shared memory exactly as merge_partials merges
// partitions.
//
// Bound on this card: decode attention reads the whole valid KV of every
// sequence once (2 * ctx * Hkv * D * 4 bytes) and does 4 * ctx * Hq * D
// FLOPs, about one FLOP per byte: bytes-bound at 3.35 TB/s.  This first
// kernel runs B * Hkv blocks, 32 at the engine's batch of 4 on qwen3-14b's
// 8 KV heads, on a card of 132 SMs, and a warp's chain of dependent
// shared-memory reads, shuffles and exponentials is latency-bound: on the
// H100 the kernel's time falls nearly as 1 / (warps per block), so the block
// takes as many warps as shared memory holds, up to 8 (6 at D = 128, 3 at
// D = 256).  A second, double-buffered stage per warp gained nothing at
// equal warps and halved the warps shared memory holds.  Splitting the pages
// of a sequence over more blocks and merging their residuals (as the
// cross-partition merge does) is the next step (ROADMAP.md).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                 // keys per warp tile, one per lane
constexpr int kMaxWarps = 8;
constexpr int kSmemLimit = 227 * 1024;    // shared memory a block may use
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// The slot of key `kpos` of sequence `trow`, or -1 if the key is not valid.
__device__ __forceinline__ int translate(const int32_t* __restrict__ trow, int kpos,
                                         int n_keys, int page) {
  return kpos < n_keys ? trow[kpos / page] : -1;
}

// 16-byte asynchronous copy from device memory to shared memory (sm_80+),
// bypassing L1; completion is tracked per thread by commit groups.
__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy one 32-key tile into shared memory (K rows of D + 4 floats, 16-byte
// aligned; V rows of D floats), all copies in flight at once: row j is
// pool[slot_j, kpos_j % page, h, :] for the slot lane j translated, and an
// invalid key gets zero rows.
__device__ __forceinline__ void stage_tile(float* ks, float* vs, const float* k_pool,
                                           const float* v_pool, int slot, int k0, int lane,
                                           int D, int page, size_t row_stride, int h) {
  const int d4 = D >> 2;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = lane; e < kTile * d4; e += 32) {
    const int j = e / d4, c = e - j * d4;
    const int sj = __shfl_sync(kFull, slot, j);
    float* dk = ks + j * (D + 4) + 4 * c;
    float* dv = vs + j * D + 4 * c;
    if (sj >= 0) {
      const size_t off = ((size_t)sj * page + (k0 + j) % page) * row_stride +
                         (size_t)h * D + 4 * c;
      cp_async16(dk, k_pool + off);
      cp_async16(dv, v_pool + off);
    } else {
      *reinterpret_cast<float4*>(dk) = zero;
      *reinterpret_cast<float4*>(dv) = zero;
    }
  }
  cp_async_commit();
}

// MAXG: query heads per KV head (G <= MAXG); MAXPER: accumulator columns
// per lane (D <= 32 * MAXPER).
template <typename T, int MAXG, int MAXPER>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int32_t* __restrict__ table,
    const int32_t* __restrict__ ctx_len, float* __restrict__ o_acc,
    float* __restrict__ o_m, float* __restrict__ o_l, int Hq, int Hkv, int D,
    int page, int pages, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int G = Hq / Hkv;
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  float* qs = smem;                                       // [G][D]
  float* tiles = qs + G * D;
  float* ks = tiles + (size_t)warp * kTile * (2 * D + 4);  // [kTile][D + 4]
  float* vs = ks + kTile * (D + 4);                         // [kTile][D]

  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int e = tid; e < G * D; e += blockDim.x) qs[e] = to_f32(qb[e]);
  __syncthreads();

  const int32_t* trow = table + (size_t)b * pages;
  const int n_keys = min(ctx_len[b], pages * page);
  const size_t row_stride = (size_t)Hkv * D;              // between tokens of a page

  float m[MAXG], l[MAXG], acc[MAXG][MAXPER];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < MAXPER; ++i) acc[g][i] = 0.f;
  }

  // Warp w takes tiles k0 = 32 w, 32 (w + W), ...; the table lookups of its
  // next tile are issued before this tile is fetched and computed.
  const int kstep = warps * kTile;
  int k0 = warp * kTile;
  int slot = translate(trow, k0 + lane, n_keys, page);
  for (; k0 < n_keys; k0 += kstep) {
    const int slot_next = translate(trow, k0 + kstep + lane, n_keys, page);
    const bool valid = slot >= 0;
    if (__ballot_sync(kFull, valid)) {
      stage_tile(ks, vs, k_pool, v_pool, slot, k0, lane, D, page, row_stride, h);
      cp_async_wait<0>();
      __syncwarp();

      const float* krow = ks + lane * (D + 4);
      float s[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
      for (int d = 0; d < D; d += 4) {    // D % 8 == 0
        const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + g * D + d);
            s[g] = fmaf(qv.x, kv.x, s[g]);
            s[g] = fmaf(qv.y, kv.y, s[g]);
            s[g] = fmaf(qv.z, kv.z, s[g]);
            s[g] = fmaf(qv.w, kv.w, s[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;                // G is uniform over the block
        const float sg = valid ? s[g] * scale : kNegInf;
        const float m_new = fmaxf(m[g], warp_max(sg));
        const float alpha = expf(m[g] - m_new);
        const float p = valid ? expf(sg - m_new) : 0.f;
        l[g] = l[g] * alpha + warp_sum(p);
#pragma unroll
        for (int i = 0; i < MAXPER; ++i) acc[g][i] *= alpha;
        m[g] = m_new;
        s[g] = p;
      }
      for (int j = 0; j < kTile; ++j) {
        float pj[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) pj[g] = __shfl_sync(kFull, s[g], j);
        const float* vrow = vs + j * D;
#pragma unroll
        for (int i = 0; i < MAXPER; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            const float vd = vrow[d];
#pragma unroll
            for (int g = 0; g < MAXG; ++g) {
              if (g < G) acc[g][i] = fmaf(pj[g], vd, acc[g][i]);
            }
          }
        }
      }
      __syncwarp();                         // the tile is consumed before it refills
    }
    slot = slot_next;
  }

  // Merge the warps' partials: the tiles are free now.
  __syncthreads();
  float* red_m = tiles;                     // [warps][G]
  float* red_l = red_m + warps * G;         // [warps][G]
  float* red_acc = red_l + warps * G;       // [warps][G][D]
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      if (lane == 0) {
        red_m[warp * G + g] = m[g];
        red_l[warp * G + g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < MAXPER; ++i) {
        const int d = lane + 32 * i;
        if (d < D) red_acc[((size_t)warp * G + g) * D + d] = acc[g][i];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e - g * D;
    float mx = kNegInf;
    for (int w = 0; w < warps; ++w) mx = fmaxf(mx, red_m[w * G + g]);
    float a = 0.f, ls = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float alpha = expf(red_m[w * G + g] - mx);
      a += red_acc[((size_t)w * G + g) * D + d] * alpha;
      ls += red_l[w * G + g] * alpha;
    }
    const size_t row = (size_t)b * Hq + (size_t)h * G + g;
    o_acc[row * D + d] = a;
    if (d == 0) {
      o_m[row] = mx;
      o_l[row] = ls;
    }
  }
}

template <typename T, int MAXG, int MAXPER>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
           const void* ctx, void* o_acc, void* o_m, void* o_l, int B, int Hq, int Hkv,
           int D, int page, int pages, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t per_warp = sizeof(float) * (size_t)kTile * (2 * D + 4);
  const size_t q_bytes = sizeof(float) * (size_t)G * D;
  int warps = (int)((kSmemLimit - q_bytes) / per_warp);
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = q_bytes + warps * per_warp;
  cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T, MAXG, MAXPER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_attention_kernel<T, MAXG, MAXPER><<<dim3(Hkv, B), 32 * warps, smem, stream>>>(
      (const T*)q, (const float*)k_pool, (const float*)v_pool, (const int32_t*)table,
      (const int32_t*)ctx, (float*)o_acc, (float*)o_m, (float*)o_l, Hq, Hkv, D, page,
      pages, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* table,
             const void* ctx, void* o_acc, void* o_m, void* o_l, int B, int Hq, int Hkv,
             int D, int page, int pages, float scale, cudaStream_t s) {
  const int G = Hq / Hkv;
#define K6_CASE(MG, MP)                                                              \
  return launch<T, MG, MP>(q, k_pool, v_pool, table, ctx, o_acc, o_m, o_l, B, Hq, Hkv, \
                           D, page, pages, scale, s)
  if (D <= 128) {
    if (G <= 1) K6_CASE(1, 4);
    if (G <= 2) K6_CASE(2, 4);
    if (G <= 4) K6_CASE(4, 4);
    if (G <= 8) K6_CASE(8, 4);
    if (G <= 16) K6_CASE(16, 4);
  } else {
    if (G <= 1) K6_CASE(1, 8);
    if (G <= 2) K6_CASE(2, 8);
    if (G <= 4) K6_CASE(4, 8);
    if (G <= 8) K6_CASE(8, 8);
  }
#undef K6_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16.  The wrapper has checked D % 8 == 0,
// D <= 256, Hq % Hkv == 0, G <= 16 (G <= 8 above D = 128) and non-empty
// shapes.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* ctx, void* o_acc, void* o_m,
                                      void* o_l, int B, int Hq, int Hkv, int D,
                                      int page, int pages, float scale, int q_dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0) {
    return dispatch<float>(q, k_pool, v_pool, table, ctx, o_acc, o_m, o_l, B, Hq, Hkv, D,
                           page, pages, scale, s);
  }
  return dispatch<__nv_bfloat16>(q, k_pool, v_pool, table, ctx, o_acc, o_m, o_l, B, Hq,
                                 Hkv, D, page, pages, scale, s);
}
