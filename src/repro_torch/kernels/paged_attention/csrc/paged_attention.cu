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
// key of the 32-key tile, translates it (its page's slot and the row's
// offset in the pool) and issues that row's copy itself, and the lanes
// translate the keys of the warp's next tile while this tile's copies are
// in flight, so the lookup for page p + 1 rides with the fetch of page p.
// Tiles whose keys are all invalid (past ctx, or on an unmapped page) are
// not loaded.
//
// Bound on this card: decode attention reads the whole valid KV of every
// sequence once (2 * ctx * Hkv * D * 4 bytes) and does 4 * ctx * Hq * D
// FLOPs, about one FLOP per byte: it is bound by bytes, 3.35 TB/s.  Reaching
// that takes enough bytes in flight on every SM.  One block per (sequence,
// KV head), the first design, ran 32 blocks at qwen3-14b's batch of 4 and
// 8 KV heads on a card of 132 SMs and moved ~166 GB/s (chip_smoke.py).  So the grid is
// (split, KV head, sequence): the wrapper's split_plan (kernel.py) cuts each
// sequence's table into `splits` contiguous ranges of whole 32-key tiles
// from the shapes alone (it never reads ctx_len, which would cost a sync a
// layer), enough for two or more blocks on every SM and about two tiles a
// warp (qwen3-14b at batch 4, nine pages: 12 ranges, 384 blocks of 3 warps).  A block
// whose range starts at or past ctx_len writes the empty partial and exits.
// A table whose tiles fit one block's warps runs unsplit when the (sequence,
// KV head) blocks already fill half the card (zamba2-7b's decode: 128 blocks
// of 6 warps), where a merge would cost more than the split saves.  Inside a
// block the warps take tiles w, w + W, ..., each with its own (m, l, acc)
// for the G = Hq / Hkv query heads that share the KV head (so each K and V
// row read from device memory serves G heads; qwen3's G = 5 has an instance
// of its own, so the guards on g < G fold away) and its own K and V tile in
// shared memory.  A tile's rows arrive by bulk copies (cp.async.bulk, the
// copy engine Hopper's TMA drives: one instruction a 512-byte row, counted
// by an mbarrier a buffer) instead of 16-byte cp.async copies, 64
// instructions a warp a tile.  K rows are padded to D + 4 floats, so the
// lanes' float4 reads of their keys' rows hit distinct banks.  K and V have
// a barrier each, so the scores of a tile are computed while its V rows
// arrive and its P V while the next tile's K rows arrive: the two buffers
// take turns, and a warp keeps a copy in flight at no cost in shared memory
// (a second full stage would halve the warps shared memory holds).  The
// warps' partials are merged through shared memory, and with more than one
// split a second small kernel merges the splits' partials exactly as
// merge_partials merges partitions, on the card (a block a row, its warps
// taking the splits in turn).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                 // keys per warp tile, one per lane
constexpr int kMaxWarps = 8;              // a warp a tile of an unsplit table
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

// The pool offset (in floats) of key `kpos`'s row for KV head h, or -1 if
// the key is not valid (past n_keys, or on an unmapped page).
__device__ __forceinline__ long long translate(const int32_t* __restrict__ trow, int kpos,
                                               int n_keys, int page, long long row_stride,
                                               long long head_off) {
  if (kpos >= n_keys) return -1;
  const int pg = kpos / page;
  const int slot = trow[pg];
  if (slot < 0) return -1;
  return ((long long)slot * page + (kpos - pg * page)) * row_stride + head_off;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// Bulk copies: lane j copies key j's row (D floats) with one
// cp.async.bulk counted by the barrier; a lane whose key is invalid zeroes
// its row instead.
__device__ __forceinline__ void bulk_rows(float* dst, int ld, const float* pool, long long off,
                                          int lane, int D, uint32_t bar) {
  const unsigned valid = __ballot_sync(kFull, off >= 0);
  if (lane == 0) mbar_expect_tx(bar, __popc(valid) * D * 4);
  __syncwarp();
  float* row = dst + lane * ld;
  if (off >= 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(row)),
        "l"(pool + off), "r"(D * 4), "r"(bar)
        : "memory");
  } else {
    for (int c = 0; c < D; c += 4)
      *reinterpret_cast<float4*>(row + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Shared memory of one block: q [G][D], then per warp a K tile
// [32][D + 4], a V tile [32][D], the tile's probabilities [G][32] and the
// two tiles' mbarriers (16 bytes).
__host__ __device__ inline size_t warp_floats(int D, int G) {
  return (size_t)kTile * (2 * D + 4) + (size_t)kTile * G + 4;
}
__host__ __device__ inline size_t block_smem(int D, int G, int warps) {
  return sizeof(float) * ((size_t)G * D + warps * warp_floats(D, G));
}

// MAXG: query heads per KV head (G <= MAXG, G == MAXG when EXACT: the
// guards on g < G fold away); NC4: float4 columns of the accumulator per
// lane (D <= 128 * NC4).  Grid (splits, Hkv, B).  With
// splits == 1 the block writes the residuals; else it writes its split's
// partial, acc to part_acc [splits][B * Hq][D] and m, l to
// part_m, part_l [splits][B * Hq].
template <typename T, int MAXG, int NC4, bool EXACT>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int32_t* __restrict__ table,
    const int32_t* __restrict__ ctx_len, float* __restrict__ o_acc,
    float* __restrict__ o_m, float* __restrict__ o_l, int B, int Hq, int Hkv, int D,
    int page, int pages, float scale, int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int G = EXACT ? MAXG : Hq / Hkv;
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t part = (size_t)split * B * Hq;              // this split's rows
  const size_t row0 = (size_t)b * Hq + (size_t)h * G;      // first output row
  float* acc_out = o_acc + (part + row0) * D;
  float* m_out = o_m + part + row0;
  float* l_out = o_l + part + row0;

  const int n_keys = min(ctx_len[b], pages * page);
  const int tile0 = split * tiles_per_split;
  const int tile_end = min(tile0 + tiles_per_split, (n_keys + kTile - 1) / kTile);
  if (tile0 >= tile_end) {                  // the range starts past ctx: empty partial
    for (int e = tid; e < G * D; e += blockDim.x) acc_out[e] = 0.f;
    for (int g = tid; g < G; g += blockDim.x) {
      m_out[g] = kNegInf;
      l_out[g] = 0.f;
    }
    return;
  }

  float* qs = smem;                                             // [G][D]
  float* tiles = qs + G * D;
  float* ks = tiles + (size_t)warp * warp_floats(D, G);         // [32][D + 4]
  float* vs = ks + kTile * (D + 4);                             // [32][D]
  float* ps = vs + kTile * D;                                   // [G][32]
  const uint32_t bar_k = smem_u32(ps + kTile * G), bar_v = bar_k + 8;
  if (lane == 0) {
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  uint32_t ph_k = 0, ph_v = 0;

  const T* qb = q + row0 * D;
  for (int e = tid; e < G * D; e += blockDim.x) qs[e] = to_f32(qb[e]);
  __syncthreads();

  const int32_t* trow = table + (size_t)b * pages;
  const long long row_stride = (long long)Hkv * D;             // between tokens of a page
  const long long head_off = (long long)h * D;
  const int d4 = D >> 2;

  float m[MAXG], l[MAXG];
  float4 acc[MAXG][NC4];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NC4; ++i) acc[g][i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // Warp w takes tiles tile0 + w, tile0 + w + W, ... of the block's range,
  // K and V of a tile under a barrier each: the scores of tile i are
  // computed while its V rows arrive, and P V of tile i while the K rows of
  // tile i + 1 arrive.  The table lookups of tile i + 1 are issued while
  // tile i's copies are in flight.  A tile without a valid key is neither
  // copied nor computed (no copy is issued, no barrier waited on).  The
  // __syncwarp()s between a buffer's reads and its next copies also make a
  // lane's zeroed rows visible to the others.
  const int k_end = tile_end * kTile;
  const int kstep = warps * kTile;
  int k0 = (tile0 + warp) * kTile;
  long long off = k0 < k_end ? translate(trow, k0 + lane, n_keys, page, row_stride, head_off)
                             : -1;
  bool any = __ballot_sync(kFull, off >= 0) != 0;
  if (any) bulk_rows(ks, D + 4, k_pool, off, lane, D, bar_k);
  if (any) bulk_rows(vs, D, v_pool, off, lane, D, bar_v);
  for (; k0 < k_end; k0 += kstep) {
    const int kn = k0 + kstep;
    const long long off_next =
        kn < k_end ? translate(trow, kn + lane, n_keys, page, row_stride, head_off) : -1;
    const bool any_next = __ballot_sync(kFull, off_next >= 0) != 0;
    const bool valid = off >= 0;
    if (any) {
      mbar_wait(bar_k, ph_k);               // tile i's K rows have landed
      ph_k ^= 1;
      // Scores: lane j takes key j of the tile.
      const float* krow = ks + lane * (D + 4);
      float s[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {      // D % 8 == 0
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
      // Online softmax per head; the tile's probabilities go to shared memory.
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float sg = valid ? s[g] * scale : kNegInf;
          const float m_new = fmaxf(m[g], warp_max(sg));
          const float alpha = expf(m[g] - m_new);
          const float p = valid ? expf(sg - m_new) : 0.f;
          l[g] = l[g] * alpha + warp_sum(p);
#pragma unroll
          for (int i = 0; i < NC4; ++i) {
            acc[g][i].x *= alpha;
            acc[g][i].y *= alpha;
            acc[g][i].z *= alpha;
            acc[g][i].w *= alpha;
          }
          m[g] = m_new;
          ps[g * kTile + lane] = p;
        }
      }
    }
    __syncwarp();                           // K consumed, P written
    if (any_next) bulk_rows(ks, D + 4, k_pool, off_next, lane, D, bar_k);
    if (any) {
      mbar_wait(bar_v, ph_v);               // tile i's V rows have landed
      ph_v ^= 1;
      // acc += P V: lane owns the float4 columns lane, lane + 32, ...; four
      // keys at a time, their V rows in registers, P read as a float4.
#pragma unroll 1
      for (int j = 0; j < kTile; j += 4) {
        float4 v[4][NC4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int i = 0; i < NC4; ++i) {
            const int c = lane + 32 * i;
            v[jj][i] = c < d4 ? *reinterpret_cast<const float4*>(vs + (j + jj) * D + 4 * c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float4 p4 = *reinterpret_cast<const float4*>(ps + g * kTile + j);
            const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
              for (int i = 0; i < NC4; ++i) {
                acc[g][i].x = fmaf(pj[jj], v[jj][i].x, acc[g][i].x);
                acc[g][i].y = fmaf(pj[jj], v[jj][i].y, acc[g][i].y);
                acc[g][i].z = fmaf(pj[jj], v[jj][i].z, acc[g][i].z);
                acc[g][i].w = fmaf(pj[jj], v[jj][i].w, acc[g][i].w);
              }
            }
          }
        }
      }
    }
    __syncwarp();                           // V and P consumed
    if (any_next) bulk_rows(vs, D, v_pool, off_next, lane, D, bar_v);
    off = off_next;
    any = any_next;
  }
  if (lane == 0) {
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar_k) : "memory");
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar_v) : "memory");
  }
  __syncwarp();

  if (warps == 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        if (lane == 0) {
          m_out[g] = m[g];
          l_out[g] = l[g];
        }
#pragma unroll
        for (int i = 0; i < NC4; ++i) {
          const int c = lane + 32 * i;
          if (c < d4) *reinterpret_cast<float4*>(acc_out + g * D + 4 * c) = acc[g][i];
        }
      }
    }
    return;
  }

  // Merge the warps' partials: the tiles are free now.
  __syncthreads();
  float* red_m = tiles;                     // [warps][G]
  float* red_l = red_m + warps * G;         // [warps][G]
  float* red_acc = red_l + warps * G;       // [warps][G][D], 16-byte aligned (G even or not:
                                            // written as scalars below)
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      if (lane == 0) {
        red_m[warp * G + g] = m[g];
        red_l[warp * G + g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < NC4; ++i) {
        const int c = lane + 32 * i;
        if (c < d4) {
          float* dst = red_acc + ((size_t)warp * G + g) * D + 4 * c;
          dst[0] = acc[g][i].x;
          dst[1] = acc[g][i].y;
          dst[2] = acc[g][i].z;
          dst[3] = acc[g][i].w;
        }
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
    acc_out[e] = a;
    if (d == 0) {
      m_out[g] = mx;
      l_out[g] = ls;
    }
  }
}

// The splits' partials [splits][rows][D] (+ m, l [splits][rows]) merged as
// merge_partials merges partitions, left as residuals against the merged m:
// one block of kMergeWarps warps per output row (b, query head); warp w sums
// splits w, w + kMergeWarps, ... (lane: float4 columns lane, lane + 32), and
// the warps' sums are added through shared memory.
constexpr int kMergeWarps = 8;

__global__ void __launch_bounds__(32 * kMergeWarps) paged_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, float* __restrict__ acc, float* __restrict__ m,
    float* __restrict__ l, int splits, int rows, int D) {
  __shared__ __align__(16) float red[kMergeWarps][256];
  __shared__ float red_l[kMergeWarps];
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d4 = D >> 2;
  float mx = kNegInf;
  for (int s = lane; s < splits; s += 32) mx = fmaxf(mx, part_m[(size_t)s * rows + row]);
  mx = warp_max(mx);
  float4 a[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  float ls = 0.f;
  for (int s = warp; s < splits; s += kMergeWarps) {
    const size_t r = (size_t)s * rows + row;
    const float alpha = expf(part_m[r] - mx);
    ls += part_l[r] * alpha;
    const float4* src = reinterpret_cast<const float4*>(part_acc + r * D);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = lane + 32 * i;
      if (c < d4) {
        const float4 v = src[c];
        a[i].x = fmaf(v.x, alpha, a[i].x);
        a[i].y = fmaf(v.y, alpha, a[i].y);
        a[i].z = fmaf(v.z, alpha, a[i].z);
        a[i].w = fmaf(v.w, alpha, a[i].w);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = lane + 32 * i;
    if (c < d4) *reinterpret_cast<float4*>(&red[warp][4 * c]) = a[i];
  }
  if (lane == 0) red_l[warp] = ls;
  __syncthreads();
  for (int d = tid; d < D; d += 32 * kMergeWarps) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kMergeWarps; ++w) v += red[w][d];
    acc[(size_t)row * D + d] = v;
  }
  if (tid == 0) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kMergeWarps; ++w) v += red_l[w];
    m[row] = mx;
    l[row] = v;
  }
}

template <typename T, int MAXG, int NC4, bool EXACT>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
           const void* ctx, void* o_acc, void* o_m, void* o_l, void* scratch, int B, int Hq,
           int Hkv, int D, int page, int pages, float scale, int splits,
           int tiles_per_split, int warps, int smem, cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (warps < 1 || warps > kMaxWarps || smem > kSmemLimit ||
      (size_t)smem != block_smem(D, G, warps) || splits < 1 || tiles_per_split < 1 ||
      (long long)splits * tiles_per_split * kTile < (long long)pages * page ||
      (splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  static int smem_set = 0;                  // the attribute, once per instance and size
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T, MAXG, NC4, EXACT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    smem_set = kSmemLimit;
  }
  const size_t rows = (size_t)B * Hq;
  float* acc = (float*)o_acc;
  float* m = (float*)o_m;
  float* l = (float*)o_l;
  if (splits > 1) {
    acc = (float*)scratch;
    m = acc + (size_t)splits * rows * D;
    l = m + (size_t)splits * rows;
  }
  paged_attention_kernel<T, MAXG, NC4, EXACT><<<dim3(splits, Hkv, B), 32 * warps, smem,
                                                 stream>>>(
      (const T*)q, (const float*)k_pool, (const float*)v_pool, (const int32_t*)table,
      (const int32_t*)ctx, acc, m, l, B, Hq, Hkv, D, page, pages, scale, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  paged_merge_kernel<<<(unsigned)rows, 32 * kMergeWarps, 0, stream>>>(
      acc, m, l, (float*)o_acc, (float*)o_m, (float*)o_l, splits, (int)rows, D);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* table,
             const void* ctx, void* o_acc, void* o_m, void* o_l, void* scratch, int B,
             int Hq, int Hkv, int D, int page, int pages, float scale, int splits,
             int tiles_per_split, int warps, int smem, cudaStream_t s) {
  const int G = Hq / Hkv;
#define K6_CASE(MG, NC, EX)                                                                \
  return launch<T, MG, NC, EX>(q, k_pool, v_pool, table, ctx, o_acc, o_m, o_l, scratch, B,  \
                               Hq, Hkv, D, page, pages, scale, splits, tiles_per_split,     \
                               warps, smem, s)
  if (D <= 128) {
    if (G <= 1) K6_CASE(1, 1, true);
    if (G <= 2) K6_CASE(2, 1, false);
    if (G <= 4) K6_CASE(4, 1, false);
    if (G == 5) K6_CASE(5, 1, true);          // qwen3-14b: 40 / 8 heads
    if (G <= 8) K6_CASE(8, 1, false);
    if (G <= 16) K6_CASE(16, 1, false);
  } else {
    if (G <= 1) K6_CASE(1, 2, true);
    if (G <= 2) K6_CASE(2, 2, false);
    if (G <= 4) K6_CASE(4, 2, false);
    if (G <= 8) K6_CASE(8, 2, false);
  }
#undef K6_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16.  The wrapper has checked D % 8 == 0,
// D <= 256, Hq % Hkv == 0, G <= 16 (G <= 8 above D = 128) and non-empty
// shapes, and passes kernel.py's split_plan (splits, tiles a split, warps a
// block, shared memory a block), which this side checks against its own
// layout; scratch holds splits * B * Hq * (D + 2) floats when splits > 1.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* ctx, void* o_acc, void* o_m,
                                      void* o_l, void* scratch, int B, int Hq, int Hkv,
                                      int D, int page, int pages, float scale, int q_dtype,
                                      int splits, int tiles_per_split, int warps, int smem,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0) {
    return dispatch<float>(q, k_pool, v_pool, table, ctx, o_acc, o_m, o_l, scratch, B, Hq,
                           Hkv, D, page, pages, scale, splits, tiles_per_split, warps, smem,
                           s);
  }
  return dispatch<__nv_bfloat16>(q, k_pool, v_pool, table, ctx, o_acc, o_m, o_l, scratch, B,
                                 Hq, Hkv, D, page, pages, scale, splits, tiles_per_split,
                                 warps, smem, s);
}
