// K5: flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention/
// kernel.py: _flash_kernel (flash_attention_pallas), the attention of every
// layer of the serving engine's prefill and of zamba2's shared block.  q
// [B, Hq, Tq, D] and k, v [B, Hkv, Tk, D], contiguous, all float32 or all
// bfloat16; query head h reads KV head h / (Hq / Hkv).  Blocked online
// softmax with float32 statistics (m, l, acc): per KV tile,
//   s = (q . k) * scale, masked where the key is past Tk or (causal) past
//       the query's decode-aligned position i + Tk - Tq
//   m' = max(m, max s);  p = exp(s - m') (0 where masked)
//   l = l * exp(m - m') + sum p;  acc = acc * exp(m - m') + p @ v
// and o = acc / l (0 where l == 0), stored in q's dtype: flash_attention_ref
// of ref.py.  The TPU grid walks KV blocks sequentially with (m, l, acc) in
// VMEM scratch; a CUDA block carries nothing between blocks, so each block
// loops over the KV tiles of its query rows itself and stops at the last
// tile its last row can see.
//
// Bound on this card: a causal prefill of T tokens does 2 * 2 * Hq * D *
// T (T + 1) / 2 FLOPs against 2 (Hq + Hkv) T D bytes, some hundred
// operations per byte at the serving path's lengths, so the bound is the
// tensor cores' bf16 rate, 989 TFLOP/s.
//
// bfloat16 (tc::flash_wgmma_kernel): both products on the tensor cores.
// A block of two consumer warpgroups and one producer warpgroup takes 128
// query rows of one (batch, head); each consumer warpgroup owns 64 rows
// (setmaxnreg moves registers from the producer to the consumers).  One
// producer thread brings Q once and the K and V tiles through a ring of 2
// or 3 stages by TMA, with full / empty mbarriers per stage: 3-D tensor maps
// over (D, T, B H), so rows past T and columns past D arrive as zeros, and
// 64-column boxes in the 128-byte swizzle (the head dim padded to 64
// columns in shared memory: 112 -> 128, 160 -> 192).  S = Q K^T is wgmma
// m64nBKk16 with both operands read from shared memory by descriptors, over
// the head dim rounded up to a built width (64, 112, 128, 160, 256); the
// online softmax runs on the float32 S fragment in registers (row max and
// sum over the 4 threads of a row by shuffles, ex2 with the scale folded
// into log2 e); P is rounded to bf16 in registers, where the accumulator
// layout of 16 columns is the A fragment of a 16-deep wgmma, and O += P V
// reads V as it lies ([BK][D], MN-major for B, the descriptor's transpose
// bit).  Each warpgroup issues S_{j+1} before P_j V_j and takes the softmax
// of S_{j+1} while P_j V_j runs, and the two warpgroups take turns to issue
// (named barriers), so that one's products run under the other's softmax.
// Only the tiles that cross the diagonal or the end of Tk compute a mask.
// Blocks take the longest query tiles (the most KV tiles) first, over all
// heads when the call's K and V fit in L2, else over groups of heads about
// a wave wide.  Rounding: p to bf16 before P V, nothing else that the plain
// version keeps in float32 (ex2.approx is within 2 ulp).  Tiles: BK = 128
// keys for a padded head dim up to 128, 64 above; kernel.py:tile_plan
// computes the same plan and the launch checks it.  What holds it back
// from the bound: one block per SM (its shared memory), so a block's
// prologue and epilogue run with nothing beside them, and the softmax's
// exponentials on the special-function unit; see PERF.md.
//
// float32 (tf32::flash_tf32_kernel): the float32 engine runs, whose tokens
// must equal the plain versions', on the tensor cores in 3xTF32.  One TF32
// product keeps some three decimal digits, so each float32 operand is split
// in registers into its TF32 rounding (to nearest, ties away, as cvt.rna
// rounds) and the TF32 rounding of the residual, and each product is
// hi hi + hi lo + lo hi (mma.sync m16n8k8 tf32, float32 accumulators): ~21
// bits, float32-grade.  P is split the same way before P V; the softmax is
// float32 as above.  A block of 4 warps takes 64 rows, 16 a warp: the
// (query head of the group, position) pairs of one (batch, KV head),
// flattened head-major, so each K / V tile is loaded once for the whole
// group and short prompts fill whole tiles; each row masks by its own
// position, and the block stops at the last key its last-seeing row can
// see.  K and V tiles of 32 keys come through a ring of 2 stages of 16-byte
// cp.async copies (tile j + 1 in flight while tile j is consumed); Q and K
// rows are padded to 8 or 24 floats mod 32 and V rows to 4 or 12 mod 16, so
// the fragment loads hit distinct banks, and V is read as it lies.  Blocks
// of the last rows (the most keys) start first.  Head dims are built at
// 16, 32, 64, 112, 128, 160 and 256 columns (others round up).  Bound: the
// operations at the rate of the unit used, three TF32 products over 495
// TFLOP/s, 165 TFLOP/s of float32 work (67 on the CUDA cores); at
// serve_exact's prefill (qwen3-14b, 2 layers) 0.0523 ms against 0.1287 at
// the float32 rate.  What holds it back: every warp splits every K and V
// element it reads (the block's four warps split each tile four times) and
// its Q fragments again for each tile, so the integer work of the splits
// rivals the mma.sync issue; a block keeps a tile's products in dependent
// chains, and two blocks fit an SM at head dim 128 (shared memory).
//
// Measured (chip_smoke.py and bench/float32_sites.py on an NVIDIA H100
// 80GB HBM3 at 700.00 W; PERF.md, K5): bf16 at 303 TFLOP/s over qwen3-14b's
// 320 prefill calls (1.27x the time of scaled_dot_product_attention) and
// 342 TFLOP/s over zamba2-7b's 27 (1.38x), 31% and 35% of the bound;
// float32 at serve_exact's 10 prefill calls 0.774 ms of device time, 11.1
// TFLOP/s (the CUDA cores' FMA kernel it replaced: 1.35 ms on the same
// calls), 6.8% of the 3xTF32 bound, half SDPA's float32 device time.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit (2 ulp; results below 2^-126 flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 mma.sync on the tensor cores, tiles brought by cp.async.
// ---------------------------------------------------------------------------
namespace tf32 {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;      // rows a block, 16 a warp
constexpr int kBlockK = 32;               // keys a tile
constexpr int kStages = 2;                // K / V tiles in the cp.async ring

// Row strides in floats.  Q and K: the float2 fragment loads of a half-warp
// (rows g, columns 2t) hit distinct banks when the stride is 8 or 24 mod 32;
// V: the scalar loads of P V's B operand (rows 2t and 2t + 1, column g) do
// when it is 4 or 12 mod 16.
__host__ __device__ constexpr int ld_qk(int D) { return D + (D % 16 == 0 ? 8 : 16); }
__host__ __device__ constexpr int ld_v(int D) { return D + 4; }
// Q once, then the ring's K and V tiles.
constexpr int smem_bytes(int D) {
  return 4 * (kBlockQ * ld_qk(D) + kStages * kBlockK * (ld_qk(D) + ld_v(D)));
}

// 16 bytes from global to shared memory, or 16 zero bytes where !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Returns once at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (to nearest, ties
// away from zero: the magnitude's low 13 bits rounded off), in two integer
// operations; the conversion instruction costs more than both.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + (|x| 2^-22 at most): hi is x rounded to TF32, lo the
// residual rounded the same way.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a b, m16n8k8, TF32 operands, float32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b in 3xTF32, a split, b = (b0, b1) split here: the two small
// products (lo hi, hi lo) before the large one.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// The A fragment of m16n8k8 (rows g and g + 8, k-slots t and t + 4) from
// four float32 values, split into TF32 parts.
__device__ __forceinline__ void split_a(float r0k0, float r1k0, float r0k1, float r1k1,
                                        uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split_tf32(r0k0, ah[0], al[0]);
  split_tf32(r1k0, ah[1], al[1]);
  split_tf32(r0k1, ah[2], al[2]);
  split_tf32(r1k1, ah[3], al[3]);
}

// The block's rows are (query head of the group, query position) pairs of
// one (batch, KV head), flattened head-major: row r is query head
// hk G + r / Tq at position r % Tq, so a block's Q rows (and O rows) are
// contiguous and every K / V tile serves the whole group.  Warp w owns rows
// 16 w ... 16 w + 15 of the block; in the mma fragment layout this thread
// holds rows g and g + 8 and, of each 8-key block j of S, the keys 8 j + 2 t
// and 8 j + 2 t + 1.  In both products the k-slots t and t + 4 of a fragment
// hold the columns (or keys) 2 t and 2 t + 1 of their 8-block: a product
// sums over k in any order, so Q and K load as float2, and S's accumulator
// pairs are P's A fragment as they lie (V's rows 2 t, 2 t + 1 match them).
// DN: the head dim rounded up to a built width (the accumulator's columns).
template <int DN>
__global__ void __launch_bounds__(kThreads) flash_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int Hq, int Hkv, int Tq, int Tk, int D, float scale_log2,
    int causal) {
  extern __shared__ __align__(16) float smem[];
  const int LQ = ld_qk(D), LV = ld_v(D), chunks = D / 4;   // 16-byte chunks a row
  float* qs = smem;                                           // [kBlockQ][LQ]
  float* ks = qs + kBlockQ * LQ;                              // stages x [kBlockK][LQ]
  float* vs = ks + kStages * kBlockK * LQ;                    // stages x [kBlockK][LV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int G = Hq / Hkv, rows = G * Tq;
  // Row blocks from the last (the most keys) to the first, each over every
  // (batch, KV head), so the longest blocks start first.
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int bhk = blockIdx.x;                                 // b Hkv + hk
  const size_t q_base = (size_t)bhk * G * Tq * D;             // the group's row 0
  const size_t kv_base = (size_t)bhk * Tk * D;
  const int shift = Tk - Tq;                                  // decode alignment

  // Each row's last visible key (-1: none; rows past the group see none).
  auto last_key = [&](int r) {
    if (r >= rows) return -1;
    return causal ? min(Tk - 1, r % Tq + shift) : Tk - 1;
  };
  // The block stops at the last key its last-seeing row can see: its last
  // row, or the last position of a head that ends inside the block.
  const int r_last = min(r0 + kBlockQ, rows) - 1;
  const int k_end = 1 + (r0 / Tq != r_last / Tq ? Tk - 1 : last_key(r_last));
  const int n_kt = k_end > 0 ? (k_end + kBlockK - 1) / kBlockK : 0;

  const int rw = r0 + 16 * warp;                              // the warp's first row
  const int lim0 = last_key(rw + g), lim1 = last_key(rw + g + 8);
  const int w_min = __reduce_min_sync(0xffffffffu, min(lim0, lim1));
  const int w_end = __reduce_max_sync(0xffffffffu, max(lim0, lim1)) + 1;

  auto load_kv = [&](int j) {
    const int k0 = j * kBlockK, s = j % kStages;
    float* kt = ks + s * kBlockK * LQ;
    float* vt = vs + s * kBlockK * LV;
    for (int e = tid; e < kBlockK * chunks; e += kThreads) {
      const int row = e / chunks, c = 4 * (e - row * chunks);
      const bool in = k0 + row < Tk;                          // rows past Tk are zeros
      const size_t src = kv_base + (size_t)(in ? k0 + row : 0) * D + c;
      cp_async16(kt + row * LQ + c, k + src, in);
      cp_async16(vt + row * LV + c, v + src, in);
    }
  };

  if (n_kt > 0) {
    for (int e = tid; e < kBlockQ * chunks; e += kThreads) {
      const int row = e / chunks, c = 4 * (e - row * chunks);
      const bool in = r0 + row < rows;
      cp_async16(qs + row * LQ + c, q + q_base + (size_t)(in ? r0 + row : 0) * D + c, in);
    }
    load_kv(0);
  }
  cp_async_commit();

  float acc[DN / 8][4];
#pragma unroll
  for (int i = 0; i < DN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;   // log2 domain; l per thread
  const float* qw = qs + (16 * warp + g) * LQ + 2 * t;

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) load_kv(j + 1);                         // in flight during tile j
    cp_async_commit();
    cp_async_wait<1>();                                       // tile j (and Q) have landed
    __syncthreads();
    const int k0 = j * kBlockK;
    if (k0 < w_end) {
      const float* kt = ks + (j % kStages) * kBlockK * LQ + g * LQ + 2 * t;
      const float* vt = vs + (j % kStages) * kBlockK * LV + 2 * t * LV + g;

      // S = Q K^T over the head dim, 8 columns a step.
      float sc[kBlockK / 8][4];
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DN / 8; ++kk) {
        if (8 * kk < D) {
          const float2 qa = *reinterpret_cast<const float2*>(qw + 8 * kk);
          const float2 qb = *reinterpret_cast<const float2*>(qw + 8 * LQ + 8 * kk);
          uint32_t ah[4], al[4];
          split_a(qa.x, qb.x, qa.y, qb.y, ah, al);
#pragma unroll
          for (int n = 0; n < kBlockK / 8; ++n) {
            const float2 kb = *reinterpret_cast<const float2*>(kt + 8 * n * LQ + 8 * kk);
            mma3(sc[n], ah, al, kb.x, kb.y);
          }
        }
      }

      // The online softmax of the tile (the scale folded into log2 e).
      const bool mask = k0 + kBlockK - 1 > w_min;
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
        const int c = k0 + 8 * n + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lim = e < 2 ? lim0 : lim1;
          sc[n][e] = mask && c + (e & 1) > lim ? -INFINITY : sc[n][e] * scale_log2;
        }
      }
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
        x0 = fmaxf(x0, fmaxf(sc[n][0], sc[n][1]));
        x1 = fmaxf(x1, fmaxf(sc[n][2], sc[n][3]));
      }
      // The four threads of a row hold its keys 2 t, 2 t + 1 of each block.
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
      const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
      // A row with no visible key yet keeps p = 0 and alpha = 0 (its sums are 0).
      const float b0 = n0 == -INFINITY ? 0.f : n0, b1 = n1 == -INFINITY ? 0.f : n1;
      const float a0 = exp2_approx(m0 - b0), a1 = exp2_approx(m1 - b1);
      m0 = n0;
      m1 = n1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
        sc[n][0] = exp2_approx(sc[n][0] - b0);
        sc[n][1] = exp2_approx(sc[n][1] - b0);
        sc[n][2] = exp2_approx(sc[n][2] - b1);
        sc[n][3] = exp2_approx(sc[n][3] - b1);
        l0 += sc[n][0] + sc[n][1];
        l1 += sc[n][2] + sc[n][3];
      }
#pragma unroll
      for (int i = 0; i < DN / 8; ++i) {
        acc[i][0] *= a0;
        acc[i][1] *= a0;
        acc[i][2] *= a1;
        acc[i][3] *= a1;
      }

      // O += P V: S's accumulator pairs are P's A fragment; V as it lies.
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
        uint32_t ph[4], pl[4];
        split_a(sc[n][0], sc[n][2], sc[n][1], sc[n][3], ph, pl);
        const float* vn = vt + 8 * n * LV;
#pragma unroll
        for (int i = 0; i < DN / 8; ++i)
          if (8 * i < D) mma3(acc[i], ph, pl, vn[8 * i], vn[LV + 8 * i]);
      }
    }
    __syncthreads();                                          // tile j's stage is free
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = l0 > 0.f ? l0 : 1.f, d1 = l1 > 0.f ? l1 : 1.f;   // 0 where l == 0
  float* o0 = o + q_base + (size_t)(rw + g) * D;
  float* o1 = o0 + (size_t)8 * D;
#pragma unroll
  for (int i = 0; i < DN / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (col < D) {
      if (rw + g < rows) *reinterpret_cast<float2*>(o0 + col) =
          make_float2(acc[i][0] / d0, acc[i][1] / d0);
      if (rw + g + 8 < rows) *reinterpret_cast<float2*>(o1 + col) =
          make_float2(acc[i][2] / d1, acc[i][3] / d1);
    }
  }
}

template <int DN>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
           int Tq, int Tk, int D, float scale, int causal, cudaStream_t stream) {
  const int smem = smem_bytes(D);
  const cudaError_t err =
      cudaFuncSetAttribute(flash_tf32_kernel<DN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hkv, (Hq / Hkv * Tq + kBlockQ - 1) / kBlockQ);
  flash_tf32_kernel<DN><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Hq, Hkv, Tq, Tk, D,
      scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

}  // namespace tf32

// ---------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores, tiles brought by TMA.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kConsumers = 2;                       // consumer warpgroups
constexpr int kBlockQ = 64 * kConsumers;            // query rows per block
constexpr int kThreads = 128 * (kConsumers + 1);    // + the producer warpgroup
// Registers per thread after setmaxnreg: the producer gives back what the
// consumers' accumulators need (per SM sub-partition: 2 x 240 + 24 <= 512).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBox = 64;                            // columns per TMA box: 128 bytes
constexpr int kRowBytes = 2 * kBox;                 // one swizzled box row
constexpr int kSmemLimit = 232448;                  // shared memory a block may use
constexpr int kSmallGroup = 8;                      // heads per group when K, V exceed L2

// 1,024 bytes of slack (the swizzled tiles start on a 1,024-byte boundary),
// Q, a K / V ring of `stages` tiles each and its mbarriers.
constexpr int ring_smem(int dp, int bk, int stages) {
  return 1024 + 2 * (kBlockQ * dp + 2 * stages * bk * dp) + 8 * (1 + 4 * stages);
}

// The tile plan for a product width DN (the head dim rounded up to one of
// 64, 112, 128, 160, 256): DP, DN padded to 64-column boxes in shared memory;
// kernel.py:tile_plan computes the same numbers and the launch refuses a
// plan that differs.
template <int DN>
struct Plan {
  static constexpr int DP = (DN + kBox - 1) / kBox * kBox;
  static constexpr int kBlockK = DP <= 128 ? 128 : 64;
  static constexpr int kQBytes = kBlockQ * DP * 2;
  static constexpr int kKVBytes = kBlockK * DP * 2;  // one K or one V tile
  static constexpr int kStages = ring_smem(DP, kBlockK, 3) <= kSmemLimit ? 3 : 2;
  static constexpr int kSmem = ring_smem(DP, kBlockK, kStages);
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.
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

// One box of the 3-D tensor map at (column c0, row c1, head c2) into shared
// memory; the barrier counts its bytes, rows and columns past the tensor's
// edge arriving as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading byte offset (MN-major: the distance between 64-column boxes), and
// 1,024 bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Returns once at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Named barriers 1 and 2 hand the turn to issue wgmma between the two
// consumer warpgroups, so that one's products run under the other's softmax.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// S = A B^T (+ S): A [64 x 16], B [64 x 16], both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// S = A B^T (+ S): A [64 x 16], B [128 x 16], both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// O += P V: P [64 x 16] bf16 in registers, V [16 x 64] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P V: P [64 x 16] bf16 in registers, V [16 x 112] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P V: P [64 x 16] bf16 in registers, V [16 x 128] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P V: P [64 x 16] bf16 in registers, V [16 x 160] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P V: P [64 x 16] bf16 in registers, V [16 x 256] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, acc);
  else wgmma_ss_n128(d, a, b, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (N == 112) wgmma_rs_n112(d, a, b);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, b);
  else if constexpr (N == 160) wgmma_rs_n160(d, a, b);
  else wgmma_rs_n256(d, a, b);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// Issues S = Q K^T for one KV tile: 16 head-dim columns per wgmma, over the
// DN columns that hold data (the pad up to DP is zeros).
template <int DN>
__device__ __forceinline__ void issue_qk(float (&sc)[Plan<DN>::kBlockK / 2], uint32_t q_tile,
                                         uint32_t k_tile) {
  constexpr int BK = Plan<DN>::kBlockK;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DN / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;                       // bytes into the swizzled row
    wgmma_ss<BK>(sc, smem_desc(q_tile + (kk >> 2) * kBlockQ * kRowBytes + col, 16),
                 smem_desc(k_tile + (kk >> 2) * BK * kRowBytes + col, 16), kk > 0);
  }
  wgmma_commit();
}

// Issues O += P V for one KV tile: V [BK][DP] as it lies is MN-major for B
// (the descriptor's transpose bit; the leading offset steps between boxes).
template <int DN>
__device__ __forceinline__ void issue_pv(float (&acc)[DN / 2],
                                         const uint32_t (&pa)[Plan<DN>::kBlockK / 16][4],
                                         uint32_t v_tile) {
  constexpr int BK = Plan<DN>::kBlockK;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < BK / 16; ++c)
    wgmma_rs<DN>(acc, pa[c], smem_desc(v_tile + c * 16 * kRowBytes, BK * kRowBytes));
  wgmma_commit();
}

// The online softmax of one finished S tile, for this thread's rows r0
// (e = 0, 1) and r0 + 8 (e = 2, 3): masks keys past each row's last visible
// key (lim0, lim1) where `mask`, moves the running max m (log2 domain),
// rescales l and returns the factors alpha that O must take; p goes to l in
// float32 and to pa rounded to bf16, where the accumulator layout of the
// 16 keys 16 c ... 16 c + 15 is the A fragment of the c-th step of P V.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4],
                                             bool mask, int k0, int t, int lim0, int lim1,
                                             float scale_log2, float& m0, float& m1, float& l0,
                                             float& l1, float& a0, float& a1) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const int c = k0 + 8 * i + 2 * t;
      if (c > lim0) sc[4 * i] = -INFINITY;
      if (c + 1 > lim0) sc[4 * i + 1] = -INFINITY;
      if (c > lim1) sc[4 * i + 2] = -INFINITY;
      if (c + 1 > lim1) sc[4 * i + 3] = -INFINITY;
    }
  }
  float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    x0 = fmaxf(x0, fmaxf(sc[4 * i], sc[4 * i + 1]));
    x1 = fmaxf(x1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  // The four threads of a row hold its columns 2 t, 2 t + 1 of each block.
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
  const float n0 = fmaxf(m0, x0 * scale_log2), n1 = fmaxf(m1, x1 * scale_log2);
  // A row with no visible key yet keeps p = 0 and alpha = 0 (its sums are 0).
  const float b0 = n0 == -INFINITY ? 0.f : n0, b1 = n1 == -INFINITY ? 0.f : n1;
  a0 = exp2_approx(m0 - b0);
  a1 = exp2_approx(m1 - b1);
  m0 = n0;
  m1 = n1;
  l0 *= a0;
  l1 *= a1;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    const float p0 = exp2_approx(fmaf(sc[4 * i], scale_log2, -b0));
    const float p1 = exp2_approx(fmaf(sc[4 * i + 1], scale_log2, -b0));
    const float p2 = exp2_approx(fmaf(sc[4 * i + 2], scale_log2, -b1));
    const float p3 = exp2_approx(fmaf(sc[4 * i + 3], scale_log2, -b1));
    l0 += p0 + p1;
    l1 += p2 + p3;
    pa[i >> 1][2 * (i & 1)] = pack_bf16(p0, p1);
    pa[i >> 1][2 * (i & 1) + 1] = pack_bf16(p2, p3);
  }
}

// blockIdx.x walks groups of `group` (batch, head) pairs, whose K and V fit
// in L2 together; within a group, the query tiles from the last (the most
// KV tiles under the causal mask) to the first, each over the group's pairs.
template <int DN>
__global__ void __launch_bounds__(kThreads, 1) flash_wgmma_kernel(
    __grid_constant__ const CUtensorMap map_q, __grid_constant__ const CUtensorMap map_k,
    __grid_constant__ const CUtensorMap map_v, __nv_bfloat16* __restrict__ o, int BH, int Hq,
    int Hkv, int Tq, int Tk, int D, float scale_log2, int causal, int n_qt, int group) {
  using P = Plan<DN>;
  constexpr int DP = P::DP, BK = P::kBlockK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;   // Q: DP / 64 boxes [kBlockQ][64]
  const uint32_t sk = sq + P::kQBytes;                        // K: stages x [BK][64] boxes
  const uint32_t sv = sk + P::kStages * P::kKVBytes;          // V: likewise
  const uint32_t bars = sv + P::kStages * P::kKVBytes;        // mbarriers, 8 bytes each:
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + P::kStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * P::kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * P::kStages + s); };

  const int tid = threadIdx.x;
  const int first = static_cast<int>(blockIdx.x) / (group * n_qt) * group;
  const int r = static_cast<int>(blockIdx.x) - first * n_qt;
  const int heads = min(group, BH - first);
  const int qt = n_qt - 1 - r / heads;
  const int bh = first + r % heads;
  const int bhk = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = qt * kBlockQ;
  const int shift = Tk - Tq;                                  // decode alignment
  // KV tiles past the block's last row's diagonal are masked for every row.
  const int k_end = causal ? min(Tk, min(q0 + kBlockQ, Tq) + shift) : Tk;
  const int n_kt = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * kConsumers);                  // lane 0 of each consumer warp
      mbar_init(v_empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * kConsumers) {
    // Producer warpgroup: one thread keeps the K / V ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 128 * kConsumers) {
      mbar_expect_tx(q_full, P::kQBytes);
      for (int c = 0; c < DP / kBox; ++c)
        tma_load(sq + c * kBlockQ * kRowBytes, &map_q, q_full, c * kBox, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % P::kStages;
        const uint32_t parity = ((j / P::kStages) & 1) ^ 1;   // round 0 passes at once
        mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), P::kKVBytes);
        for (int c = 0; c < DP / kBox; ++c)
          tma_load(sk + s * P::kKVBytes + c * BK * kRowBytes, &map_k, k_full(s), c * kBox,
                   j * BK, bhk);
        mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), P::kKVBytes);
        for (int c = 0; c < DP / kBox; ++c)
          tma_load(sv + s * P::kKVBytes + c * BK * kRowBytes, &map_v, v_full(s), c * kBox,
                   j * BK, bhk);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // Consumers: warpgroup wg owns query rows q0 + 64 wg ... + 63; in the wgmma
  // fragment layout this thread holds rows r0 and r0 + 8, and in each 8-key
  // column block i the keys 8 i + 2 t and 8 i + 2 t + 1.
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg_q0 = q0 + 64 * wg;
  const int r0 = wg_q0 + 16 * warp + g;
  const int lim0 = causal ? min(Tk - 1, r0 + shift) : Tk - 1;  // last visible key of each row
  const int lim1 = causal ? min(Tk - 1, r0 + 8 + shift) : Tk - 1;
  // The warpgroup computes the tiles its own rows can see (a prefix of the
  // block's) and only passes the rest through the ring.
  const int wg_k_end = wg_q0 >= Tq ? 0 : causal ? min(Tk, min(wg_q0 + 64, Tq) + shift) : Tk;
  const int n_wg = wg_k_end > 0 ? (wg_k_end + BK - 1) / BK : 0;
  // Tiles that reach past Tk or across the diagonal of the first row compute a mask.
  auto needs_mask = [&](int k0) { return k0 + BK > Tk || (causal && k0 + BK - 1 > wg_q0 + shift); };
  const uint32_t sq_wg = sq + 64 * wg * kRowBytes;

  float acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2];
  uint32_t pa[BK / 16][4], pn[BK / 16][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0, a1;

  // The products overlap the softmax: while P_j V_j runs, the warpgroup
  // takes the softmax of S_{j+1}, issued before it.  Each warpgroup issues
  // n_kt + 1 batches of wgmma (S_0, then S_{j+1} with P_j V_j, then empty
  // turns for the tiles it passes through), taking turns with the other.
  int batch = 0;
  auto pass = [&]() {
    if (wg == 0 || ++batch <= n_kt) turn_pass(wg);            // the last turn has no taker
  };
  mbar_wait(q_full, 0);
  if (wg == 1) turn_pass(1);                                  // warpgroup 0 goes first
  if (n_wg > 0) mbar_wait(k_full(0), 0);
  turn_wait(wg);
  if (n_wg > 0) issue_qk<DN>(sc, sq_wg, sk);
  pass();
  if (n_wg > 0) {
    wgmma_wait<0>();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(0));
    softmax_tile<BK>(sc, pa, needs_mask(0), 0, t, lim0, lim1, scale_log2, m0, m1, l0, l1, a0, a1);
  }
  for (int j = 0; j < n_wg; ++j) {
    const int s = j % P::kStages, s1 = (j + 1) % P::kStages;
    const bool next = j + 1 < n_wg;
    if (next) mbar_wait(k_full(s1), ((j + 1) / P::kStages) & 1);
    mbar_wait(v_full(s), (j / P::kStages) & 1);
    turn_wait(wg);
    if (next) issue_qk<DN>(sc, sq_wg, sk + s1 * P::kKVBytes);
    issue_pv<DN>(acc, pa, sv + s * P::kKVBytes);
    pass();
    if (next) {
      wgmma_wait<1>();                                        // S_{j+1} is done
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty(s1));
      softmax_tile<BK>(sc, pn, needs_mask((j + 1) * BK), (j + 1) * BK, t, lim0, lim1,
                       scale_log2, m0, m1, l0, l1, a0, a1);
    }
    wgmma_wait<0>();                                          // P_j V_j is done
    fence_regs(acc);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty(s));
    if (next) {
#pragma unroll
      for (int i = 0; i < DN / 8; ++i) {
        acc[4 * i] *= a0;
        acc[4 * i + 1] *= a0;
        acc[4 * i + 2] *= a1;
        acc[4 * i + 3] *= a1;
      }
#pragma unroll
      for (int c = 0; c < BK / 16; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[c][e] = pn[c][e];
    }
  }
  for (int j = n_wg; j < n_kt; ++j) {                         // keep the ring's counts
    const int s = j % P::kStages;
    const uint32_t parity = (j / P::kStages) & 1;
    mbar_wait(k_full(s), parity);
    mbar_wait(v_full(s), parity);
    turn_wait(wg);
    pass();
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(k_empty(s));
      mbar_arrive(v_empty(s));
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* o0 = o + ((size_t)bh * Tq + r0) * D;
  __nv_bfloat16* o1 = o0 + (size_t)8 * D;
#pragma unroll
  for (int i = 0; i < DN / 8; ++i) {
    const int col = 8 * i + 2 * t;                            // D % 8 == 0: pairs stay inside
    if (col < D) {
      if (r0 < Tq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
            __floats2bfloat162_rn(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
      if (r0 + 8 < Tq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
            __floats2bfloat162_rn(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled is a driver-API function; the library links the
// runtime only, so it is taken through the runtime's entry-point query.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [BH][T][D] bf16 as a 3-D map (D, T, BH), boxes of 64 columns x `rows` rows
// of one head, 128-byte swizzle; reads past D or T give zeros.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int D, int T, int BH,
            int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int DN>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                 int Tq, int Tk, int D, float scale, int causal, const int* plan,
                 cudaStream_t stream) {
  using P = Plan<DN>;
  if (plan[0] != P::DP || plan[1] != kBlockQ || plan[2] != P::kBlockK || plan[3] != P::kStages ||
      plan[4] != kThreads || plan[5] != P::kSmem || plan[6] != DN)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!encode(fn, &mq, q, D, Tq, B * Hq, kBlockQ) || !encode(fn, &mk, k, D, Tk, B * Hkv, P::kBlockK) ||
      !encode(fn, &mv, v, D, Tk, B * Hkv, P::kBlockK))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DN>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Tq + kBlockQ - 1) / kBlockQ;
  // Block order: when the call's K and V fit in L2 with room to spare, all
  // heads form one group (the longest query tiles of every head first);
  // otherwise groups of about one wave of blocks share their heads' K and V.
  const long long kv_bytes = 4LL * B * Hkv * Tk * D;
  const int group = kv_bytes <= (16LL << 20) ? B * Hq : std::max(1, kSmallGroup);
  flash_wgmma_kernel<DN><<<n_qt * B * Hq, kThreads, P::kSmem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, B * Hq, Hq, Hkv, Tq, Tk, D, scale * 1.4426950408889634f,
      causal, n_qt, group);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  plan: the tile plan of kernel.py
// (padded head dim, query rows, keys per tile, stages, threads, shared-memory
// bytes, product width), which must be the one this source builds.  The
// wrapper has checked D % 8 == 0, D <= 256, Hq % Hkv == 0, non-empty shapes
// and, for bfloat16, 16-byte-aligned bases.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Hq, int Hkv, int Tq, int Tk, int D,
                                      float scale, int causal, int dtype, int plan_dp,
                                      int plan_bq, int plan_bk, int plan_stages,
                                      int plan_threads, int plan_smem, int plan_width,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int plan[7] = {plan_dp,      plan_bq,   plan_bk,   plan_stages,
                       plan_threads, plan_smem, plan_width};
  if (dtype == 0) {
    // The accumulator's width: the head dim rounded up to a width built below.
    const int dn = D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 112 ? 112 : D <= 128 ? 128
                 : D <= 160 ? 160 : 256;
    if (plan[0] != tf32::ld_qk(D) || plan[1] != tf32::kBlockQ || plan[2] != tf32::kBlockK ||
        plan[3] != tf32::kStages || plan[4] != tf32::kThreads || plan[5] != tf32::smem_bytes(D) ||
        plan[6] != dn)
      return (int)cudaErrorInvalidValue;
    switch (dn) {
      case 16: return tf32::launch<16>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, s);
      case 32: return tf32::launch<32>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, s);
      case 64: return tf32::launch<64>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, s);
      case 112: return tf32::launch<112>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, s);
      case 128: return tf32::launch<128>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, s);
      case 160: return tf32::launch<160>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, s);
      default: return tf32::launch<256>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, s);
    }
  }
  // The product width: the head dim rounded up to a width built below.
  const int width = D <= 64 ? 64 : D <= 112 ? 112 : D <= 128 ? 128 : D <= 160 ? 160 : 256;
  switch (width) {
    case 64: return tc::launch_wgmma<64>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, plan, s);
    case 112: return tc::launch_wgmma<112>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, plan, s);
    case 128: return tc::launch_wgmma<128>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, plan, s);
    case 160: return tc::launch_wgmma<160>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, plan, s);
    default: return tc::launch_wgmma<256>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, plan, s);
  }
}
