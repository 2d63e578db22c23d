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
//   y[t][p]   = exp(logc[t]) sum_n C_t[n] S0[n][p] + sum_{s<=t} att[t][s] x[s][p]
//             + D x[t][p]
//   S[n][p]   = exp(logc[C-1]) S0[n][p] + sum_s B_s[n] dt_s exp(logc[C-1] - logc[s]) x[s][p]
// Every exponent is a difference logc[later] - logc[earlier] or a cumulative
// sum itself, so it is <= 0 and exp never overflows.  The TPU kernel forms
// B_s dt_s / c_s = B_s dt_s exp(-logc[s]) instead: at zamba2's decays
// (A = -exp(A_log), A_log = log(linspace(1, 8, H)), dt = softplus of a
// projection with std ~0.63) logc reaches -100 ... -370 within a 64-token
// chunk, exp(370) overflows float32 and 0 * inf gives NaN, so that kernel
// returns NaN for nearly every head (tests/test_torch_ssm_kernels.py).  Both
// kernels here stay finite there.  logc is a warp scan of A dt.
//
// The tensor-core kernel (mamba2_mma_kernel), for x in bf16 or float32.  The TPU grid
// (B, H, T/C) walks chunks in order with S in VMEM scratch; CUDA blocks carry
// nothing between them, so a block owns HB heads of one batch row (one
// warpgroup of 128 threads a head, kernel.py's heads_plan choosing HB by
// occupancy; heads past H are masked) and loops over the chunks itself, each
// head's S [N][P] float32 in its warpgroup's registers as mma accumulators
// (warp w holds rows 16w..16w+15).  Chunks and N, P up to 64 are padded with
// zeros to 64 x 64 tiles.  Per chunk the block stages B and C once for its
// heads and forms C B^T once (the decay mask is all that differs between
// heads: n_groups = 1), and each warpgroup runs its head's products on the
// tensor cores, mma.sync m16n8k16 bf16 -> float32 with operands loaded by
// ldmatrix from shared memory rows padded to 72 bf16 (so the eight rows of
// a load hit distinct banks): C S, the masked att x (causal: warp w skips
// the key blocks past its rows), and the state update B_dec^T x.  x is
// exact in bf16.  B, C, att, B_dec = B dt exp(logc[C-1] - logc[s]) and S are
// float32: each is split into a bf16 high part and a bf16 low part (the
// residual, rounded), and a product is the sum of the parts' products
// (hi x + lo x with x; hi hi + hi lo + lo hi between two split operands), so
// the operands keep ~16 bits and the sums are float32: the state holds the
// float32 checks (the split, ldmatrix and mma helpers are in mma_bf16.cuh,
// shared with K7).  The decay arithmetic stays in float32.
//
// float32 x (the float32 runs: ssm_exact, ssm_full_depth) takes the same
// kernel, instantiated on float: x is staged as bf16 high and low parts (one
// more [64][72] tile a head, 9,216 bytes), so where x meets a split operand
// (att x, B_dec^T x) the product has three terms, hi hi + lo hi + hi lo,
// and D x reads hi + lo; y is stored in float32.  The split keeps ~16 bits
// of every operand, well inside the float32 checks' 5e-4.  Blocks take two
// heads or one (at four, 128 registers a thread, the third product spills).
// Bound at ssm_exact (zamba2-7b, 6 calls [2, 112, 128, 64]): bytes, x and
// y in float32 plus dt, B, C and the state, 18.6 MB a call, 0.0333 ms over
// the 6 calls (chip_smoke.py counts them); measured 0.18 ms of device time
// there, where the CUDA cores' FMA kernel it replaced took 0.82 ms
// (chip_smoke.py and bench/float32_sites.py on an NVIDIA H100 80GB HBM3 at
// 700.00 W; PERF.md, K8): 112 blocks of two heads, two chunks each, leave
// the card mostly idle.
//
// Bound on this card: at zamba2-7b's prefill (B = 4, H = 112, T = 2048,
// P = N = 64, C = 64, bf16 x) a call moves ~249 MB (x read and y written in
// bf16, dt, B, C and the state in float32), 74.5 us at 3.35 TB/s (6.05 ms
// over zamba2's 81 calls); the recurrence itself needs 19.0 GFLOP, 0.283 ms
// at the float32 rate (67 TFLOP/s; 22.93 ms over the 81 calls) and 0.019
// ms at the bf16 tensor-core rate (989 TFLOP/s), and even the split
// products this kernel runs (~58 GFLOP at two heads a block, key blocks
// past the diagonal skipped) take 0.059 ms there.  So at the rate of the
// unit used the bound is bytes, for either dtype of x (chip_smoke.py prints
// both).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int kTileRows = 64;            // a chunk padded to 64 rows
constexpr int kLd = 72;                  // bf16 row of a 64-column tile, padded
constexpr int kLdF = 68;                 // float32 row of C B^T, padded
constexpr unsigned kFull = 0xffffffffu;

// logc of one chunk by warp scan: lane l takes positions 2l and 2l + 1 of
// up to 64 (a_t = A dt_t, 0 past the chunk); returns them in lc0, lc1.
__device__ __forceinline__ void chunk_logc(float a0, float a1, int lane, float& lc0,
                                           float& lc1) {
  float incl = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  lc0 = incl - (a0 + a1) + a0;
  lc1 = lc0 + a1;
}

// ---------------------------------------------------------------------------
// The tensor-core kernel.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Shared memory of the tensor-core kernel, in bytes: B and C as bf16 high
// and low parts [64][72] each, C B^T float32 [64][68], then per head x
// [64][72] bf16, a region of two [64][72] bf16 tiles (S's parts, then
// B_dec's), logc, dt, exp(logc) and dt exp(logc[C-1] - logc) [64] float32,
// and for float32 x its bf16 low parts [64][72].
constexpr int kTileBytes = kTileRows * kLd * 2;
constexpr int kSharedBytes = 4 * kTileBytes + kTileRows * kLdF * 4;
template <typename XT>
constexpr int kHeadBytes = 3 * kTileBytes + 4 * kTileRows * 4 + (sizeof(XT) == 4 ? kTileBytes : 0);

// Offsets within one head's region.
constexpr int kHeadX = 0, kHeadR = kTileBytes, kHeadVec = 3 * kTileBytes;
constexpr int kHeadXlo = kHeadVec + 4 * kTileRows * 4;

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float v0, float v1, bool both,
                                           bool vec) {
  if (both && vec) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    dst[0] = __float2bfloat16(v0);
    if (both) dst[1] = __float2bfloat16(v1);
  }
}
__device__ __forceinline__ void store_pair(float* dst, float v0, float v1, bool both, bool vec) {
  if (both && vec) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    dst[0] = v0;
    if (both) dst[1] = v1;
  }
}

// d0, d1 += a x over x's 16 x 16 block at (x's parts) xh, xlo: a split
// into bf16 parts, x exact in bf16 (a_hi x + a_lo x) or, with kSplitX, also
// split (a_hi x_hi + a_lo x_hi + a_hi x_lo).  Transposed loads: x is [s][p].
template <bool kSplitX>
__device__ __forceinline__ void mma_x(float (&d0)[4], float (&d1)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], const __nv_bfloat16* xh,
                                      const __nv_bfloat16* xlo) {
  uint32_t bx[4];
  ldsm_x4_t(smem_addr(xh), bx);
  mma(d0, ah, bx[0], bx[1]);
  mma(d0, al, bx[0], bx[1]);
  mma(d1, ah, bx[2], bx[3]);
  mma(d1, al, bx[2], bx[3]);
  if constexpr (kSplitX) {
    ldsm_x4_t(smem_addr(xlo), bx);
    mma(d0, ah, bx[0], bx[1]);
    mma(d1, ah, bx[2], bx[3]);
  }
}

// XT: x's and y's type, bf16 (x exact in bf16) or float (x split into bf16
// high and low parts like the other float32 operands).  bf16 blocks of HB
// heads run 4 / HB to an SM (128 registers a thread); float blocks, whose
// head regions are a tile larger, run 1 (HB = 2) or 2 (HB = 1) to an SM by
// shared memory, and take the registers that leaves (at 128 a thread, the
// third product with x spilled).
template <typename XT, int HB>
__global__ void __launch_bounds__(128 * HB, sizeof(XT) == 4 || 4 / HB < 2 ? 1 : 4 / HB)
    mamba2_mma_kernel(
    const XT* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ Dv, XT* __restrict__ y, float* __restrict__ s_out,
    int H, int T_len, int P, int N, int C) {
  constexpr bool kSplitX = sizeof(XT) == 4;
  extern __shared__ __align__(128) unsigned char sm[];
  __nv_bfloat16* Bhi = reinterpret_cast<__nv_bfloat16*>(sm);
  __nv_bfloat16* Blo = Bhi + kTileRows * kLd;
  __nv_bfloat16* Chi = Blo + kTileRows * kLd;
  __nv_bfloat16* Clo = Chi + kTileRows * kLd;
  float* CB = reinterpret_cast<float*>(sm + 4 * kTileBytes);      // [64][kLdF]

  const int tid = threadIdx.x, lane = tid & 31, wib = tid >> 5;
  const int q = wib >> 2, w = wib & 3, tq = tid & 127;   // head slot, warp in it
  const int g = lane >> 2, c = lane & 3;                  // mma fragment coordinates
  const int b = blockIdx.y;
  const int head = blockIdx.x * HB + q;
  const bool active = head < H;

  unsigned char* hb = sm + kSharedBytes + q * kHeadBytes<XT>;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(hb + kHeadX);   // [64][kLd] (x's high parts)
  __nv_bfloat16* xl = reinterpret_cast<__nv_bfloat16*>(hb + kHeadXlo); // float32 x: low parts
  __nv_bfloat16* Rhi = reinterpret_cast<__nv_bfloat16*>(hb + kHeadR);  // S, then B_dec
  __nv_bfloat16* Rlo = Rhi + kTileRows * kLd;
  float* lcs = reinterpret_cast<float*>(hb + kHeadVec);                // logc
  float* dts = lcs + kTileRows;                                         // dt
  float* elc = dts + kTileRows;                                         // exp(logc)
  float* wdec = elc + kTileRows;                                        // dt exp(lc_last - lc)

  const float a_h = active ? A[head] : 0.f, d_h = active ? Dv[head] : 0.f;
  const size_t xbase = ((size_t)b * H + head) * T_len * P;
  const size_t dbase = ((size_t)b * H + head) * T_len;
  const bool x_vec = !kSplitX && P == kTileRows && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  // The head's state, rows 16w + g (+ 8), columns 8j + 2c (+ 1).
  float S[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) S[j][i] = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += C) {
    __syncthreads();                        // the previous chunk is consumed

    // B and C of the chunk, as bf16 high and low parts, zero-padded.
    const size_t bb = ((size_t)b * T_len + t0) * N;
#pragma unroll 4
    for (int e = tid; e < kTileRows * 32; e += 128 * HB) {
      const int t = e >> 5, n = 2 * (e & 31);
      float b0 = 0.f, b1 = 0.f, c0 = 0.f, c1 = 0.f;
      if (t < C) {
        const size_t o = bb + (size_t)t * N + n;
        if (n < N) {
          b0 = Bm[o];
          c0 = Cm[o];
        }
        if (n + 1 < N) {
          b1 = Bm[o + 1];
          c1 = Cm[o + 1];
        }
      }
      uint32_t hi, lo;
      split2(b0, b1, hi, lo);
      *reinterpret_cast<uint32_t*>(Bhi + t * kLd + n) = hi;
      *reinterpret_cast<uint32_t*>(Blo + t * kLd + n) = lo;
      split2(c0, c1, hi, lo);
      *reinterpret_cast<uint32_t*>(Chi + t * kLd + n) = hi;
      *reinterpret_cast<uint32_t*>(Clo + t * kLd + n) = lo;
    }

    if (active) {
      // x of the chunk, zero-padded.
      const size_t xb = xbase + (size_t)t0 * P;
      if (x_vec) {
        for (int e = tq; e < kTileRows * 8; e += 128) {
          const int t = e >> 3, cc = 8 * (e & 7);
          if (t < C)
            cp_async16(xs + t * kLd + cc, x + xb + (size_t)t * P + cc);
          else
            *reinterpret_cast<uint4*>(xs + t * kLd + cc) = make_uint4(0, 0, 0, 0);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      } else if constexpr (kSplitX) {
        for (int e = tq; e < kTileRows * 32; e += 128) {
          const int t = e >> 5, p = 2 * (e & 31);
          const XT* src = x + xb + (size_t)t * P + p;
          const float x0 = t < C && p < P ? src[0] : 0.f;
          const float x1 = t < C && p + 1 < P ? src[1] : 0.f;
          uint32_t hi, lo;
          split2(x0, x1, hi, lo);
          *reinterpret_cast<uint32_t*>(xs + t * kLd + p) = hi;
          *reinterpret_cast<uint32_t*>(xl + t * kLd + p) = lo;
        }
      } else {
        for (int e = tq; e < kTileRows * kTileRows; e += 128) {
          const int t = e >> 6, p = e & 63;
          xs[t * kLd + p] = (t < C && p < P) ? x[xb + (size_t)t * P + p] : __float2bfloat16(0.f);
        }
      }
      // logc by a warp scan (warp 0 of the head).
      if (w == 0) {
        const int t = 2 * lane;
        const float d0 = t < C ? dt[dbase + t0 + t] : 0.f;
        const float d1 = t + 1 < C ? dt[dbase + t0 + t + 1] : 0.f;
        float l0, l1;
        chunk_logc(a_h * d0, a_h * d1, lane, l0, l1);
        const float last = __shfl_sync(kFull, l1, 31);   // = logc[C - 1]: dt = 0 past C
        lcs[t] = l0;
        lcs[t + 1] = l1;
        dts[t] = d0;
        dts[t + 1] = d1;
        elc[t] = expf(l0);
        elc[t + 1] = expf(l1);
        wdec[t] = d0 * expf(last - l0);
        wdec[t + 1] = d1 * expf(last - l1);
      }
      // The state on entry as bf16 parts, [n][p].
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t hi, lo;
        const int r = 16 * w + g, col = 8 * j + 2 * c;
        split2(S[j][0], S[j][1], hi, lo);
        *reinterpret_cast<uint32_t*>(Rhi + r * kLd + col) = hi;
        *reinterpret_cast<uint32_t*>(Rlo + r * kLd + col) = lo;
        split2(S[j][2], S[j][3], hi, lo);
        *reinterpret_cast<uint32_t*>(Rhi + (r + 8) * kLd + col) = hi;
        *reinterpret_cast<uint32_t*>(Rlo + (r + 8) * kLd + col) = lo;
      }
      if (x_vec) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();

    // C B^T, once for the block's heads: warp i of the block takes rows
    // 16 (i % 4) .. and 8 / HB of the eight 8-column tiles.
    {
      constexpr int NT = 8 / HB;
      const int rb = wib & 3, j0 = (wib >> 2) * NT;
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        const int ar = 16 * rb + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int ac = 16 * kk + (lane >> 4) * 8;
        ldsm_x4(smem_addr(Chi + ar * kLd + ac), ah);
        ldsm_x4(smem_addr(Clo + ar * kLd + ac), al);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bh[4], bl[4];
          const int br = 8 * (j0 + j) + (lane & 7) + (lane >> 4) * 8;
          const int bc = 16 * kk + ((lane >> 3) & 1) * 8;
          ldsm_x4(smem_addr(Bhi + br * kLd + bc), bh);
          ldsm_x4(smem_addr(Blo + br * kLd + bc), bl);
          mma(acc[j], ah, bh[0], bh[1]);
          mma(acc[j], ah, bl[0], bl[1]);
          mma(acc[j], al, bh[0], bh[1]);
          mma(acc[j + 1], ah, bh[2], bh[3]);
          mma(acc[j + 1], ah, bl[2], bl[3]);
          mma(acc[j + 1], al, bh[2], bh[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = 16 * rb + g, col = 8 * (j0 + j) + 2 * c;
        *reinterpret_cast<float2*>(CB + r * kLdF + col) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(CB + (r + 8) * kLdF + col) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();
    if (!active) continue;

    const int r0 = 16 * w + g, r1 = r0 + 8;     // this thread's rows t (and n)
    // y = exp(logc[t]) C S0: A = C parts (rows t), B = S parts [n][p].
    float yacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) yacc[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      const int ar = 16 * w + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int ac = 16 * kk + (lane >> 4) * 8;
      ldsm_x4(smem_addr(Chi + ar * kLd + ac), ah);
      ldsm_x4(smem_addr(Clo + ar * kLd + ac), al);
      const int br = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bh[4], bl[4];
        const int bc = 8 * j + (lane >> 4) * 8;
        ldsm_x4_t(smem_addr(Rhi + br * kLd + bc), bh);
        ldsm_x4_t(smem_addr(Rlo + br * kLd + bc), bl);
        mma(yacc[j], ah, bh[0], bh[1]);
        mma(yacc[j], ah, bl[0], bl[1]);
        mma(yacc[j], al, bh[0], bh[1]);
        mma(yacc[j + 1], ah, bh[2], bh[3]);
        mma(yacc[j + 1], ah, bl[2], bl[3]);
        mma(yacc[j + 1], al, bh[2], bh[3]);
      }
    }
    {
      const float e0 = elc[r0], e1 = elc[r1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        yacc[j][0] *= e0;
        yacc[j][1] *= e0;
        yacc[j][2] *= e1;
        yacc[j][3] *= e1;
      }
    }
    // y += att x over the key blocks kk <= w (causal): att from C B^T, the
    // decay mask and dt in float32, split into bf16 parts as the A operand.
    {
      const float lt0 = lcs[r0], lt1 = lcs[r1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > w) break;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s0 = 16 * kk + 8 * half + 2 * c, s1 = s0 + 1;
          const float2 cb0 = *reinterpret_cast<const float2*>(CB + r0 * kLdF + s0);
          const float2 cb1 = *reinterpret_cast<const float2*>(CB + r1 * kLdF + s0);
          const float ls0 = lcs[s0], ls1 = lcs[s1], ds0 = dts[s0], ds1 = dts[s1];
          const float v00 = s0 <= r0 ? cb0.x * ds0 * expf(lt0 - ls0) : 0.f;
          const float v01 = s1 <= r0 ? cb0.y * ds1 * expf(lt0 - ls1) : 0.f;
          const float v10 = s0 <= r1 ? cb1.x * ds0 * expf(lt1 - ls0) : 0.f;
          const float v11 = s1 <= r1 ? cb1.y * ds1 * expf(lt1 - ls1) : 0.f;
          split2(v00, v01, ah[2 * half], al[2 * half]);
          split2(v10, v11, ah[2 * half + 1], al[2 * half + 1]);
        }
        const int br = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          const int off = br * kLd + 8 * j + (lane >> 4) * 8;
          mma_x<kSplitX>(yacc[j], yacc[j + 1], ah, al, xs + off, xl + off);
        }
      }
    }
    // y += D x; store the chunk's rows t < C, columns p < P.
    {
      const size_t yb = xbase + (size_t)t0 * P;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * c;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = hr ? r1 : r0;
          float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + t * kLd + col));
          if constexpr (kSplitX) {
            const float2 xlv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xl + t * kLd + col));
            xv = make_float2(xv.x + xlv.x, xv.y + xlv.y);
          }
          const float v0 = fmaf(d_h, xv.x, yacc[j][2 * hr]);
          const float v1 = fmaf(d_h, xv.y, yacc[j][2 * hr + 1]);
          if (t < C && col < P)
            store_pair(y + yb + (size_t)t * P + col, v0, v1, col + 1 < P, (P & 1) == 0);
        }
      }
    }
    wg_barrier(1 + q);                      // the head's warps are done with S's parts

    // B_dec = B dt exp(logc[C-1] - logc[s]) as bf16 parts, [s][n].
    for (int e = tq; e < kTileRows * 32; e += 128) {
      const int s = e >> 5, n = 2 * (e & 31);
      const float2 bh = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Bhi + s * kLd + n));
      const float2 bl = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Blo + s * kLd + n));
      const float ws = wdec[s];
      uint32_t hi, lo;
      split2((bh.x + bl.x) * ws, (bh.y + bl.y) * ws, hi, lo);
      *reinterpret_cast<uint32_t*>(Rhi + s * kLd + n) = hi;
      *reinterpret_cast<uint32_t*>(Rlo + s * kLd + n) = lo;
    }
    wg_barrier(1 + q);

    // S = exp(logc[C-1]) S + B_dec^T x: A = B_dec^T (rows n) from [s][n]
    // by transposed loads, B = x [s][p].
    {
      const float decay = expf(lcs[kTileRows - 1]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) S[j][i] *= decay;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        const int mi = lane >> 3;
        const int ar = 16 * kk + (lane & 7) + (mi >> 1) * 8;
        const int ac = 16 * w + (mi & 1) * 8;
        ldsm_x4_t(smem_addr(Rhi + ar * kLd + ac), ah);
        ldsm_x4_t(smem_addr(Rlo + ar * kLd + ac), al);
        const int br = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          const int off = br * kLd + 8 * j + (lane >> 4) * 8;
          mma_x<kSplitX>(S[j], S[j + 1], ah, al, xs + off, xl + off);
        }
      }
    }
  }

  if (!active) return;
  float* so = s_out + ((size_t)b * H + head) * N * P;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * c;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int n = 16 * w + g + 8 * hr;
      if (n < N && col < P) so[(size_t)n * P + col] = S[j][2 * hr];
      if (n < N && col + 1 < P) so[(size_t)n * P + col + 1] = S[j][2 * hr + 1];
    }
  }
}

template <typename XT, int HB>
int launch_mma(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
               const void* D, void* y, void* s, int B, int H, int T_len, int P, int N, int C,
               int smem, cudaStream_t stream) {
  if (smem != kSharedBytes + HB * kHeadBytes<XT>) return (int)cudaErrorInvalidValue;
  static bool attr = false;                 // the attribute, once per instance
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(mamba2_mma_kernel<XT, HB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  mamba2_mma_kernel<XT, HB><<<dim3((H + HB - 1) / HB, B), 128 * HB, smem, stream>>>(
      (const XT*)x, (const float*)dt, (const float*)A, (const float*)Bm, (const float*)Cm,
      (const float*)D, (XT*)y, (float*)s, H, T_len, P, N, C);
  return (int)cudaGetLastError();
}

// The instances: 1, 2 or 4 heads a block for bf16 x; 1 or 2 for float32 x.
template <typename XT>
int launch_dtype(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                 const void* D, void* y, void* s, int B, int H, int T_len, int P, int N, int C,
                 int heads_per_block, int smem, cudaStream_t st) {
  switch (heads_per_block) {
    case 1: return launch_mma<XT, 1>(x, dt, A, Bm, Cm, D, y, s, B, H, T_len, P, N, C, smem, st);
    case 2: return launch_mma<XT, 2>(x, dt, A, Bm, Cm, D, y, s, B, H, T_len, P, N, C, smem, st);
    case 4:
      if constexpr (sizeof(XT) == 2)
        return launch_mma<XT, 4>(x, dt, A, Bm, Cm, D, y, s, B, H, T_len, P, N, C, smem, st);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, both the tensor-core kernel with
// kernel.py's heads_plan (heads a block and shared memory a block, which
// this side checks against the dtype's layout).  The wrapper has checked
// the shapes, 0 < P, N <= 64, 0 < C <= 64, T % C == 0 and T > 0.
extern "C" int mamba2_scan_launch(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, const void* D, void* y,
                                  void* s, int B, int H, int T_len, int P, int N, int C,
                                  int dtype, int heads_per_block, int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dtype<float>(x, dt, A, Bm, Cm, D, y, s, B, H, T_len, P, N, C,
                               heads_per_block, smem, st);
  return launch_dtype<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, s, B, H, T_len, P, N, C,
                                     heads_per_block, smem, st);
}
