// K3: segmented capped-LRU-stack scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/stackdist/kernel.py:
// _stack_scan_kernel (stack_scan_pallas), the hot loop of the exact
// stack-distance engine that Fig 4's sweep takes by default.  L lanes each
// walk the C accesses of their row of a set-sorted tag stream through a
// capped LRU stack of W slots (most recent first, -1 = empty):
//   if seg[l, c]:  stack[:] = -1                    (a set segment starts)
//   depth[l, c] = first slot holding tag[l, c], else -1
//   idx = depth on a hit, else W - 1 (the LRU slot is evicted)
//   slots [0, idx] rotate right by one and slot 0 takes the tag
// final[l, :] is the stack after the walk.  This is lru_stack_step of
// src/repro/kernels/stackdist/ref.py, one access per lane per step.
//
// Bound on this card: the lanes are independent, so unlike K1/K2 the work
// spreads over L threads (tens of thousands at Fig 4's shapes).  Each
// (lane, access) reads a 4-byte tag and a 1-byte flag and writes a 4-byte
// depth, and does W compares; the bytes bound (9 B per access over
// 3.35 TB/s) is far above the compare bound.  One thread per lane keeps
// its stack in registers for W <= 32 (fully unrolled slot loops, so no
// dynamic register indexing); wider stacks (the engine allows up to 256
// slots) live in the lane's row of `final` in device memory.  A thread
// reads its own row of tags, so a warp's loads are not coalesced; the
// rows' cache lines are reused across 32 consecutive steps from L1.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int MAXW>
__global__ void stack_scan_reg_kernel(const int32_t* __restrict__ tags,
                                      const uint8_t* __restrict__ seg,
                                      const int32_t* __restrict__ init,
                                      int32_t* __restrict__ depths,
                                      int32_t* __restrict__ final_stack,
                                      int L, int C, int W) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int32_t* t_l = tags + (size_t)l * C;
  const uint8_t* f_l = seg + (size_t)l * C;
  int32_t* d_l = depths + (size_t)l * C;
  int st[MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) st[i] = i < W ? init[(size_t)l * W + i] : -1;
  for (int c = 0; c < C; ++c) {
    const int t = t_l[c];
    if (f_l[c]) {
#pragma unroll
      for (int i = 0; i < MAXW; ++i) st[i] = -1;
    }
    int depth = -1;
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      if (i < W && depth < 0 && st[i] == t) depth = i;
    }
    const int idx = depth >= 0 ? depth : W - 1;
    // High slots first, so each reads its neighbour's old value; slots >= W
    // are never touched because idx <= W - 1.
#pragma unroll
    for (int i = MAXW - 1; i > 0; --i) {
      if (i <= idx) st[i] = st[i - 1];
    }
    st[0] = t;
    d_l[c] = depth;
  }
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i < W) final_stack[(size_t)l * W + i] = st[i];
  }
}

// Same walk for any W, with the stack kept in the lane's row of final_stack.
__global__ void stack_scan_mem_kernel(const int32_t* __restrict__ tags,
                                      const uint8_t* __restrict__ seg,
                                      const int32_t* __restrict__ init,
                                      int32_t* __restrict__ depths,
                                      int32_t* __restrict__ final_stack,
                                      int L, int C, int W) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int32_t* t_l = tags + (size_t)l * C;
  const uint8_t* f_l = seg + (size_t)l * C;
  int32_t* d_l = depths + (size_t)l * C;
  int32_t* st = final_stack + (size_t)l * W;
  for (int i = 0; i < W; ++i) st[i] = init[(size_t)l * W + i];
  for (int c = 0; c < C; ++c) {
    const int t = t_l[c];
    if (f_l[c]) {
      for (int i = 0; i < W; ++i) st[i] = -1;
    }
    int depth = -1;
    for (int i = 0; i < W; ++i) {
      if (st[i] == t) {
        depth = i;
        break;
      }
    }
    const int idx = depth >= 0 ? depth : W - 1;
    for (int i = idx; i > 0; --i) st[i] = st[i - 1];
    st[0] = t;
    d_l[c] = depth;
  }
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int stack_scan_launch(const void* tags, const void* seg,
                                 const void* init, void* depths,
                                 void* final_stack, int L, int C, int W,
                                 void* stream) {
  if (L > 0) {
    const dim3 grid((L + kThreads - 1) / kThreads), block(kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    auto t = (const int32_t*)tags;
    auto f = (const uint8_t*)seg;
    auto i0 = (const int32_t*)init;
    auto d = (int32_t*)depths;
    auto fin = (int32_t*)final_stack;
    if (W <= 4) {
      stack_scan_reg_kernel<4><<<grid, block, 0, s>>>(t, f, i0, d, fin, L, C, W);
    } else if (W <= 8) {
      stack_scan_reg_kernel<8><<<grid, block, 0, s>>>(t, f, i0, d, fin, L, C, W);
    } else if (W <= 16) {
      stack_scan_reg_kernel<16><<<grid, block, 0, s>>>(t, f, i0, d, fin, L, C, W);
    } else if (W <= 32) {
      stack_scan_reg_kernel<32><<<grid, block, 0, s>>>(t, f, i0, d, fin, L, C, W);
    } else {
      stack_scan_mem_kernel<<<grid, block, 0, s>>>(t, f, i0, d, fin, L, C, W);
    }
  }
  return (int)cudaGetLastError();
}
