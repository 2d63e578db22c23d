// K3: segmented capped-LRU-stack scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/stackdist/kernel.py:
// _stack_scan_kernel (stack_scan_pallas), the hot loop of the exact
// stack-distance engine that Fig 4's and Fig 5's sweeps take by default.
// L lanes each walk the C accesses of their row of a set-sorted tag stream
// through a capped LRU stack of W slots (most recent first, -1 = empty):
//   if seg[l, c]:  stack[:] = -1                    (a set segment starts)
//   depth[l, c] = first slot holding tag[l, c], else -1
//   idx = depth on a hit, else W - 1 (the LRU slot is evicted)
//   slots [0, idx] rotate right by one and slot 0 takes the tag
// final[l, :] is the stack after the walk.  This is lru_stack_step of
// src/repro/kernels/stackdist/ref.py, one access per lane per step.
//
// Bound on this card: each (lane, access) reads a 4-byte tag and a 1-byte
// flag and writes a 4-byte depth, and does W compares, so the bytes (9 B an
// access over 3.35 TB/s) bound it.  Two things keep a lane-per-thread walk
// far from that bound: a warp's 32 lanes read 32 rows 4 KB apart, so no
// access is coalesced, and the engine's launches often hold too few lanes
// to fill the card (Fig 5's hold 120-4,688), each a chain of C dependent
// steps.  The design answers both (W <= 32, the stack in registers):
//
// * Rows are staged through shared memory by coalesced copies (16-byte
//   cp.async where rows and parts are 16-byte aligned, else 4- and 1-byte
//   loads by consecutive threads), the walks read only shared memory, and
//   the depths are written in place over the tags and leave in coalesced
//   stores.  A thread reads its row 4 steps (a 16-byte chunk) at a time;
//   the chunks of row r are XOR-swizzled by r, so the 8 threads of a
//   quarter warp read 8 different 16-byte bank groups: all 32 banks.
// * kernel.py:stack_plan splits each lane across P threads (a power of two
//   up to 32) from the shapes alone.  P = 1 ("streamed"): a thread walks
//   its whole lane from init_stack through tiles of K steps, two stages
//   in flight.  P > 1 ("resident"): a block holds its lanes' whole rows;
//   thread p walks part p (Q = ceil(C / P) steps) from an unknown stack to
//   its effect (n, s) -- the first n slots of s are the part's distinct
//   tags, most recent first, or n = W and s is the part's final stack once
//   it holds a segment start -- the P effects are scanned with warp
//   shuffles, seeded with init_stack, under
//     (n1, s1) . (n2, s2) = s2[:n2] ++ (s1[:n1] less the first occurrence
//                           of each of s2[:n2]), cut to W slots,
//   and each thread re-walks its part from its carry-in, writing depths.
//   That is the engine's own two-pass lane carry one level down
//   (core/stackdist.py:_merge_effects, with the count n in place of the
//   -1 sentinel so that any tag value, -1 and -2 included, and any
//   init_stack compose exactly).  Both walks read the rows once from
//   device memory, so the bytes bound stays the bound.
//
// Wider stacks (the engine allows up to 256 slots) keep the first walk with
// the stack in the lane's row of `final` in device memory, one thread a lane.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxParts = 32;
constexpr int kMaxThreads = 256;       // threads a block (stack_plan keeps to it)
constexpr int kSmemLimit = 232448;     // 227 KB a block
constexpr int kMemThreads = 128;       // the device-memory walk's block
constexpr int kTile = 64;              // a streamed tile's steps (kernel.py:TILE_STEPS)
constexpr int kResTile = 32;           // a resident copy tile's steps (kernel.py:RES_TILE_STEPS)

struct ScanArgs {
  const int32_t* tags;
  const uint8_t* seg;
  const int32_t* init;
  int32_t* depths;
  int32_t* fin;
  int L, C, W;
  int P, logP, Q;     // parts a lane, log2(P), steps a part (ceil(C / P))
  int K, KS;          // steps a row of a stage holds, and its padded length
  int LB;             // lanes a block
  int vec;            // 16-byte copies: rows, parts and tiles 16-aligned
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most `n` (0-7) of this thread's newest commit groups are
// still in flight.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Rows of KS steps for every thread of the block, the tags (int32) then the
// flags (bytes), both in 16-byte chunks XOR-swizzled by row within groups
// of 8 tag chunks (32 steps) and of fmask + 1 flag chunks (a tile's).
struct Stage {
  int32_t* tags;
  uint8_t* flags;
  int KS, tmask, fmask;

  __device__ __forceinline__ Stage(uint8_t* base, int rows, int KS_, int fmask_)
      : KS(KS_), fmask(fmask_) {
    tags = reinterpret_cast<int32_t*>(base);
    flags = base + (size_t)rows * KS * 4;
    tmask = ((KS >> 2) & 7) == 0 ? 7 : 3;   // KS % 16 == 0: 4 or 8 chunks a group
  }
  __device__ __forceinline__ int tag_at(int r, int s) const {
    return r * KS + ((((s >> 2) ^ (r & tmask))) << 2) + (s & 3);
  }
  __device__ __forceinline__ int flag_at(int r, int s) const {
    return r * KS + ((((s >> 4) ^ (r & fmask))) << 4) + (s & 15);
  }
};

// Row r of the block, steps [off, off + span) of its part: their first
// access in the [L, C] arrays and their count (0 past the last lane or the
// part's end).
__device__ __forceinline__ int run_of(const ScanArgs& a, int lane0, int r, int off, int span,
                                      size_t& g) {
  const int lane = lane0 + (r >> a.logP);
  const int p = r & (a.P - 1);
  const int start = p * a.Q + off;
  const int end = min((p + 1) * a.Q, a.C);
  g = (size_t)lane * a.C + start;
  return lane < a.L ? max(0, min(end - start, span)) : 0;
}

// Copies of a SPAN-step tile of every row, 16 bytes a thread: thread i takes
// tag chunk i % CT of rows i / CT + j T / CT and flag chunk i % CF of rows
// i / CF + j T / CF (CT = SPAN / 4, CF = SPAN / 16), one commit group.  The
// tile is steps [off, off + SPAN) of each part, stored from step `so` of
// each row of `st`.
template <int SPAN>
__device__ __forceinline__ void load_tile_vec(const ScanArgs& a, const Stage& st, int lane0,
                                              int off, int so) {
  constexpr int CT = SPAN / 4, CF = SPAN / 16;
  const int T = blockDim.x;
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const int r = threadIdx.x / CT + j * (T / CT), c = 4 * (threadIdx.x % CT);
    size_t g;
    if (c < run_of(a, lane0, r, off, SPAN, g)) cp_async16(st.tags + st.tag_at(r, so + c), a.tags + g + c);
  }
#pragma unroll
  for (int j = 0; j < CF; ++j) {
    const int r = threadIdx.x / CF + j * (T / CF), c = 16 * (threadIdx.x % CF);
    size_t g;
    if (c < run_of(a, lane0, r, off, SPAN, g)) cp_async16(st.flags + st.flag_at(r, so + c), a.seg + g + c);
  }
  cp_async_commit();
}

template <int SPAN>
__device__ __forceinline__ void store_tile_vec(const ScanArgs& a, const Stage& st, int lane0,
                                               int off, int so) {
  constexpr int CT = SPAN / 4;
  const int T = blockDim.x;
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const int r = threadIdx.x / CT + j * (T / CT), c = 4 * (threadIdx.x % CT);
    size_t g;
    if (c < run_of(a, lane0, r, off, SPAN, g)) {
      *reinterpret_cast<int4*>(a.depths + g + c) =
          *reinterpret_cast<const int4*>(st.tags + st.tag_at(r, so + c));
    }
  }
}

// The same for any span and alignment: a warp a row at a time (warp w takes
// rows w, w + T / 32, ...), its lanes on consecutive 16-byte chunks
// (cp.async) or elements (plain loads and stores) of the row's run.
__device__ void load_tile_any(const ScanArgs& a, const Stage& st, int lane0, int off, int span,
                              int so) {
  const int T = blockDim.x, wl = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < T; r += T >> 5) {
    size_t g;
    const int len = run_of(a, lane0, r, off, span, g);
    if (a.vec) {
      for (int c = 4 * wl; c < len; c += 128) cp_async16(st.tags + st.tag_at(r, so + c), a.tags + g + c);
      for (int c = 16 * wl; c < len; c += 512) cp_async16(st.flags + st.flag_at(r, so + c), a.seg + g + c);
    } else {
      for (int c = wl; c < len; c += 32) {
        st.tags[st.tag_at(r, so + c)] = a.tags[g + c];
        st.flags[st.flag_at(r, so + c)] = a.seg[g + c];
      }
    }
  }
  cp_async_commit();
}

__device__ void store_tile_any(const ScanArgs& a, const Stage& st, int lane0, int off, int span,
                               int so) {
  const int T = blockDim.x, wl = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < T; r += T >> 5) {
    size_t g;
    const int len = run_of(a, lane0, r, off, span, g);
    if (a.vec) {
      for (int c = 4 * wl; c < len; c += 128) {
        *reinterpret_cast<int4*>(a.depths + g + c) =
            *reinterpret_cast<const int4*>(st.tags + st.tag_at(r, so + c));
      }
    } else {
      for (int c = wl; c < len; c += 32) a.depths[g + c] = st.tags[st.tag_at(r, so + c)];
    }
  }
}

template <int SPAN>
__device__ __forceinline__ void load_tile(const ScanArgs& a, const Stage& st, int lane0, int off,
                                          int so) {
  if (a.vec) load_tile_vec<SPAN>(a, st, lane0, off, so);
  else load_tile_any(a, st, lane0, off, SPAN, so);
}

template <int SPAN>
__device__ __forceinline__ void store_tile(const ScanArgs& a, const Stage& st, int lane0,
                                           int off, int so) {
  if (a.vec) store_tile_vec<SPAN>(a, st, lane0, off, so);
  else store_tile_any(a, st, lane0, off, SPAN, so);
}

// One access.  DEPTHS: the exact step from a known stack, returning the
// depth.  Else the effect walk: only the first n slots are known (all W
// after a segment start), a tag is looked up there alone, and a miss
// grows n.  Slot i takes its upper neighbour's old value unless the tag is
// in an earlier slot (slot 0 takes the tag), so a hit at d rotates [0, d]
// and a miss rotates every slot, evicting the last.  Branch-free over all
// MAXW slots: a slot at or past W may take a neighbour's value, but it is
// never matched (i < known <= W) and never read out.
template <int MAXW, bool DEPTHS>
__device__ __forceinline__ int step(int (&s)[MAXW], int& n, int W, int t, bool f) {
  const int known = (DEPTHS || f) ? W : n;
  int v[MAXW];
  bool eq[MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    v[i] = f ? -1 : s[i];
    eq[i] = v[i] == t && i < known;
  }
  bool seen = false;
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    s[i] = seen ? v[i] : (i == 0 ? t : v[i > 0 ? i - 1 : 0]);
    seen = seen || eq[i];
  }
  int depth = -1;
  if (DEPTHS) {
#pragma unroll
    for (int i = MAXW - 1; i >= 0; --i) depth = eq[i] ? i : depth;
  } else {
    n = min(W, known + (seen ? 0 : 1));
  }
  return depth;
}

// Walk steps [from, to) of row r of `st` (from a multiple of 16; 16 steps a
// flag chunk, 4 a tag chunk); DEPTHS writes each chunk's depths over its
// tags.
template <int MAXW, bool DEPTHS, bool GUARD>
__device__ __forceinline__ void walk16(int (&s)[MAXW], int& n, int W, const Stage& st,
                                       int r, int s0, int to) {
  const int4 fv = *reinterpret_cast<const int4*>(st.flags + st.flag_at(r, s0));
  const uint32_t fw[4] = {(uint32_t)fv.x, (uint32_t)fv.y, (uint32_t)fv.z, (uint32_t)fv.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int4* tp = reinterpret_cast<int4*>(st.tags + st.tag_at(r, s0 + 4 * q));
    const int4 tv = *tp;
    const int tg[4] = {tv.x, tv.y, tv.z, tv.w};
    int d[4] = {0, 0, 0, 0};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (!GUARD || s0 + 4 * q + u < to) {
        d[u] = step<MAXW, DEPTHS>(s, n, W, tg[u], (fw[q] >> (8 * u)) & 0xffu);
      }
    }
    if (DEPTHS) *tp = make_int4(d[0], d[1], d[2], d[3]);
  }
}

template <int MAXW, bool DEPTHS>
__device__ __forceinline__ void walk(int (&s)[MAXW], int& n, int W, const Stage& st, int r,
                                     int from, int to) {
  int s0 = from;
  for (; s0 + 16 <= to; s0 += 16) walk16<MAXW, DEPTHS, false>(s, n, W, st, r, s0, to);
  if (s0 < to) walk16<MAXW, DEPTHS, true>(s, n, W, st, r, s0, to);
}

// b := (a then b): b[:nb] ++ (a[:na] less the first occurrence of each of
// b[:nb]), cut to W slots; nb := its known length.  In place: a kept entry
// lands at slot pos >= nb, and only slots < nb are compared.  Static
// indices only, so every slot stays in a register; like the step, slots
// at or past W may take values that are never read.
template <int MAXW>
__device__ __forceinline__ void compose(const int (&a)[MAXW], int na, int (&b)[MAXW], int& nb,
                                        int W) {
  int pos = nb;
#pragma unroll
  for (int j = 0; j < MAXW; ++j) {
    bool in_b = false, first = true;
#pragma unroll
    for (int i = 0; i < MAXW; ++i) in_b = in_b || (i < nb && b[i] == a[j]);
#pragma unroll
    for (int i = 0; i < j; ++i) first = first && a[i] != a[j];
    const bool kept = j < na && !(in_b && first);
#pragma unroll
    for (int i = 0; i < MAXW; ++i) b[i] = (kept && pos == i) ? a[j] : b[i];
    pos += kept ? 1 : 0;
  }
  nb = min(W, pos);
}

template <int MAXW>
__device__ __forceinline__ void load_init(const ScanArgs& a, int lane, int (&s)[MAXW]) {
#pragma unroll
  for (int i = 0; i < MAXW; ++i) s[i] = (i < a.W && lane < a.L) ? a.init[(size_t)lane * a.W + i] : -1;
}

// P = 1: a thread a lane, tiles of K steps through two stages.
template <int MAXW>
__global__ void __launch_bounds__(kMaxThreads, 1)
stack_scan_streamed_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int T = blockDim.x, r = threadIdx.x;
  const int lane0 = blockIdx.x * a.LB, lane = lane0 + r;
  const size_t stage_bytes = (size_t)T * a.KS * 5;
  const int fmask = ((a.KS >> 4) & 3) == 0 ? 3 : ((a.KS >> 4) & 1) == 0 ? 1 : 0;
  auto stage = [&](int k) { return Stage(smem + (k & 1) * stage_bytes, T, a.KS, fmask); };
  auto load = [&](int k) {
    if (a.K == kTile) load_tile<kTile>(a, stage(k), lane0, k * kTile, 0);
    else load_tile_any(a, stage(k), lane0, k * a.K, a.K, 0);
  };
  int s[MAXW];
  load_init(a, lane, s);
  int n = a.W;
  const int tiles = (a.C + a.K - 1) / a.K;
  load(0);
  for (int k = 0; k < tiles; ++k) {
    const Stage cur = stage(k);
    cp_async_wait_all();
    __syncthreads();                                  // tile k in; tile k - 1 stored
    if (k + 1 < tiles) load(k + 1);
    size_t g;
    walk<MAXW, true>(s, n, a.W, cur, r, 0, run_of(a, lane0, r, k * a.K, a.K, g));
    __syncthreads();                                  // every row's depths in place
    if (a.K == kTile) store_tile<kTile>(a, cur, lane0, k * kTile, 0);
    else store_tile_any(a, cur, lane0, k * a.K, a.K, 0);
  }
  if (lane < a.L) {
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      if (i < a.W) a.fin[(size_t)lane * a.W + i] = s[i];
    }
  }
}

// P > 1: the block's lanes' whole parts in shared memory, copied as tiles
// of kResTile steps a row (one commit group each, up to 8 in flight), so
// the effect walk starts on a part's first tile while the rest arrive;
// then a seeded shuffle scan over the lane's P threads, then the re-walk,
// each tile's depths stored as soon as every row has walked it.
template <int MAXW>
__global__ void __launch_bounds__(kMaxThreads, 1)
stack_scan_resident_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int T = blockDim.x, r = threadIdx.x;
  const int lane0 = blockIdx.x * a.LB, lane = lane0 + (r >> a.logP);
  const int p = r & (a.P - 1);
  const Stage st(smem, T, a.KS, 1);                 // 2 flag chunks a 32-step tile
  const int tiles = (a.Q + kResTile - 1) / kResTile;
  const int ahead = min(tiles, 8);
  for (int k = 0; k < ahead; ++k) load_tile<kResTile>(a, st, lane0, k * kResTile, k * kResTile);

  int s[MAXW];
  int n = 0;
#pragma unroll
  for (int i = 0; i < MAXW; ++i) s[i] = -1;
  for (int k = 0; k < tiles; ++k) {                  // the part's effect
    cp_async_wait_pending(min(tiles, ahead + k) - k - 1);
    __syncthreads();                                 // tile k of every row in
    size_t g;
    const int len = run_of(a, lane0, r, k * kResTile, kResTile, g);
    walk<MAXW, false>(s, n, a.W, st, r, k * kResTile, k * kResTile + len);
    if (k + ahead < tiles) {
      load_tile<kResTile>(a, st, lane0, (k + ahead) * kResTile, (k + ahead) * kResTile);
    }
  }

  // Inclusive scan of (init, effect 0, ..., effect p); a lane's P threads
  // are consecutive lanes of one warp (P divides 32, T a multiple of 32).
  if (p == 0) {
    int seed[MAXW];
    load_init(a, lane, seed);
    compose<MAXW>(seed, a.W, s, n, a.W);
  }
  for (int k = 1; k < a.P; k <<= 1) {
    int o[MAXW];
#pragma unroll
    for (int i = 0; i < MAXW; ++i) o[i] = __shfl_up_sync(0xffffffffu, s[i], k, a.P);
    const int no = __shfl_up_sync(0xffffffffu, n, k, a.P);
    if (p >= k) compose<MAXW>(o, no, s, n, a.W);
  }
  // Carry-in: the prefix through part p - 1, or init_stack for part 0.
  int carry[MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) carry[i] = __shfl_up_sync(0xffffffffu, s[i], 1, a.P);
  if (p == 0) load_init(a, lane, carry);
  n = a.W;
  for (int k = 0; k < tiles; ++k) {                  // depths over the tags
    size_t g;
    const int len = run_of(a, lane0, r, k * kResTile, kResTile, g);
    walk<MAXW, true>(carry, n, a.W, st, r, k * kResTile, k * kResTile + len);
    __syncthreads();                                 // tile k of every row walked
    store_tile<kResTile>(a, st, lane0, k * kResTile, k * kResTile);
  }
  if (p == a.P - 1 && lane < a.L) {
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      if (i < a.W) a.fin[(size_t)lane * a.W + i] = carry[i];
    }
  }
}

// Any W, with the stack kept in the lane's row of final_stack.
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

template <int MAXW>
cudaError_t launch(const ScanArgs& a, int smem, cudaStream_t s) {
  const dim3 grid((a.L + a.LB - 1) / a.LB), block(a.LB * a.P);
  auto kernel = a.P == 1 ? stack_scan_streamed_kernel<MAXW> : stack_scan_resident_kernel<MAXW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, s>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// The plan (kernel.py:stack_plan): P parts a lane, Q steps a part, K steps
// a row of a stage holds (padded to KS), LB lanes a block, `stages` stages
// and their shared bytes.  Checked here; a plan that does not fit is
// refused with cudaErrorInvalidValue and nothing is launched.
extern "C" int stack_scan_launch(const void* tags, const void* seg, const void* init,
                                 void* depths, void* final_stack, int L, int C, int W,
                                 int P, int Q, int K, int KS, int LB, int stages, int smem,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (L <= 0 || C <= 0) return 0;
  if (W > 32) {
    stack_scan_mem_kernel<<<(L + kMemThreads - 1) / kMemThreads, kMemThreads, 0, s>>>(
        (const int32_t*)tags, (const uint8_t*)seg, (const int32_t*)init, (int32_t*)depths,
        (int32_t*)final_stack, L, C, W);
    return (int)cudaGetLastError();
  }
  int logP = 0;
  while ((1 << logP) < P) ++logP;
  const int T = LB * P;
  const bool ok = W >= 1 && P >= 1 && P <= kMaxParts && (1 << logP) == P && LB >= 1 &&
                  T >= 32 && T <= kMaxThreads && T % 32 == 0 &&
                  Q == (C + P - 1) / P && K >= 1 && KS % 16 == 0 && KS >= K &&
                  (P == 1 ? (K <= C && stages == (K < C ? 2 : 1) && KS == (K + 15) / 16 * 16)
                          : (K == Q && stages == 1 && KS == (Q + kResTile - 1) / kResTile * kResTile)) &&
                  smem == stages * T * KS * 5 && smem <= kSmemLimit;
  if (!ok) return (int)cudaErrorInvalidValue;
  ScanArgs a{(const int32_t*)tags, (const uint8_t*)seg, (const int32_t*)init, (int32_t*)depths,
             (int32_t*)final_stack, L, C, W, P, logP, Q, K, KS, LB, 0};
  a.vec = aligned16(tags) && aligned16(seg) && aligned16(depths) && C % 16 == 0 &&
          Q % 16 == 0 && K % 16 == 0;
  cudaError_t err;
  if (W <= 4) err = launch<4>(a, smem, s);
  else if (W <= 8) err = launch<8>(a, smem, s);
  else if (W <= 16) err = launch<16>(a, smem, s);
  else err = launch<32>(a, smem, s);
  return (int)err;
}
