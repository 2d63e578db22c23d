// The set-parallel LRU shared by K1 (tlb_sim.cu) and K2 (system_sim.cu).
//
// Sets never share state: access j of config b reads and writes only row
// s = set[b, j] of the carried (tags, last) state (the step function of
// src/repro/core/tlbsim.py:75-85).  So every (config, set) bucket is an
// independent LRU over its own accesses in trace order, and the stamp an
// access writes, now0 + j + 1, depends only on its global index j.  One
// call of a structure runs in two steps:
//
// 1. Bucketing (a stable counting sort by set, written out here):
//    - count:   task (config b, range of kRange sets, segment of the
//               trace) counts its accesses per set in shared memory with a
//               block of threads, by atomics in any order;
//    - scan:    an exclusive scan over the counts laid out (b, s, segment)
//               gives each (bucket, segment) its first position;
//    - scatter: the same task, as one warp, walks its accesses in order
//               32 a step (the next steps' keys in flight), with its sets'
//               cursors in shared memory started at those positions; a lane
//               writes its (tag, j) at its group's cursor plus the number of
//               lower lanes in the group (the group found by
//               __match_any_sync, its rank by __popc), so every bucket
//               holds its accesses in trace order, and the group's lowest
//               lane advances the cursor.
//    A gate drops the accesses a structure does not apply (K2's TLBs).
// 2. LRU pass: one thread per (config, set) bucket loads the row's W ways
//    into registers (W <= 32; compile-time indices only, so the arrays stay
//    in registers), walks its pairs in batches with the next batch's loads
//    in flight, and writes the row back.  The probe is the reference's:
//    hit = any tag match; way = the first match, else the first argmin of
//    the stamps (strict <, ties keep the first way); the way takes (tag,
//    now0 + j + 1).  Poisoned ways (tag -2, stamp 2^31-1) never match or
//    win; empty ways (tag -1, stamp 0) lose to nothing older.  Wider rows
//    (W > 32) are walked in device memory by the one thread that owns them.
//    A step is a chain of dependent register operations (~45 instructions
//    at 4 ways, ~45-60 ns on the H100), so the pass takes about as long as
//    its longest bucket; a probe of a narrow row that hits only re-stamps
//    its way.
//
// The bucketing never sorts with a library; the wrapper allocates every
// scratch buffer and the kernels allocate nothing.
#pragma once

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace lru_sets {
namespace {

constexpr int kRange = 8192;        // sets per bucketing task (its cursors in shared memory)
constexpr int kScanThreads = 1024;  // threads of a scan block
constexpr int kScanItems = 8;       // counts per scan thread
constexpr int kScanChunk = kScanThreads * kScanItems;
constexpr int kCountThreads = 256;  // threads of a counting task
constexpr int kScatterSteps = 8;    // warp steps of keys a scatter task loads together
constexpr int kPassThreads = 256;   // bucket threads per LRU-pass block (at most)
constexpr long long kSpread = 1 << 16;  // up to this many buckets, one warp per block
constexpr unsigned kFull = 0xffffffffu;

// Which accesses of a structure are applied (K2's gating, system_sim.cu).
enum Gate : int {
  kAll = 0,    // every access (K1)
  kCache = 1,  // the config has a cache
  kAccel = 2,  // has_accel and (probed on every access, or a cache miss)
  kMem = 3,    // a cache miss
};

// One LRU structure of a call: its keys, its carried state, where its hits
// go and how its bucketing is cut.
struct Structure {
  const int32_t* set;    // [B, L] set index of each access
  const int32_t* tag;    // [B, L] tag of each access
  int32_t* tags;         // [B, TS, W] carried state, updated in place
  int32_t* last;         // [B, TS, W]
  uint8_t* out;          // [B, L] hit of each applied access
  int TS, W;             // state rows per config, ways per row
  int sets;              // buckets per config: every set index is below it
  int segs;              // trace segments per config in the bucketing
  int gate;              // Gate
  long long count_base;  // first count of this structure (set by the launcher)
};

// Up to two structures bucketed and passed together (K2's two TLBs).
struct Batch {
  Structure st[2];
  int n;                   // structures in use
  int B, L, now0;
  const int32_t* flags;    // [B, 3] has_cache, has_accel, accel_on_miss_only (K2)
  const uint8_t* craw;     // [B, L] raw cache hits (K2's TLB gates)
  int32_t* counts;         // [entries + 1] counts, then (scanned) positions
  long long entries;       // counts in use; counts[entries] ends up the total
  int2* pairs;             // (tag, j) of every applied access, bucket by bucket
};

// Structure k of a kernel's batch, copied field by field (no local copy of
// the parameter block).
__device__ __forceinline__ Structure pick(const Batch& b, int k) {
  return k ? b.st[1] : b.st[0];
}

// ---------------------------------------------------------------------------
// Bucketing.
// ---------------------------------------------------------------------------

// Bucketing tasks of a structure: one per (config, range of kRange sets,
// segment of the trace), for the count and for the scatter alike.
__host__ __device__ __forceinline__ long long tasks_of(const Structure& st, int B) {
  return (long long)B * ((st.sets + kRange - 1) / kRange) * st.segs;
}

// What a bucketing task covers: config b, sets [lo, lo + n), accesses
// [j_lo, j_hi), and the gate of its row.
struct Task {
  Structure st;
  int b, lo, n, seg, j_lo, j_hi;
  bool row_on, per_access, has_c;
};

__device__ __forceinline__ Task task_of(const Batch& bt, long long t) {
  Task q;
  const long long first = tasks_of(bt.st[0], bt.B);
  const int k = (bt.n > 1 && t >= first) ? 1 : 0;
  if (k) t -= first;
  q.st = pick(bt, k);
  const int ranges = (q.st.sets + kRange - 1) / kRange;
  q.seg = (int)(t % q.st.segs);
  t /= q.st.segs;
  q.lo = (int)(t % ranges) * kRange;
  q.b = (int)(t / ranges);
  q.n = min(kRange, q.st.sets - q.lo);
  const int seg_len = (bt.L + q.st.segs - 1) / q.st.segs;
  q.j_lo = min(bt.L, q.seg * seg_len);
  q.j_hi = min(bt.L, q.j_lo + seg_len);
  bool has_a = false, miss_only = false;
  q.has_c = false;
  if (bt.flags) {
    q.has_c = bt.flags[3 * q.b] > 0;
    has_a = bt.flags[3 * q.b + 1] > 0;
    miss_only = bt.flags[3 * q.b + 2] > 0;
  }
  q.row_on = q.st.gate == kCache ? q.has_c : q.st.gate == kAccel ? has_a : true;
  q.per_access = q.st.gate == kAccel ? miss_only : q.st.gate == kMem;
  return q;
}

// The set (less the task's lo) of access j, or -1 where the task does not
// take it: out of the segment or the range, or gated off.
__device__ __forceinline__ int task_set(const Batch& bt, const Task& q, long long row, int j) {
  if (j >= q.j_hi) return -1;
  const int s = __ldg(q.st.set + row + j) - q.lo;
  if ((unsigned)s >= (unsigned)q.n) return -1;
  if (q.per_access && q.has_c && __ldg(bt.craw + row + j)) return -1;
  return s;
}

// Count: the task's block counts its accesses per set with shared-memory
// atomics, in any order, and writes the counts of (b, set, segment) out.
__global__ void __launch_bounds__(kCountThreads) bucket_count_kernel(const Batch bt) {
  extern __shared__ int tally[];
  const Task q = task_of(bt, blockIdx.x);
  int32_t* cnt = bt.counts + q.st.count_base + ((long long)q.b * q.st.sets + q.lo) * q.st.segs + q.seg;
  for (int i = threadIdx.x; i < q.n; i += kCountThreads) tally[i] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) bt.counts[bt.entries] = 0;
  __syncthreads();
  const long long row = (long long)q.b * bt.L;
  const int span = q.row_on ? q.j_hi - q.j_lo : 0;
#pragma unroll 4
  for (int i0 = 0; i0 < span; i0 += kCountThreads) {
    const int s = task_set(bt, q, row, q.j_lo + i0 + (int)threadIdx.x);
    if (s >= 0) atomicAdd(&tally[s], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < q.n; i += kCountThreads) cnt[(long long)i * q.st.segs] = tally[i];
}

// The next kScatterSteps warp steps' sets (-1 where not taken) and tags.
__device__ __forceinline__ void scatter_keys(const Batch& bt, const Task& q, long long row,
                                             int j0, int (&s)[kScatterSteps],
                                             int (&tg)[kScatterSteps]) {
#pragma unroll
  for (int u = 0; u < kScatterSteps; ++u) {
    const int j = j0 + 32 * u + (int)threadIdx.x;
    s[u] = task_set(bt, q, row, j);
    tg[u] = j < q.j_hi ? __ldg(q.st.tag + row + j) : 0;  // not behind the set's load
  }
}

// Scatter: one warp walks the task's accesses in order, 32 a step, with
// the sets' cursors in shared memory started at the scanned positions and
// the next steps' keys in flight.  Every lane of a group of lanes with one
// set (__match_any_sync) reads the cursor, writes its (tag, j) at the
// cursor plus the number of lower lanes in the group, and the group's
// lowest lane advances the cursor.
__global__ void __launch_bounds__(32) bucket_scatter_kernel(const Batch bt) {
  extern __shared__ int cursor[];
  constexpr int U = kScatterSteps;
  const Task q = task_of(bt, blockIdx.x);
  const int lane = threadIdx.x;
  const int32_t* cnt = bt.counts + q.st.count_base + ((long long)q.b * q.st.sets + q.lo) * q.st.segs + q.seg;
  for (int i0 = 0; i0 < q.n; i0 += 32 * U) {
    int v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 32 * u + lane;
      v[u] = i < q.n ? cnt[(long long)i * q.st.segs] : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 32 * u + lane;
      if (i < q.n) cursor[i] = v[u];
    }
  }
  __syncwarp();
  const long long row = (long long)q.b * bt.L;
  const unsigned lower = (1u << lane) - 1;
  const int j_end = q.row_on ? q.j_hi : q.j_lo;
  int s[U], tg[U];
  scatter_keys(bt, q, row, q.j_lo, s, tg);
  for (int j0 = q.j_lo; j0 < j_end; j0 += 32 * U) {
    int s_next[U], tg_next[U];
    scatter_keys(bt, q, row, j0 + 32 * U, s_next, tg_next);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool on = s[u] >= 0;
      const unsigned act = __ballot_sync(kFull, on);
      unsigned peers = 0;
      int base = 0;
      if (on) {
        peers = __match_any_sync(act, s[u]);
        base = cursor[s[u]];
      }
      __syncwarp();
      if (on) {
        const int rank = __popc(peers & lower);
        if (rank == 0) cursor[s[u]] = base + __popc(peers);
        bt.pairs[base + rank] = make_int2(tg[u], j0 + 32 * u + lane);
      }
      __syncwarp();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = s_next[u];
      tg[u] = tg_next[u];
    }
  }
}

// ---------------------------------------------------------------------------
// Exclusive scan of the counts (reduce, scan the block sums, apply).
// ---------------------------------------------------------------------------

__device__ __forceinline__ int warp_inclusive(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Exclusive prefix of v over a kScanThreads block; *total gets the sum.
__device__ __forceinline__ int block_exclusive(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inc = warp_inclusive(v);
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int x = sh[lane];
    const int xi = warp_inclusive(x);
    sh[lane] = xi - x;
    if (lane == 31) sh[32] = xi;
  }
  __syncthreads();
  const int out = sh[warp] + inc - v;
  *total = sh[32];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kScanThreads)
scan_reduce_kernel(const int32_t* __restrict__ x, long long n, int32_t* __restrict__ partial) {
  __shared__ int sh[33];
  const long long base = (long long)blockIdx.x * kScanChunk;
  int v = 0;
  for (int i = threadIdx.x; i < kScanChunk; i += kScanThreads) {
    if (base + i < n) v += x[base + i];
  }
  int total;
  block_exclusive(v, sh, &total);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
scan_partials_kernel(int32_t* __restrict__ partial, int nb) {
  __shared__ int sh[33];
  int carry = 0;
  for (int base = 0; base < nb; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < nb ? partial[i] : 0;
    int total;
    const int ex = block_exclusive(v, sh, &total);
    if (i < nb) partial[i] = carry + ex;
    carry += total;
  }
}

__global__ void __launch_bounds__(kScanThreads)
scan_apply_kernel(int32_t* __restrict__ x, long long n, const int32_t* __restrict__ partial) {
  __shared__ int sh[33];
  const long long base = (long long)blockIdx.x * kScanChunk + (long long)threadIdx.x * kScanItems;
  int v[kScanItems];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = base + i < n ? x[base + i] : 0;
    sum += v[i];
  }
  int total;
  int run = partial[blockIdx.x] + block_exclusive(sum, sh, &total);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (base + i < n) x[base + i] = run;
    run += v[i];
  }
}

// ---------------------------------------------------------------------------
// The LRU pass.
// ---------------------------------------------------------------------------

// The first index of the least value (strict <: a later way wins only if it
// is strictly older), as a tournament whose left side wins ties; one level
// per STEP, every index a compile-time constant.
template <int WC, int STEP = 1>
__device__ __forceinline__ void tournament(int (&val)[WC], int (&idx)[WC]) {
  if constexpr (STEP < WC) {
#pragma unroll
    for (int i = 0; i + STEP < WC; i += 2 * STEP) {
      if (val[i + STEP] < val[i]) {
        val[i] = val[i + STEP];
        idx[i] = idx[i + STEP];
      }
    }
    tournament<WC, 2 * STEP>(val, idx);
  }
}

template <int WC>
__device__ __forceinline__ int first_argmin(const int (&v)[WC]) {
  int val[WC], idx[WC];
#pragma unroll
  for (int w = 0; w < WC; ++w) {
    val[w] = v[w];
    idx[w] = w;
  }
  tournament<WC>(val, idx);
  return idx[0];
}

// One probe of a row held in registers; returns the hit.  kExact: the row
// has WC ways (else ways at or above W are padding, masked by `valid`: they
// never match, and their stamp INT_MAX never wins).  Narrow exact rows take
// the first match through predicates and branch on the hit, so a hit only
// re-stamps its way; other rows build the match mask.
template <int WC, bool kExact>
__device__ __forceinline__ bool probe(int (&tg)[WC], int (&ls)[WC], unsigned valid, int t,
                                      int now) {
  if constexpr (kExact && WC <= 8) {
    bool first[WC];
    bool any = false;
#pragma unroll
    for (int w = 0; w < WC; ++w) {
      const bool h = tg[w] == t;
      first[w] = h && !any;
      any = any || h;
    }
    if (any) {
#pragma unroll
      for (int w = 0; w < WC; ++w) ls[w] = first[w] ? now : ls[w];
    } else {
      const int way = first_argmin<WC>(ls);
#pragma unroll
      for (int w = 0; w < WC; ++w) {
        tg[w] = w == way ? t : tg[w];
        ls[w] = w == way ? now : ls[w];
      }
    }
    return any;
  } else {
    unsigned m = 0;
#pragma unroll
    for (int w = 0; w < WC; ++w) m |= (tg[w] == t ? 1u : 0u) << w;
    if (!kExact) m &= valid;
    const int way = m ? __ffs(m) - 1 : first_argmin<WC>(ls);
#pragma unroll
    for (int w = 0; w < WC; ++w) {
      tg[w] = w == way ? t : tg[w];
      ls[w] = w == way ? now : ls[w];
    }
    return m != 0;
  }
}

// One bucket's walk with its row in registers (W <= WC <= 32): full batches
// of P pairs with the next batch's loads in flight, then the tail.
template <int WC, bool kExact>
__device__ __forceinline__ void walk_registers(int32_t* row_t, int32_t* row_l, int W,
                                               const int2* __restrict__ pr, int n,
                                               uint8_t* __restrict__ out, int now1) {
  constexpr int P = WC >= 32 ? 8 : 16;
  const unsigned valid = W >= 32 ? kFull : (1u << W) - 1;
  int tg[WC], ls[WC];
#pragma unroll
  for (int w = 0; w < WC; ++w) {
    tg[w] = kExact || w < W ? row_t[w] : 0;
    ls[w] = kExact || w < W ? row_l[w] : INT_MAX;
  }
  int2 cur[P];
#pragma unroll
  for (int k = 0; k < P; ++k) cur[k] = k < n ? pr[k] : make_int2(0, 0);
  int i0 = 0;
  for (; i0 + P <= n; i0 += P) {
    int2 nxt[P];
#pragma unroll
    for (int k = 0; k < P; ++k) nxt[k] = i0 + P + k < n ? pr[i0 + P + k] : make_int2(0, 0);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      out[cur[k].y] = probe<WC, kExact>(tg, ls, valid, cur[k].x, now1 + cur[k].y);
    }
#pragma unroll
    for (int k = 0; k < P; ++k) cur[k] = nxt[k];
  }
  for (; i0 < n; ++i0) {
    const int2 q = pr[i0];
    out[q.y] = probe<WC, kExact>(tg, ls, valid, q.x, now1 + q.y);
  }
#pragma unroll
  for (int w = 0; w < WC; ++w) {
    if (kExact || w < W) {
      row_t[w] = tg[w];
      row_l[w] = ls[w];
    }
  }
}

// The same walk for any W, on the row in device memory (only this thread
// touches it, so it stays in L1).
__device__ __forceinline__ void walk_memory(int32_t* row_t, int32_t* row_l, int W,
                                            const int2* __restrict__ pr, int n,
                                            uint8_t* __restrict__ out, int now1) {
  for (int i = 0; i < n; ++i) {
    const int2 q = pr[i];
    int hit_way = -1, min_way = 0, min_l = row_l[0];
    for (int w = 0; w < W; ++w) {
      if (hit_way < 0 && row_t[w] == q.x) hit_way = w;
      const int l = row_l[w];
      if (l < min_l) {
        min_l = l;
        min_way = w;
      }
    }
    const int way = hit_way >= 0 ? hit_way : min_way;
    row_t[way] = q.x;
    row_l[way] = now1 + q.y;
    out[q.y] = hit_way >= 0;
  }
}

// One thread per (structure, config, set) bucket; WC = 0 walks in memory.
template <int WC, bool kExact>
__global__ void __launch_bounds__(kPassThreads) lru_pass_kernel(const Batch bt) {
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long first = (long long)bt.B * bt.st[0].sets;
  int k = 0;
  if (g >= first) {
    if (bt.n < 2) return;
    k = 1;
    g -= first;
  }
  const Structure st = pick(bt, k);
  if (g >= (long long)bt.B * st.sets) return;
  const long long c = st.count_base + g * st.segs;
  const int start = bt.counts[c];
  const int n = bt.counts[c + st.segs] - start;
  if (n == 0) return;
  const int b = (int)(g / st.sets), s = (int)(g % st.sets);
  const long long r = ((long long)b * st.TS + s) * st.W;
  uint8_t* out = st.out + (long long)b * bt.L;
  if constexpr (WC == 0) {
    walk_memory(st.tags + r, st.last + r, st.W, bt.pairs + start, n, out, bt.now0 + 1);
  } else {
    walk_registers<WC, kExact>(st.tags + r, st.last + r, st.W, bt.pairs + start, n, out,
                               bt.now0 + 1);
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// Scratch the wrapper allocated (lengths in elements).
struct Scratch {
  int32_t* counts;
  long long count_len;
  int32_t* partials;
  long long partial_len;
  int2* pairs;
  long long pair_len;
};

inline void record(cudaEvent_t ev, cudaStream_t stream) {
  if (ev) cudaEventRecord(ev, stream);
}

inline int ways_class(int W) {
  if (W > 32) return 0;
  int wc = 1;
  while (wc < W) wc *= 2;
  return wc;
}

// Buckets bt's structures (their keys, gates and cuts filled in by the
// caller) and runs their LRU pass.  Records `mid` between the bucketing and
// the pass when it is not null.  Returns cudaErrorInvalidValue, launching
// nothing, when a shape or a scratch buffer does not fit.
inline cudaError_t bucket_and_pass(Batch bt, const Scratch& sc, cudaEvent_t mid,
                                   cudaStream_t stream) {
  long long entries = 0, tasks = 0;
  int max_sets = 1, wc = 1;
  for (int k = 0; k < bt.n; ++k) {
    Structure& st = bt.st[k];
    if (st.sets < 1 || st.segs < 1 || st.W < 1 || st.sets > st.TS) return cudaErrorInvalidValue;
    st.count_base = entries;
    entries += (long long)bt.B * st.sets * st.segs;
    tasks += tasks_of(st, bt.B);
    max_sets = std::max(max_sets, std::min(st.sets, kRange));
    const int c = ways_class(st.W);
    wc = (c == 0 || wc == 0) ? 0 : std::max(wc, c);
  }
  const long long nb = (entries + 1 + kScanChunk - 1) / kScanChunk;
  if (sc.count_len < entries + 1 || sc.partial_len < nb ||
      sc.pair_len < (long long)bt.n * bt.B * bt.L || tasks > INT_MAX || nb > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  bt.counts = sc.counts;
  bt.entries = entries;
  bt.pairs = sc.pairs;
  const size_t smem = (size_t)max_sets * sizeof(int);
  bucket_count_kernel<<<(unsigned)tasks, kCountThreads, smem, stream>>>(bt);
  scan_reduce_kernel<<<(unsigned)nb, kScanThreads, 0, stream>>>(sc.counts, entries + 1, sc.partials);
  scan_partials_kernel<<<1, kScanThreads, 0, stream>>>(sc.partials, (int)nb);
  scan_apply_kernel<<<(unsigned)nb, kScanThreads, 0, stream>>>(sc.counts, entries + 1, sc.partials);
  bucket_scatter_kernel<<<(unsigned)tasks, 32, smem, stream>>>(bt);
  record(mid, stream);
  // Few buckets, all of them busy (Fig 10's cache: 9 x 64), would share a
  // handful of SMs whose load-store units then serialise their scattered
  // loads and stores; one warp per block spreads them over the card.
  long long buckets = 0;
  bool exact = true;
  for (int k = 0; k < bt.n; ++k) {
    buckets += (long long)bt.B * bt.st[k].sets;
    exact = exact && bt.st[k].W == wc;
  }
  const int threads = buckets <= kSpread ? 32 : kPassThreads;
  const unsigned grid = (unsigned)((buckets + threads - 1) / threads);
#define LRU_PASS(W_, E_) lru_pass_kernel<W_, E_><<<grid, threads, 0, stream>>>(bt)
  switch (wc) {
    case 1: LRU_PASS(1, true); break;
    case 2: if (exact) LRU_PASS(2, true); else LRU_PASS(2, false); break;
    case 4: if (exact) LRU_PASS(4, true); else LRU_PASS(4, false); break;
    case 8: if (exact) LRU_PASS(8, true); else LRU_PASS(8, false); break;
    case 16: if (exact) LRU_PASS(16, true); else LRU_PASS(16, false); break;
    case 32: if (exact) LRU_PASS(32, true); else LRU_PASS(32, false); break;
    default: LRU_PASS(0, false); break;
  }
#undef LRU_PASS
  return cudaGetLastError();
}

}  // namespace
}  // namespace lru_sets
