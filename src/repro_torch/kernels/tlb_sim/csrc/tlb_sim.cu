// K1: batched, resumable set-associative LRU simulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/tlb_sim/kernel.py:
// _tlb_kernel (tlb_sim_pallas), _tlb_batched_kernel (tlb_sim_batched_pallas)
// and _tlb_batched_carry_kernel (tlb_sim_batched_pallas_carry).  All three
// compute the carry function below: the monolithic variants start it from
// padded_tlb_state with now0 = 0, and the single-config one has B = 1.
//
// For config b and access j, with s = set[b, j] and t = tag[b, j]:
//   hit  = any(tags[b, s, :] == t)
//   way  = first matching way on a hit, else the first argmin of last[b, s, :]
//   tags[b, s, way] = t;  last[b, s, way] = now0 + j + 1   (global int32 stamp)
//   hits[b, j] = hit
// Poisoned ways (tag -2, stamp 2^31-1) arrive in the state; they never match
// and never win the argmin, so padding a config's ways is invisible.
//
// Bound on this card: bytes, 9 per (config, access) (set and tag in, the hit
// out) plus the carried state read and written once; the compares are far
// below the card's integer rate.  What kept the first design (one thread per
// config) far from that bound was the serial chain of L dependent probes per
// config, each waiting on a state row round trip through L2 (~260 ns an
// access in TLBSweepStream).  This design is the set-parallel LRU of
// lru_sets.cuh: a stable counting sort puts each (config, set) bucket's
// accesses together in trace order, and one thread per bucket walks them
// with the row's ways in registers, so the chain is one bucket long and a
// step is a few dozen register instructions.  Its own floor is the longest
// bucket of the call times one probe (~45-60 ns at 4 ways), plus the
// bucketing: a block-parallel count, a scan of the counts and a warp walk of
// each trace segment that scatters the keys.
#include <cstdint>
#include <cuda_runtime.h>

#include "lru_sets.cuh"

extern "C" int tlb_sim_launch(const void* set, const void* tag, void* tags, void* last,
                              void* hits, int B, int L, int TS, int W, int now0, int sets,
                              int segs, void* counts, long long count_len, void* partials,
                              long long partial_len, void* pairs, long long pair_len,
                              void* events, void* stream) {
  using namespace lru_sets;
  if (B <= 0 || L <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaEvent_t* ev = (cudaEvent_t*)events;  // null, or {start, bucketed, done}
  Batch bt{};
  bt.n = 1;
  bt.B = B;
  bt.L = L;
  bt.now0 = now0;
  Structure& s = bt.st[0];
  s.set = (const int32_t*)set;
  s.tag = (const int32_t*)tag;
  s.tags = (int32_t*)tags;
  s.last = (int32_t*)last;
  s.out = (uint8_t*)hits;
  s.TS = TS;
  s.W = W;
  s.sets = sets;
  s.segs = segs;
  s.gate = kAll;
  const Scratch sc{(int32_t*)counts, count_len, (int32_t*)partials, partial_len,
                   (int2*)pairs, pair_len};
  if (ev) record(ev[0], st);
  const cudaError_t err = bucket_and_pass(bt, sc, ev ? ev[1] : nullptr, st);
  if (ev) record(ev[2], st);
  return (int)err;
}

// Message of a cudaError_t returned by any entry point of the library (one
// definition for all the sources linked into it).
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
