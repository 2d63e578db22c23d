// K2: batched, resumable joint-system simulation for Hopper (sm_90a): data
// cache + accelerator TLB + partitioned memory-side TLB per config.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/system_sim/kernel.py:
// _system_batched_kernel (system_sim_batched_pallas) and
// _system_batched_carry_kernel (system_sim_batched_pallas_carry).  Both
// compute the carry function below; the monolithic one starts it from three
// padded_tlb_state pairs with now0 = 0.
//
// Each structure is the LRU probe of K1 (tlb_sim.cu): hit = any tag match,
// way = first match or else first argmin of the stamps, and the way takes
// (tag, now0 + j + 1) where the structure applies the access.  Per config,
// flags[b] = (has_cache, has_accel, accel_probe_on_miss_only):
//   c_hit = has_c & c_raw                  (the cache applies iff has_c)
//   do_a  = (miss_only ? !c_hit : 1) & has_a
//   a_hit = has_a ? (do_a ? a_raw : 1) : 0  (the accel TLB applies iff do_a)
//   the mem TLB applies iff !c_hit;  m_hit = !c_hit ? m_raw : 1
//   hits[b, j] = c_hit | a_hit << 1 | m_hit << 2
// A raw probe result is read only where its structure applies the access,
// so an access that is not applied need not be probed at all.
//
// Bound on this card: bytes, 25 per (config, access) (six int32 keys in, one
// hit word out) plus the carried state read and written once.  The first
// design (one thread per config, three dependent row probes per access
// through L2, ~750 ns an access over Fig 10) was bound by that serial chain.
// This design runs the set-parallel LRU of lru_sets.cuh as passes:
//   1. the cache: bucket its accesses by (config, set) and walk each bucket
//      in one thread with its ways in registers; writes the raw cache hits;
//   2. the two TLBs, which depend on the cache hits but not on each other,
//      bucketed and walked together in one pair of launches.  Their buckets
//      are formed after pass 1, over the accesses each one applies (the
//      gates above), so a bucket holds only accesses that probe, and the
//      walk needs no gate;
//   3. one elementwise pass packs the hit word.
// Its own floor is the longest cache bucket plus the longer of the two TLBs'
// longest gated buckets, times one register probe, plus two bucketings.
#include <cstdint>
#include <cuda_runtime.h>

#include "../../tlb_sim/csrc/lru_sets.cuh"

namespace {

__global__ void pack_hits_kernel(const int32_t* __restrict__ flags,
                                 const uint8_t* __restrict__ craw,
                                 const uint8_t* __restrict__ araw,
                                 const uint8_t* __restrict__ mraw,
                                 uint8_t* __restrict__ hits, int L, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int b = (int)(i / L);
  const bool has_c = flags[3 * b] > 0;
  const bool has_a = flags[3 * b + 1] > 0;
  const bool miss_only = flags[3 * b + 2] > 0;
  const bool c = has_c && craw[i];
  const bool do_a = has_a && (!miss_only || !c);
  const bool a = has_a && (!do_a || araw[i]);
  const bool m = c || mraw[i];
  hits[i] = (uint8_t)((int)c | ((int)a << 1) | ((int)m << 2));
}

}  // namespace

extern "C" int system_sim_launch(
    const void* c_set, const void* c_tag, const void* a_set, const void* a_tag,
    const void* m_set, const void* m_tag, const void* flags, void* c_tags,
    void* c_last, void* a_tags, void* a_last, void* m_tags, void* m_last,
    void* hits, int B, int L, int CS, int CW, int AS, int AW, int MS, int MW,
    int now0, int c_sets, int c_segs, int a_sets, int a_segs, int m_sets, int m_segs,
    void* raw, void* counts, long long count_len, void* partials, long long partial_len,
    void* pairs, long long pair_len, void* events, void* stream) {
  using namespace lru_sets;
  if (B <= 0 || L <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  // null, or {start, cache bucketed, cache passed, TLBs bucketed, TLBs passed, packed}
  cudaEvent_t* ev = (cudaEvent_t*)events;
  const long long n = (long long)B * L;
  uint8_t* craw = (uint8_t*)raw;
  uint8_t* araw = craw + n;
  uint8_t* mraw = araw + n;
  const Scratch sc{(int32_t*)counts, count_len, (int32_t*)partials, partial_len,
                   (int2*)pairs, pair_len};
  auto structure = [&](const void* set, const void* tag, void* tags, void* last,
                       uint8_t* out, int TS, int W, int sets, int segs, int gate) {
    Structure s{};
    s.set = (const int32_t*)set;
    s.tag = (const int32_t*)tag;
    s.tags = (int32_t*)tags;
    s.last = (int32_t*)last;
    s.out = out;
    s.TS = TS;
    s.W = W;
    s.sets = sets;
    s.segs = segs;
    s.gate = gate;
    return s;
  };
  Batch bt{};
  bt.B = B;
  bt.L = L;
  bt.now0 = now0;
  bt.flags = (const int32_t*)flags;
  bt.craw = craw;

  if (ev) record(ev[0], st);
  bt.n = 1;
  bt.st[0] = structure(c_set, c_tag, c_tags, c_last, craw, CS, CW, c_sets, c_segs, kCache);
  cudaError_t err = bucket_and_pass(bt, sc, ev ? ev[1] : nullptr, st);
  if (err != cudaSuccess) return (int)err;
  if (ev) record(ev[2], st);

  bt.n = 2;
  bt.st[0] = structure(a_set, a_tag, a_tags, a_last, araw, AS, AW, a_sets, a_segs, kAccel);
  bt.st[1] = structure(m_set, m_tag, m_tags, m_last, mraw, MS, MW, m_sets, m_segs, kMem);
  err = bucket_and_pass(bt, sc, ev ? ev[3] : nullptr, st);
  if (err != cudaSuccess) return (int)err;
  if (ev) record(ev[4], st);

  pack_hits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const int32_t*)flags, craw, araw, mraw, (uint8_t*)hits, L, n);
  if (ev) record(ev[5], st);
  return (int)cudaGetLastError();
}
