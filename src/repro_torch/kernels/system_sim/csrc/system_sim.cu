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
// way = first match or else first argmin of the stamps.  A probe always runs;
// it writes (tag, now0 + j + 1) into its way only when its update is enabled.
// Per config, flags[b] = (has_cache, has_accel, accel_probe_on_miss_only):
//   c_hit = has_c & c_raw                  (the cache updates iff has_c)
//   do_a  = (miss_only ? !c_hit : 1) & has_a
//   a_hit = has_a ? (do_a ? a_raw : 1) : 0
//   the mem TLB updates iff !c_hit;  m_hit = !c_hit ? m_raw : 1
//   hits[b, j] = c_hit | a_hit << 1 | m_hit << 2
//
// Bound on this card: as for K1, a serial dependency chain per config (three
// dependent row probes per access), far above the bytes bound of 25 bytes
// per (config, access) (six int32 keys in, one hit word out).  One thread per
// config, each in its own block; the next access's six keys are loaded ahead
// so only the row loads stay on the chain.  Spreading the work over
// (config, set) is the next step (ROADMAP.md).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Structure {
  int32_t* tags;
  int32_t* last;
  int W;
};

// One LRU probe of row s; returns the raw hit and writes only if `update`.
__device__ __forceinline__ bool probe(const Structure& st, int s, int t,
                                      bool update, int now) {
  int32_t* row_t = st.tags + (size_t)s * st.W;
  int32_t* row_l = st.last + (size_t)s * st.W;
  int hit_way = -1;
  int min_way = 0;
  int min_l = row_l[0];
  for (int w = 0; w < st.W; ++w) {
    if (hit_way < 0 && row_t[w] == t) hit_way = w;
    const int l = row_l[w];
    if (l < min_l) {  // strict: ties keep the first index, as argmin does
      min_l = l;
      min_way = w;
    }
  }
  if (update) {
    const int way = hit_way >= 0 ? hit_way : min_way;
    row_t[way] = t;
    row_l[way] = now;
  }
  return hit_way >= 0;
}

__global__ void system_sim_kernel(
    const int32_t* __restrict__ c_set, const int32_t* __restrict__ c_tag,
    const int32_t* __restrict__ a_set, const int32_t* __restrict__ a_tag,
    const int32_t* __restrict__ m_set, const int32_t* __restrict__ m_tag,
    const int32_t* __restrict__ flags,
    int32_t* __restrict__ c_tags, int32_t* __restrict__ c_last,
    int32_t* __restrict__ a_tags, int32_t* __restrict__ a_last,
    int32_t* __restrict__ m_tags, int32_t* __restrict__ m_last,
    uint8_t* __restrict__ hits, int L, int CS, int CW, int AS, int AW,
    int MS, int MW, int now0) {
  const int b = blockIdx.x;
  const size_t off = (size_t)b * L;
  const Structure cache{c_tags + (size_t)b * CS * CW, c_last + (size_t)b * CS * CW, CW};
  const Structure accel{a_tags + (size_t)b * AS * AW, a_last + (size_t)b * AS * AW, AW};
  const Structure mem{m_tags + (size_t)b * MS * MW, m_last + (size_t)b * MS * MW, MW};
  const bool has_c = flags[3 * b] > 0;
  const bool has_a = flags[3 * b + 1] > 0;
  const bool miss_only = flags[3 * b + 2] > 0;
  uint8_t* h_b = hits + off;
  if (L == 0) return;
  int cs = c_set[off], ct = c_tag[off], as = a_set[off], at = a_tag[off];
  int ms = m_set[off], mt = m_tag[off];
  for (int j = 0; j < L; ++j) {
    int cs_n = 0, ct_n = 0, as_n = 0, at_n = 0, ms_n = 0, mt_n = 0;
    if (j + 1 < L) {
      const size_t k = off + j + 1;
      cs_n = c_set[k]; ct_n = c_tag[k];
      as_n = a_set[k]; at_n = a_tag[k];
      ms_n = m_set[k]; mt_n = m_tag[k];
    }
    const int now = now0 + j + 1;
    const bool c_raw = probe(cache, cs, ct, has_c, now);
    const bool c_hit = has_c && c_raw;
    const bool do_a = (miss_only ? !c_hit : true) && has_a;
    const bool a_raw = probe(accel, as, at, do_a, now);
    const bool a_hit = has_a ? (do_a ? a_raw : true) : false;
    const bool m_raw = probe(mem, ms, mt, !c_hit, now);
    const bool m_hit = !c_hit ? m_raw : true;
    h_b[j] = (uint8_t)((int)c_hit | ((int)a_hit << 1) | ((int)m_hit << 2));
    cs = cs_n; ct = ct_n; as = as_n; at = at_n; ms = ms_n; mt = mt_n;
  }
}

}  // namespace

extern "C" int system_sim_launch(
    const void* c_set, const void* c_tag, const void* a_set, const void* a_tag,
    const void* m_set, const void* m_tag, const void* flags, void* c_tags,
    void* c_last, void* a_tags, void* a_last, void* m_tags, void* m_last,
    void* hits, int B, int L, int CS, int CW, int AS, int AW, int MS, int MW,
    int now0, void* stream) {
  if (B > 0) {
    system_sim_kernel<<<B, 1, 0, (cudaStream_t)stream>>>(
        (const int32_t*)c_set, (const int32_t*)c_tag, (const int32_t*)a_set,
        (const int32_t*)a_tag, (const int32_t*)m_set, (const int32_t*)m_tag,
        (const int32_t*)flags, (int32_t*)c_tags, (int32_t*)c_last,
        (int32_t*)a_tags, (int32_t*)a_last, (int32_t*)m_tags,
        (int32_t*)m_last, (uint8_t*)hits, L, CS, CW, AS, AW, MS, MW, now0);
  }
  return (int)cudaGetLastError();
}
