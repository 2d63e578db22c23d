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
// Bound on this card: the work is a serial dependency chain per config (each
// access reads the state row the previous access may have written), so the
// time is set by the latency of the row loads, not by the 9 bytes per
// (config, access) of set + tag in and hit out (the bytes bound is far
// lower).  This first design runs one thread per config, each in its own
// block so that every config's state rows are cached by a different SM; the
// next access's (set, tag) is loaded before the current row is processed so
// that only the row load stays on the chain.  It uses B threads of the card;
// spreading the work over (config, set) is the next step (ROADMAP.md).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void tlb_sim_kernel(const int32_t* __restrict__ set,
                               const int32_t* __restrict__ tag,
                               int32_t* __restrict__ tags,
                               int32_t* __restrict__ last,
                               uint8_t* __restrict__ hits,
                               int L, int TS, int W, int now0) {
  const int b = blockIdx.x;
  const int32_t* s_b = set + (size_t)b * L;
  const int32_t* t_b = tag + (size_t)b * L;
  int32_t* tags_b = tags + (size_t)b * TS * W;
  int32_t* last_b = last + (size_t)b * TS * W;
  uint8_t* h_b = hits + (size_t)b * L;
  if (L == 0) return;
  int s = s_b[0], t = t_b[0];
  for (int j = 0; j < L; ++j) {
    int s_next = 0, t_next = 0;
    if (j + 1 < L) {
      s_next = s_b[j + 1];
      t_next = t_b[j + 1];
    }
    int32_t* row_t = tags_b + (size_t)s * W;
    int32_t* row_l = last_b + (size_t)s * W;
    int hit_way = -1;
    int min_way = 0;
    int min_l = row_l[0];
    for (int w = 0; w < W; ++w) {
      if (hit_way < 0 && row_t[w] == t) hit_way = w;
      const int l = row_l[w];
      if (l < min_l) {  // strict: ties keep the first index, as argmin does
        min_l = l;
        min_way = w;
      }
    }
    const int way = hit_way >= 0 ? hit_way : min_way;
    row_t[way] = t;
    row_l[way] = now0 + j + 1;
    h_b[j] = hit_way >= 0;
    s = s_next;
    t = t_next;
  }
}

}  // namespace

extern "C" int tlb_sim_launch(const void* set, const void* tag, void* tags,
                              void* last, void* hits, int B, int L, int TS,
                              int W, int now0, void* stream) {
  if (B > 0) {
    tlb_sim_kernel<<<B, 1, 0, (cudaStream_t)stream>>>(
        (const int32_t*)set, (const int32_t*)tag, (int32_t*)tags,
        (int32_t*)last, (uint8_t*)hits, L, TS, W, now0);
  }
  return (int)cudaGetLastError();
}

// Message of a cudaError_t returned by any entry point of the library (one
// definition for all the sources linked into it).
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
