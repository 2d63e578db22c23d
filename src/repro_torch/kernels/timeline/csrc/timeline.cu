// K4: batched, resumable cycle-approximate timeline simulation for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/timeline/kernel.py:
// _timeline_kernel (timeline_sim_pallas), _timeline_batched_kernel
// (timeline_sim_batched_pallas) and _timeline_batched_carry_kernel
// (timeline_sim_batched_pallas_carry).  All three compute the carry function
// below: the monolithic one starts it from timeline_init_state_batched, and
// the single-sim one is B = 1 with that sim's pack_params row.
//
// Per sim b and access j, timeline_step_dyn of src/repro/kernels/timeline/
// ref.py:267-349 with fparams[b] = (l_cache, l_tlb, l_dram, t_net, walk2,
// tlb_occ, dram_occ, issue_interval) and iparams[b] = (serial_walk, mem_tlb,
// num_accels, mshrs, num_partitions, tlb_ports, dram_banks): MSHR admission,
// the earliest-free port of the partition's memory-side TLB (first index on
// ties; poisoned columns never win), the walk / PTE DRAM reference, the data
// DRAM reference, then latency, overhead and done.  The state is the sim's
// row of acc_next [A], mshr_ring [A, M], mshr_cnt [A] (int32), port_free
// [P, T] and bank_free [D], all padded to the batch's envelope.
//
// Bit-identity with the reference: every sum is taken in the reference's
// order with __fadd_rn / __fsub_rn (never contracted into an FMA, never
// reordered), max(x - y, 0) is fmaxf, and each select picks one of two
// values computed in that order.  Times are integral cycle counts in f32.
//
// Bound on this card: a serial dependency chain per sim (each access reads
// and writes state that the next access reads), far above the bytes bound of
// 44 bytes per (sim, access) (seven int32 and one f32 in, three f32 out).
// One thread per sim, each in its own block; the sim's state lives in
// shared memory (loaded at entry, written back at exit) when it fits in
// 48 KB, else in its row of the carried state in device memory; the next
// access's eight inputs are loaded ahead, so only the state reads and writes
// stay on the chain.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSharedBytes = 48 * 1024;

struct Inputs {
  int a, part, bd, bp, c, th, mh;
  float pen;
};

__device__ __forceinline__ Inputs load(const int32_t* __restrict__ accel,
                                       const int32_t* __restrict__ part,
                                       const int32_t* __restrict__ bank_d,
                                       const int32_t* __restrict__ bank_p,
                                       const int32_t* __restrict__ cache_hit,
                                       const int32_t* __restrict__ tlb_hit,
                                       const int32_t* __restrict__ mem_hit,
                                       const float* __restrict__ pen, size_t k) {
  return Inputs{accel[k],     part[k],    bank_d[k],  bank_p[k],
                cache_hit[k], tlb_hit[k], mem_hit[k], pen[k]};
}

__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float wait(float free_at, float arrive) {
  return fmaxf(__fsub_rn(free_at, arrive), 0.0f);
}

__global__ void timeline_kernel(
    const int32_t* __restrict__ accel, const int32_t* __restrict__ part,
    const int32_t* __restrict__ bank_d, const int32_t* __restrict__ bank_p,
    const int32_t* __restrict__ cache_hit, const int32_t* __restrict__ tlb_hit,
    const int32_t* __restrict__ mem_hit, const float* __restrict__ pen,
    const float* __restrict__ fparams, const int32_t* __restrict__ iparams,
    float* __restrict__ g_acc, float* __restrict__ g_mshr,
    int32_t* __restrict__ g_cnt, float* __restrict__ g_port,
    float* __restrict__ g_bank, float* __restrict__ lat,
    float* __restrict__ ov, float* __restrict__ done_out, int L, int A, int M,
    int P, int T, int D, int use_shared) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  float* acc = g_acc + (size_t)b * A;
  float* mshr = g_mshr + (size_t)b * A * M;
  int32_t* cnt = g_cnt + (size_t)b * A;
  float* port = g_port + (size_t)b * P * T;
  float* bank = g_bank + (size_t)b * D;
  if (use_shared) {
    float* s_acc = smem;
    float* s_mshr = s_acc + A;
    int32_t* s_cnt = reinterpret_cast<int32_t*>(s_mshr + A * M);
    float* s_port = reinterpret_cast<float*>(s_cnt + A);
    float* s_bank = s_port + P * T;
    for (int i = 0; i < A; ++i) s_acc[i] = acc[i];
    for (int i = 0; i < A * M; ++i) s_mshr[i] = mshr[i];
    for (int i = 0; i < A; ++i) s_cnt[i] = cnt[i];
    for (int i = 0; i < P * T; ++i) s_port[i] = port[i];
    for (int i = 0; i < D; ++i) s_bank[i] = bank[i];
    acc = s_acc; mshr = s_mshr; cnt = s_cnt; port = s_port; bank = s_bank;
  }

  const float* fp = fparams + (size_t)b * 8;
  const int32_t* ip = iparams + (size_t)b * 7;
  const float l_cache = fp[0], l_tlb = fp[1], l_dram = fp[2], t_net = fp[3];
  const float walk2 = fp[4], tlb_occ = fp[5], dram_occ = fp[6], issue_iv = fp[7];
  const bool serial = ip[0] != 0, memtlb = ip[1] != 0;
  const int mshrs = ip[3], ports = ip[5], banks = ip[6];
  const int mshr_mod = mshrs > 1 ? mshrs : 1;

  const size_t off = (size_t)b * L;
  Inputs x = L > 0 ? load(accel, part, bank_d, bank_p, cache_hit, tlb_hit,
                          mem_hit, pen, off)
                   : Inputs{};
  for (int j = 0; j < L; ++j) {
    Inputs nx{};
    if (j + 1 < L) {
      nx = load(accel, part, bank_d, bank_p, cache_hit, tlb_hit, mem_hit, pen,
                off + j + 1);
    }
    const bool c_hit = x.c != 0;
    const float nominal = acc[x.a];

    // MSHR admission (slot ids never reach padded columns).
    const int slot = cnt[x.a] % mshr_mod;
    float* mshr_slot = mshr + (size_t)x.a * M + slot;
    const float w_mshr = wait(*mshr_slot, nominal);
    const bool use_mshr = !c_hit && mshrs > 0;
    const float issue = add(nominal, use_mshr ? w_mshr : 0.0f);
    const float t0 = add(issue, l_cache);

    // SPARTA port queue: the earliest-free port, first index on ties.
    const float arr = add(t0, t_net);
    float* row = port + (size_t)x.part * T;
    int pslot = 0;
    float pmin = row[0];
    for (int k = 1; k < T; ++k) {
      const float v = row[k];
      if (v < pmin) {
        pmin = v;
        pslot = k;
      }
    }
    const float w_port = ports > 0 ? wait(pmin, arr) : 0.0f;
    if (memtlb && !c_hit && ports > 0) row[pslot] = add(add(arr, w_port), tlb_occ);
    const float probe_done = add(add(arr, w_port), l_tlb);

    // Translation-path DRAM reference (conventional walk / SPARTA PTE read).
    const float walk_arr = add(add(t0, l_tlb), t_net);
    const float trans_arr = serial ? walk_arr : probe_done;
    const float w_tr = banks > 0 ? wait(bank[x.bp], trans_arr) : 0.0f;
    const bool do_tr =
        !c_hit && banks > 0 && (serial ? x.th == 0 : (memtlb && x.mh == 0));
    if (do_tr) bank[x.bp] = add(add(trans_arr, w_tr), dram_occ);

    const float walk = add(add(walk2, w_tr), l_dram);
    const float trans_conv = add(l_tlb, x.th != 0 ? 0.0f : walk);
    const float trans_sparta =
        add(add(w_port, l_tlb), x.mh != 0 ? 0.0f : add(w_tr, l_dram));
    const float trans = serial ? trans_conv : (memtlb ? trans_sparta : x.pen);
    const float data_arr = serial ? add(add(t0, trans_conv), t_net)
                                  : (memtlb ? add(arr, trans_sparta) : arr);
    const float pen_eff = (serial || memtlb) ? 0.0f : x.pen;

    // Data DRAM access (all designs).
    const float w_data = banks > 0 ? wait(bank[x.bd], data_arr) : 0.0f;
    if (!c_hit && banks > 0) {
      bank[x.bd] = add(add(add(data_arr, w_data), dram_occ), pen_eff);
    }

    float lat_miss;
    if (serial) {
      lat_miss = add(add(add(add(add(l_cache, trans_conv), t_net), w_data), l_dram), t_net);
    } else if (memtlb) {
      lat_miss = add(add(add(add(add(l_cache, t_net), trans_sparta), w_data), l_dram), t_net);
    } else {
      lat_miss = add(add(add(add(add(l_cache, t_net), w_data), l_dram), pen_eff), t_net);
    }
    const float latency = c_hit ? l_cache : lat_miss;
    const float done = add(issue, latency);
    lat[off + j] = latency;
    ov[off + j] = c_hit ? 0.0f : trans;
    done_out[off + j] = done;

    if (use_mshr) {
      *mshr_slot = done;
      cnt[x.a] += 1;
    }
    acc[x.a] = add(issue, issue_iv);
    x = nx;
  }

  if (use_shared) {
    float* s_acc = smem;
    float* s_mshr = s_acc + A;
    int32_t* s_cnt = reinterpret_cast<int32_t*>(s_mshr + A * M);
    float* s_port = reinterpret_cast<float*>(s_cnt + A);
    float* s_bank = s_port + P * T;
    for (int i = 0; i < A; ++i) g_acc[(size_t)b * A + i] = s_acc[i];
    for (int i = 0; i < A * M; ++i) g_mshr[(size_t)b * A * M + i] = s_mshr[i];
    for (int i = 0; i < A; ++i) g_cnt[(size_t)b * A + i] = s_cnt[i];
    for (int i = 0; i < P * T; ++i) g_port[(size_t)b * P * T + i] = s_port[i];
    for (int i = 0; i < D; ++i) g_bank[(size_t)b * D + i] = s_bank[i];
  }
}

}  // namespace

extern "C" int timeline_launch(
    const void* accel, const void* part, const void* bank_d, const void* bank_p,
    const void* cache_hit, const void* tlb_hit, const void* mem_hit,
    const void* pen, const void* fparams, const void* iparams, void* acc,
    void* mshr, void* cnt, void* port, void* bank, void* lat, void* ov,
    void* done, int B, int L, int A, int M, int P, int T, int D, void* stream) {
  if (B > 0) {
    const size_t state_bytes = 4 * ((size_t)A + (size_t)A * M + A + (size_t)P * T + D);
    const int use_shared = state_bytes <= (size_t)kMaxSharedBytes;
    timeline_kernel<<<B, 1, use_shared ? state_bytes : 0, (cudaStream_t)stream>>>(
        (const int32_t*)accel, (const int32_t*)part, (const int32_t*)bank_d,
        (const int32_t*)bank_p, (const int32_t*)cache_hit,
        (const int32_t*)tlb_hit, (const int32_t*)mem_hit, (const float*)pen,
        (const float*)fparams, (const int32_t*)iparams, (float*)acc,
        (float*)mshr, (int32_t*)cnt, (float*)port, (float*)bank, (float*)lat,
        (float*)ov, (float*)done, L, A, M, P, T, D, use_shared);
  }
  return (int)cudaGetLastError();
}
