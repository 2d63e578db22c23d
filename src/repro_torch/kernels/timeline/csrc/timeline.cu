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
// The floor is the longest sim's accesses times the shortest dependent step.
// The one-thread-per-sim kernel this replaces spent ~0.41 us an access on
// the NVIDIA H100 80GB HBM3 (700 W): its chain thread issued eight global
// loads (one access ahead) and three global stores an access, and every
// step was a series of dependent shared-memory round trips (the MSHR count,
// an int32 modulo by a runtime value, the slot; a bank read after a store
// that may alias it), hits computing a miss's whole path to discard it.
//
// Design.  One block of two warps a sim.  Lane 0 of warp 0 runs the sim's
// chain and touches no device memory inside its loop: warp 1 stages the
// eight input columns, tiles of kTile accesses, into a ring of kStages
// buffers in shared memory (cp.async.bulk for each column's 16-byte aligned
// middle, plain loads for the at most three elements at either end, an
// mbarrier "full" per stage that counts the bytes), and writes each finished
// tile of latency / overhead / done back with coalesced stores once the
// chain has released the stage (an mbarrier "empty" per stage).  A ragged
// last tile and L below one tile are the same code with a shorter count.
// The chain step:
//   * a hit (c_hit) touches only acc[a]: issue = nominal + 0, latency =
//     l_cache, overhead 0, done = issue + l_cache (the reference's !c_hit
//     gates leave the MSHRs, the ports and the banks alone);
//   * a miss reads everything it needs at the top of the step: the
//     accelerator's (acc, head, slot, cnt) as one 16-byte shared load, where
//     slot is a wrapping MSHR slot index (cnt % mshrs, set up from the
//     carried cnt when the state is loaded; no modulo in the loop) and head
//     the ring entry at slot; the next slot's entry; the port row; both
//     banks.  bank[bd] is forwarded in a register from the freshly written
//     bank[bp] when bd == bp and the translation reference fired;
//   * the step is an instance per design (conventional, SPARTA, neither,
//     both flags), picked per sim, so it carries no select between designs;
//   * T = 1 (one TLB port a partition, Fig 11's queues) is an instance with
//     no argmin loop; the general T scans the row.
// The state lives in shared memory when it fits in kMaxStateBytes (loaded at
// entry, written back at exit, cnt counted and exported as before); above
// that, in the sim's row of the carried state in device memory, with the
// slot taken as cnt % mshrs on each miss as before.  On the same card this
// design takes ~0.14 us an access (Fig 11: 55.2-55.7 ms): what is left is
// the step's dependent float chain and its shared stores, which the next
// step's loads wait behind.  Its own floor, the same launch with every
// access a hit (the shortest step it has), is ~0.058 us an access (Fig 11:
// 23.2 ms; chip_smoke.py's chain_floor_ms).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStateBytes = 48 * 1024;
constexpr int kTile = 512;                   // accesses a staged tile
constexpr int kStages = 3;
constexpr int kCols = 8;                     // seven int32 columns, then f32 pen
constexpr int kColWords = kTile + 4;         // a column's tile, shifted to 16-byte alignment
constexpr int kInWords = kCols * kColWords;
constexpr int kOutWords = 3 * kTile;         // latency, overhead, done
constexpr int kThreads = 64;                 // the chain's warp and the staging warp
constexpr unsigned kFull = 0xffffffffu;
// The ring, in bytes: inputs, outputs, each stage's column shifts, then the
// full and empty mbarriers.
constexpr int kRingBytes =
    kStages * (kInWords + kOutWords) * 4 + kStages * kCols * 4 + 2 * kStages * 8;

struct Columns {
  const int32_t* col[kCols];                 // accel, part, bank_d, bank_p, c, th, mh, pen
};

struct Inputs {
  int a, part, bd, bp, c, th, mh;
  float pen;
};

// One accelerator's chain state in shared memory: a single 16-byte load.
struct __align__(16) Accel {
  float acc, head;
  int slot, cnt;
};

__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float wait(float free_at, float arrive) {
  return fmaxf(__fsub_rn(free_at, arrive), 0.0f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
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

__device__ __forceinline__ Inputs read_inputs(const int32_t* in, const int (&sh)[kCols], int j) {
  return Inputs{in[0 * kColWords + sh[0] + j], in[1 * kColWords + sh[1] + j],
                in[2 * kColWords + sh[2] + j], in[3 * kColWords + sh[3] + j],
                in[4 * kColWords + sh[4] + j], in[5 * kColWords + sh[5] + j],
                in[6 * kColWords + sh[6] + j],
                __int_as_float(in[7 * kColWords + sh[7] + j])};
}

// The staging warp: tile k of every column into stage s.  Column element
// g0 + j lands at word shift + j of the column's buffer, where shift is
// g0's word offset within its 16-byte line, so the bulk copy of the aligned
// middle has aligned ends on both sides; lanes copy the ends.
__device__ __forceinline__ void stage_tile(const Columns& cols, size_t g0, int n,
                                           int32_t* in, int* shifts, uint32_t full, int lane) {
  int e0 = 0, e1 = 0, shift = 0;
  if (lane < kCols) {
    const int32_t* src = cols.col[lane] + g0;
    shift = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    e0 = min((4 - shift) & 3, n);
    e1 = e0 + ((n - e0) & ~3);
    shifts[lane] = shift;
  }
  // The ends: column c's elements [0, e0) and [e1, n), at most 3 + 3.
  for (int idx = lane; idx < kCols * 6; idx += 32) {
    const int c = idx / 6, m = idx - 6 * c;
    const int32_t* src = cols.col[c] + g0;
    const int sc = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    const int c0 = min((4 - sc) & 3, n), c1 = c0 + ((n - c0) & ~3);
    const int j = m < 3 ? m : c1 + (m - 3);
    if (m < 3 ? j < c0 : j < n) in[c * kColWords + sc + j] = src[j];
  }
  uint32_t bytes = 4u * (uint32_t)(e1 - e0);
#pragma unroll
  for (int o = 1; o < kCols; o <<= 1) bytes += __shfl_xor_sync(kFull, bytes, o);
  __syncwarp();
  if (lane == 0) mbar_expect_tx(full, bytes);   // the arrival: the ends are in place
  __syncwarp();
  if (lane < kCols && e1 > e0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(in + lane * kColWords + shift + e0)),
        "l"(cols.col[lane] + g0 + e0), "r"(4 * (e1 - e0)), "r"(full)
        : "memory");
  }
}

__device__ __forceinline__ void drain_tile(const float* out, size_t g0, int n, float* lat,
                                           float* ov, float* done, int lane) {
  for (int j = lane; j < n; j += 32) {
    lat[g0 + j] = out[j];
    ov[g0 + j] = out[kTile + j];
    done[g0 + j] = out[2 * kTile + j];
  }
}

// The sim's chain, on one thread.  kSerial / kMemtlb: the design's flags
// (conventional, SPARTA, neither: DIPTA and ideal; both as the reference
// would run them), fixed per sim, so the step carries no select between
// designs.
struct ChainArgs {
  const float* fparams;
  const int32_t* ring_in;
  float* ring_out;
  const int* ring_shift;
  uint32_t bar0;
  Accel* accs;
  float *acc, *mshr, *port, *bank;
  int32_t* cnt;
  int mshrs, ports, banks, M, T, L, ntiles;
};

template <bool kSerial, bool kMemtlb, bool kShared, bool kOnePort>
__device__ __forceinline__ void run_chain(const ChainArgs& cx) {
  const float* fp = cx.fparams;
  const float l_cache = fp[0], l_tlb = fp[1], l_dram = fp[2], t_net = fp[3];
  const float walk2 = fp[4], tlb_occ = fp[5], dram_occ = fp[6], issue_iv = fp[7];
  constexpr bool serial = kSerial, memtlb = kMemtlb;
  const int mshrs = cx.mshrs, ports = cx.ports, banks = cx.banks, M = cx.M, T = cx.T;
  const int mshr_mod = mshrs > 1 ? mshrs : 1;
  Accel* accs = cx.accs;
  float *acc = cx.acc, *mshr = cx.mshr, *port = cx.port, *bank = cx.bank;
  int32_t* cnt = cx.cnt;
  const int L = cx.L, ntiles = cx.ntiles;
  const uint32_t bar0 = cx.bar0;

  for (int k = 0; k < ntiles; ++k) {
    const int s = k % kStages;
    mbar_wait(bar0 + 8 * s, (k / kStages) & 1);
    const int n = min(kTile, L - k * kTile);
    const int32_t* in = cx.ring_in + s * kInWords;
    float* out = cx.ring_out + s * kOutWords;
    int sh[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) sh[c] = cx.ring_shift[s * kCols + c];
    Inputs x = read_inputs(in, sh, 0);
    for (int j = 0; j < n; ++j) {
      const Inputs nx = read_inputs(in, sh, j + 1);   // word n is in the buffer
      float latency, overhead, done;
      if (x.c != 0) {
        // A hit touches acc[a] alone.
        float* pa = kShared ? &accs[x.a].acc : acc + x.a;
        const float issue = add(*pa, 0.0f);
        latency = l_cache;
        overhead = 0.0f;
        done = add(issue, l_cache);
        *pa = add(issue, issue_iv);
      } else {
        // Every read of the step first.
        float nominal, head, next_head = 0.0f;
        int slot, count;
        if (kShared) {
          const Accel st = accs[x.a];
          nominal = st.acc;
          head = st.head;
          slot = st.slot;
          count = st.cnt;
          const int ns = slot + 1 >= mshrs ? 0 : slot + 1;
          next_head = mshr[x.a * M + ns];
        } else {
          nominal = acc[x.a];
          count = cnt[x.a];
          slot = count % mshr_mod;
          head = mshr[(size_t)x.a * M + slot];
        }
        float* row = port + (size_t)x.part * T;
        int pslot = 0;
        float pmin = row[0];
        if (!kOnePort) {
          for (int q = 1; q < T; ++q) {
            const float v = row[q];
            if (v < pmin) {
              pmin = v;
              pslot = q;
            }
          }
        }
        const float bank_p = bank[x.bp], bank_d = bank[x.bd];

        // MSHR admission (slot ids never reach padded columns).
        const float w_mshr = wait(head, nominal);
        const float issue = add(nominal, mshrs > 0 ? w_mshr : 0.0f);
        const float t0 = add(issue, l_cache);

        // SPARTA port queue: the earliest-free port, first index on ties.
        const float arr = add(t0, t_net);
        const float w_port = ports > 0 ? wait(pmin, arr) : 0.0f;
        if (memtlb && ports > 0) row[pslot] = add(add(arr, w_port), tlb_occ);
        const float probe_done = add(add(arr, w_port), l_tlb);

        // Translation-path DRAM reference (conventional walk / SPARTA PTE read).
        const float walk_arr = add(add(t0, l_tlb), t_net);
        const float trans_arr = serial ? walk_arr : probe_done;
        const float w_tr = banks > 0 ? wait(bank_p, trans_arr) : 0.0f;
        const bool do_tr = banks > 0 && (serial ? x.th == 0 : (memtlb && x.mh == 0));
        const float bank_p_new = add(add(trans_arr, w_tr), dram_occ);
        if (do_tr) bank[x.bp] = bank_p_new;

        const float walk = add(add(walk2, w_tr), l_dram);
        const float trans_conv = add(l_tlb, x.th != 0 ? 0.0f : walk);
        const float trans_sparta =
            add(add(w_port, l_tlb), x.mh != 0 ? 0.0f : add(w_tr, l_dram));
        const float trans = serial ? trans_conv : (memtlb ? trans_sparta : x.pen);
        const float data_arr = serial ? add(add(t0, trans_conv), t_net)
                                      : (memtlb ? add(arr, trans_sparta) : arr);
        const float pen_eff = (serial || memtlb) ? 0.0f : x.pen;

        // Data DRAM access (all designs); bank[bd] as just written when bd == bp.
        const float bank_d_now = (do_tr && x.bd == x.bp) ? bank_p_new : bank_d;
        const float w_data = banks > 0 ? wait(bank_d_now, data_arr) : 0.0f;
        if (banks > 0) bank[x.bd] = add(add(add(data_arr, w_data), dram_occ), pen_eff);

        float lat_miss;
        if (serial) {
          lat_miss = add(add(add(add(add(l_cache, trans_conv), t_net), w_data), l_dram), t_net);
        } else if (memtlb) {
          lat_miss =
              add(add(add(add(add(l_cache, t_net), trans_sparta), w_data), l_dram), t_net);
        } else {
          lat_miss = add(add(add(add(add(l_cache, t_net), w_data), l_dram), pen_eff), t_net);
        }
        latency = lat_miss;
        overhead = trans;
        done = add(issue, lat_miss);

        const float acc_next = add(issue, issue_iv);
        if (kShared) {
          if (mshrs > 0) {
            mshr[x.a * M + slot] = done;
            const int ns = slot + 1 >= mshrs ? 0 : slot + 1;
            accs[x.a] = Accel{acc_next, mshrs == 1 ? done : next_head, ns, count + 1};
          } else {
            accs[x.a].acc = acc_next;
          }
        } else {
          if (mshrs > 0) {
            mshr[(size_t)x.a * M + slot] = done;
            cnt[x.a] = count + 1;
          }
          acc[x.a] = acc_next;
        }
      }
      out[j] = latency;
      out[kTile + j] = overhead;
      out[2 * kTile + j] = done;
      x = nx;
    }
    mbar_arrive(bar0 + 8 * (kStages + s));    // the stage's inputs read, outputs written
  }
}

// kShared: the state in shared memory (else in device memory); kOnePort:
// T == 1.
template <bool kShared, bool kOnePort>
__global__ void __launch_bounds__(kThreads) timeline_kernel(
    Columns cols, const float* __restrict__ fparams, const int32_t* __restrict__ iparams,
    float* __restrict__ g_acc, float* __restrict__ g_mshr, int32_t* __restrict__ g_cnt,
    float* __restrict__ g_port, float* __restrict__ g_bank, float* __restrict__ lat,
    float* __restrict__ ov, float* __restrict__ done_out, int L, int A, int M, int P, int T,
    int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  int32_t* ring_in = reinterpret_cast<int32_t*>(smem);
  float* ring_out = reinterpret_cast<float*>(ring_in + kStages * kInWords);
  int* ring_shift = reinterpret_cast<int*>(ring_out + kStages * kOutWords);
  const uint32_t bar0 = smem_u32(ring_shift + kStages * kCols);   // full[s], then empty[s]
  unsigned char* state_mem = smem + kRingBytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int32_t* ip = iparams + (size_t)b * 7;
  const int mshrs = ip[3];
  const int mshr_mod = mshrs > 1 ? mshrs : 1;

  float* acc = g_acc + (size_t)b * A;
  float* mshr = g_mshr + (size_t)b * A * M;
  int32_t* cnt = g_cnt + (size_t)b * A;
  float* port = g_port + (size_t)b * P * T;
  float* bank = g_bank + (size_t)b * D;
  Accel* accs = reinterpret_cast<Accel*>(state_mem);
  if (kShared) {
    float* s_mshr = reinterpret_cast<float*>(accs + A);
    float* s_port = s_mshr + A * M;
    float* s_bank = s_port + P * T;
    for (int i = tid; i < A * M; i += kThreads) s_mshr[i] = mshr[i];
    for (int i = tid; i < P * T; i += kThreads) s_port[i] = port[i];
    for (int i = tid; i < D; i += kThreads) s_bank[i] = bank[i];
    for (int i = tid; i < A; i += kThreads) {
      const int sl = cnt[i] % mshr_mod;
      accs[i] = Accel{acc[i], mshr[(size_t)i * M + sl], sl, cnt[i]};
    }
    mshr = s_mshr;
    port = s_port;
    bank = s_bank;
  }
  if (tid == 0) {
    for (int s = 0; s < 2 * kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const size_t off = (size_t)b * L;
  const int ntiles = (L + kTile - 1) / kTile;
  if (warp == 1) {
    // The staging warp: load tile k into stage k % kStages once the chain
    // has released it, draining the outputs of the tile it held.
    for (int k = 0; k < ntiles + kStages; ++k) {
      const int s = k % kStages;
      if (k >= kStages) {
        const int kd = k - kStages;
        mbar_wait(bar0 + 8 * (kStages + s), (kd / kStages) & 1);
        drain_tile(ring_out + s * kOutWords, off + (size_t)kd * kTile,
                   min(kTile, L - kd * kTile), lat, ov, done_out, lane);
        __syncwarp();
      }
      if (k < ntiles) {
        stage_tile(cols, off + (size_t)k * kTile, min(kTile, L - k * kTile),
                   ring_in + s * kInWords, ring_shift + s * kCols, bar0 + 8 * s, lane);
      }
    }
  } else if (tid == 0) {
    const ChainArgs cx{fparams + (size_t)b * 8, ring_in, ring_out, ring_shift, bar0,
                       accs, acc, mshr, port, bank, cnt, mshrs, ip[5], ip[6], M, T, L, ntiles};
    const bool serial = ip[0] != 0, memtlb = ip[1] != 0;
    if (serial && memtlb) {
      run_chain<true, true, kShared, kOnePort>(cx);
    } else if (serial) {
      run_chain<true, false, kShared, kOnePort>(cx);
    } else if (memtlb) {
      run_chain<false, true, kShared, kOnePort>(cx);
    } else {
      run_chain<false, false, kShared, kOnePort>(cx);
    }
  }
  __syncthreads();

  if (kShared) {
    float* s_mshr = reinterpret_cast<float*>(accs + A);
    float* s_port = s_mshr + A * M;
    float* s_bank = s_port + P * T;
    float* o_mshr = g_mshr + (size_t)b * A * M;
    for (int i = tid; i < A; i += kThreads) {
      g_acc[(size_t)b * A + i] = accs[i].acc;
      g_cnt[(size_t)b * A + i] = accs[i].cnt;
    }
    for (int i = tid; i < A * M; i += kThreads) o_mshr[i] = s_mshr[i];
    for (int i = tid; i < P * T; i += kThreads) g_port[(size_t)b * P * T + i] = s_port[i];
    for (int i = tid; i < D; i += kThreads) g_bank[(size_t)b * D + i] = s_bank[i];
  }
  if (tid == 0) {
    for (int s = 0; s < 2 * kStages; ++s)
      asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar0 + 8 * s) : "memory");
  }
}

template <bool kShared, bool kOnePort>
int launch(const Columns& cols, const void* fparams, const void* iparams, void* acc,
           void* mshr, void* cnt, void* port, void* bank, void* lat, void* ov, void* done,
           int B, int L, int A, int M, int P, int T, int D, size_t smem, cudaStream_t stream) {
  static bool attr = false;                 // the attribute, once per instance
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(timeline_kernel<kShared, kOnePort>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kRingBytes + kMaxStateBytes);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  timeline_kernel<kShared, kOnePort><<<B, kThreads, smem, stream>>>(
      cols, (const float*)fparams, (const int32_t*)iparams, (float*)acc, (float*)mshr,
      (int32_t*)cnt, (float*)port, (float*)bank, (float*)lat, (float*)ov, (float*)done, L, A,
      M, P, T, D);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper has checked the shapes, the ids against the envelope and
// mshrs <= M, tlb_ports <= T.
extern "C" int timeline_launch(
    const void* accel, const void* part, const void* bank_d, const void* bank_p,
    const void* cache_hit, const void* tlb_hit, const void* mem_hit,
    const void* pen, const void* fparams, const void* iparams, void* acc,
    void* mshr, void* cnt, void* port, void* bank, void* lat, void* ov,
    void* done, int B, int L, int A, int M, int P, int T, int D, void* stream) {
  if (B <= 0 || L <= 0) return (int)cudaGetLastError();
  const Columns cols{{(const int32_t*)accel, (const int32_t*)part, (const int32_t*)bank_d,
                      (const int32_t*)bank_p, (const int32_t*)cache_hit,
                      (const int32_t*)tlb_hit, (const int32_t*)mem_hit,
                      (const int32_t*)pen}};
  // acc, head, slot, cnt as one 16-byte Accel, then the rings and the banks.
  const size_t state_bytes =
      sizeof(Accel) * (size_t)A + 4 * ((size_t)A * M + (size_t)P * T + D);
  const bool shared = state_bytes <= (size_t)kMaxStateBytes;
  const size_t smem = kRingBytes + (shared ? state_bytes : 0);
  cudaStream_t st = (cudaStream_t)stream;
#define K4_LAUNCH(S, O)                                                                       \
  launch<S, O>(cols, fparams, iparams, acc, mshr, cnt, port, bank, lat, ov, done, B, L, A, M, \
               P, T, D, smem, st)
  if (shared) return T == 1 ? K4_LAUNCH(true, true) : K4_LAUNCH(true, false);
  return T == 1 ? K4_LAUNCH(false, true) : K4_LAUNCH(false, false);
#undef K4_LAUNCH
}
