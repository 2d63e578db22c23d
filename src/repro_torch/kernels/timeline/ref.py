"""Plain PyTorch version of the cycle-approximate timeline engine (K4).

The port of the JAX package's ``src/repro/kernels/timeline/ref.py``.  One
:func:`timeline_step` / :func:`timeline_step_dyn` advances the queueing state
of B sims by one trace access; the three scans are Python loops over the
access axis, vectorised over the sims.  It is the oracle the CUDA kernel
(``csrc/timeline.cu``) is held against, and slow by nature: one Python
iteration, a few dozen tensor ops, per access.

Latency composition per access (virtual-cache accelerator, Fig 3 timelines):

* cache hit — ``l_cache``; never leaves the accelerator, no queueing.
* cache miss — design-specific translation + data path with three queueing
  points: the accelerator's MSHR window (the i-th miss waits on the
  (i - mshrs)-th miss's completion), the partition's memory-side TLB ports
  (SPARTA only; earliest-free port, ``tlb_occ`` cycles each) and the DRAM
  banks (page walk, PTE read and data fetch each hold a bank ``dram_occ``
  cycles).  A resource count of 0 means unbounded.

Arithmetic is float32 with every sum taken in the reference's order, so the
outputs equal the JAX package's bit for bit; every default latency is an
integer number of cycles, so all times stay exactly representable.  The
state of a batch of sims is stacked on a leading sim axis and padded to the
batch's (A, M, P, T, D) envelope; port columns beyond a sim's own
``tlb_ports`` are poisoned with :data:`PORT_POISON` so the earliest-free
argmin never selects them, and padded MSHR slots and banks are never
indexed.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class TimelineParams(NamedTuple):
    """Static scan parameters of one sim.

    ``serial_walk`` selects the conventional design (private accel-side TLB,
    page walk serialized before the data fetch); ``mem_tlb`` selects SPARTA
    (translation at the partition's memory-side TLB, overlapped with the
    network traversal).  Neither flag => DIPTA/ideal (translation fully
    overlapped; the per-access ``pen`` input carries DIPTA's serialized
    way-misprediction penalty, 0 for ideal).

    A resource count of 0 means *unbounded* (no queueing on that resource).
    """

    serial_walk: bool = False
    mem_tlb: bool = False
    num_accels: int = 1
    mshrs: int = 0            # outstanding-miss slots per accelerator
    num_partitions: int = 1   # memory-side TLB partitions (SPARTA P)
    tlb_ports: int = 0        # service ports per partition TLB
    dram_banks: int = 0       # DRAM banks machine-wide
    l_cache: float = 2.0
    l_tlb: float = 2.0
    l_dram: float = 120.0
    t_net: float = 390.0
    tlb_occ: float = 2.0      # port busy time per probe
    dram_occ: float = 120.0   # bank busy time per access
    issue_interval: float = 1.0  # cycles between successive issues per accel


# Per-sim parameters as packed data rows (the batched engine's layout):
# ``fp`` float32 [8] holds the latency table plus ``walk2``, the host-computed
# ``float32(2.0 * t_net)`` so the conventional walk's round-trip term rounds
# exactly like the static oracle's Python-float fold; ``ip`` int32 [7] holds
# the design flags and resource counts.
FP_COLS = ("l_cache", "l_tlb", "l_dram", "t_net", "walk2", "tlb_occ",
           "dram_occ", "issue_interval")
IP_COLS = ("serial_walk", "mem_tlb", "num_accels", "mshrs", "num_partitions",
           "tlb_ports", "dram_banks")

PORT_POISON = 3.0e38  # ~f32 max: argmin never selects a padded port column

STATE_NAMES = ("acc_next", "mshr_ring", "mshr_cnt", "port_free", "bank_free")


def pack_params(p: TimelineParams) -> Tuple[np.ndarray, np.ndarray]:
    """(fp float32 [8], ip int32 [7]) rows for one sim's configuration."""
    fp = np.array([p.l_cache, p.l_tlb, p.l_dram, p.t_net,
                   np.float32(2.0 * p.t_net), p.tlb_occ, p.dram_occ,
                   p.issue_interval], np.float32)
    ip = np.array([int(p.serial_walk), int(p.mem_tlb), p.num_accels, p.mshrs,
                   p.num_partitions, p.tlb_ports, p.dram_banks], np.int32)
    return fp, ip


def params_envelope(p: TimelineParams) -> Tuple[int, int, int, int, int]:
    """The (A, M, P, T, D) state shape of one sim (each count floored at 1)."""
    return (p.num_accels, max(p.mshrs, 1), max(p.num_partitions, 1),
            max(p.tlb_ports, 1), max(p.dram_banks, 1))


def timeline_init_state(p: TimelineParams, *, device):
    """All-zero queueing state of one sim (times in cycles; everything free
    at t=0), unbatched as the reference returns it."""
    A, M, P, T, D = params_envelope(p)
    z = dict(dtype=torch.float32, device=device)
    return (torch.zeros((A,), **z), torch.zeros((A, M), **z),
            torch.zeros((A,), dtype=torch.int32, device=device),
            torch.zeros((P, T), **z), torch.zeros((D,), **z))


def timeline_init_state_batched(B: int, envelope, tlb_ports, *, device):
    """Stacked all-zero queueing state on the (A, M, P, T, D) resource
    envelope, with port columns beyond each sim's own ``tlb_ports`` (int
    [B], numpy array or tensor) poisoned as always-busy."""
    A, M, P, T, D = (int(x) for x in envelope)
    ports = torch.as_tensor(tlb_ports, device=device).to(torch.int32).view(B, 1, 1)
    col = torch.arange(T, dtype=torch.int32, device=device).view(1, 1, T)
    free, poison = _f32(0.0, device), _f32(PORT_POISON, device)
    port0 = torch.where(col < ports, free, poison).expand(B, P, T).contiguous()
    z = dict(dtype=torch.float32, device=device)
    return (torch.zeros((B, A), **z), torch.zeros((B, A, M), **z),
            torch.zeros((B, A), dtype=torch.int32, device=device),
            port0, torch.zeros((B, D), **z))


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def timeline_step(state, inp, p: TimelineParams):
    """Advance B sims that share the static parameters ``p`` by one access.

    ``state`` is the five arrays of :func:`timeline_init_state` with a
    leading sim axis, updated in place; ``inp`` the per-access tuple
    ``(accel, partition, bank_data, bank_pte, cache_hit, tlb_hit,
    mem_tlb_hit, pen)`` of [B] tensors (int32, float32 ``pen``).  Returns
    ``(latency, overhead, done)``, each f32 [B]: issue->completion cycles,
    the translation-induced component (queue waits included) and the
    absolute completion time.  Latencies are composed from segments (waits
    + service times), with the reference's Python-float folds of two
    parameters done in float64 first, exactly as the reference does them.
    """
    acc_next, mshr_ring, mshr_cnt, port_free, bank_free = state
    a, part, bank_d, bank_p, c, th, mh, pen = inp
    dev = acc_next.device
    F = lambda v: _f32(v, dev)  # noqa: E731  (a Python float, rounded once)
    zero = F(0.0)
    b = torch.arange(a.shape[0], device=dev)
    c_hit = c != 0
    nominal = acc_next[b, a]

    # --- MSHR admission: a miss needs a free outstanding-miss slot. ---------
    if p.mshrs > 0:
        slot = mshr_cnt[b, a] % p.mshrs
        w_mshr = torch.maximum(mshr_ring[b, a, slot] - nominal, zero)
        issue = nominal + torch.where(c_hit, zero, w_mshr)
    else:
        issue = nominal

    t0 = issue + F(p.l_cache)  # cache probe; a miss leaves the accelerator here

    # --- translation path (computed unconditionally, applied on miss) -------
    if p.serial_walk:
        walk_arr = t0 + F(p.l_tlb) + F(p.t_net)
        if p.dram_banks > 0:
            old = bank_free[b, bank_p]
            w_walk = torch.maximum(old - walk_arr, zero)
            do_walk = (~c_hit) & (th == 0)
            bank_free[b, bank_p] = torch.where(
                do_walk, walk_arr + w_walk + F(p.dram_occ), old)
        else:
            w_walk = zero
        walk = F(2.0 * p.t_net) + w_walk + F(p.l_dram)
        trans = F(p.l_tlb) + torch.where(th != 0, zero, walk)
        data_arr = t0 + trans + F(p.t_net)
        pen_eff = zero
    elif p.mem_tlb:
        arr = t0 + F(p.t_net)
        if p.tlb_ports > 0:
            row = port_free[b, part]
            pslot = torch.argmin(row, dim=1)
            old = row[b, pslot]
            w_port = torch.maximum(old - arr, zero)
            port_free[b, part, pslot] = torch.where(
                ~c_hit, arr + w_port + F(p.tlb_occ), old)
        else:
            w_port = zero
        probe_done = arr + w_port + F(p.l_tlb)
        if p.dram_banks > 0:
            old = bank_free[b, bank_p]
            w_pte = torch.maximum(old - probe_done, zero)
            do_pte = (~c_hit) & (mh == 0)
            bank_free[b, bank_p] = torch.where(
                do_pte, probe_done + w_pte + F(p.dram_occ), old)
        else:
            w_pte = zero
        trans = w_port + F(p.l_tlb) + torch.where(mh != 0, zero, w_pte + F(p.l_dram))
        data_arr = arr + trans
        pen_eff = zero
    else:
        trans = pen
        data_arr = t0 + F(p.t_net)
        pen_eff = pen

    # --- data DRAM access (all designs) -------------------------------------
    if p.dram_banks > 0:
        old = bank_free[b, bank_d]
        w_data = torch.maximum(old - data_arr, zero)
        bank_free[b, bank_d] = torch.where(
            ~c_hit, data_arr + w_data + F(p.dram_occ) + pen_eff, old)
    else:
        w_data = zero

    if p.serial_walk:
        lat_miss = F(p.l_cache) + trans + F(p.t_net) + w_data + F(p.l_dram) + F(p.t_net)
    elif p.mem_tlb:
        lat_miss = F(p.l_cache + p.t_net) + trans + w_data + F(p.l_dram) + F(p.t_net)
    else:
        lat_miss = F(p.l_cache + p.t_net) + w_data + F(p.l_dram) + pen_eff + F(p.t_net)

    latency = torch.where(c_hit, F(p.l_cache), lat_miss)
    overhead = torch.where(c_hit, zero, trans)
    done = issue + latency

    # --- state updates -------------------------------------------------------
    if p.mshrs > 0:
        mshr_ring[b, a, slot] = torch.where(c_hit, mshr_ring[b, a, slot], done)
        mshr_cnt[b, a] += (~c_hit).to(torch.int32)
    acc_next[b, a] = issue + F(p.issue_interval)
    return latency, overhead, done


def timeline_step_dyn(state, inp, fp: torch.Tensor, ip: torch.Tensor):
    """One access of B sims with per-sim parameters as data (``fp`` f32
    [B, 8], ``ip`` int32 [B, 7]) and envelope-padded state, updated in
    place.  Each sim is bit-identical to :func:`timeline_step` on its own
    configuration; every ``where`` selects between expressions computed in
    the reference's float32 order."""
    acc_next, mshr_ring, mshr_cnt, port_free, bank_free = state
    a, part, bank_d, bank_p, c, th, mh, pen = inp
    l_cache, l_tlb, l_dram, t_net, walk2, tlb_occ, dram_occ, issue_iv = fp.unbind(1)
    serial, memtlb = ip[:, 0] != 0, ip[:, 1] != 0
    mshrs, ports, banks = ip[:, 3], ip[:, 5], ip[:, 6]
    dev = acc_next.device
    zero = _f32(0.0, dev)
    b = torch.arange(a.shape[0], device=dev)
    c_hit = c != 0
    nominal = acc_next[b, a]

    # --- MSHR admission (slot ids never reach padded columns) ---------------
    slot = mshr_cnt[b, a] % torch.clamp_min(mshrs, 1)
    w_mshr = torch.maximum(mshr_ring[b, a, slot] - nominal, zero)
    use_mshr = (~c_hit) & (mshrs > 0)
    issue = nominal + torch.where(use_mshr, w_mshr, zero)

    t0 = issue + l_cache

    # --- SPARTA port queue (poisoned columns lose every argmin) -------------
    arr = t0 + t_net
    row = port_free[b, part]
    pslot = torch.argmin(row, dim=1)
    old = row[b, pslot]
    w_port = torch.where(ports > 0, torch.maximum(old - arr, zero), zero)
    do_port = memtlb & (~c_hit) & (ports > 0)
    port_free[b, part, pslot] = torch.where(do_port, arr + w_port + tlb_occ, old)
    probe_done = arr + w_port + l_tlb

    # --- translation-path DRAM reference (conv walk / SPARTA PTE read) ------
    walk_arr = t0 + l_tlb + t_net
    trans_arr = torch.where(serial, walk_arr, probe_done)
    old = bank_free[b, bank_p]
    w_tr = torch.where(banks > 0, torch.maximum(old - trans_arr, zero), zero)
    do_tr = (~c_hit) & (banks > 0) & torch.where(serial, th == 0, memtlb & (mh == 0))
    bank_free[b, bank_p] = torch.where(do_tr, trans_arr + w_tr + dram_occ, old)

    walk = walk2 + w_tr + l_dram
    trans_conv = l_tlb + torch.where(th != 0, zero, walk)
    trans_sparta = w_port + l_tlb + torch.where(mh != 0, zero, w_tr + l_dram)
    trans = torch.where(serial, trans_conv, torch.where(memtlb, trans_sparta, pen))
    data_arr = torch.where(serial, t0 + trans_conv + t_net,
                           torch.where(memtlb, arr + trans_sparta, arr))
    pen_eff = torch.where(serial | memtlb, zero, pen)

    # --- data DRAM access (all designs) -------------------------------------
    old = bank_free[b, bank_d]
    w_data = torch.where(banks > 0, torch.maximum(old - data_arr, zero), zero)
    bank_free[b, bank_d] = torch.where(
        (~c_hit) & (banks > 0), data_arr + w_data + dram_occ + pen_eff, old)

    lat_conv = l_cache + trans_conv + t_net + w_data + l_dram + t_net
    lat_sparta = l_cache + t_net + trans_sparta + w_data + l_dram + t_net
    lat_over = l_cache + t_net + w_data + l_dram + pen_eff + t_net
    lat_miss = torch.where(serial, lat_conv, torch.where(memtlb, lat_sparta, lat_over))
    latency = torch.where(c_hit, l_cache, lat_miss)
    overhead = torch.where(c_hit, zero, trans)
    done = issue + latency

    # --- state updates -------------------------------------------------------
    mshr_ring[b, a, slot] = torch.where(use_mshr, done, mshr_ring[b, a, slot])
    mshr_cnt[b, a] += use_mshr.to(torch.int32)
    acc_next[b, a] = issue + issue_iv
    return latency, overhead, done


def _columns(cols):
    """The eight [B, L] input columns as L-major contiguous copies, so each
    step reads one contiguous [B] row."""
    return [x.t().contiguous() for x in cols]


def _scan(step, cols, state):
    """Run ``step(state, inp)`` over the access axis of the [B, L] columns;
    returns (latency, overhead, done), each f32 [B, L]."""
    xs = _columns(cols)
    L, B = xs[0].shape
    dev = xs[0].device
    outs = [torch.empty((L, B), dtype=torch.float32, device=dev) for _ in range(3)]
    for j in range(L):
        ys = step(state, [x[j] for x in xs])
        for o, y in zip(outs, ys):
            o[j] = y
    return tuple(o.t().contiguous() for o in outs)


def _own_state(state):
    return [s.clone(memory_format=torch.contiguous_format) for s in state]


def timeline_scan_ref(accel, part, bank_data, bank_pte, cache_hit, tlb_hit,
                      mem_hit, pen, params: TimelineParams):
    """Sequential timeline simulation of one trace (each column [N]);
    returns (latency, overhead, done), each f32 [N]."""
    state = [s[None] for s in timeline_init_state(params, device=accel.device)]
    cols = [x[None] for x in (accel, part, bank_data, bank_pte,
                              cache_hit, tlb_hit, mem_hit, pen)]
    ys = _scan(lambda st, inp: timeline_step(st, inp, params), cols, state)
    return tuple(y[0] for y in ys)


def timeline_scan_batched_carry_ref(accel, part, bank_data, bank_pte, cache_hit,
                                    tlb_hit, mem_hit, pen, fparams, iparams, state):
    """Chunk-resumable batched scan: B sims ([B, L] columns, ``fparams`` f32
    [B, 8], ``iparams`` int32 [B, 7]) from the carried ``state`` (five
    arrays, see :func:`timeline_init_state_batched`).  The queueing state
    holds absolute times, so carrying it across chunks is bit-identical to
    one monolithic pass.  Returns ``((latency, overhead, done), state')``;
    the inputs are not modified."""
    state = _own_state(state)
    ys = _scan(lambda st, inp: timeline_step_dyn(st, inp, fparams, iparams),
               (accel, part, bank_data, bank_pte, cache_hit, tlb_hit, mem_hit, pen),
               state)
    return ys, tuple(state)


def timeline_scan_batched_ref(accel, part, bank_data, bank_pte, cache_hit,
                              tlb_hit, mem_hit, pen, fparams, iparams, envelope):
    """All B sims advanced per trace element in one pass from the zero state
    on the (A, M, P, T, D) ``envelope``; returns (latency, overhead, done),
    each f32 [B, N]."""
    state = timeline_init_state_batched(accel.shape[0], envelope, iparams[:, 5],
                                        device=accel.device)
    return timeline_scan_batched_carry_ref(
        accel, part, bank_data, bank_pte, cache_hit, tlb_hit, mem_hit, pen,
        fparams, iparams, state)[0]
