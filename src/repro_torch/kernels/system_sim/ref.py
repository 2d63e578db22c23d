"""Plain PyTorch version of the joint-system kernel (K2).

A Python loop over the accesses, vectorised over the B configs, of the three
gated LRU probes per access (data cache, accelerator TLB, partitioned
memory-side TLB).  Structure presence (``has_cache`` / ``has_accel``) and the
virtual-cache probe policy (``accel_probe_on_miss_only``) are per-config
*data*, so heterogeneous design points share one pass.

:func:`system_sim_set_parallel_ref` is a plain model of the CUDA kernel's
order of work: the cache's accesses bucketed by (config, set) and applied
round by round, then each TLB's, over the accesses it applies.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.tlb_sim.ref import lru_probe, lru_rows, lru_set_parallel, stamps


def system_sim_batched_carry_ref(
    inputs,   # 6 x int32 [B, L]: cache/accel/mem (set, tag) streams of one chunk
    flags,    # int32 [B, 3]: has_cache, has_accel, accel_on_miss_only
    state,    # 6 x int32 [B, S, W]: carried (tags, last) x 3 structures
    now0: int,
):
    """Chunk-resumable batched joint pipeline; returns ``((cache, accel, mem)
    hit bits bool [B, L], state')``.  The inputs are not modified."""
    c_set = inputs[0]
    B, L = c_set.shape
    has_c, has_a, miss_only = (flags[:, k] > 0 for k in range(3))
    flat, rows = [], []
    for k in range(3):
        tags, last = state[2 * k], state[2 * k + 1]
        S, W = tags.shape[1], tags.shape[2]
        flat += [tags.clone(memory_format=torch.contiguous_format).view(B * S, W),
                 last.clone(memory_format=torch.contiguous_format).view(B * S, W)]
        rows.append(lru_rows(tags, inputs[2 * k]))
    (ct, cl, at, al, mt, ml) = flat
    c_tag, a_tag, m_tag = inputs[1], inputs[3], inputs[5]
    hits = [torch.empty((B, L), dtype=torch.bool, device=c_set.device) for _ in range(3)]
    for j in range(L):
        now = int(now0) + j + 1
        c_raw = lru_probe(ct, cl, rows[0][:, j], c_tag[:, j], now, has_c)
        c_hit = has_c & c_raw
        # Physical cache: accel TLB probed every access.  Virtual cache: only
        # on cache misses (translation needed only to leave the accelerator).
        do_a = (~miss_only | ~c_hit) & has_a
        a_raw = lru_probe(at, al, rows[1][:, j], a_tag[:, j], now, do_a)
        a_hit = has_a & (~do_a | a_raw)
        # Memory-side TLB sees only cache misses (hits never leave the accel).
        m_raw = lru_probe(mt, ml, rows[2][:, j], m_tag[:, j], now, ~c_hit)
        hits[0][:, j] = c_hit
        hits[1][:, j] = a_hit
        hits[2][:, j] = c_hit | m_raw
    new_state = tuple(x.view(s.shape) for x, s in zip(flat, state))
    return tuple(hits), new_state


def system_sim_set_parallel_ref(inputs, flags, state, now0: int):
    """:func:`system_sim_batched_carry_ref` in the CUDA kernel's order of
    work: a pass over the cache's buckets, then over each TLB's buckets of
    the accesses it applies (the accel TLB where ``do_a``, the mem TLB on
    cache misses); a raw probe result is read only where its structure
    applies the access.  The same ``((cache, accel, mem) hits, state')``."""
    c_set = inputs[0]
    B, L = c_set.shape
    has_c, has_a, miss_only = (flags[:, k, None] > 0 for k in range(3))
    now = stamps(B, L, now0, c_set.device).flatten()
    flat = []
    for k in range(3):
        tags, last = state[2 * k], state[2 * k + 1]
        S, W = tags.shape[1], tags.shape[2]
        flat += [tags.clone(memory_format=torch.contiguous_format).view(B * S, W),
                 last.clone(memory_format=torch.contiguous_format).view(B * S, W)]

    def apply(k: int, applied: torch.Tensor) -> torch.Tensor:
        m = applied.expand(B, L).flatten()
        rows = lru_rows(state[2 * k], inputs[2 * k]).flatten()[m]
        raw = torch.zeros(B * L, dtype=torch.bool, device=c_set.device)
        raw[m] = lru_set_parallel(flat[2 * k], flat[2 * k + 1], rows,
                                  inputs[2 * k + 1].flatten()[m], now[m])
        return raw.view(B, L)

    c_hit = has_c & apply(0, has_c)
    do_a = has_a & (~miss_only | ~c_hit)
    a_hit = has_a & (~do_a | apply(1, do_a))
    m_hit = c_hit | apply(2, ~c_hit)
    new_state = tuple(x.view(s.shape) for x, s in zip(flat, state))
    return (c_hit, a_hit, m_hit), new_state
