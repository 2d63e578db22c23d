"""Plain PyTorch version of the TLB-simulation kernel (K1).

A Python loop over the accesses, vectorised over the B configs: gather each
config's set row, compare, take the first-index argmax / argmin, scatter.  It
runs on any device; the CPU tests hold it against the JAX package, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.

:func:`tlb_sim_set_parallel_ref` is a plain model of the CUDA kernel's order
of work (``csrc/lru_sets.cuh``): the accesses bucketed stably by (config,
set), then round r probes the r-th access of every bucket at once.  The CPU
tests hold it to the JAX package too, which shows that the order is sound.
"""
from __future__ import annotations

import torch


def lru_rows(tags: torch.Tensor, set_idx: torch.Tensor) -> torch.Tensor:
    """Row index into the flattened [B * TS, W] state for every (b, j)."""
    B, TS = tags.shape[0], tags.shape[1]
    offs = torch.arange(B, device=set_idx.device, dtype=torch.int64)[:, None] * TS
    return set_idx.to(torch.int64) + offs


def lru_probe(tags: torch.Tensor, last: torch.Tensor, rows: torch.Tensor,
              t: torch.Tensor, now: int, update: torch.Tensor = None) -> torch.Tensor:
    """One LRU probe of ``rows`` (one per config) of the flattened state, in
    place; returns the hit bits.  The way is the first match on a hit, else
    the first least-recently-used way; it is written only where ``update``
    (everywhere when ``update`` is None)."""
    match = tags[rows] == t[:, None]
    hit = match.any(1)
    way = torch.where(hit, match.to(torch.int32).argmax(1), last[rows].argmin(1))
    if update is None:
        tags[rows, way] = t
        last[rows, way] = now
    else:
        tags[rows, way] = torch.where(update, t, tags[rows, way])
        last[rows, way] = torch.where(update, now, last[rows, way])
    return hit


def tlb_sim_batched_carry_ref(
    set_idx: torch.Tensor,   # int32 [B, L] one trace chunk
    tag: torch.Tensor,       # int32 [B, L]
    tags: torch.Tensor,      # int32 [B, TS, W] carried state in
    last: torch.Tensor,      # int32 [B, TS, W]
    now0: int,               # accesses consumed before this chunk
):
    """Chunk-resumable batched LRU simulation; returns ``(hits bool [B, L],
    tags', last')``.  The inputs are not modified."""
    B, L = set_idx.shape
    TS, W = tags.shape[1], tags.shape[2]
    tags = tags.clone(memory_format=torch.contiguous_format).view(B * TS, W)
    last = last.clone(memory_format=torch.contiguous_format).view(B * TS, W)
    rows = lru_rows(tags.view(B, TS, W), set_idx)
    hits = torch.empty((B, L), dtype=torch.bool, device=set_idx.device)
    for j in range(L):
        hits[:, j] = lru_probe(tags, last, rows[:, j], tag[:, j], int(now0) + j + 1)
    return hits, tags.view(B, TS, W), last.view(B, TS, W)


def bucket_ranks(keys: torch.Tensor) -> torch.Tensor:
    """Each access's position within its bucket, for ``keys`` int64 [N] in
    trace order: a stable sort by key keeps each bucket in trace order."""
    n = keys.numel()
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    pos = torch.arange(n, device=keys.device)
    new = torch.ones(n, dtype=torch.bool, device=keys.device)
    new[1:] = sk[1:] != sk[:-1]
    first = torch.cummax(torch.where(new, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - first
    return rank


def lru_set_parallel(tags: torch.Tensor, last: torch.Tensor, rows: torch.Tensor,
                     t: torch.Tensor, now: torch.Tensor) -> torch.Tensor:
    """Apply accesses (``rows`` of the flattened state, tags ``t``, stamps
    ``now``, all [N] in trace order) bucket by bucket: a bucket is a row, and
    rows share no state, so round r probes the r-th access of every bucket at
    once.  Updates the state in place; returns the hit bits [N]."""
    hit = torch.zeros(rows.numel(), dtype=torch.bool, device=rows.device)
    if rows.numel() == 0:
        return hit
    rank = bucket_ranks(rows)
    for r in range(int(rank.max()) + 1):
        ix = torch.nonzero(rank == r).flatten()
        hit[ix] = lru_probe(tags, last, rows[ix], t[ix], now[ix])
    return hit


def stamps(B: int, L: int, now0: int, device) -> torch.Tensor:
    """int32 [B, L]: the stamp now0 + j + 1 of every access."""
    j = torch.arange(L, dtype=torch.int64, device=device) + (int(now0) + 1)
    return j.to(torch.int32).expand(B, L)


def tlb_sim_set_parallel_ref(
    set_idx: torch.Tensor,   # int32 [B, L] one trace chunk
    tag: torch.Tensor,       # int32 [B, L]
    tags: torch.Tensor,      # int32 [B, TS, W] carried state in
    last: torch.Tensor,      # int32 [B, TS, W]
    now0: int,               # accesses consumed before this chunk
):
    """:func:`tlb_sim_batched_carry_ref` in the CUDA kernel's order of work;
    the same ``(hits bool [B, L], tags', last')``."""
    B, L = set_idx.shape
    TS, W = tags.shape[1], tags.shape[2]
    tags = tags.clone(memory_format=torch.contiguous_format).view(B * TS, W)
    last = last.clone(memory_format=torch.contiguous_format).view(B * TS, W)
    rows = lru_rows(tags.view(B, TS, W), set_idx).flatten()
    hits = lru_set_parallel(tags, last, rows, tag.flatten(),
                            stamps(B, L, now0, set_idx.device).flatten())
    return hits.view(B, L), tags.view(B, TS, W), last.view(B, TS, W)
