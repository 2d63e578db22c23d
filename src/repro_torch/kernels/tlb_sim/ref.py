"""Plain PyTorch version of the TLB-simulation kernel (K1).

A Python loop over the accesses, vectorised over the B configs: gather each
config's set row, compare, take the first-index argmax / argmin, scatter.  It
runs on any device; the CPU tests hold it against the JAX package, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
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
