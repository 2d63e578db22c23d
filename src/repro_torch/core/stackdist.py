"""Exact sort-based stack-distance engine for set-associative LRU sweeps.

The port of the JAX package's ``src/repro/core/stackdist.py``.  For pure-LRU
structures an access hits a ``w``-way set **iff fewer than w distinct tags
mapped to that set since the same tag's previous occurrence** (the stack
algorithm of Mattson et al.), so exact per-access hit bits for *every*
associativity fall out of one data-parallel reuse-depth computation per
set-mapping.

Pipeline, on the data's device:

1. **sort by set** (stable): the trace becomes contiguous per-set segments,
   trace order preserved inside each segment;
2. **lane-blocked segmented stack scan**: the set-sorted stream is reshaped
   into ``L = N/C`` lanes of ``C`` accesses and all lanes advance capped LRU
   stacks in lock-step (:mod:`repro_torch.kernels.stackdist`, kernel K3).
   Cross-lane carry is restored by composing per-lane *stack effects* (a
   prefix over lane finals) and re-walking with the true carry-in;
3. **depth -> hits**: an access at stack depth ``d`` hits every ``ways > d``
   geometry sharing the set-mapping.

Exactness: a capped stack always equals the first ``W`` entries of the
uncapped LRU stack, and composing capped effects preserves that prefix — so
hit bits are **bit-identical** to :func:`repro_torch.core.tlbsim.simulate_tlb`
for every ``ways <= W``, and the depths to the JAX package's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.stackdist import stack_scan

__all__ = [
    "STACKDIST_INF",
    "AUTO_MAX_WAYS",
    "MAX_CAP",
    "prev_occurrence",
    "stack_depths",
    "stack_depths_batched",
    "reuse_distances",
    "hits_from_depths",
]

# "Infinite" reuse distance: the tag was never seen before in its set.
STACKDIST_INF = 2**31 - 1

# `auto` prefers the stackdist backend only when every spec's associativity is
# at most this: the scan state is [lanes, W], so huge fully-associative
# geometries would trade the N-step scan for a W-wide one.
AUTO_MAX_WAYS = 16

# Hard cap: beyond this the capped-stack state stops being "small" in the
# sense the engine is built around; use the sequential kernels instead.
MAX_CAP = 256

_PAD_TAG = -2  # never matches a real tag (>= 0) nor an empty slot (-1)

# Chunk the (streams x padded-trace) workspace as the reference does, so a
# wide sweep (Fig 4's 60 set-mappings) does not hold every lane at once.
_CHUNK_ELEMS = 1 << 25


def prev_occurrence(set_idx: torch.Tensor, tag: torch.Tensor) -> torch.Tensor:
    """Index (int64) of the previous access to the same (set, tag), -1 if none.

    Stable sorts by tag, then by set: equal keys become adjacent in trace
    order, so each access's predecessor is its sorted neighbour.
    """
    n = set_idx.shape[0]
    prev = torch.full((n,), -1, dtype=torch.int64, device=set_idx.device)
    if n == 0:
        return prev
    order = torch.argsort(tag, stable=True)
    order = order[torch.argsort(set_idx[order], stable=True)]
    s, t = set_idx[order], tag[order]
    same = (s[1:] == s[:-1]) & (t[1:] == t[:-1])
    prev[order[1:][same]] = order[:-1][same]
    return prev


# ---------------------------------------------------------------------------
# Stack-effect composition across lanes.
# ---------------------------------------------------------------------------

def _merge_effects(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stack after running sequence A then sequence B, given each sequence's
    final stack from empty: B's distinct tags (MRU side) followed by A's tags
    not in B, truncated to W.  Safe under capping: dropped entries could only
    ever get deeper."""
    W = a.shape[-1]
    in_b = (a[..., :, None] == b[..., None, :]).any(-1)
    a_kept = torch.where(in_b | (a < 0), -1, a)
    c = torch.cat([b, a_kept], -1)                               # [..., 2W]
    valid = c >= 0
    pos = torch.cumsum(valid, -1) - 1
    # Valid entries go to their compacted slot; the rest to a spare slot W.
    pos = torch.where(valid & (pos < W), pos, W)
    out = torch.full(c.shape[:-1] + (W + 1,), -1, dtype=c.dtype, device=c.device)
    return out.scatter_(-1, pos, c)[..., :W]


def _lane_prefix(finals: torch.Tensor, has_start: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix of lane effects along the lane-block axis.

    finals [G, NB, W] (per-lane final stacks from empty), has_start [G, NB]
    (lane contains a segment start => earlier lanes cannot influence its
    final).  Returns the carry-in stack for each lane, [G, NB, W].

    The reference walks the NB lanes one after another.  Here the effects
    combine as ``(f1, s1) . (f2, s2) = (f1 | f2, s2 if f2 else
    merge(s1, s2))``, which is associative (a capped merge keeps the first W
    of the uncapped recency order, whichever way it is bracketed), so a
    log2(NB)-step doubling scan gives the same stacks bit for bit.
    """
    G, NB, W = finals.shape
    s, f = finals, has_start
    k = 1
    while k < NB:
        merged = torch.where(f[:, k:, None], s[:, k:], _merge_effects(s[:, :-k], s[:, k:]))
        s = torch.cat([s[:, :k], merged], 1)
        f = torch.cat([f[:, :k], f[:, k:] | f[:, :-k]], 1)
        k *= 2
    empty = torch.full((G, 1, W), -1, dtype=finals.dtype, device=finals.device)
    return torch.cat([empty, s[:, :-1]], 1)


# ---------------------------------------------------------------------------
# Core depth computation.
# ---------------------------------------------------------------------------

def _lane_layout(set_b: torch.Tensor, tag_b: torch.Tensor, block: int):
    """Set-sorted, padded layout of G streams: ``(tags_l int32 [G, NP],
    seg_l bool [G, NP], order int64 [G, N])`` with ``NP`` the length padded
    to a multiple of ``block``; ``order`` is the stable set-sort permutation
    (trace order preserved within each set) and ``seg_l`` marks segment
    starts in sorted order."""
    G, n = set_b.shape
    n_pad = -(-n // block) * block
    dev = set_b.device
    s_sorted, order = torch.sort(set_b, dim=1, stable=True)
    tags_l = torch.full((G, n_pad), _PAD_TAG, dtype=torch.int32, device=dev)
    tags_l[:, :n] = torch.gather(tag_b, 1, order).to(torch.int32)
    seg_l = torch.zeros((G, n_pad), dtype=torch.bool, device=dev)
    seg_l[:, 0] = True
    seg_l[:, 1:n] = s_sorted[:, 1:] != s_sorted[:, :-1]
    if n_pad > n:
        seg_l[:, n] = True  # padding forms its own throwaway segment
    return tags_l, seg_l, order


def _chunk_streams(G: int, n_pad: int) -> int:
    """Streams per depth pass, as the reference chunks them."""
    return max(1, min(G, _CHUNK_ELEMS // n_pad))


def _depths_layout(
    tags_l: torch.Tensor,     # int32 [G, NP] set-sorted tags, padded
    seg_l: torch.Tensor,      # bool  [G, NP] segment starts, padded
    cap: int,
    kernel_mode: str,
    block: int,
) -> torch.Tensor:
    """Capped stack depths for G set-sorted (padded) streams, [G, NP]."""
    G, NP = tags_l.shape
    nb = NP // block
    tags_b = tags_l.reshape(G * nb, block)
    seg_b = seg_l.reshape(G * nb, block)
    empty = torch.full((G * nb, cap), -1, dtype=torch.int32, device=tags_l.device)
    # Phase 1: per-lane effects from empty; phase 2: re-walk with true carry.
    _, finals = stack_scan(tags_b, seg_b, empty, kernel_mode=kernel_mode)
    carries = _lane_prefix(
        finals.reshape(G, nb, cap), seg_l.reshape(G, nb, block).any(2),
    ).reshape(G * nb, cap).contiguous()
    depths, _ = stack_scan(tags_b, seg_b, carries, kernel_mode=kernel_mode)
    return depths.reshape(G, NP)


def _check_cap(cap: int) -> None:
    if cap < 1:
        raise ValueError(f"cap={cap}: must be >= 1")
    if cap > MAX_CAP:
        raise ValueError(
            f"cap={cap} exceeds MAX_CAP={MAX_CAP}; the capped-stack engine is "
            "built for small associativities — use the sequential kernels "
            "for huge fully-associative geometries")


def stack_depths_batched(
    set_b,                    # int [G, N] set-index streams (one per mapping)
    tag_b,                    # int [G, N] tag streams
    *,
    cap: int,
    kernel_mode: str = "auto",
    block: int = 1024,
) -> torch.Tensor:
    """Per-access LRU stack depth (trace order) for G set-mappings at once.

    Returns int32 [G, N] on the streams' device: 0-based depth of each
    access's tag in its set's pre-access LRU stack, or -1 when the tag is not
    among the ``cap`` most recent distinct tags (cold miss, or true distance
    >= cap).  An access hits a ``w``-way set iff ``0 <= depth < w`` for any
    ``w <= cap``.
    """
    _check_cap(cap)
    set_b, tag_b = torch.as_tensor(set_b), torch.as_tensor(tag_b)
    G, n = set_b.shape
    if n == 0:
        return torch.empty((G, 0), dtype=torch.int32, device=set_b.device)
    # Tags are carried as int32 with -1 (empty slot) and -2 (padding) as
    # sentinels; anything outside [0, 2^31) would silently alias on the cast.
    lo, hi = (int(v) for v in torch.aminmax(tag_b.to(torch.int64)))
    if lo < 0 or hi >= 2**31:
        raise ValueError("tags must be in [0, 2**31) to fit int32 stack slots")
    block = max(32, min(block, 1 << 14))
    tags_l, seg_l, order = _lane_layout(set_b, tag_b, block)
    g_chunk = _chunk_streams(G, tags_l.shape[1])
    out = torch.empty((G, n), dtype=torch.int32, device=set_b.device)
    for g0 in range(0, G, g_chunk):
        g1 = min(g0 + g_chunk, G)
        d = _depths_layout(tags_l[g0:g1], seg_l[g0:g1], cap, kernel_mode, block)
        out[g0:g1].scatter_(1, order[g0:g1], d[:, :n])
    return out


def stack_depths(
    set_idx,
    tag,
    *,
    cap: int,
    kernel_mode: str = "auto",
    block: int = 1024,
) -> torch.Tensor:
    """Single-stream :func:`stack_depths_batched`."""
    return stack_depths_batched(
        torch.as_tensor(set_idx)[None], torch.as_tensor(tag)[None],
        cap=cap, kernel_mode=kernel_mode, block=block)[0]


def hits_from_depths(depths: torch.Tensor, ways: int) -> torch.Tensor:
    """Hit bits for a ``ways``-way LRU structure (requires ways <= the cap
    the depths were computed with)."""
    return (depths >= 0) & (depths < ways)


def reuse_distances(
    set_idx,
    tag,
    *,
    cap: int = AUTO_MAX_WAYS,
    kernel_mode: str = "auto",
    block: int = 1024,
) -> torch.Tensor:
    """Exact set-local LRU stack distances, clipped at ``cap``.

    Returns int32 [N]: the number of distinct other tags that mapped to the
    access's set since the same tag's previous occurrence — exact when
    ``< cap``, ``cap`` when the true (finite) distance is >= cap, and
    :data:`STACKDIST_INF` for cold accesses.  ``distance < w`` iff the access
    hits a w-way set (w <= cap).
    """
    set_idx, tag = torch.as_tensor(set_idx), torch.as_tensor(tag)
    depth = stack_depths(set_idx, tag, cap=cap, kernel_mode=kernel_mode, block=block)
    cold = prev_occurrence(set_idx, tag) < 0
    return torch.where(depth >= 0, depth,
                       torch.where(cold, STACKDIST_INF, cap)).to(torch.int32)
