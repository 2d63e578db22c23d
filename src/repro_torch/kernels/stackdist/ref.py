"""Plain PyTorch version of the segmented LRU-stack scan kernel (K3).

The stack-distance engine (:mod:`repro_torch.core.stackdist`) reshapes a
set-sorted access stream into ``L`` independent lanes of ``C`` accesses and
walks all lanes in lock-step: one :func:`lru_stack_step` per in-lane
position, ``C`` steps in a Python loop, each vectorised over the lanes.  Each
lane carries a capped LRU stack — the ``W`` most-recently-used distinct tags
of the current set segment, MRU first, ``-1`` = empty — and every access
reports its 0-based depth in the pre-access stack (``-1`` = absent: cold, or
distance >= W).  ``seg_flags`` marks set-segment starts; the stack resets
there.  It runs on any device; the CPU tests hold it against the JAX package,
and ``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def lru_stack_step(
    stack: torch.Tensor,      # int32 [..., W] MRU-first, -1 = empty
    tag: torch.Tensor,        # int32 [...]
    seg_start: torch.Tensor,  # bool  [...]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance capped LRU stacks by one access per lane; returns
    ``(new_stack, depth)``.  Exact for any ways <= W: the capped stack is
    always the first W entries of the uncapped LRU stack."""
    W = stack.shape[-1]
    stack = torch.where(seg_start[..., None], -1, stack)
    eq = stack == tag[..., None]
    found = eq.any(-1)
    depth = torch.where(found, eq.to(torch.int32).argmax(-1).to(torch.int32), -1)
    # Move the tag to the front: rotate slots [0, idx] right by one, where idx
    # is the tag's slot on a hit and the last slot (LRU eviction) on a miss.
    idx = torch.where(found, depth, W - 1)
    shifted = torch.cat([tag[..., None], stack[..., :-1]], -1)
    way_ix = torch.arange(W, dtype=torch.int32, device=stack.device)
    new = torch.where(way_ix <= idx[..., None], shifted, stack)
    return new, depth


def stack_scan_ref(
    tags: torch.Tensor,        # int32 [L, C]
    seg_flags: torch.Tensor,   # bool  [L, C]
    init_stack: torch.Tensor,  # int32 [L, W]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk C accesses per lane.  Returns (depths int32 [L, C], final [L, W])."""
    L, C = tags.shape
    stack = init_stack.to(torch.int32).clone()
    depths = torch.empty((L, C), dtype=torch.int32, device=tags.device)
    tags, seg_flags = tags.to(torch.int32), seg_flags.to(torch.bool)
    for c in range(C):
        stack, depths[:, c] = lru_stack_step(stack, tags[:, c], seg_flags[:, c])
    return depths, stack
