"""Public segmented LRU-stack scan op with kernel-mode dispatch."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import resolve_mode
from repro_torch.kernels.stackdist.kernel import stack_scan_cuda
from repro_torch.kernels.stackdist.ref import stack_scan_ref

__all__ = ["stack_scan"]


def stack_scan(
    tags: torch.Tensor,        # int32 [L, C] lane-blocked, set-sorted tag stream
    seg_flags: torch.Tensor,   # bool  [L, C] True at set-segment starts
    init_stack: torch.Tensor,  # int32 [L, W] carry-in stacks (-1 = empty)
    *,
    kernel_mode: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance L capped LRU stacks through C accesses each.

    Returns ``(depths, final)``: ``depths[l, c]`` is the 0-based position of
    ``tags[l, c]`` in lane ``l``'s pre-access stack (-1 = absent), ``final``
    the post-walk stacks.  An access with depth ``d`` hits every LRU structure
    of associativity ``w > d`` mapped to the same set — the stack-inclusion
    property that lets one scan serve a whole sweep axis of geometries.
    """
    mode = resolve_mode(kernel_mode, tags.device)
    if mode == "reference":
        return stack_scan_ref(tags, seg_flags, init_stack)
    return stack_scan_cuda(tags, seg_flags, init_stack)
