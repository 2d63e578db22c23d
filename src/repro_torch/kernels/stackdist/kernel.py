"""Python wrapper of the hand-written CUDA segmented LRU-stack scan (K3).

``csrc/stackdist.cu`` holds the kernel and says which Pallas TPU kernel it
replaces and what bounds it on the card.  :func:`stack_scan_cuda` checks its
inputs, allocates the outputs, launches the kernel on PyTorch's current
stream and counts the launch in :data:`launches`.  Given CPU tensors it runs
the plain version (``ref.py``) instead; given CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stackdist.ref import stack_scan_ref
from repro_torch.kernels.tlb_sim.kernel import check_int32

# Launches of the CUDA kernel in this process; chip_smoke.py resets and reads
# it to show which path ran through the kernel.
launches = 0


def stack_scan_cuda(
    tags: torch.Tensor,        # int32 [L, C] lane-blocked, set-sorted tags
    seg_flags: torch.Tensor,   # bool  [L, C] True at set-segment starts
    init_stack: torch.Tensor,  # int32 [L, W] carry-in stacks (-1 = empty)
):
    """Returns ``(depths int32 [L, C], final stacks int32 [L, W])``; the
    inputs are not modified."""
    if tags.device.type == "cpu":
        return stack_scan_ref(tags, seg_flags, init_stack)
    global launches
    dev = tags.device
    L, C = tags.shape
    W = init_stack.shape[-1]
    check_int32("tags", tags, (L, C), dev)
    check_int32("init_stack", init_stack, (L, W), dev)
    if seg_flags.device != dev or seg_flags.dtype != torch.bool:
        raise ValueError(f"seg_flags must be a bool tensor on {dev}, got "
                         f"{seg_flags.dtype} on {seg_flags.device}")
    if tuple(seg_flags.shape) != (L, C) or not seg_flags.is_contiguous():
        raise ValueError(f"seg_flags must be contiguous with shape {(L, C)}, "
                         f"got {tuple(seg_flags.shape)}")
    if W < 1:
        raise ValueError(f"init_stack has {W} slots")
    depths = torch.empty((L, C), dtype=torch.int32, device=dev)
    final = torch.empty((L, W), dtype=torch.int32, device=dev)
    if L == 0 or C == 0:
        return depths, init_stack.clone()
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cdll.stack_scan_launch(
            tags.data_ptr(), seg_flags.data_ptr(), init_stack.data_ptr(),
            depths.data_ptr(), final.data_ptr(), L, C, W, stream)
    lib.check(err, "stack_scan_launch")
    launches += 1
    return depths, final
