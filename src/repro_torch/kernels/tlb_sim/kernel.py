"""Python wrapper of the hand-written CUDA TLB-simulation kernel (K1).

``csrc/tlb_sim.cu`` holds the kernel and says which Pallas TPU kernels it
replaces and what bounds it on the card.  :func:`tlb_sim_carry_cuda` checks
its inputs, allocates the outputs, launches the kernel on PyTorch's current
stream and counts the launch in :data:`launches`.  Given CPU tensors it runs
the plain version (``ref.py``) instead; given CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tlb_sim.ref import tlb_sim_batched_carry_ref

# Launches of the CUDA kernel in this process; chip_smoke.py resets and reads
# it to show which path ran through the kernel.
launches = 0

_STAMP_LIMIT = 2**31 - 1  # the poisoned-way stamp; real stamps stay below it


def check_int32(name: str, x: torch.Tensor, shape: tuple, device: torch.device) -> None:
    """Raise unless ``x`` is a contiguous int32 tensor of ``shape`` on ``device``."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.int32:
        raise ValueError(f"{name} has dtype {x.dtype}, expected torch.int32")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_launch(set_idx: torch.Tensor, rows: int, ways: int, now0: int) -> None:
    """Raise unless every set index lies in [0, rows), a row has a way, and
    the stamps of this chunk stay below the poisoned-way stamp."""
    L = set_idx.shape[-1]
    if now0 < 0 or now0 + L >= _STAMP_LIMIT:
        raise ValueError(f"stamps {now0 + 1}..{now0 + L} leave [1, 2**31 - 1)")
    if ways < 1:
        raise ValueError(f"state has {ways} ways")
    lo, hi = (int(v) for v in torch.aminmax(set_idx))
    if lo < 0 or hi >= rows:
        raise ValueError(f"set index range [{lo}, {hi}] outside [0, {rows})")


def tlb_sim_carry_cuda(
    set_idx: torch.Tensor,   # int32 [B, L] one trace chunk
    tag: torch.Tensor,       # int32 [B, L]
    tags: torch.Tensor,      # int32 [B, TS, W] carried state in
    last: torch.Tensor,      # int32 [B, TS, W]
    now0: int,               # accesses consumed before this chunk
):
    """Chunk-resumable batched LRU simulation; returns ``(hits bool [B, L],
    tags', last')``.  The carried state is updated in place on copies this
    function owns; the inputs are not modified."""
    if set_idx.device.type == "cpu":
        return tlb_sim_batched_carry_ref(set_idx, tag, tags, last, now0)
    global launches
    dev = set_idx.device
    B, L = set_idx.shape
    TS, W = tags.shape[1], tags.shape[2]
    check_int32("set_idx", set_idx, (B, L), dev)
    check_int32("tag", tag, (B, L), dev)
    check_int32("tags", tags, (B, TS, W), dev)
    check_int32("last", last, (B, TS, W), dev)
    now0 = int(now0)
    tags, last = tags.clone(), last.clone()
    hits = torch.empty((B, L), dtype=torch.uint8, device=dev)
    if B == 0 or L == 0:
        return hits.view(torch.bool), tags, last
    check_launch(set_idx, TS, W, now0)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cdll.tlb_sim_launch(
            set_idx.data_ptr(), tag.data_ptr(), tags.data_ptr(), last.data_ptr(),
            hits.data_ptr(), B, L, TS, W, now0, stream)
    lib.check(err, "tlb_sim_launch")
    launches += 1
    return hits.view(torch.bool), tags, last
