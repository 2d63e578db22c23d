"""Public TLB-simulation ops with kernel-mode dispatch.

All three ops run the one carry function: the monolithic op starts it from
:func:`repro_torch.core.tlbsim.padded_tlb_state` with ``now0 = 0``, and the
single-config op is the batched one with B = 1 and no poisoned ways.  The
CUDA kernel streams any chunk length, so unlike the TPU kernel these ops take
no ``block`` and pad nothing.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.tlbsim import padded_tlb_state
from repro_torch.kernels.common import resolve_mode
from repro_torch.kernels.tlb_sim.kernel import tlb_sim_carry_cuda
from repro_torch.kernels.tlb_sim.ref import tlb_sim_batched_carry_ref

__all__ = ["tlb_sim", "tlb_sim_batched", "tlb_sim_batched_carry"]


def tlb_sim_batched_carry(
    set_idx: torch.Tensor,   # int32 [B, L] one trace chunk
    tag: torch.Tensor,       # int32 [B, L]
    tags: torch.Tensor,      # int32 [B, TS, W] carried state (caller-owned)
    last: torch.Tensor,      # int32 [B, TS, W]
    now0: int,               # accesses consumed before this chunk
    *,
    kernel_mode: str = "auto",
):
    """Run ONE trace chunk against caller-owned carried LRU state (initialise
    with :func:`repro_torch.core.tlbsim.padded_tlb_state`) and the global
    access counter ``now0``.  Returns ``(hits bool [B, L], tags', last')``;
    feeding chunks sequentially is bit-identical to the monolithic op, in
    either mode and across mode changes at chunk boundaries, since both share
    one state layout and stamp rule.  A spare parked set row that no access
    indexes (the sweep streams keep one) passes through untouched."""
    mode = resolve_mode(kernel_mode, set_idx.device)
    if mode == "reference":
        return tlb_sim_batched_carry_ref(set_idx, tag, tags, last, now0)
    return tlb_sim_carry_cuda(set_idx, tag, tags, last, now0)


def tlb_sim_batched(
    set_idx: torch.Tensor,   # int32 [B, N]
    tag: torch.Tensor,       # int32 [B, N]
    total_sets: int,         # padded envelope over configs
    ways: int,               # padded envelope over configs
    valid_ways: Optional[Sequence[int]] = None,
    *,
    kernel_mode: str = "auto",
) -> torch.Tensor:
    """Batched-config TLB simulation (the sweep-engine hot loop): B configs'
    LRU states advance together through ONE pass over the trace.  Returns
    hit bits bool [B, N]; bit-identical per config to :func:`tlb_sim` on
    that config's own (unpadded) geometry."""
    vw = tuple(valid_ways) if valid_ways is not None else (ways,) * set_idx.shape[0]
    tags, last = padded_tlb_state(set_idx.shape[0], total_sets, ways, vw,
                                  device=set_idx.device)
    return tlb_sim_batched_carry(set_idx, tag, tags, last, 0, kernel_mode=kernel_mode)[0]


def tlb_sim(
    set_idx: torch.Tensor,   # int32 [N]
    tag: torch.Tensor,       # int32 [N]
    total_sets: int,
    ways: int,
    *,
    kernel_mode: str = "auto",
) -> torch.Tensor:
    """Per-access hit bits bool [N] for one set-associative LRU structure."""
    return tlb_sim_batched(set_idx[None], tag[None], total_sets, ways,
                           kernel_mode=kernel_mode)[0]
