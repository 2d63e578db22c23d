"""Public batched joint-system ops with kernel-mode dispatch.

Sweep-only backends are rejected loudly: the joint pipeline's
cache-hit-conditional TLB probes break the LRU stack-inclusion property, so
the exact stack-distance engine cannot serve it, and silently falling back
would misreport which backend produced a figure.  ``"auto"`` resolves to the
CUDA kernel for data on the card and the plain version on the CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.tlbsim import padded_tlb_state
from repro_torch.kernels.common import SWEEP_MODES, VALID_MODES, resolve_mode
from repro_torch.kernels.system_sim.kernel import system_sim_carry_cuda
from repro_torch.kernels.system_sim.ref import system_sim_batched_carry_ref

__all__ = ["system_sim_batched", "system_sim_batched_carry",
           "resolve_system_mode"]


def resolve_system_mode(kernel_mode: str, device) -> str:
    """Validate and resolve ``kernel_mode`` for the joint system sweep.

    ``"stackdist"`` (and any future sweep-only backend) raises: stack
    inclusion does not hold when TLB probes are conditional on cache hits, so
    there is no exact stack-distance execution of the joint pipeline.
    """
    if kernel_mode in SWEEP_MODES and kernel_mode not in VALID_MODES:
        raise ValueError(
            f"kernel_mode={kernel_mode!r} is a sweep_tlb/miss_ratio_curve-only "
            f"backend: the joint system sweep's cache-hit-conditional TLB "
            f"probes break the LRU stack-inclusion property, so the "
            f"stack-distance engine cannot serve it; expected one of "
            f"{VALID_MODES}")
    return resolve_mode(kernel_mode, device)


def system_sim_batched_carry(
    c_set: torch.Tensor, c_tag: torch.Tensor,   # int32 [B, L] one trace chunk
    a_set: torch.Tensor, a_tag: torch.Tensor,
    m_set: torch.Tensor, m_tag: torch.Tensor,
    flags: torch.Tensor,                        # int32 [B, 3]
    state,                                      # 6-tuple int32 [B, S, W]
    now0: int,                                  # accesses consumed before chunk
    *,
    kernel_mode: str = "auto",
):
    """Run ONE trace chunk against caller-owned carried state (three
    :func:`repro_torch.core.tlbsim.padded_tlb_state` pairs) and the global
    access counter.  Returns ``((c, a, m) hit bits bool [B, L], state')``;
    chunked execution is bit-identical to the monolithic op in either mode
    and across mode changes at chunk boundaries.  Spare parked set rows that
    no access indexes pass through untouched."""
    mode = resolve_system_mode(kernel_mode, c_set.device)
    inputs = (c_set, c_tag, a_set, a_tag, m_set, m_tag)
    if mode == "reference":
        return system_sim_batched_carry_ref(inputs, flags, tuple(state), now0)
    return system_sim_carry_cuda(inputs, flags, state, now0)


def system_sim_batched(
    c_set: torch.Tensor, c_tag: torch.Tensor,   # int32 [B, N]
    a_set: torch.Tensor, a_tag: torch.Tensor,   # int32 [B, N]
    m_set: torch.Tensor, m_tag: torch.Tensor,   # int32 [B, N]
    flags: torch.Tensor,                        # int32 [B, 3]
    geom: Tuple[int, int, int, int, int, int],
    valid: Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]],
    *,
    kernel_mode: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched-config joint cache + accel-TLB + mem-TLB simulation (the
    ``sweep_system`` hot loop): B configs' three LRU states advance together
    through ONE pass over the trace.  Returns (cache_hit, accel_tlb_hit,
    mem_tlb_hit) bool [B, N]; bit-identical per config to
    :func:`repro_torch.core.tlbsim.simulate_system` on that config's own
    (unpadded) geometry."""
    B = c_set.shape[0]
    state = tuple(
        x for k in range(3)
        for x in padded_tlb_state(B, geom[2 * k], geom[2 * k + 1], valid[k],
                                  device=c_set.device))
    return system_sim_batched_carry(
        c_set, c_tag, a_set, a_tag, m_set, m_tag, flags, state, 0,
        kernel_mode=kernel_mode)[0]
