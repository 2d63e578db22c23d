"""Public timeline-simulation ops with kernel-mode dispatch.

All three ops run the one carry function: the monolithic batched op starts
it from :func:`timeline_init_state_batched` on the batch's resource
envelope, and the single-sim op is the batched one with B = 1 and that
sim's :func:`pack_params` row (its ``"reference"`` mode runs the
static-parameter oracle, which the reference holds bit-identical to the
batched step).  The CUDA kernel streams any chunk length, so unlike the TPU
kernel these ops take no ``block`` and pad nothing.

``"auto"`` is ``"cuda"`` for data on the card at every batch size and
``"reference"`` on the CPU.  The JAX package sends a single sim to its scan
because a TPU ran its kernel at 0.87x of the scan there; on the H100 the
plain version pays dozens of launches per access, and ``chip_smoke.py``
times B = 1 both ways (``PERF.md`` records the measurement behind this
rule).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.common import SWEEP_MODES, VALID_MODES, resolve_mode
from repro_torch.kernels.timeline.kernel import timeline_carry_cuda
from repro_torch.kernels.timeline.ref import (
    FP_COLS,
    IP_COLS,
    TimelineParams,
    pack_params,
    params_envelope,
    timeline_init_state_batched,
    timeline_scan_batched_carry_ref,
    timeline_scan_ref,
)

__all__ = ["TimelineParams", "timeline_sim", "timeline_sim_batched",
           "timeline_sim_batched_carry", "timeline_init_state_batched",
           "pack_params", "resolve_timeline_mode", "envelope_of", "FP_COLS", "IP_COLS"]


def resolve_timeline_mode(kernel_mode: str, device) -> str:
    """Validate and resolve ``kernel_mode`` for the timeline engine.

    Sweep-only backends are rejected loudly (no silent coercion): the
    timeline is not a pure-LRU sweep, so ``"stackdist"`` cannot apply."""
    if kernel_mode in SWEEP_MODES and kernel_mode not in VALID_MODES:
        raise ValueError(
            f"kernel_mode={kernel_mode!r} is a sweep_tlb/miss_ratio_curve-only "
            f"backend, not a timeline backend; the timeline engine accepts "
            f"one of {VALID_MODES}")
    return resolve_mode(kernel_mode, device)


def envelope_of(iparams) -> Tuple[int, int, int, int, int]:
    """The (A, M, P, T, D) resource envelope of a batch: the max of
    num_accels / mshrs / partitions / tlb_ports / dram_banks over its sims,
    each floored at 1."""
    ip = iparams.cpu().numpy() if isinstance(iparams, torch.Tensor) else np.asarray(iparams)
    return tuple(max(int(ip[:, c].max()), 1) for c in (2, 3, 4, 5, 6))


def _params(fparams, iparams, device: torch.device):
    """The packed parameter rows as f32 / int32 tensors on ``device``."""
    return (torch.as_tensor(fparams, device=device).to(torch.float32).contiguous(),
            torch.as_tensor(iparams, device=device).to(torch.int32).contiguous())


def timeline_sim_batched_carry(
    accel: torch.Tensor,      # int32 [B, L] one trace chunk
    part: torch.Tensor,
    bank_data: torch.Tensor,
    bank_pte: torch.Tensor,
    cache_hit: torch.Tensor,
    tlb_hit: torch.Tensor,
    mem_hit: torch.Tensor,
    pen: torch.Tensor,        # f32 [B, L]
    fparams,                  # f32 [B, 8]  (FP_COLS), numpy or tensor
    iparams,                  # int32 [B, 7] (IP_COLS), numpy or tensor
    state,                    # 5-tuple carried queueing state
    *,
    kernel_mode: str = "auto",
):
    """Run ONE trace chunk against caller-owned carried queueing state
    (initialise with :func:`timeline_init_state_batched` on the batch's
    resource envelope).  Returns ``((latency, overhead, done) f32 [B, L],
    state')``; chunked execution is bit-identical to the monolithic op in
    either mode and across mode changes at chunk boundaries (state layout
    and step function are shared)."""
    mode = resolve_timeline_mode(kernel_mode, accel.device)
    fp, ip = _params(fparams, iparams, accel.device)
    cols = (accel, part, bank_data, bank_pte, cache_hit, tlb_hit, mem_hit, pen)
    if mode == "reference":
        return timeline_scan_batched_carry_ref(*cols, fp, ip, tuple(state))
    return timeline_carry_cuda(cols, fp, ip, state)


def timeline_sim_batched(
    accel: torch.Tensor,      # int32 [B, N]
    part: torch.Tensor,
    bank_data: torch.Tensor,
    bank_pte: torch.Tensor,
    cache_hit: torch.Tensor,
    tlb_hit: torch.Tensor,
    mem_hit: torch.Tensor,
    pen: torch.Tensor,        # f32 [B, N]
    fparams,                  # f32 [B, 8]
    iparams,                  # int32 [B, 7]
    *,
    kernel_mode: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B-sim batched timeline simulation (the ``sweep_timeline`` hot loop):
    every sim's queueing state advances together through ONE pass over the
    stacked trace.  Returns (latency, overhead, done), each f32 [B, N]; per
    sim bit-identical to :func:`timeline_sim` on that sim's own
    configuration."""
    state = timeline_init_state_batched(accel.shape[0], envelope_of(iparams),
                                        iparams[:, 5], device=accel.device)
    return timeline_sim_batched_carry(
        accel, part, bank_data, bank_pte, cache_hit, tlb_hit, mem_hit, pen,
        fparams, iparams, state, kernel_mode=kernel_mode)[0]


def timeline_sim(
    accel: torch.Tensor,      # int32 [N]
    part: torch.Tensor,       # int32 [N]
    bank_data: torch.Tensor,  # int32 [N]
    bank_pte: torch.Tensor,   # int32 [N]
    cache_hit: torch.Tensor,  # int32 [N]
    tlb_hit: torch.Tensor,    # int32 [N]
    mem_hit: torch.Tensor,    # int32 [N]
    pen: torch.Tensor,        # f32   [N]
    params: TimelineParams,
    *,
    kernel_mode: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-access (latency, overhead, completion-time) for one trace."""
    mode = resolve_timeline_mode(kernel_mode, accel.device)
    cols = (accel, part, bank_data, bank_pte, cache_hit, tlb_hit, mem_hit, pen)
    if mode == "reference":
        return timeline_scan_ref(*cols, params)
    fp, ip = (torch.from_numpy(x[None]).to(accel.device) for x in pack_params(params))
    state = timeline_init_state_batched(1, params_envelope(params), ip[:, 5],
                                        device=accel.device)
    ys = timeline_carry_cuda([x[None].contiguous() for x in cols], fp, ip, state)[0]
    return tuple(y[0] for y in ys)
