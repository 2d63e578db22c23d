"""Python wrapper of the hand-written CUDA joint-system kernel (K2).

``csrc/system_sim.cu`` holds the kernel and says which Pallas TPU kernels it
replaces and what bounds it on the card; it runs the set-parallel LRU of
``tlb_sim/csrc/lru_sets.cuh`` as a cache pass and a gated TLB pass.
:func:`system_sim_carry_cuda` checks its inputs, plans the bucketing,
allocates the outputs and the scratch, launches the kernels on PyTorch's
current stream and counts the call in :data:`launches`.  Given CPU tensors
it runs the plain version (``ref.py``) instead; given CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import note_launch
from repro_torch.kernels.system_sim.ref import system_sim_batched_carry_ref
from repro_torch.kernels.tlb_sim.kernel import (
    bucket_plan,
    bucket_scratch,
    check_int32,
    check_launch,
    event_array,
)

# Calls of the CUDA kernel in this process (one per wrapper call, however
# many launches the call makes); chip_smoke.py resets and reads it to show
# which path ran through the kernel.
launches = 0


def system_sim_carry_cuda(inputs, flags: torch.Tensor, state, now0: int, *,
                          phase_events: Optional[Sequence] = None):
    """Chunk-resumable batched joint pipeline.

    ``inputs`` are the six int32 [B, L] (set, tag) streams of the cache, the
    accel TLB and the mem TLB; ``flags`` int32 [B, 3]; ``state`` the six
    int32 [B, S, W] carried (tags, last) arrays.  Returns ``((cache, accel,
    mem) hit bits bool [B, L], state')``.  The carried state is updated in
    place on copies this function owns; the inputs are not modified.
    ``phase_events``: six CUDA events recorded at the start, after the cache
    bucketing, after the cache pass, after the TLB bucketing, after the TLB
    pass and after the packing of the hit word."""
    inputs, state = tuple(inputs), tuple(state)
    if inputs[0].device.type == "cpu":
        return system_sim_batched_carry_ref(inputs, flags, state, now0)
    global launches
    dev = inputs[0].device
    B, L = inputs[0].shape
    for name, x in zip(("c_set", "c_tag", "a_set", "a_tag", "m_set", "m_tag"), inputs):
        check_int32(name, x, (B, L), dev)
    check_int32("flags", flags, (B, 3), dev)
    dims = []
    for k, s in enumerate("cam"):
        S, W = state[2 * k].shape[1], state[2 * k].shape[2]
        check_int32(f"{s}_tags", state[2 * k], (B, S, W), dev)
        check_int32(f"{s}_last", state[2 * k + 1], (B, S, W), dev)
        dims += [S, W]
    now0 = int(now0)
    state = tuple(x.clone() for x in state)
    hits = torch.empty((B, L), dtype=torch.uint8, device=dev)
    if B and L:
        plans = [bucket_plan(B, L, check_launch(inputs[2 * k], dims[2 * k],
                                                dims[2 * k + 1], now0))
                 for k in range(3)]
        lib = _build.load()
        with torch.cuda.device(dev):
            scratch, _keep = bucket_scratch([plans[:1], plans[1:]], B, L, dev)
            raw = torch.empty((3, B, L), dtype=torch.uint8, device=dev)
            events = event_array(phase_events, 6)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.cdll.system_sim_launch(
                *(x.data_ptr() for x in inputs), flags.data_ptr(),
                *(x.data_ptr() for x in state), hits.data_ptr(),
                B, L, *dims, now0, *(v for p in plans for v in (p.sets, p.segs)),
                raw.data_ptr(), *scratch, events, stream)
        lib.check(err, "system_sim_launch")
        launches += 1
        note_launch("system_sim")
    return ((hits & 1).bool(), (hits & 2).bool(), (hits & 4).bool()), state
