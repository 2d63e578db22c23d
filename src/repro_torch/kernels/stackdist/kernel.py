"""Python wrapper of the hand-written CUDA segmented LRU-stack scan (K3).

``csrc/stackdist.cu`` holds the kernel and says which Pallas TPU kernel it
replaces, what bounds it on the card and how its design answers that.
:func:`stack_plan` splits each lane across P threads from the shapes alone;
:func:`stack_scan_cuda` checks its inputs, allocates the outputs, launches
the kernel with the plan on PyTorch's current stream and counts the launch
in :data:`launches`.  Given CPU tensors it runs the plain version
(``ref.py``) instead; given CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import note_launch
from repro_torch.kernels.paged_attention.kernel import sm_count
from repro_torch.kernels.stackdist.ref import stack_scan_ref
from repro_torch.kernels.tlb_sim.kernel import check_int32

# Launches of the CUDA kernel in this process; chip_smoke.py resets and reads
# it to show which path ran through the kernel.
launches = 0

MAX_REG_WAYS = 32            # wider stacks walk device memory (one thread a lane)
MAX_THREADS = 256            # threads a block (the kernels' launch bound)
SMEM_LIMIT = 232_448         # shared bytes a block may use (227 KB)
SM_SMEM = 233_472            # shared bytes an SM holds (228 KB)
STREAM_BLOCK = 128           # lanes a block when P = 1
TILE_STEPS = 64              # steps a thread stages at a time when P = 1
RES_TILE_STEPS = 32          # steps a resident row is copied by at a time when P > 1
MIN_PART_STEPS = 16          # no part shorter than this
# P = 1 where the launch has at least this many lanes an SM: its one chain
# of C steps then hides under the launch's own bytes.  Else the smaller of
# P = 16 and 32 that gives this many threads an SM, and P = 1 where parts
# of 16 would be shorter than MIN_PART_STEPS.  Both read on the H100 at
# C = 1,024 (chip_smoke.py's parts_plan_ms, PERF.md): P = 1 is fastest
# from ~19,000 lanes, P = 16 from ~1,500 to 10,000, P = 32 below ~1,000,
# and P = 4 and 8 at none of them.
STREAM_LANES_PER_SM = 128
FILL_THREADS_PER_SM = 128


@dataclasses.dataclass(frozen=True)
class StackPlan:
    design: str             # "streamed" (P = 1), "resident" (P > 1), "device-memory" (W > 32)
    parts: int              # P: threads a lane
    part_steps: int         # Q = ceil(C / P): steps a part
    tile_steps: int         # K: steps of a thread's row a stage holds (Q when resident)
    row_steps: int          # K padded to a multiple of 16 (of RES_TILE_STEPS when resident)
    lanes_per_block: int
    stages: int
    smem_bytes: int
    blocks: int

    @property
    def threads(self) -> int:
        return self.lanes_per_block * self.parts

    @property
    def chain_steps(self) -> int:
        """Steps a thread walks one after another: its whole lane when
        P = 1, else its part twice (the effect walk, then the re-walk)."""
        return self.part_steps * (1 if self.parts == 1 else 2)


def _row_steps(k: int, multiple: int = 16) -> int:
    return -(-k // multiple) * multiple


def _resident_lane_bytes(C: int, P: int) -> int:
    """A lane's P rows, each its part padded to whole copy tiles: int32 tags
    and byte flags."""
    return P * _row_steps(-(-C // P), RES_TILE_STEPS) * 5


def _resident_fits(C: int, P: int) -> bool:
    """A full warp of the lane's threads fits one block's shared memory."""
    return C >= P * MIN_PART_STEPS and (32 // P) * _resident_lane_bytes(C, P) <= SMEM_LIMIT


def stack_plan(L: int, C: int, W: int, sms: int) -> StackPlan:
    """The launch of ``L`` lanes of ``C`` steps with ``W`` slots on a card of
    ``sms`` SMs, from the shapes alone.  P = 1 (a thread walks its lane
    through tiles of ``TILE_STEPS`` steps, two stages in flight) when the
    lanes fill the card; else the smaller of P = 16 and 32 that gives
    ``FILL_THREADS_PER_SM`` threads an SM, each part at least
    ``MIN_PART_STEPS`` steps and a full warp's rows in shared memory; P = 1
    where neither fits."""
    parts = 1
    if W <= MAX_REG_WAYS and 0 < L < sms * STREAM_LANES_PER_SM:
        fits = [p for p in (16, 32) if _resident_fits(C, p)]
        if fits:
            parts = next((p for p in fits if L * p >= sms * FILL_THREADS_PER_SM), fits[-1])
    return plan_for_parts(L, C, W, sms, parts)


def plan_for_parts(L: int, C: int, W: int, sms: int, parts: int) -> StackPlan:
    """The launch at ``parts`` threads a lane (1, or a power of two up to 32
    whose rows fit a block).  A resident block takes as many lanes as leave
    four blocks an SM (at most 256 threads), fewer where the blocks would
    not cover the SMs; a streamed block 128 lanes, fewer likewise."""
    if W > MAX_REG_WAYS:
        return StackPlan("device-memory", 1, C, 0, 0, 128, 0, 0, -(-L // 128))
    if parts not in (1, 2, 4, 8, 16, 32) or (parts > 1 and 32 // parts * _resident_lane_bytes(
            C, parts) > SMEM_LIMIT):
        raise ValueError(f"parts={parts}: a power of two up to 32 whose rows fit a block")
    if parts == 1:
        lanes = STREAM_BLOCK
        while lanes > 32 and -(-L // lanes) < sms:
            lanes //= 2
        k = min(TILE_STEPS, C)
        stages = 2 if C > k else 1
        smem = stages * lanes * _row_steps(k) * 5
        return StackPlan("streamed", 1, C, k, _row_steps(k), lanes, stages, smem, -(-L // lanes))
    q = -(-C // parts)
    lane_bytes = _resident_lane_bytes(C, parts)
    lanes = MAX_THREADS // parts
    while lanes > 32 // parts and (lanes * lane_bytes > SM_SMEM // 4 or -(-L // lanes) < sms):
        lanes //= 2
    return StackPlan("resident", parts, q, q, _row_steps(q, RES_TILE_STEPS), lanes, 1,
                     lanes * lane_bytes, -(-L // lanes))


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
    plan = stack_plan(L, C, W, sm_count(dev.index))
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cdll.stack_scan_launch(
            tags.data_ptr(), seg_flags.data_ptr(), init_stack.data_ptr(),
            depths.data_ptr(), final.data_ptr(), L, C, W, plan.parts, plan.part_steps,
            plan.tile_steps, plan.row_steps, plan.lanes_per_block, plan.stages,
            plan.smem_bytes, stream)
    lib.check(err, "stack_scan_launch")
    launches += 1
    note_launch("stackdist")
    return depths, final
