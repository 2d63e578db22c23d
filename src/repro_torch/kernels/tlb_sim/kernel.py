"""Python wrapper of the hand-written CUDA TLB-simulation kernel (K1).

``csrc/tlb_sim.cu`` holds the kernel and says which Pallas TPU kernels it
replaces and what bounds it on the card; ``csrc/lru_sets.cuh`` holds the
set-parallel LRU it shares with K2.  :func:`tlb_sim_carry_cuda` checks its
inputs, plans the bucketing (:func:`bucket_plan`), allocates the outputs and
the scratch, launches the kernels on PyTorch's current stream and counts the
call in :data:`launches`.  Given CPU tensors it runs the plain version
(``ref.py``) instead; given CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import note_launch
from repro_torch.kernels.tlb_sim.ref import tlb_sim_batched_carry_ref

# Calls of the CUDA kernel in this process (one per wrapper call, however
# many launches the call makes); chip_smoke.py resets and reads it to show
# which path ran through the kernel.
launches = 0

_STAMP_LIMIT = 2**31 - 1  # the poisoned-way stamp; real stamps stay below it

# The bucketing's cuts (csrc/lru_sets.cuh: kRange, kScanChunk).
RANGE = 8192           # sets whose cursors one scatter task holds in shared memory
SCAN_CHUNK = 8192      # counts per block of the scan
COUNT_CAP = 1 << 23    # counts beyond which a config's trace is cut no finer
SEG_MIN = 4096         # accesses per trace segment at the finest cut


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """How one structure's accesses are bucketed by (config, set)."""

    sets: int      # buckets per config: every set index is below it
    segs: int      # trace segments per config, counted and scattered apart
    seg_len: int   # accesses per segment (the last may be shorter)
    ranges: int    # groups of RANGE sets, one bucketing task each
    tasks: int     # scatter tasks (one warp each): configs x ranges x segs
    counts: int    # count entries: configs x sets x segs


def bucket_plan(B: int, L: int, sets: int) -> BucketPlan:
    """The bucketing of B configs' chunks of L accesses whose set indices lie
    below ``sets``.  A bucketing task walks one segment of one config's chunk
    in warp steps, so the trace is cut into segments while the counts, one
    per (config, set, segment), stay within COUNT_CAP and a segment keeps at
    least SEG_MIN accesses."""
    if B < 1 or sets < 1 or L < 0:
        raise ValueError(f"no bucketing for B={B}, L={L}, sets={sets}")
    segs = max(1, min(L // SEG_MIN, COUNT_CAP // (B * sets)))
    ranges = -(-sets // RANGE)
    return BucketPlan(sets=sets, segs=segs, seg_len=-(-L // segs), ranges=ranges,
                      tasks=B * ranges * segs, counts=B * sets * segs)


def scratch_sizes(phases: Sequence[Sequence[BucketPlan]], B: int, L: int):
    """(counts, scan block sums, pairs) elements the bucketing needs for a
    call whose phases each bucket the structures listed (one scratch serves
    every phase in turn): the counts plus the total, one block sum per
    SCAN_CHUNK counts, and a (tag, j) pair per applied access."""
    counts = max(sum(p.counts for p in plans) for plans in phases) + 1
    pairs = max(len(plans) for plans in phases) * B * L
    return counts, -(-counts // SCAN_CHUNK), pairs


def bucket_scratch(phases, B: int, L: int, device: torch.device):
    """The bucketing scratch of :func:`scratch_sizes`, as the C entry points
    take it: (pointer, length) of the counts, the block sums and the pairs,
    and the tensors that own them."""
    n_counts, n_partials, n_pairs = scratch_sizes(phases, B, L)
    counts = torch.empty(n_counts, dtype=torch.int32, device=device)
    partials = torch.empty(n_partials, dtype=torch.int32, device=device)
    pairs = torch.empty((n_pairs, 2), dtype=torch.int32, device=device)
    args = (counts.data_ptr(), n_counts, partials.data_ptr(), n_partials,
            pairs.data_ptr(), n_pairs)
    return args, (counts, partials, pairs)


def event_array(events: Optional[Sequence], n: int):
    """A C array of ``n`` cudaEvent_t handles of ``events`` (CUDA events the
    entry point records between its phases), or None.  An event not yet
    recorded is recorded once here, which creates it."""
    if events is None:
        return None
    if len(events) != n:
        raise ValueError(f"phase_events has {len(events)} events, expected {n}")
    for e in events:
        if not e.cuda_event:
            e.record()
    return (ctypes.c_void_p * n)(*(e.cuda_event for e in events))


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


def check_launch(set_idx: torch.Tensor, rows: int, ways: int, now0: int) -> int:
    """Raise unless every set index lies in [0, rows), a row has a way, and
    the stamps of this chunk stay below the poisoned-way stamp.  Returns the
    number of sets the accesses use (the largest index + 1)."""
    L = set_idx.shape[-1]
    if now0 < 0 or now0 + L >= _STAMP_LIMIT:
        raise ValueError(f"stamps {now0 + 1}..{now0 + L} leave [1, 2**31 - 1)")
    if ways < 1:
        raise ValueError(f"state has {ways} ways")
    lo, hi = (int(v) for v in torch.aminmax(set_idx))
    if lo < 0 or hi >= rows:
        raise ValueError(f"set index range [{lo}, {hi}] outside [0, {rows})")
    return hi + 1


def tlb_sim_carry_cuda(
    set_idx: torch.Tensor,   # int32 [B, L] one trace chunk
    tag: torch.Tensor,       # int32 [B, L]
    tags: torch.Tensor,      # int32 [B, TS, W] carried state in
    last: torch.Tensor,      # int32 [B, TS, W]
    now0: int,               # accesses consumed before this chunk
    *,
    phase_events: Optional[Sequence] = None,
):
    """Chunk-resumable batched LRU simulation; returns ``(hits bool [B, L],
    tags', last')``.  The carried state is updated in place on copies this
    function owns; the inputs are not modified.  ``phase_events``: three
    CUDA events recorded at the start, after the bucketing and at the end."""
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
    plan = bucket_plan(B, L, check_launch(set_idx, TS, W, now0))
    lib = _build.load()
    with torch.cuda.device(dev):
        scratch, _keep = bucket_scratch([[plan]], B, L, dev)
        events = event_array(phase_events, 3)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cdll.tlb_sim_launch(
            set_idx.data_ptr(), tag.data_ptr(), tags.data_ptr(), last.data_ptr(),
            hits.data_ptr(), B, L, TS, W, now0, plan.sets, plan.segs, *scratch,
            events, stream)
    lib.check(err, "tlb_sim_launch")
    launches += 1
    note_launch("tlb_sim")
    return hits.view(torch.bool), tags, last
