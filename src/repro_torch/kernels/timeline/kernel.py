"""Python wrapper of the hand-written CUDA timeline kernel (K4).

``csrc/timeline.cu`` holds the kernel and says which Pallas TPU kernels it
replaces and what bounds it on the card.  :func:`timeline_carry_cuda` checks
its inputs, allocates the outputs, launches the kernel on PyTorch's current
stream and counts the launch in :data:`launches`.  Given CPU tensors it runs
the plain version (``ref.py``) instead; given CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import note_launch
from repro_torch.kernels.timeline.ref import STATE_NAMES, timeline_scan_batched_carry_ref
from repro_torch.kernels.tlb_sim.kernel import check_int32

# Launches of the CUDA kernel in this process; chip_smoke.py resets and reads
# it to show which path ran through the kernel.
launches = 0

_COLUMNS = ("accel", "part", "bank_data", "bank_pte", "cache_hit", "tlb_hit", "mem_hit")


def _check_f32(name: str, x: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if x.device != device or x.dtype != torch.float32:
        raise ValueError(f"{name} must be a float32 tensor on {device}, got "
                         f"{x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous with shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")


def _check_ids(name: str, x: torch.Tensor, bound: int) -> None:
    """Raise unless every id in ``x`` indexes the state envelope [0, bound)."""
    if x.numel():
        lo, hi = (int(v) for v in torch.aminmax(x))
        if lo < 0 or hi >= bound:
            raise ValueError(f"{name} range [{lo}, {hi}] outside the state's [0, {bound})")


def timeline_carry_cuda(cols, fparams: torch.Tensor, iparams: torch.Tensor, state):
    """Chunk-resumable batched timeline simulation.

    ``cols`` are the eight [B, L] per-access columns (seven int32, then f32
    ``pen``), ``fparams`` f32 [B, 8], ``iparams`` int32 [B, 7] and ``state``
    the five carried arrays of
    :func:`~repro_torch.kernels.timeline.ref.timeline_init_state_batched`.
    Returns ``((latency, overhead, done) f32 [B, L], state')``.  The carried
    state is updated in place on copies this function owns; the inputs are
    not modified."""
    cols, state = tuple(cols), tuple(state)
    if cols[0].device.type == "cpu":
        return timeline_scan_batched_carry_ref(*cols, fparams, iparams, state)
    global launches
    dev = cols[0].device
    B, L = cols[0].shape
    for name, x in zip(_COLUMNS, cols[:7]):
        check_int32(name, x, (B, L), dev)
    _check_f32("pen", cols[7], (B, L), dev)
    _check_f32("fparams", fparams, (B, 8), dev)
    check_int32("iparams", iparams, (B, 7), dev)
    if len(state) != 5:
        raise ValueError(f"state has {len(state)} arrays, expected 5 ({STATE_NAMES})")
    A, M = state[1].shape[1], state[1].shape[2]
    P, T = state[3].shape[1], state[3].shape[2]
    D = state[4].shape[1]
    for name, x, shape in zip(STATE_NAMES, state,
                              ((B, A), (B, A, M), (B, A), (B, P, T), (B, D))):
        (check_int32 if name == "mshr_cnt" else _check_f32)(name, x, shape, dev)
    for name, x, bound in (("accel", cols[0], A), ("part", cols[1], P),
                           ("bank_data", cols[2], D), ("bank_pte", cols[3], D)):
        _check_ids(name, x, bound)
    if B and (int(iparams[:, 3].max()) > M or int(iparams[:, 5].max()) > T):
        raise ValueError(f"iparams ask for more MSHRs or ports than the state's "
                         f"envelope (M={M}, T={T})")
    state = tuple(x.clone() for x in state)
    outs = tuple(torch.empty((B, L), dtype=torch.float32, device=dev) for _ in range(3))
    if B == 0 or L == 0:
        return outs, state
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cdll.timeline_launch(
            *(x.data_ptr() for x in cols), fparams.data_ptr(), iparams.data_ptr(),
            *(x.data_ptr() for x in state), *(o.data_ptr() for o in outs),
            B, L, A, M, P, T, D, stream)
    lib.check(err, "timeline_launch")
    launches += 1
    note_launch("timeline")
    return outs, state
