"""Python wrapper of the hand-written CUDA paged-attention kernel (K6).

``csrc/paged_attention.cu`` holds the kernel and says which Pallas TPU
kernel it replaces and what bounds it on the card.  :func:`split_plan` cuts
each sequence's table into contiguous ranges of whole 32-key tiles, one
block each, from the shapes alone; the C side refuses a plan that does not
match its layout.  :func:`paged_attention_cuda` checks its inputs,
allocates the residuals (and, with more than one split, the splits'
partials), launches the kernel on PyTorch's current stream and counts the
launch in :data:`launches`.  Given CPU tensors it runs the plain version
(``ref.py``) instead; given CUDA tensors it launches the kernel or raises.
The table's entries are not range-checked on the card (that would cost a
sync per layer): each must be negative (unmapped) or a slot of the pool.
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import note_launch
from repro_torch.kernels.flash_attention.kernel import (DTYPE_CODES, SMEM_LIMIT,
                                                        check_head_dim)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

# Launches of the CUDA kernel in this process; chip_smoke.py resets and reads
# it to show which path ran through the kernel.
launches = 0

MAX_GROUP = 16           # query heads per KV head (8 above head_dim 128)
TILE = 32                # keys a warp takes at a time, one per lane
MAX_WARPS = 4            # warps a block of a split table
MAX_WARPS_UNSPLIT = 8    # warps a block of an unsplit table (a warp a tile)


class SplitPlan(NamedTuple):
    """The grid of one launch, as ``csrc/paged_attention.cu`` lays it out."""
    splits: int          # blocks per (sequence, KV head)
    tiles_per_split: int  # contiguous 32-key tiles each of them takes
    warps: int           # warps a block
    smem_bytes: int      # shared memory a block


def block_smem(D: int, G: int, warps: int) -> int:
    """q [G][D], then per warp a K tile [32][D + 4], a V tile [32][D] and the
    tile's probabilities [G][32], all float32, and two 8-byte mbarriers."""
    return 4 * (G * D + warps * (TILE * (2 * D + 4) + TILE * G + 4))


@functools.lru_cache(maxsize=1024)
def split_plan(B: int, Hkv: int, pages: int, page: int, sms: int, D: int, G: int) -> SplitPlan:
    """Splits from the shapes alone (never ``ctx_len``).  A table whose tiles
    all fit one block's warps (a warp a tile, at most 8) runs unsplit when
    the (sequence, KV head) blocks fill half of the ``sms`` SMs already: a
    merge would cost more than the split saves.  Else as many warps a block
    as leave room for two blocks on an SM (at most 4), then enough splits
    for two blocks on every SM and about two tiles a warp (at least that
    many splits, at most one a tile), no more warps than a split has tiles,
    and a split's tiles rounded up to a multiple of its warps where the
    splits still fill the card; the splits are whole tiles and the last one
    is not empty."""
    tiles = max(1, -(-pages * page // TILE))
    per_warp = block_smem(D, G, 1) - block_smem(D, G, 0)
    if 2 * B * Hkv >= sms and tiles <= min(MAX_WARPS_UNSPLIT,
                                          (SMEM_LIMIT - block_smem(D, G, 0)) // per_warp):
        return SplitPlan(1, tiles, tiles, block_smem(D, G, tiles))
    warps = max(1, min(MAX_WARPS, (SMEM_LIMIT // 2 - block_smem(D, G, 0)) // per_warp))
    fill = -(-2 * sms // max(1, B * Hkv))
    work = -(-tiles // (2 * warps))
    per = max(1, tiles // max(1, fill, work))
    warps = min(warps, per)
    even = -(-per // warps) * warps         # the same tiles for every warp
    if B * Hkv * -(-tiles // even) >= min(2 * sms, B * Hkv * tiles):
        per = even
    return SplitPlan(-(-tiles // per), per, warps, block_smem(D, G, warps))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"{name} must be a {dtype} tensor on {device}, got "
                         f"{x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous with shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")


def paged_attention_cuda(
    q: torch.Tensor,            # [B, Hq, D] float32 or bfloat16
    k_pool: torch.Tensor,       # [slots, page, Hkv, D] float32
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [B, pages] int32, -1 = unmapped
    ctx_len: torch.Tensor,      # [B] int32
    *,
    sm_scale: Optional[float] = None,
):
    """Residuals ``(acc [B, Hq, D], m [B, Hq], l [B, Hq])``, all float32."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_table, ctx_len,
                                   sm_scale=sm_scale, return_residuals=True)
    global launches
    dev = q.device
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be [B, Hq, D] and the pools [slots, page, Hkv, D], "
                         f"got {tuple(q.shape)} and {tuple(k_pool.shape)}")
    B, Hq, D = q.shape
    slots, page, Hkv, _ = k_pool.shape
    pages = block_table.shape[-1]
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    _check("q", q, q.dtype, (B, Hq, D), dev)
    _check("k_pool", k_pool, torch.float32, (slots, page, Hkv, D), dev)
    _check("v_pool", v_pool, torch.float32, (slots, page, Hkv, D), dev)
    _check("block_table", block_table, torch.int32, (B, pages), dev)
    _check("ctx_len", ctx_len, torch.int32, (B,), dev)
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    check_head_dim(D)
    G = Hq // Hkv
    if G > MAX_GROUP or (D > 128 and G > MAX_GROUP // 2):
        raise ValueError(f"{G} query heads per KV head: the kernel takes up to "
                         f"{MAX_GROUP} (up to {MAX_GROUP // 2} above head_dim 128)")
    if B == 0 or Hq == 0:
        return _outputs(B, Hq, D, 0, dev)[:3]
    if pages == 0 or page == 0:
        acc, m, l, _ = _outputs(B, Hq, D, 0, dev)
        return acc.zero_(), m.fill_(-1e30), l.zero_()
    plan = split_plan(B, Hkv, pages, page, sm_count(dev.index), D, G)
    acc, m, l, scratch = _outputs(B, Hq, D, plan.splits if plan.splits > 1 else 0, dev)
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    lib = _build.load()
    on_dev = dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if on_dev else torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cdll.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
            ctx_len.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None,
            B, Hq, Hkv, D, page, pages, float(scale), DTYPE_CODES[q.dtype], *plan, stream)
    lib.check(err, "paged_attention_launch")
    launches += 1
    note_launch("paged_attention")
    return acc, m, l


def _outputs(B: int, Hq: int, D: int, splits: int, dev):
    """acc [B, Hq, D], m and l [B, Hq], and the splits' partials (splits x
    B x Hq x (D + 2) floats, 16-byte aligned) as views of one float32
    allocation: one allocation a call instead of four."""
    rows = B * Hq
    head = -(-rows * (D + 2) // 4) * 4
    buf = torch.empty(head + splits * rows * (D + 2), dtype=torch.float32, device=dev)
    acc, m, l, _, scratch = buf.split_with_sizes(
        [rows * D, rows, rows, head - rows * (D + 2), splits * rows * (D + 2)])
    return acc.view(B, Hq, D), m.view(B, Hq), l.view(B, Hq), scratch
