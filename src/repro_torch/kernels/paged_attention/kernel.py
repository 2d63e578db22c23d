"""Python wrapper of the hand-written CUDA paged-attention kernel (K6).

``csrc/paged_attention.cu`` holds the kernel and says which Pallas TPU
kernel it replaces and what bounds it on the card.
:func:`paged_attention_cuda` checks its inputs, allocates the residuals,
launches the kernel on PyTorch's current stream and counts the launch in
:data:`launches`.  Given CPU tensors it runs the plain version (``ref.py``)
instead; given CUDA tensors it launches the kernel or raises.  The table's
entries are not range-checked on the card (that would cost a sync per
layer): each must be negative (unmapped) or a slot of the pool.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import DTYPE_CODES, check_head_dim
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

# Launches of the CUDA kernel in this process; chip_smoke.py resets and reads
# it to show which path ran through the kernel.
launches = 0

MAX_GROUP = 16           # query heads per KV head (8 above head_dim 128)


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
    acc = torch.empty((B, Hq, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, Hq), dtype=torch.float32, device=dev)
    l = torch.empty((B, Hq), dtype=torch.float32, device=dev)
    if B == 0 or Hq == 0:
        return acc, m, l
    if pages == 0 or page == 0:
        return acc.zero_(), m.fill_(-1e30), l.zero_()
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cdll.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
            ctx_len.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            B, Hq, Hkv, D, page, pages, float(scale), DTYPE_CODES[q.dtype], stream)
    lib.check(err, "paged_attention_launch")
    launches += 1
    return acc, m, l
