"""Python wrapper of the hand-written CUDA flash-attention kernel (K5).

``csrc/flash_attention.cu`` holds the kernel and says which Pallas TPU kernel
it replaces and what bounds it on the card.  :func:`flash_attention_cuda`
checks its inputs, allocates the output, launches the kernel on PyTorch's
current stream and counts the launch in :data:`launches`.  Given CPU tensors
it runs the plain version (``ref.py``) instead; given CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# Launches of the CUDA kernel in this process; chip_smoke.py resets and reads
# it to show which path ran through the kernel.
launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def check_head_dim(D: int) -> None:
    if D % 8 or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D}: the kernel takes 0 < D <= {MAX_HEAD_DIM}, "
                         f"D % 8 == 0")


def flash_attention_cuda(
    q: torch.Tensor,  # [B, Hq, Tq, D]
    k: torch.Tensor,  # [B, Hkv, Tk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention output [B, Hq, Tq, D] in q's dtype (f32 statistics)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    global launches
    dev = q.device
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D, got {q.dim()}, {k.dim()}, {v.dim()}")
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Tk, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k, v must have shape {(B, Hkv, Tk, D)}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != dev or x.dtype != q.dtype:
            raise ValueError(f"{name} must be a {q.dtype} tensor on {dev}, got "
                             f"{x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    check_head_dim(D)
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    if Tk == 0:
        return o.zero_()
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cdll.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Hq, Hkv, Tq, Tk, D, float(scale), int(bool(causal)), DTYPE_CODES[q.dtype],
            stream)
    lib.check(err, "flash_attention_launch")
    launches += 1
    return o
