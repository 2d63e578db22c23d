"""Public flash-attention op with kernel-mode dispatch (the port of
``src/repro/kernels/flash_attention/ops.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import refuse_autograd, resolve_mode
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention"]


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Tq, D]
    k: torch.Tensor,  # [B, Hkv, Tk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    kernel_mode: str = "auto",
) -> torch.Tensor:
    """GQA attention with the decode-aligned causal mask; q's dtype out.
    ``reference`` runs the blocked plain version, ``cuda`` the kernel (whose
    inputs must be contiguous)."""
    refuse_autograd("flash_attention", kernel_mode, q.device, q, k, v)
    mode = resolve_mode(kernel_mode, q.device)
    if mode == "reference":
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    return flash_attention_cuda(q, k, v, causal=causal, sm_scale=sm_scale)
