"""Public paged-attention ops with kernel-mode dispatch (the port of
``src/repro/kernels/paged_attention/ops.py``).

``paged_attention``         — full decode attention over a paged KV pool.
``paged_attention_partial`` — the residuals (acc, m, l), merged with other
                              partials by :func:`merge_partials` (the decode
                              path merges the hot tail this way).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import refuse_autograd, resolve_mode
from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
from repro_torch.kernels.paged_attention.ref import merge_partials, paged_attention_ref

__all__ = ["paged_attention", "paged_attention_partial", "merge_partials"]


def paged_attention_partial(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,
    ctx_len: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    kernel_mode: str = "auto",
):
    """Residuals (acc, m, l) over the pages mapped by ``block_table``."""
    refuse_autograd("paged_attention_partial", kernel_mode, q.device, q, k_pool, v_pool)
    mode = resolve_mode(kernel_mode, q.device)
    if mode == "reference":
        return paged_attention_ref(q, k_pool, v_pool, block_table, ctx_len,
                                   sm_scale=sm_scale, return_residuals=True)
    return paged_attention_cuda(q, k_pool, v_pool, block_table, ctx_len, sm_scale=sm_scale)


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,
    ctx_len: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    kernel_mode: str = "auto",
) -> torch.Tensor:
    """Normalised decode attention [B, Hq, D] in q's dtype."""
    refuse_autograd("paged_attention", kernel_mode, q.device, q, k_pool, v_pool)
    mode = resolve_mode(kernel_mode, q.device)
    if mode == "reference":
        return paged_attention_ref(q, k_pool, v_pool, block_table, ctx_len, sm_scale=sm_scale)
    acc, m, l = paged_attention_cuda(q, k_pool, v_pool, block_table, ctx_len,
                                     sm_scale=sm_scale)
    safe_l = torch.where(l > 0, l, 1.0)
    return (acc / safe_l[..., None]).to(q.dtype)
