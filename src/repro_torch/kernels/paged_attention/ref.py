"""Plain PyTorch version of SPARTA paged decode attention (K6), the port of
``src/repro/kernels/paged_attention/ref.py``.

A gather-translate-attend oracle: the block table (logical KV page ->
physical pool slot, -1 = unmapped) is translated by indexing the pool, and
one new query token per sequence attends over its ``ctx_len`` valid
positions.  With ``return_residuals`` it returns the un-normalised
accumulator and the softmax statistics (acc, m, l) in float32 (in float64
when the pools are float64, the oracle ``chip_smoke.py`` holds the kernel
to at the serving path's long contexts), which
:func:`merge_partials` combines with other partials (other partitions, or
the decode path's hot tail).  A sequence with no valid position returns
m = -1e30, l = 0, acc = 0.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def paged_attention_ref(
    q: torch.Tensor,            # [B, Hq, D] one new token per sequence
    k_pool: torch.Tensor,       # [slots, page, Hkv, D] physical KV pool
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [B, pages] int32 slot per logical page (-1 = unmapped)
    ctx_len: torch.Tensor,      # [B] int32 tokens of valid context
    *,
    sm_scale: Optional[float] = None,
    return_residuals: bool = False,
):
    B, Hq, D = q.shape
    _, page, Hkv, _ = k_pool.shape
    pages = block_table.shape[1]
    G = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)

    table = block_table.long()
    safe_table = table.clamp_min(0)
    k = k_pool[safe_table].reshape(B, pages * page, Hkv, D)   # [B, S, Hkv, D]
    v = v_pool[safe_table].reshape(B, pages * page, Hkv, D)

    ct = torch.promote_types(torch.float32, k_pool.dtype)
    qf = q.to(ct).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k.to(ct)) * scale

    pos = torch.arange(pages * page, device=q.device)[None, :]               # [1, S]
    valid = (pos < ctx_len.long()[:, None]) & (table >= 0).repeat_interleave(page, dim=1)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)

    m = s.amax(-1)                                                          # [B, Hkv, G]
    p = torch.where(valid[:, None, None, :], torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v.to(ct))

    if return_residuals:
        return acc.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq)
    safe_l = torch.where(l > 0, l, 1.0)
    return (acc / safe_l[..., None]).reshape(B, Hq, D).to(q.dtype)


def merge_partials(
    accs: torch.Tensor,  # [P, B, Hq, D] unnormalised accumulators
    ms: torch.Tensor,    # [P, B, Hq]
    ls: torch.Tensor,    # [P, B, Hq]
) -> torch.Tensor:
    """Merge flash partials into the final attention output."""
    m = ms.amax(0)                           # [B, Hq]
    alpha = torch.exp(ms - m[None])          # [P, B, Hq]
    l = (ls * alpha).sum(0)
    acc = (accs * alpha[..., None]).sum(0)
    safe_l = torch.where(l > 0, l, 1.0)
    return (acc / safe_l[..., None]).to(accs.dtype)
