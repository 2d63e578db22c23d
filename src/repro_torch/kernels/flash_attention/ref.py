"""Plain PyTorch versions of flash attention (K5).

* :func:`attention_ref` — naive full-materialisation attention in float32,
  the port of ``src/repro/kernels/flash_attention/ref.py``; the test oracle.
* :func:`flash_attention_ref` — the blocked online-softmax scan of
  ``src/repro/models/flash_ref.py`` (``flash_attention_jnp``), a Python loop
  over KV blocks with running (m, l, acc) statistics, so memory is
  O(B x H x Tq x block_k).  The op's ``reference`` mode runs it, and
  ``chip_smoke.py`` holds the CUDA kernel against it on the card.

Both take q [B, Hq, Tq, D] and k, v [B, Hkv, Tk, D] with Hq % Hkv == 0
(query head h reads KV head h // (Hq / Hkv)), mask causally with the decode
alignment (query i sees keys <= i + Tk - Tq) and return q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # [B, Hq, Tq, D]
    k: torch.Tensor,  # [B, Hkv, Tk, D]
    v: torch.Tensor,  # [B, Hkv, Tk, D]
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Naive full-materialisation attention in f32; GQA via head grouping."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    assert Hq % Hkv == 0, (Hq, Hkv)
    G = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)

    qf = q.float().reshape(B, Hkv, G, Tq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if causal:
        qi = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
        ki = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Tq, D).to(q.dtype)


def flash_attention_ref(
    q: torch.Tensor,  # [B, Hq, Tq, D]
    k: torch.Tensor,  # [B, Hkv, Tk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_k: int = 512,
) -> torch.Tensor:
    """Blocked online-softmax attention, f32 statistics, q's dtype out.  A
    row that sees no key (l == 0) returns 0."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    block_k = max(1, min(block_k, Tk))

    qf = q.float().reshape(B, Hkv, G, Tq, D)
    q_pos = (torch.arange(Tq, device=q.device) + (Tk - Tq))[:, None]   # decode alignment
    m = torch.full((B, Hkv, G, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Tq, D), dtype=torch.float32, device=q.device)
    for start in range(0, Tk, block_k):
        kc = k[:, :, start:start + block_k].float()
        vc = v[:, :, start:start + block_k].float()
        k_pos = start + torch.arange(kc.shape[2], device=q.device)[None, :]
        mask = k_pos < Tk
        if causal:
            mask = mask & (k_pos <= q_pos)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kc) * scale
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vc)
        m = m_new
    safe_l = torch.where(l > 0, l, 1.0)
    return (acc / safe_l[..., None]).reshape(B, Hq, Tq, D).to(q.dtype)
