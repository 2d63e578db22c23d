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
    row that sees no key (l == 0) returns 0.  Under autograd the backward
    pass recomputes each block's probabilities from the saved log-sum-exp
    (:class:`_FlashRef`), so no [B, H, Tq, block_k] tensor outlives its
    block."""
    scale = sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashRef.apply(q, k, v, causal, scale, block_k)
    return _flash_forward(q, k, v, causal, scale, block_k)[0]


def _blocks(q: torch.Tensor, k: torch.Tensor, causal: bool, block_k: int):
    """(start, key mask [Tq, blk]) of each KV block, the decode-aligned
    causal mask (query i sees keys <= i + Tk - Tq) included."""
    Tq, Tk = q.shape[2], k.shape[2]
    block_k = max(1, min(block_k, Tk))
    q_pos = (torch.arange(Tq, device=q.device) + (Tk - Tq))[:, None]
    for start in range(0, Tk, block_k):
        k_pos = start + torch.arange(min(block_k, Tk - start), device=q.device)[None, :]
        mask = k_pos < Tk
        if causal:
            mask = mask & (k_pos <= q_pos)
        yield start, start + block_k, mask


def _flash_forward(q, k, v, causal: bool, scale: float, block_k: int):
    """(output in q's dtype [B, Hq, Tq, D], float32 output [B, Hkv, G, Tq,
    D], log-sum-exp [B, Hkv, G, Tq]; +inf where a row sees no key)."""
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qf = q.float().reshape(B, Hkv, G, Tq, D)
    m = torch.full_like(qf[..., 0], NEG_INF)
    l = torch.zeros_like(qf[..., 0])
    acc = torch.zeros_like(qf)
    for start, end, mask in _blocks(q, k, causal, block_k):
        kc, vc = k[:, :, start:end].float(), v[:, :, start:end].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kc) * scale
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vc)
        m = m_new
    safe_l = torch.where(l > 0, l, 1.0)
    of = acc / safe_l[..., None]
    lse = torch.where(l > 0, m + torch.log(safe_l), float("inf"))
    return of.reshape(B, Hq, Tq, D).to(q.dtype), of, lse


class _FlashRef(torch.autograd.Function):
    """:func:`flash_attention_ref` with the flash backward pass: it keeps
    q, k, v, the float32 output and the log-sum-exp, and per KV block
    recomputes p = exp(s - lse) and forms dv += p^T do, dp = do v^T,
    ds = p (dp - rowsum(do * o)), dq += ds k, dk += ds^T q (scaled), all in
    float32.  Autograd through the forward loop would keep each block's
    [B, H, Tq, block_k] scores and probabilities until the backward pass."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_k):
        o, of, lse = _flash_forward(q, k, v, causal, scale, block_k)
        ctx.save_for_backward(q, k, v, of, lse)
        ctx.args = (causal, scale, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, of, lse = ctx.saved_tensors
        causal, scale, block_k = ctx.args
        B, Hq, Tq, D = q.shape
        Hkv = k.shape[1]
        qf = q.float().reshape(B, Hkv, Hq // Hkv, Tq, D)
        dof = do.float().reshape(qf.shape)
        delta = (dof * of).sum(-1)
        dq = torch.zeros_like(qf)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for start, end, mask in _blocks(q, k, causal, block_k):
            kc, vc = k[:, :, start:end].float(), v[:, :, start:end].float()
            s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kc) * scale
            p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
            dv[:, :, start:end] = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
            ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", dof, vc) - delta[..., None])
            dq += torch.einsum("bhgqk,bhkd->bhgqd", ds, kc) * scale
            dk[:, :, start:end] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
        return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None)
