"""Global-view SPARTA paged attention, the port of
``src/repro/models/paged_global.py``: the partition axis is EXPLICIT.

The partition-explicit serve step keeps KV pools as ``[B, P, pages_local,
page, Hkv, hd]``, ``P`` the number of SPARTA partitions.  Every gather uses
a *local* block table indexed within its own partition, so a partition
never reads another's pages: local page-table walk, local data fetch, and
ONE cross-partition merge of the flash softmax partials (max / sum over the
P axis), the paper's schedule.  Here all partitions live on one card, and the
math runs as plain tensor ops (the JAX package's is plain ``jnp`` too); the
single-partition decode path reads its pool through the paged attention
kernel (K6) instead.

The pools keep the dtype they come in (bf16 pools for a bf16 config) and
are updated in place; the functions return them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_norm
from repro_torch.models.transformer import ffn_forward, local_ctx_from_global

NEG_INF = -1e30


def local_ctx_all_partitions(ctx: torch.Tensor, P: int, page: int) -> torch.Tensor:
    """[B] global ctx -> [B, P] per-partition packed valid-token counts."""
    return torch.stack([local_ctx_from_global(ctx, p, P, page) for p in range(P)], dim=1)


def paged_attention_global(
    q: torch.Tensor,          # [B, Hq, hd] (new token)
    k_pool: torch.Tensor,     # [B, P, pages_local, page, Hkv, hd]
    v_pool: torch.Tensor,
    tables: torch.Tensor,     # [B, P, pages_local] local slots (-1 = unmapped)
    ctx: torch.Tensor,        # [B] context length EXCLUDING the new token
    *,
    extra_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # new token K/V [B, Hkv, hd]
) -> torch.Tensor:
    """Merged attention output [B, Hq, hd], float32."""
    B, P, pl, page, Hkv, hd = k_pool.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    scale = 1.0 / (hd ** 0.5)
    dev = q.device

    idx = tables.clamp_min(0).long()                                 # [B, P, pl]
    bi = torch.arange(B, device=dev)[:, None, None]
    pi = torch.arange(P, device=dev)[None, :, None]
    k = k_pool[bi, pi, idx].reshape(B, P, pl * page, Hkv, hd)        # local gather
    v = v_pool[bi, pi, idx].reshape(B, P, pl * page, Hkv, hd)

    qf = q.float().reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bpshd->bphgs", qf, k.float()) * scale

    local_ctx = local_ctx_all_partitions(ctx, P, page)               # [B, P]
    pos = torch.arange(pl * page, device=dev)
    valid = pos[None, None] < local_ctx[..., None]                   # [B, P, S]
    valid = valid & (tables >= 0).repeat_interleave(page, dim=-1)
    valid = valid[:, :, None, None, :]
    s = torch.where(valid, s, NEG_INF)

    m = s.amax(-1)                                                   # [B, P, Hkv, G]
    p_ = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p_.sum(-1)
    acc = torch.einsum("bphgs,bpshd->bphgd", p_, v.float())

    if extra_kv is not None:
        k1, v1 = extra_kv                                            # the hot tail
        s1 = torch.einsum("bhgd,bhd->bhg", qf, k1.float()) * scale
        m = torch.cat([m, s1[:, None]], dim=1)
        l = torch.cat([l, torch.ones_like(s1)[:, None]], dim=1)
        acc1 = v1.float()[:, :, None, :].expand(B, Hkv, G, hd)
        acc = torch.cat([acc, acc1[:, None]], dim=1)

    # SPARTA merge: one reduction over the partition axis.
    m_g = m.amax(1)                                                  # [B, Hkv, G]
    alpha = torch.exp(m - m_g[:, None])
    l_g = (l * alpha).sum(1)
    acc_g = (acc * alpha[..., None]).sum(1)
    safe_l = torch.where(l_g > 0, l_g, 1.0)
    return (acc_g / safe_l[..., None]).reshape(B, Hq, hd)


def write_kv_global(
    pool: torch.Tensor,       # [B, P, pages_local, page, Hkv, hd], updated in place
    tables: torch.Tensor,     # [B, P, pages_local]
    new_kv: torch.Tensor,     # [B, Hkv, hd]
    ctx: torch.Tensor,        # [B] ctx INCLUDING the new token
    page: int,
) -> torch.Tensor:
    """Write the new token into its owning partition's pool, one row per
    sequence (the JAX package's default "scatter" formulation); returns the
    pool.  The page's *slot* comes from the local table (demand-allocated
    anywhere in the partition, paper section 5); slots must lie below
    ``pages_local``.  Where the current page is unmapped (table entry -1),
    the row goes into slot 0 of the owner at the page offset, as in the JAX
    package."""
    B, P = pool.shape[:2]
    gpage = torch.div(ctx - 1, page, rounding_mode="floor")          # [B] logical page
    owner = (gpage % P).long()
    lpage = torch.div(gpage, P, rounding_mode="floor").long()
    b_idx = torch.arange(B, device=pool.device)
    slot = tables[b_idx, owner].gather(1, lpage[:, None])[:, 0].long()   # [B]
    off = ((ctx - 1) % page).long()
    pool[b_idx, owner, slot.clamp_min(0), off] = new_kv.to(pool.dtype)
    return pool


def decode_block_global(
    lp,
    x: torch.Tensor,            # [B, 1, D]
    cfg: ModelConfig,
    k_pool: torch.Tensor,       # [B, P, pages_local, page, Hkv, hd], updated in place
    v_pool: torch.Tensor,
    tables: torch.Tensor,       # [B, P, pages_local] int32
    ctx_len: torch.Tensor,      # [B] int32 incl. the new token
    *,
    skip_mlp: bool = False,
):
    """One layer of global-view paged decode (dense / MoE / shared
    attention): attention over the pools as they stand before the new token
    plus its hot tail, merged over the partitions, then the new row written
    into its owner's pool.  ``skip_mlp`` returns after the attention
    residual.  Returns (x, k_pool, v_pool)."""
    page = cfg.kv_page_size
    h = apply_norm(lp.ln1, x, cfg.norm)
    q, k, v = attn._project_qkv(lp.attn, h, cfg, (ctx_len - 1)[:, None])
    k_new, v_new = k[:, 0], v[:, 0]
    merged = paged_attention_global(q[:, 0], k_pool, v_pool, tables, ctx_len - 1,
                                    extra_kv=(k_new, v_new))
    write_kv_global(k_pool, tables, k_new, ctx_len, page)
    write_kv_global(v_pool, tables, v_new, ctx_len, page)
    x = x + attn.finish_decode_attention(lp.attn, merged, cfg)
    if skip_mlp:
        return x, k_pool, v_pool
    return x + ffn_forward(lp, apply_norm(lp.ln2, x, cfg.norm), cfg)[0], k_pool, v_pool
