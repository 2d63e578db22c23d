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
from repro_torch.distributed.sharding import batch_only, is_dtensor
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_norm
from repro_torch.models.transformer import ffn_forward, local_ctx_from_global

NEG_INF = -1e30


def local_ctx_all_partitions(ctx: torch.Tensor, P: int, page: int, first: int = 0,
                             count: Optional[int] = None) -> torch.Tensor:
    """[B] global ctx -> [B, count] per-partition packed valid-token counts
    of partitions ``first`` .. ``first + count - 1`` (all ``P`` by
    default)."""
    parts = torch.arange(first, first + (P if count is None else count), device=ctx.device)
    return local_ctx_from_global(ctx[:, None], parts[None, :], P, page)


def _partials(qf, k_pool, v_pool, tables, local_ctx, scale):
    """Each partition's flash-softmax partials over its own pages, read
    through its own local table: (m, l) [B, P, Hkv, G] and acc [B, P, Hkv,
    G, hd], float32.  ``local_ctx`` [B, P] is each partition's valid-token
    count."""
    B, P, pl, page, Hkv, hd = k_pool.shape
    dev = qf.device
    idx = tables.clamp_min(0).long()                                 # [B, P, pl]
    bi = torch.arange(B, device=dev)[:, None, None]
    pi = torch.arange(P, device=dev)[None, :, None]
    k = k_pool[bi, pi, idx].reshape(B, P, pl * page, Hkv, hd)        # local gather
    v = v_pool[bi, pi, idx].reshape(B, P, pl * page, Hkv, hd)
    s = torch.einsum("bhgd,bpshd->bphgs", qf, k.float()) * scale

    pos = torch.arange(pl * page, device=dev)
    valid = pos[None, None] < local_ctx[..., None]                   # [B, P, S]
    valid = valid & (tables >= 0).repeat_interleave(page, dim=-1)
    valid = valid[:, :, None, None, :]
    s = torch.where(valid, s, NEG_INF)

    m = s.amax(-1)                                                   # [B, P, Hkv, G]
    p_ = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p_.sum(-1)
    acc = torch.einsum("bphgs,bpshd->bphgd", p_, v.float())
    return m, l, acc


# ---------------------------------------------------------------------------
# Pools as DTensors: B over the data axes and P over the partition axes
# (``sharding.serve_input_specs``).  Each rank works on its own shard of the
# pools (``to_local``) with its partitions' global indices, so no rank ever
# reads another's pages; the one cross-partition exchange is the merge's
# all-reduce (max, then sums) of [B, Hkv, G(, hd)] partials over the
# partition axes.  A [B, ...] tensor meets the pools in their batch
# placements (:func:`_leading`).  On plain tensors each helper is the
# identity: offset 0, every partition local, no all-reduce.
# ---------------------------------------------------------------------------

def _leading(pool, ndim: int) -> tuple:
    """The pool's placements for a tensor of its first ``ndim`` dims: a
    [B, ...] row tensor (``ndim`` 1) or the tables [B, P, pages_local]
    (``ndim`` 3)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(p if isinstance(p, Shard) and p.dim < ndim else Replicate()
                 for p in pool.placements)


def _local_as(x, pool, ndim: int = 1) -> torch.Tensor:
    """``x``'s local shard in the pool's placements for its first ``ndim``
    dims (a plain ``x`` counts as replicated); ``x`` itself beside a plain
    pool."""
    if not is_dtensor(pool):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh, want = pool.device_mesh, _leading(pool, ndim)
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    if tuple(x.placements) != tuple(want):
        x = x.redistribute(mesh, want)
    return x.to_local()


def _partition_offset(pool) -> int:
    """The global index of this rank's first partition (dim 1)."""
    if not is_dtensor(pool):
        return 0
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return compute_local_shape_and_global_offset(pool.shape, pool.device_mesh,
                                                 pool.placements)[1][1]


def _all_reduce(t: torch.Tensor, pool, op: str) -> torch.Tensor:
    """``t`` ([B_local, ...]) reduced by ``op`` over the pool's partition
    axes: a DTensor pending ``op`` there, redistributed to replicated."""
    if not is_dtensor(pool):
        return t
    from torch.distributed.tensor import DTensor, Partial, Shard

    mesh, rows = pool.device_mesh, _leading(pool, 1)
    pending = tuple(Partial(op) if isinstance(p, Shard) and p.dim == 1 else r
                    for p, r in zip(pool.placements, rows))
    return DTensor.from_local(t, mesh, pending, run_check=False).redistribute(
        mesh, rows).to_local()


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def paged_attention_global(
    q: torch.Tensor,          # [B, Hq, hd] (new token)
    k_pool: torch.Tensor,     # [B, P, pages_local, page, Hkv, hd]
    v_pool: torch.Tensor,
    tables: torch.Tensor,     # [B, P, pages_local] local slots (-1 = unmapped)
    ctx: torch.Tensor,        # [B] context length EXCLUDING the new token
    *,
    extra_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # new token K/V [B, Hkv, hd]
) -> torch.Tensor:
    """Merged attention output [B, Hq, hd], float32.  On DTensor pools
    each rank reads only its own partitions' pages and the output is a
    DTensor in the pools' batch placements."""
    B, P, pl, page, Hkv, hd = k_pool.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    scale = 1.0 / (hd ** 0.5)

    tables = _local_as(tables, k_pool, 3)
    q, ctx = _local_as(q, k_pool), _local_as(ctx, k_pool)
    if extra_kv is not None:                  # every rank takes part in placing its rows
        extra_kv = tuple(_local_as(t, k_pool) for t in extra_kv)
    kl, vl = _local(k_pool), _local(v_pool)
    Bl, Pl = kl.shape[:2]
    p0 = _partition_offset(k_pool)

    qf = q.float().reshape(Bl, Hkv, G, hd)
    local_ctx = local_ctx_all_partitions(ctx, P, page, p0, Pl)       # [B, Pl]
    m, l, acc = _partials(qf, kl, vl, tables, local_ctx, scale)

    # The hot tail joins after the last partition, on the ranks holding it.
    if extra_kv is not None and p0 + Pl == P:
        k1, v1 = extra_kv
        s1 = torch.einsum("bhgd,bhd->bhg", qf, k1.float()) * scale
        m = torch.cat([m, s1[:, None]], dim=1)
        l = torch.cat([l, torch.ones_like(s1)[:, None]], dim=1)
        acc1 = v1.float()[:, :, None, :].expand(Bl, Hkv, G, hd)
        acc = torch.cat([acc, acc1[:, None]], dim=1)

    # SPARTA merge: one reduction over the partition axis (each rank's
    # partitions, then the all-reduce over the partition axes).
    m_g = _all_reduce(m.amax(1), k_pool, "max")                      # [B, Hkv, G]
    alpha = torch.exp(m - m_g[:, None])
    l_g = _all_reduce((l * alpha).sum(1), k_pool, "sum")
    acc_g = _all_reduce((acc * alpha[..., None]).sum(1), k_pool, "sum")
    safe_l = torch.where(l_g > 0, l_g, 1.0)
    out = (acc_g / safe_l[..., None]).reshape(Bl, Hq, hd)
    if not is_dtensor(k_pool):
        return out
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(out, k_pool.device_mesh, _leading(k_pool, 1), run_check=False,
                              shape=(B, Hq, hd), stride=(Hq * hd, hd, 1))


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
    package.  A DTensor pool is written shard by shard: each rank writes the
    rows whose owning partition it holds into its own shard, and the others
    write back what their slot holds."""
    P = pool.shape[1]
    tables = _local_as(tables, pool, 3)
    new_kv, ctx = _local_as(new_kv, pool), _local_as(ctx, pool)
    local = _local(pool)                                             # shares the storage
    Bl, Pl = local.shape[:2]
    gpage = torch.div(ctx - 1, page, rounding_mode="floor")          # [B] logical page
    owner = (gpage % P).long()
    lpage = torch.div(gpage, P, rounding_mode="floor").long()
    here = owner - _partition_offset(pool)
    mine = (here >= 0) & (here < Pl)
    here = here.clamp(0, Pl - 1)
    b_idx = torch.arange(Bl, device=local.device)
    slot = tables[b_idx, here].gather(1, lpage[:, None])[:, 0].long().clamp_min(0)   # [B]
    off = ((ctx - 1) % page).long()
    row = new_kv.to(local.dtype)
    if Pl < P:
        row = torch.where(mine[:, None, None], row, local[b_idx, here, slot, off])
    local[b_idx, here, slot, off] = row
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
    # On a mesh the residual stream stays [B, 1, D] with B over the data
    # axes and D whole (``batch_only``: the row-sharded output projections'
    # pending sums reduced): a norm over a D-sharded stream would leave the
    # next projection's weights to be all-gathered.
    x = batch_only(x + attn.finish_decode_attention(lp.attn, merged, cfg))
    if skip_mlp:
        return x, k_pool, v_pool
    return batch_only(x + ffn_forward(lp, apply_norm(lp.ln2, x, cfg.norm), cfg)[0]), \
        k_pool, v_pool
