"""Attention block: GQA + RoPE + optional qk-norm, the port of
``src/repro/models/attention.py`` (prefill and cross-attention through K5,
decode through K6)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    constrain_bthd, contiguous_stride, is_dtensor, replicate_dim, shard_heads, tp_product,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention_partial
from repro_torch.models.layers import Device, apply_rope, dense_init, param, rmsnorm


class Attention(nn.Module):
    """``wq``/``wk``/``wv``/``wo`` ([d_in, d_out]) and, with qk-norm,
    ``q_norm``/``k_norm`` (float32 zeros, the rmsnorm scale)."""

    def __init__(self, gen, cfg: ModelConfig, dtype=torch.float32, device: Device = "cuda"):
        super().__init__()
        self.wq = param(dense_init(gen, cfg.d_model, cfg.q_dim, dtype, device))
        self.wk = param(dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, device))
        self.wv = param(dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, device))
        self.wo = param(dense_init(gen, cfg.q_dim, cfg.d_model, dtype, device))
        if cfg.qk_norm:
            self.q_norm = param(torch.zeros(cfg.head_dim, dtype=torch.float32, device=device))
            self.k_norm = param(torch.zeros(cfg.head_dim, dtype=torch.float32, device=device))


def attention_params(gen, cfg: ModelConfig, dtype=torch.float32,
                     device: Device = "cuda") -> Attention:
    """The attention block's parameters, initialised from ``gen``."""
    return Attention(gen, cfg, dtype, device)


def _project_qkv(
    p: Attention, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, T, D] -> q [B, T, Hq, hd], k/v [B, T, Hkv, hd]; qk-norm before
    RoPE, then the activation constraint, as in the JAX package."""
    B, T, _ = x.shape
    q = shard_heads(replicate_dim(tp_product(x, p.wq), -1, cfg.num_heads).reshape(
        B, T, cfg.num_heads, cfg.head_dim))
    k = replicate_dim(tp_product(x, p.wk), -1, cfg.num_kv_heads).reshape(
        B, T, cfg.num_kv_heads, cfg.head_dim)
    v = replicate_dim(tp_product(x, p.wv), -1, cfg.num_kv_heads).reshape(
        B, T, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm)
        k = rmsnorm(k, p.k_norm)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain_bthd(q, cfg.num_heads)
    k = constrain_bthd(k, cfg.num_kv_heads)
    v = constrain_bthd(v, cfg.num_kv_heads)
    return q, k, v


def heads_first(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, hd] -> contiguous [B, H, T, hd], the kernels' layout."""
    return x.transpose(1, 2).contiguous()


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig, *,
           causal: bool, kernel_mode: str) -> torch.Tensor:
    """q [B, T, Hq, hd], k/v [B, S, Hkv, hd] -> flash attention -> [B, T, q_dim].
    DTensor inputs go through :func:`_attend_sharded`."""
    if is_dtensor(q):
        return _attend_sharded(q, k, v, cfg, causal=causal, kernel_mode=kernel_mode)
    B, T = q.shape[:2]
    o = flash_attention(heads_first(q), heads_first(k), heads_first(v), causal=causal,
                        kernel_mode=kernel_mode)                  # [B, Hq, T, hd]
    return o.transpose(1, 2).reshape(B, T, cfg.q_dim)


def _attend_sharded(q, k, v, cfg: ModelConfig, *, causal: bool, kernel_mode: str):
    """:func:`attend` on DTensors: each rank attends its own batch rows over
    its share of the query heads (:func:`shard_heads`: split over every
    mesh dim that does not shard the batch), reading the KV heads its query
    heads use; the heads are then gathered back.  DTensor's own rules
    replicate the heads (their [Hkv, G] grouping cannot be sharded unless
    each shard holds whole groups), so every rank would attend every head
    of its rows.  One rank holds every head and runs :func:`attend`'s ops."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    q = shard_heads(q)
    mesh, B, T, H, hd = q.device_mesh, *q.shape
    rows = [p == Shard(0) for p in q.placements]
    kv_pl = tuple(Shard(0) if r else Replicate() for r in rows)
    ql = q.to_local(grad_placements=q.placements)
    kl, vl = (t.redistribute(mesh, kv_pl).to_local(
        grad_placements=tuple(Shard(0) if r else Partial() for r in rows)) for t in (k, v))
    (_, _, nh, _), (_, _, h0, _) = compute_local_shape_and_global_offset(q.shape, mesh,
                                                                          q.placements)
    G = H // k.shape[2]
    if h0 % G == 0 and nh % G == 0:            # whole groups: the grouped call
        kh, vh = kl[:, :, h0 // G:(h0 + nh) // G], vl[:, :, h0 // G:(h0 + nh) // G]
    else:                                      # each query head with its own KV head
        idx = torch.arange(h0, h0 + nh, device=ql.device) // G
        kh, vh = kl.index_select(2, idx), vl.index_select(2, idx)
    if nh == 0:     # no head here: an empty output that still joins q, k and v to the graph,
        # so that every rank's backward pass makes the same collectives
        o = ql + (kh.sum() + vh.sum()).to(ql.dtype)
    else:
        o = flash_attention(heads_first(ql), heads_first(kh), heads_first(vh), causal=causal,
                            kernel_mode=kernel_mode).transpose(1, 2).contiguous()
    o = DTensor.from_local(o, mesh, q.placements, run_check=False, shape=q.shape,
                           stride=contiguous_stride(q.shape))
    return o.redistribute(mesh, kv_pl).reshape(B, T, cfg.q_dim)


def attention_forward(
    p: Attention,
    x: torch.Tensor,  # [B, T, D]
    cfg: ModelConfig,
    *,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cross-attn
    kernel_mode: str = "auto",
) -> torch.Tensor:
    """Full-sequence attention (training / prefill); with ``kv_override``
    the keys and values [B, S, Hkv, hd] come from there (cross-attention)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    if kv_override is not None:
        k, v = kv_override
    return tp_product(attend(q, k, v, cfg, causal=causal, kernel_mode=kernel_mode), p.wo)


def cross_kv(p: Attention, enc: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder K/V [B, S, Hkv, hd] for cross-attention (no RoPE, as in
    whisper's cross-attention)."""
    B, S, _ = enc.shape
    k = tp_product(enc, p.wk).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = tp_product(enc, p.wv).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return k, v


def attention_decode_paged(
    p: Attention,
    x: torch.Tensor,                # [B, 1, D] new token activations
    cfg: ModelConfig,
    k_pool: torch.Tensor,           # [slots, page, Hkv, hd] float32 (one partition's pool)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,      # [B, pages_local] int32 local slots
    ctx_len: torch.Tensor,          # [B] int32 total context (incl. the new token)
    *,
    kernel_mode: str = "auto",
):
    """One decode step against a SPARTA-paged KV pool partition through K6:
    the attention residuals (acc, m, l) for the cross-partition merge, and
    the new (k, v) row [B, Hkv, hd] for the owning partition to write."""
    q, k, v = _project_qkv(p, x, cfg, (ctx_len - 1)[:, None])
    acc, m, l = paged_attention_partial(q[:, 0], k_pool, v_pool, block_table, ctx_len,
                                        kernel_mode=kernel_mode)
    return acc, m, l, k[:, 0], v[:, 0]


def finish_decode_attention(p: Attention, merged: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """merged: [B, Hq, hd] -> output projection -> [B, 1, D]."""
    B = merged.shape[0]
    return merged.reshape(B, 1, cfg.q_dim).to(p.wo.dtype) @ p.wo
