"""Decoder-only transformer (dense + MoE): the port of
``src/repro/models/transformer.py`` for stablelm-12b, qwen3-14b,
starcoder2-7b, gemma-7b, qwen3-moe-30b-a3b, dbrx-132b and the LM backbone of
internvl2-2b.

The parameters live in an ``nn.Module`` tree that keeps the JAX names
(``embed``, ``layers[i].ln1/attn/ln2`` and ``mlp`` or, with ``cfg.moe``,
``moe``, ``final_norm``, ``lm_head``) and the ``x @ w`` layout; the JAX
package stacks the layers on a leading [L] axis and scans them, the port
loops over an ``nn.ModuleList``.  ``_block`` constrains its activations where
the JAX package's does (:func:`repro_torch.distributed.sharding.constrain_btd`:
a redistribute of DTensor activations under an activation policy, else the
identity); decode here is single-device (one SPARTA partition; the
partition-explicit layout is :mod:`repro_torch.models.paged_global`).

Entry points:
* :func:`forward` / :func:`forward_hidden` — full-sequence logits / the
  final hidden states with the unembedding matrix.
* :func:`prefill_with_kv`  — prefill (attention through K5) that also emits
  page-layout KV.
* :func:`decode_block` / :func:`decode_step` — single-token decode against a
  SPARTA-paged KV pool (attention through K6 plus the hot tail).  The pools
  are updated in place (the JAX package returns new ones).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    batch_only, constrain_btd, gather_rows, tp_product,
)
from repro_torch.kernels.common import as_device
from repro_torch.kernels.paged_attention import merge_partials, paged_attention_partial
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    MLP, Device, Norm, apply_norm, dense_init, dtype_of, embed_init, generator, mlp_forward,
    param, remat_call,
)


class Layer(nn.Module):
    def __init__(self, gen, cfg: ModelConfig, dtype, device: Device):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.attn = attn.attention_params(gen, cfg, dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        if cfg.moe is not None:
            self.moe = moe_lib.moe_params(gen, cfg, dtype, device)
        else:
            self.mlp = MLP(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype, device)


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator], device: Device):
        super().__init__()
        dtype = dtype_of(cfg.dtype)
        self.embed = param(embed_init(gen, cfg.vocab, cfg.d_model, dtype, device))
        self.layers = nn.ModuleList(Layer(gen, cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm, device)
        if not cfg.tie_embeddings:
            self.lm_head = param(dense_init(gen, cfg.d_model, cfg.vocab, dtype, device))


def init(cfg: ModelConfig, *, seed: int = 0, device: Device = "cuda") -> Transformer:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (on ``meta`` nothing is allocated)."""
    dev = as_device(device)
    return Transformer(cfg, generator(dev, seed), dev)


def ffn_forward(lp: Layer, h: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's MLP or MoE block: (output, aux loss; None without MoE)."""
    if cfg.moe is not None:
        return moe_lib.moe_forward(lp.moe, h, cfg)
    return mlp_forward(lp.mlp, h, cfg.activation), None


def _block(cfg: ModelConfig, kernel_mode: str, x: torch.Tensor, lp: Layer):
    h = apply_norm(lp.ln1, x, cfg.norm)
    # The raw block outputs (pre-residual) are constrained, as in the JAX
    # package (its perf iteration 2).
    o = constrain_btd(attn.attention_forward(lp.attn, h, cfg, causal=True,
                                             kernel_mode=kernel_mode))
    # On a mesh the residual stream keeps its batch over the data axes and D
    # whole (``batch_only``: the row-sharded output projections leave
    # partial sums, which the norm would carry into the next product and
    # reduce there, over its wider output).
    x = constrain_btd(batch_only(x + o))
    y, aux = ffn_forward(lp, apply_norm(lp.ln2, x, cfg.norm), cfg)
    return constrain_btd(batch_only(x + constrain_btd(y))), aux


def embed_tokens(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = gather_rows(params.embed, tokens.long())
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def backbone(params: Transformer, x: torch.Tensor, cfg: ModelConfig, *,
             kernel_mode: str = "auto", remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer stack over embeddings [B, T, D]: (hidden [B, T, D], summed
    aux loss, a float32 scalar; 0 without MoE).  ``remat``: each layer is
    recomputed in the backward pass (:func:`layers.remat_call`)."""
    auxs = []
    for lp in params.layers:
        x, aux = remat_call(_block, cfg, kernel_mode, x, lp, remat=remat)
        if aux is not None:
            auxs.append(aux)
    if not auxs:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return x, torch.stack(auxs).sum()


def head_matrix(params: Transformer, cfg: ModelConfig) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def unembed(params: Transformer, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return tp_product(apply_norm(params.final_norm, x, cfg.norm), head_matrix(params, cfg))


def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, *,
            kernel_mode: str = "auto", remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B, T, V], summed MoE aux loss; 0 for the dense
    family)."""
    x, aux = backbone(params, embed_tokens(params, cfg, tokens), cfg, kernel_mode=kernel_mode,
                      remat=remat)
    return unembed(params, cfg, x), aux


def forward_hidden(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, *,
                   kernel_mode: str = "auto", remat: bool = True):
    """(final-normed hidden [B, T, D], unembedding matrix [D, V], aux loss)."""
    x, aux = backbone(params, embed_tokens(params, cfg, tokens), cfg, kernel_mode=kernel_mode,
                      remat=remat)
    return apply_norm(params.final_norm, x, cfg.norm), head_matrix(params, cfg), aux


# ---------------------------------------------------------------------------
# Prefill: forward + paged-layout KV emission.
# ---------------------------------------------------------------------------

def prefill_with_kv(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, *,
                    kernel_mode: str = "auto"):
    """Prefill producing last-position logits [B, 1, V] and per-layer KV in
    page layout [L, B, n_pages, page, Hkv, hd] (zero-padded past T), which
    the serving engine scatters into its pools through the block tables."""
    B, T = tokens.shape
    page = cfg.kv_page_size
    n_pages = -(-T // page)
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(T, device=x.device)[None, :]
    ks, vs = [], []
    for lp in params.layers:
        h = apply_norm(lp.ln1, x, cfg.norm)
        q, k, v = attn._project_qkv(lp.attn, h, cfg, positions)
        x = x + attn.attend(q, k, v, cfg, causal=True, kernel_mode=kernel_mode) @ lp.attn.wo
        x = x + ffn_forward(lp, apply_norm(lp.ln2, x, cfg.norm), cfg)[0]
        ks.append(k)
        vs.append(v)
    logits = unembed(params, cfg, x[:, -1:, :])

    def pages(kv):  # [L, B, T, Hkv, hd] -> [L, B, n_pages, page, Hkv, hd]
        kv = F.pad(torch.stack(kv), (0, 0, 0, 0, 0, n_pages * page - T))
        return kv.reshape(len(kv), B, n_pages, page, cfg.num_kv_heads, cfg.head_dim)

    return logits, pages(ks), pages(vs)


# ---------------------------------------------------------------------------
# Paged decode.
# ---------------------------------------------------------------------------

def local_ctx_from_global(ctx: torch.Tensor, partition: int, num_partitions: int,
                          page: int) -> torch.Tensor:
    """Valid token count within one partition's packed local pages: logical
    page l lives on partition l % P at local index l // P; local pages are
    packed (all full except possibly the partition holding the globally-last
    partial page)."""
    n_pages = -(-ctx // page)
    n_here = torch.where(n_pages > partition,
                         torch.div(n_pages - partition - 1, num_partitions,
                                   rounding_mode="floor") + 1, 0)
    last_owner = (n_pages - 1) % num_partitions
    tail = ctx - (n_pages - 1) * page
    return torch.where((n_here > 0) & (last_owner == partition),
                       (n_here - 1) * page + tail, n_here * page).to(torch.int32)


def decode_block(
    lp: Layer,
    x: torch.Tensor,           # [B, 1, D]
    cfg: ModelConfig,
    k_pool: torch.Tensor,      # [slots, page, Hkv, hd] float32, updated in place
    v_pool: torch.Tensor,
    table: torch.Tensor,       # [B, pages] int32 slots
    ctx_len: torch.Tensor,     # [B] int32 context length incl. the new token
    *,
    kernel_mode: str = "auto",
    skip_mlp: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One transformer layer of paged decode on one partition (P = 1).
    ``skip_mlp`` returns after the attention residual (the enc-dec decoder
    splices cross-attention between self-attention and the MLP), so ``lp``
    needs only ``ln1`` and ``attn`` then."""
    page = cfg.kv_page_size
    h = apply_norm(lp.ln1, x, cfg.norm)
    q_all, k_all, v_all = attn._project_qkv(lp.attn, h, cfg, (ctx_len - 1)[:, None])
    q1, k_new, v_new = q_all[:, 0], k_all[:, 0], v_all[:, 0]   # [B, H, hd]

    # Attend over the pool as it stands BEFORE this token (hence ctx - 1).
    local_ctx = local_ctx_from_global(ctx_len - 1, 0, 1, page)
    acc, m, l = paged_attention_partial(q1, k_pool, v_pool, table, local_ctx,
                                        kernel_mode=kernel_mode)

    # Write the new token's KV into the pool (in place).
    cur_page = ((ctx_len - 1) // page).long()
    slot = table.gather(1, cur_page[:, None])[:, 0].long()
    off = ((ctx_len - 1) % page).long()
    safe_slot = torch.where(slot >= 0, slot, 0)
    k_pool[safe_slot, off] = k_new.to(k_pool.dtype)
    v_pool[safe_slot, off] = v_new.to(v_pool.dtype)

    # The new token joins as one more partial (the "hot tail"): the kernel
    # read the pool before the write.
    hd, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    G = Hq // Hkv
    qf = q1.reshape(-1, Hkv, G, hd).float()
    s_tail = torch.einsum("bhgd,bhd->bhg", qf, k_new.float()) / (hd ** 0.5)
    tail_m = s_tail.reshape(-1, Hq)
    tail_l = torch.ones_like(tail_m)
    tail_acc = v_new.float().repeat_interleave(G, dim=1)        # [B, Hq, hd]
    merged = merge_partials(torch.stack([acc, tail_acc]), torch.stack([m, tail_m]),
                            torch.stack([l, tail_l]))           # [B, Hq, hd]
    x = x + attn.finish_decode_attention(lp.attn, merged, cfg)
    if skip_mlp:
        return x, k_pool, v_pool
    return x + ffn_forward(lp, apply_norm(lp.ln2, x, cfg.norm), cfg)[0], k_pool, v_pool


def decode_step(
    params: Transformer,
    tokens: torch.Tensor,      # [B] newest token ids
    cfg: ModelConfig,
    k_pools: torch.Tensor,     # [L, slots, page, Hkv, hd] float32, updated in place
    v_pools: torch.Tensor,
    table: torch.Tensor,       # [B, pages] int32
    ctx_len: torch.Tensor,     # [B] int32 ctx incl. the new token
    *,
    kernel_mode: str = "auto",
):
    """Single-token decode over the layer stack; returns (logits [B, V],
    pools)."""
    x = embed_tokens(params, cfg, tokens[:, None])
    for i, lp in enumerate(params.layers):
        x, _, _ = decode_block(lp, x, cfg, k_pools[i], v_pools[i], table, ctx_len,
                               kernel_mode=kernel_mode)
    return unembed(params, cfg, x)[:, 0], k_pools, v_pools
