"""Zamba2-style hybrid, the port of ``src/repro/models/zamba2.py``: a Mamba2
backbone plus ONE shared attention block.

The config's layers are ``hybrid_period``-sized groups of Mamba2 blocks with
the shared attention + MLP block applied after each group (one weight set
for every application, as in Zamba2; the published model's per-application
LoRA deltas are left out, as in the JAX package).  zamba2-7b: 81 Mamba2
blocks in 27 groups of 3, 27 shared-attention applications.

Prefill: the Mamba2 blocks run the SSD scan (K8), the shared attention the
flash attention kernel (K5).  Decode: the Mamba2 state is O(1), and each
shared-attention application keeps its own SPARTA-paged KV pool, read by
the paged attention kernel (K6) plus the newest token's hot tail
(:func:`repro_torch.models.transformer.decode_block`, one partition).  The
pools are updated in place (the JAX package returns new ones).

Parameters keep the JAX names: ``embed``, ``mamba[g][j]`` (the JAX package
stacks them [G, per]), ``shared_attn.{ln1, attn, ln2, mlp}``,
``final_norm``, ``lm_head``.  The Mamba2 decode state keeps the stacked
layout ``{"conv": [G, per, B, W-1, C], "ssm": [G, per, B, H, N, P]}``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import gather_rows
from repro_torch.kernels.common import as_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    Device, Norm, apply_norm, dense_init, dtype_of, embed_init, generator, mlp_forward, param,
    remat_call,
)


def group_dims(cfg: ModelConfig) -> Tuple[int, int]:
    period = max(cfg.hybrid_period, 1)
    assert cfg.num_layers % period == 0, (cfg.num_layers, period)
    return cfg.num_layers // period, period  # (groups, mamba per group)


class Zamba2(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator], device: Device):
        super().__init__()
        dtype = dtype_of(cfg.dtype)
        G, per = group_dims(cfg)
        self.embed = param(embed_init(gen, cfg.vocab, cfg.d_model, dtype, device))
        self.mamba = nn.ModuleList(
            nn.ModuleList(mamba2.Block(gen, cfg, dtype, device) for _ in range(per))
            for _ in range(G))
        self.shared_attn = tfm.Layer(gen, cfg, dtype, device)
        self.final_norm = Norm(cfg.d_model, cfg.norm, device)
        self.lm_head = param(dense_init(gen, cfg.d_model, cfg.vocab, dtype, device))


def init(cfg: ModelConfig, *, seed: int = 0, device: Device = "cuda") -> Zamba2:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (on ``meta`` nothing is allocated)."""
    dev = as_device(device)
    return Zamba2(cfg, generator(dev, seed), dev)


def _shared_attn_forward(sp: tfm.Layer, x: torch.Tensor, cfg: ModelConfig,
                         kernel_mode: str) -> torch.Tensor:
    h = apply_norm(sp.ln1, x, cfg.norm)
    x = x + attn.attention_forward(sp.attn, h, cfg, causal=True, kernel_mode=kernel_mode)
    h = apply_norm(sp.ln2, x, cfg.norm)
    return x + mlp_forward(sp.mlp, h, cfg.activation)


def _group(group: nn.ModuleList, sp: tfm.Layer, x: torch.Tensor, cfg: ModelConfig,
           kernel_mode: str) -> torch.Tensor:
    """One group: its ``per`` Mamba2 blocks, then the shared attention."""
    for mp in group:
        x, _ = mamba2.block_forward(mp, x, cfg, kernel_mode=kernel_mode)
    return _shared_attn_forward(sp, x, cfg, kernel_mode)


def forward_hidden(params: Zamba2, tokens: torch.Tensor, cfg: ModelConfig, *,
                   kernel_mode: str = "auto", remat: bool = True):
    """(final-normed hidden [B, T, D], lm_head [D, V], aux loss 0).
    ``remat``: each group is recomputed in the backward pass, as the JAX
    package checkpoints its group scan body."""
    x = gather_rows(params.embed, tokens.long())
    for group in params.mamba:
        x = remat_call(_group, group, params.shared_attn, x, cfg, kernel_mode, remat=remat)
    x = apply_norm(params.final_norm, x, cfg.norm)
    return x, params.lm_head, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params: Zamba2, tokens: torch.Tensor, cfg: ModelConfig, *,
            kernel_mode: str = "auto", remat: bool = True):
    """(logits [B, T, V], aux loss 0)."""
    x, head, aux = forward_hidden(params, tokens, cfg, kernel_mode=kernel_mode, remat=remat)
    return x @ head, aux


def init_decode_state(cfg: ModelConfig, batch: int, *, device: Device = "cuda") -> dict:
    """Zero Mamba2 states stacked [G, per, ...]."""
    G, per = group_dims(cfg)
    one = mamba2.init_block_state(cfg, batch, device=device)
    return {k: v.expand((G, per) + v.shape).clone() for k, v in one.items()}


def decode_step(
    params: Zamba2,
    tokens: torch.Tensor,       # [B]
    cfg: ModelConfig,
    mamba_state: dict,          # {"conv", "ssm"} with leading [G, per]
    k_pools: torch.Tensor,      # [G, slots, page, Hkv, hd] float32, updated in place
    v_pools: torch.Tensor,
    table: torch.Tensor,        # [B, pages] int32
    ctx_len: torch.Tensor,      # [B] int32 context incl. the new token
    *,
    kernel_mode: str = "auto",
):
    """One token: G x (per Mamba2 steps + one paged shared attention).
    Returns (logits [B, V], new Mamba2 state, k_pools, v_pools)."""
    x = params.embed[tokens.long()][:, None, :]
    conv, ssm = [], []
    for g, group in enumerate(params.mamba):
        for j, mp in enumerate(group):
            st = {"conv": mamba_state["conv"][g, j], "ssm": mamba_state["ssm"][g, j]}
            x, new = mamba2.block_forward(mp, x, cfg, kernel_mode=kernel_mode, state=st)
            conv.append(new["conv"])
            ssm.append(new["ssm"])
        x, _, _ = tfm.decode_block(params.shared_attn, x, cfg, k_pools[g], v_pools[g],
                                   table, ctx_len, kernel_mode=kernel_mode)
    x = apply_norm(params.final_norm, x, cfg.norm)
    logits = (x @ params.lm_head)[:, 0]
    G, per = group_dims(cfg)
    new_state = {"conv": torch.stack(conv).unflatten(0, (G, per)),
                 "ssm": torch.stack(ssm).unflatten(0, (G, per))}
    return logits, new_state, k_pools, v_pools
