"""Whisper-style encoder-decoder, the port of ``src/repro/models/whisper.py``
(audio backbone; the conv frontend is a stub).

``frames`` are precomputed frame embeddings [B, S_enc, D] (the conv1d + GELU
frontend's output); the encoder adds sinusoidal positions and runs
bidirectional attention (K5, non-causal).  The decoder is causal with
cross-attention; decode reads SPARTA-paged self-attention KV through K6
(:func:`repro_torch.models.transformer.decode_block`, one partition) and the
cross-attention KV, computed once from the encoder output, through K5 with
one query row.

Parameters keep the JAX names: ``embed`` (tied to the output), ``dec_pos``,
``enc_layers[i].{ln1, attn, ln2, mlp}``, ``enc_norm``,
``dec_layers[i].{ln1, self_attn, ln_x, cross_attn, ln2, mlp}``, ``dec_norm``
(the JAX package stacks the layers on a leading [L] axis).  ``remat``
recomputes each encoder and decoder layer in the backward pass, as the JAX
package checkpoints its layer scan bodies.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import gather_rows
from repro_torch.kernels.common import as_device
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    MLP, Device, Norm, _normal, apply_norm, dtype_of, embed_init, generator, mlp_forward, param,
    remat_call,
)

MAX_DECODER_POS = 65_536  # learned positions (decodes up to 32k)


def sinusoid_positions(length: int, d: int, device: Device = "cpu") -> torch.Tensor:
    """[length, d] float32: sines of every position over the first half of
    the columns, cosines over the second."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10_000.0, 2.0 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


class EncLayer(nn.Module):
    def __init__(self, gen, cfg: ModelConfig, dtype, device: Device):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.attn = attn.attention_params(gen, cfg, dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self.mlp = MLP(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype, device)


class DecLayer(nn.Module):
    def __init__(self, gen, cfg: ModelConfig, dtype, device: Device):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.self_attn = attn.attention_params(gen, cfg, dtype, device)
        self.ln_x = Norm(cfg.d_model, cfg.norm, device)
        self.cross_attn = attn.attention_params(gen, cfg, dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self.mlp = MLP(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype, device)


class Whisper(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator], device: Device):
        super().__init__()
        dtype = dtype_of(cfg.dtype)
        self.embed = param(embed_init(gen, cfg.vocab, cfg.d_model, dtype, device))
        self.dec_pos = param((_normal(gen, (MAX_DECODER_POS, cfg.d_model), device) * 0.01)
                             .to(dtype))
        self.enc_layers = nn.ModuleList(EncLayer(gen, cfg, dtype, device)
                                        for _ in range(cfg.encoder_layers))
        self.enc_norm = Norm(cfg.d_model, cfg.norm, device)
        self.dec_layers = nn.ModuleList(DecLayer(gen, cfg, dtype, device)
                                        for _ in range(cfg.num_layers))
        self.dec_norm = Norm(cfg.d_model, cfg.norm, device)


def init(cfg: ModelConfig, *, seed: int = 0, device: Device = "cuda") -> Whisper:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (on ``meta`` nothing is allocated)."""
    dev = as_device(device)
    return Whisper(cfg, generator(dev, seed), dev)


def encode(params: Whisper, frames: torch.Tensor, cfg: ModelConfig, *,
           kernel_mode: str = "auto", remat: bool = True) -> torch.Tensor:
    """frames: the stub frontend's output [B, S, D] -> encoder output."""
    S = frames.shape[1]
    x = frames + sinusoid_positions(S, cfg.d_model, frames.device).to(frames.dtype)[None]
    for lp in params.enc_layers:
        x = remat_call(_enc_block, lp, x, cfg, kernel_mode, remat=remat)
    return apply_norm(params.enc_norm, x, cfg.norm)


def _enc_block(lp: EncLayer, x: torch.Tensor, cfg: ModelConfig,
               kernel_mode: str) -> torch.Tensor:
    h = apply_norm(lp.ln1, x, cfg.norm)
    x = x + attn.attention_forward(lp.attn, h, cfg, causal=False, kernel_mode=kernel_mode)
    h = apply_norm(lp.ln2, x, cfg.norm)
    return x + mlp_forward(lp.mlp, h, cfg.activation)


def _dec_block(lp: DecLayer, x: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig,
               kernel_mode: str) -> torch.Tensor:
    h = apply_norm(lp.ln1, x, cfg.norm)
    x = x + attn.attention_forward(lp.self_attn, h, cfg, causal=True, kernel_mode=kernel_mode)
    h = apply_norm(lp.ln_x, x, cfg.norm)
    kv = attn.cross_kv(lp.cross_attn, enc_out, cfg)
    x = x + attn.attention_forward(lp.cross_attn, h, cfg, causal=False, kv_override=kv,
                                   kernel_mode=kernel_mode)
    h = apply_norm(lp.ln2, x, cfg.norm)
    return x + mlp_forward(lp.mlp, h, cfg.activation)


def _decoder_hidden(params: Whisper, enc_out: torch.Tensor, tokens: torch.Tensor,
                    cfg: ModelConfig, kernel_mode: str, remat: bool) -> torch.Tensor:
    """The decoder stack over ``tokens`` [B, T], final-normed [B, T, D]."""
    T = tokens.shape[1]
    x = gather_rows(params.embed, tokens.long()) + params.dec_pos[:T][None]
    for lp in params.dec_layers:
        x = remat_call(_dec_block, lp, x, enc_out, cfg, kernel_mode, remat=remat)
    return apply_norm(params.dec_norm, x, cfg.norm)


def decode_train(params: Whisper, enc_out: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig, *, kernel_mode: str = "auto",
                 remat: bool = True) -> torch.Tensor:
    """Teacher-forced decoder logits [B, T, V] (the head is ``embed.T``)."""
    return _decoder_hidden(params, enc_out, tokens, cfg, kernel_mode, remat) @ params.embed.T


def forward(params: Whisper, batch: dict, cfg: ModelConfig, *, kernel_mode: str = "auto",
            remat: bool = True):
    """batch: {frames [B, S, D], tokens [B, T]} -> (logits, aux loss 0)."""
    enc = encode(params, batch["frames"], cfg, kernel_mode=kernel_mode, remat=remat)
    logits = decode_train(params, enc, batch["tokens"], cfg, kernel_mode=kernel_mode,
                          remat=remat)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def forward_hidden(params: Whisper, batch: dict, cfg: ModelConfig, *,
                   kernel_mode: str = "auto", remat: bool = True):
    """(final-normed decoder hidden [B, T, D], ``embed.T`` [D, V], aux 0)."""
    enc = encode(params, batch["frames"], cfg, kernel_mode=kernel_mode, remat=remat)
    x = _decoder_hidden(params, enc, batch["tokens"], cfg, kernel_mode, remat)
    return x, params.embed.T, torch.zeros((), dtype=torch.float32, device=x.device)


def precompute_cross_kv(params: Whisper, enc_out: torch.Tensor, cfg: ModelConfig):
    """Per-layer cross-attention KV, computed once per request at prefill:
    (k, v), each [L, B, S, Hkv, hd]."""
    kvs = [attn.cross_kv(lp.cross_attn, enc_out, cfg) for lp in params.dec_layers]
    return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])


def self_attention_block(lp: DecLayer) -> SimpleNamespace:
    """A decoder layer's self-attention as the ``ln1`` / ``attn`` pair that
    the paged decode blocks take (with ``skip_mlp=True``)."""
    return SimpleNamespace(ln1=lp.ln1, attn=lp.self_attn)


def cross_attention_and_mlp(lp: DecLayer, x: torch.Tensor, cfg: ModelConfig,
                            cross_k: torch.Tensor, cross_v: torch.Tensor, *,
                            kernel_mode: str) -> torch.Tensor:
    """The decode step's rest of a layer after self-attention: one query row
    [B, 1, D] against the cross KV [B, S, Hkv, hd] (K5, non-causal), then
    the MLP."""
    B = x.shape[0]
    h = apply_norm(lp.ln_x, x, cfg.norm)
    q = (h @ lp.cross_attn.wq).reshape(B, 1, cfg.num_heads, cfg.head_dim)
    o = attn.attend(q, cross_k, cross_v, cfg, causal=False, kernel_mode=kernel_mode)
    x = x + o @ lp.cross_attn.wo
    h = apply_norm(lp.ln2, x, cfg.norm)
    return x + mlp_forward(lp.mlp, h, cfg.activation)


def decode_step(
    params: Whisper,
    tokens: torch.Tensor,       # [B]
    cfg: ModelConfig,
    k_pools: torch.Tensor,      # [L, slots, page, Hkv, hd] float32 paged self-attn KV
    v_pools: torch.Tensor,
    cross_k: torch.Tensor,      # [L, B, S_enc, Hkv, hd] cross KV
    cross_v: torch.Tensor,
    table: torch.Tensor,        # [B, pages] int32
    ctx_len: torch.Tensor,      # [B] int32 context incl. the new token
    *,
    kernel_mode: str = "auto",
):
    """One token: paged self-attention (K6 + the hot tail), cross-attention
    (K5) and the MLP per layer.  Returns (logits [B, V], k_pools, v_pools);
    the pools are updated in place."""
    pos = (ctx_len - 1).long()
    x = params.embed[tokens.long()][:, None, :] + params.dec_pos[pos][:, None, :]
    for i, lp in enumerate(params.dec_layers):
        x, _, _ = tfm.decode_block(self_attention_block(lp), x, cfg, k_pools[i], v_pools[i],
                                   table, ctx_len, kernel_mode=kernel_mode, skip_mlp=True)
        x = cross_attention_and_mlp(lp, x, cfg, cross_k[i], cross_v[i],
                                    kernel_mode=kernel_mode)
    x = apply_norm(params.dec_norm, x, cfg.norm)
    return (x @ params.embed.T)[:, 0], k_pools, v_pools
