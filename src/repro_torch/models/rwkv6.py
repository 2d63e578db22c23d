"""RWKV6 "Finch", the port of ``src/repro/models/rwkv6.py``: an
attention-free LM with data-dependent per-channel decay.

RWKV6 has no KV cache, so SPARTA's paged KV serving does not apply; decode
carries O(1) recurrent state.  A block is time-mix (the RWKV6 scan, kernel
K7, at prefill; :func:`rwkv6_decode_step` at T = 1 with state) plus
channel-mix, both with token shift.  The decay LoRA follows the paper:
w = exp(-exp(w_base + tanh(x A) B)).

The parameters live in an ``nn.Module`` tree with the JAX names (``embed``,
``layers[i].ln1/ln2/tm/cm``, ``final_norm``, ``lm_head``) and the ``x @ w``
layout; the JAX package stacks the layers on a leading [L] axis and scans
them, the port loops over an ``nn.ModuleList``.  The decode state keeps the
JAX package's stacked layout: ``tm_shift`` and ``cm_shift`` [L, B, D] and
``wkv`` [L, B, H, N, N], all float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    aligned, batch_only, gather_rows, on_batch_and_heads, tp_product,
)
from repro_torch.kernels.common import as_device
from repro_torch.kernels.rwkv6_scan import rwkv6_decode_step, rwkv6_scan
from repro_torch.models.layers import (
    Device, Norm, apply_norm, dense_init, dtype_of, embed_init, generator, param, remat_call,
)

LORA_RANK = 64


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    n = cfg.ssm_headdim  # head size (64)
    assert cfg.d_model % n == 0
    return cfg.d_model // n, n


def _full(shape, value: float, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.float32, device=device)


class TimeMix(nn.Module):
    def __init__(self, gen, cfg: ModelConfig, dtype, device: Device):
        super().__init__()
        D = cfg.d_model
        H, N = _heads(cfg)
        self.mu = param(_full((5, D), 0.5, device))        # r, k, v, w, g shifts
        self.wr = param(dense_init(gen, D, D, dtype, device))
        self.wk = param(dense_init(gen, D, D, dtype, device))
        self.wv = param(dense_init(gen, D, D, dtype, device))
        self.wg = param(dense_init(gen, D, D, dtype, device))
        self.w_base = param(_full((D,), -1.0, device))
        self.w_lora_a = param(dense_init(gen, D, LORA_RANK, dtype, device))
        self.w_lora_b = param(dense_init(gen, LORA_RANK, D, torch.float32, device) * 0.1)
        self.u = param(_full((H, N), 0.0, device))
        self.head_norm = param(_full((D,), 0.0, device))
        self.wo = param(dense_init(gen, D, D, dtype, device))


class ChannelMix(nn.Module):
    def __init__(self, gen, cfg: ModelConfig, dtype, device: Device):
        super().__init__()
        D, Fd = cfg.d_model, cfg.d_ff
        self.mu = param(_full((2, D), 0.5, device))        # k, r shifts
        self.wk = param(dense_init(gen, D, Fd, dtype, device))
        self.wv = param(dense_init(gen, Fd, D, dtype, device))
        self.wr = param(dense_init(gen, D, D, dtype, device))


class Layer(nn.Module):
    def __init__(self, gen, cfg: ModelConfig, dtype, device: Device):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self.tm = TimeMix(gen, cfg, dtype, device)
        self.cm = ChannelMix(gen, cfg, dtype, device)


class RWKV6(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator], device: Device):
        super().__init__()
        dtype = dtype_of(cfg.dtype)
        self.embed = param(embed_init(gen, cfg.vocab, cfg.d_model, dtype, device))
        self.layers = nn.ModuleList(Layer(gen, cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm, device)
        self.lm_head = param(dense_init(gen, cfg.d_model, cfg.vocab, dtype, device))


def init(cfg: ModelConfig, *, seed: int = 0, device: Device = "cuda") -> RWKV6:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (on ``meta`` nothing is allocated)."""
    dev = as_device(device)
    return RWKV6(cfg, generator(dev, seed), dev)


def _shift(x: torch.Tensor, last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token shift: previous token's activation (zeros / carry at t=0)."""
    if last is None:
        return F.pad(x[:, :-1], (0, 0, 1, 0))
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1]], 1)


def _decay(tm: TimeMix, xw: torch.Tensor) -> torch.Tensor:
    lora = tp_product(torch.tanh(tp_product(xw, tm.w_lora_a)).float(), tm.w_lora_b)
    return torch.exp(-torch.exp(tm.w_base + lora))  # (0, 1), per channel


def _heads_first(y: torch.Tensor, H: int, N: int) -> torch.Tensor:
    """[B, T, H * N] -> [B, H, T, N]."""
    B, T, _ = y.shape
    return y.reshape(B, T, H, N).transpose(1, 2)


def _time_mix(tm: TimeMix, x: torch.Tensor, cfg: ModelConfig, kernel_mode: str,
              shift_state=None, wkv_state=None):
    B, T, D = x.shape
    H, N = _heads(cfg)
    xs = _shift(x, shift_state)
    mu = tm.mu.to(x.dtype)
    xr, xk, xv, xw, xg = (x + mu[i] * (xs - x) for i in range(5))
    r = _heads_first(tp_product(xr, tm.wr), H, N)
    k = _heads_first(tp_product(xk, tm.wk), H, N)
    v = _heads_first(tp_product(xv, tm.wv), H, N)
    w = _heads_first(_decay(tm, xw), H, N)
    g = F.silu(tp_product(xg, tm.wg))
    if T == 1 and wkv_state is not None:
        o, new_state = rwkv6_decode_step(r[:, :, 0], k[:, :, 0], v[:, :, 0], w[:, :, 0],
                                         tm.u, wkv_state)
        o = o[:, :, None, :]
    else:
        o, new_state = on_batch_and_heads(
            lambda *a: rwkv6_scan(*a, kernel_mode=kernel_mode), (r, k, v, w.float(), tm.u),
            ((0, 1),) * 4 + ((None, 0),), ((0, 1), (0, 1)))
    # Per-head normalisation (GroupNorm in the reference implementation).
    o = o.transpose(1, 2)                                         # [B, T, H, N]
    o = o * torch.rsqrt((o.float() ** 2).mean(-1, keepdim=True) + 1e-6)
    o = (o.reshape(B, T, D) * (1.0 + tm.head_norm)).to(x.dtype)
    out = tp_product(o * g.to(o.dtype), tm.wo).to(x.dtype)
    return out, x[:, -1, :].float(), new_state


def _channel_mix(cm: ChannelMix, x: torch.Tensor, shift_state=None):
    xs = _shift(x, shift_state)
    mu = cm.mu.to(x.dtype)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    k = torch.square(torch.relu(tp_product(xk, cm.wk)))
    out = (torch.sigmoid(tp_product(xr, cm.wr)) * tp_product(k, cm.wv)).to(x.dtype)
    return out, x[:, -1, :].float()


def _block(lp: Layer, x: torch.Tensor, cfg: ModelConfig, kernel_mode: str) -> torch.Tensor:
    # On a mesh the residual stream keeps its batch over the data axes and D
    # whole (``batch_only``: the channel mix's value projection shards D over
    # ``model``, and a norm over a sharded D leaves a pending mean that
    # DTensor cannot take a gradient back into), as in the decode step.
    h, _, _ = _time_mix(lp.tm, apply_norm(lp.ln1, x, cfg.norm), cfg, kernel_mode)
    x = batch_only(x + h)
    h, _ = _channel_mix(lp.cm, apply_norm(lp.ln2, x, cfg.norm))
    return batch_only(x + h)


def forward_hidden(params: RWKV6, tokens: torch.Tensor, cfg: ModelConfig, *,
                   kernel_mode: str = "auto", remat: bool = True):
    """(final-normed hidden [B, T, D], lm_head [D, V], aux loss 0).
    ``remat``: each layer is recomputed in the backward pass."""
    x = gather_rows(params.embed, tokens.long())
    for lp in params.layers:
        x = remat_call(_block, lp, x, cfg, kernel_mode, remat=remat)
    x = apply_norm(params.final_norm, x, cfg.norm)
    return x, params.lm_head, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params: RWKV6, tokens: torch.Tensor, cfg: ModelConfig, *,
            kernel_mode: str = "auto", remat: bool = True):
    """(logits [B, T, V], aux loss 0)."""
    x, head, aux = forward_hidden(params, tokens, cfg, kernel_mode=kernel_mode, remat=remat)
    return x @ head, aux


def init_decode_state(cfg: ModelConfig, batch: int, *, device: Device = "cuda") -> dict:
    H, N = _heads(cfg)
    L, D = cfg.num_layers, cfg.d_model
    dev = as_device(device)
    z = dict(dtype=torch.float32, device=dev)
    return {
        "tm_shift": torch.zeros((L, batch, D), **z),
        "cm_shift": torch.zeros((L, batch, D), **z),
        "wkv": torch.zeros((L, batch, H, N, N), **z),
    }


def decode_step(params: RWKV6, tokens: torch.Tensor, cfg: ModelConfig, state: dict, *,
                kernel_mode: str = "auto"):
    """O(1) per-token decode (the state's size does not grow with the
    context).  Returns (logits [B, V], new state)."""
    x = gather_rows(params.embed, tokens.long())[:, None, :]
    tm_s, cm_s, wkv_s = [], [], []
    for i, lp in enumerate(params.layers):
        h, tm_new, wkv_new = _time_mix(
            lp.tm, apply_norm(lp.ln1, x, cfg.norm), cfg, kernel_mode,
            shift_state=state["tm_shift"][i], wkv_state=state["wkv"][i])
        x = batch_only(x + h)
        h, cm_new = _channel_mix(lp.cm, apply_norm(lp.ln2, x, cfg.norm),
                                 shift_state=state["cm_shift"][i])
        x = batch_only(x + h)
        # On a mesh each layer's new state takes its input's placements
        # (a stack of mixed pending sums and means has no rule).
        tm_s.append(aligned(tm_new, state["tm_shift"][i]))
        cm_s.append(aligned(cm_new, state["cm_shift"][i]))
        wkv_s.append(aligned(wkv_new, state["wkv"][i]))
    x = apply_norm(params.final_norm, x, cfg.norm)
    logits = (x @ params.lm_head)[:, 0]
    return logits, {"tm_shift": torch.stack(tm_s), "cm_shift": torch.stack(cm_s),
                    "wkv": torch.stack(wkv_s)}
