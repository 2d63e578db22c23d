"""Mixture-of-Experts FFN, the port of ``src/repro/models/moe.py``: top-k
token-choice routing with a capacity bound.

Dispatch is the sort-based "dropping" formulation: assignments are sorted by
expert (stably), ranked within expert (capacity C drops the overflow),
gathered into an [E, C, D] buffer, run through batched expert matmuls
(``torch.bmm``), and combined with the router weights.  Every expert's
weights are read at every call, whatever the routing.

The combine gathers each token's k contributions back into token order,
[tokens, k, D], and sums them, so its result does not depend on the order in
which the card's threads run (the JAX package scatter-adds).  The router and
its softmax run in float32; the expert products in the activations' dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Device, _normal, dense_init, param


class MoE(nn.Module):
    """``router`` float32 [D, E] and per-expert GLU weights stacked on the
    expert axis: ``w_gate`` / ``w_up`` [E, D, F], ``w_down`` [E, F, D]."""

    def __init__(self, gen: Optional[torch.Generator], cfg: ModelConfig, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        E, D, Fe = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert

        def stack_init(d_in: int, d_out: int) -> torch.Tensor:
            scale = (2.0 / (d_in + d_out)) ** 0.5        # dense_init's, per expert
            return (_normal(gen, (E, d_in, d_out), device) * scale).to(dtype)

        self.router = param(dense_init(gen, D, E, torch.float32, device))
        self.w_gate = param(stack_init(D, Fe))
        self.w_up = param(stack_init(D, Fe))
        self.w_down = param(stack_init(Fe, D))


def moe_params(gen, cfg: ModelConfig, dtype=torch.float32, device: Device = "cuda") -> MoE:
    """The MoE block's parameters, initialised from ``gen``."""
    return MoE(gen, cfg, dtype, device)


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    moe = cfg.moe
    c = int(tokens * moe.top_k * moe.capacity_factor / moe.num_experts)
    return max(8, c)


def _top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, equal values in
    order of their index (a stable descending sort; ``torch.topk`` does not
    say how it breaks ties)."""
    vals, ids = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def moe_forward(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, D] -> (out [B, T, D], aux load-balance loss, a float32
    scalar)."""
    moe = cfg.moe
    B, T, D = x.shape
    E, K = moe.num_experts, moe.top_k
    tokens = B * T
    C = _capacity(tokens, cfg)
    dev = x.device

    xf = x.reshape(tokens, D)
    gates = torch.softmax(xf.float() @ p.router, dim=-1)                   # [T, E]
    weights, ids = _top_k(gates, K)                                        # [T, K]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_ids = ids.reshape(-1)                                             # [T*K]
    tk = tokens * K

    # Aux load-balance loss (Switch-style): E * sum_e f_e * P_e.  The counts
    # are an integer scatter-add, exact in any order; ``torch.bincount``
    # would wait for the card to read its maximum.
    me = gates.mean(0)                                                     # [E]
    counts = torch.zeros(E, dtype=torch.int32, device=dev).scatter_add_(
        0, flat_ids, torch.ones(tk, dtype=torch.int32, device=dev))
    ce = counts.float() / tk
    aux = moe.router_aux_weight * E * torch.sum(me * ce)

    # Sort assignments by expert; rank within expert; drop rank >= C.
    sort = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[sort]
    pos = torch.arange(tk, device=dev)
    is_start = torch.ones(tk, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg_start = torch.cummax(torch.where(is_start, pos, 0), 0).values
    rank = pos - seg_start                                                 # rank within expert
    keep = rank < C
    slot = sorted_ids * C + torch.clamp_max(rank, C - 1)                   # [T*K]

    token_of = sort // K                                                   # source token
    # Dispatch: [E*C, D] buffer; dropped assignments go to one spare row past
    # the end, never read (the JAX package's mode="drop").
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    buf[torch.where(keep, slot, E * C)] = xf[token_of]
    h = buf[:E * C].view(E, C, D)

    # Expert GLU FFN, batched over experts.
    if cfg.activation == "gelu_glu":
        hg = F.gelu(torch.bmm(h, p.w_gate.to(x.dtype)), approximate="tanh")
    else:
        hg = F.silu(torch.bmm(h, p.w_gate.to(x.dtype)))
    hu = torch.bmm(h, p.w_up.to(x.dtype))
    ho = torch.bmm(hg * hu, p.w_down.to(x.dtype)).reshape(E * C, D)

    # Combine: each assignment's weighted output, back in token order.
    w_flat = weights.reshape(-1)[sort]                                     # sorted order
    contrib = ho[torch.clamp_max(slot, E * C - 1)] * \
        torch.where(keep, w_flat, 0.0)[:, None].to(x.dtype)
    unsort = torch.empty_like(sort)
    unsort[sort] = pos
    out = contrib[unsort].view(tokens, K, D).sum(1)
    return out.reshape(B, T, D), aux
