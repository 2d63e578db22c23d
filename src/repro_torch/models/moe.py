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
from repro_torch.distributed.sharding import contiguous_stride, is_dtensor, tp_product, whole
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


class _Shards:
    """Where a rank's share of the work lies: tokens ``t0 .. t0 + Tl - 1`` of
    the flattened batch and experts ``e0 .. e0 + El - 1``, all of both for
    plain tensors.  On a mesh the tokens keep their batch shard over the
    axes that shard them (the token axes) and the experts theirs over the
    axes that shard the expert weights' leading dim (the expert axes); each
    method below is the identity on plain tensors."""

    def __init__(self, xf: torch.Tensor, w: torch.Tensor, E: int, C: int):
        self.mesh = xf.device_mesh if is_dtensor(xf) else None
        self.t0, self.Tl, self.e0, self.El, self.E = 0, xf.shape[0], 0, E, E
        if self.mesh is None:
            return
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        mesh, D = self.mesh, xf.shape[1]
        wp = w.placements if is_dtensor(w) else (Replicate(),) * mesh.ndim
        ex = [isinstance(q, Shard) and q.dim == 0 for q in wp]
        tk = [isinstance(q, Shard) and q.dim == 0 and not e for q, e in zip(xf.placements, ex)]

        def pl(tok, exp, other=Replicate()):
            return tuple(tok if t else exp if e else other for t, e in zip(tk, ex))

        self.tokens_pl = pl(Shard(0), Replicate())       # [T, ...]: rows over the token axes
        self.tokens_grad = pl(Shard(0), Partial())       # each expert rank's share of their grad
        self.dispatch_pl = pl(Partial(), Shard(0))       # [E, C, D]: my tokens' rows of my experts
        self.experts_pl = pl(Shard(1), Shard(0))         # the expert products' layout
        self.rows_pl = pl(Replicate(), Shard(0))         # [E, C, D]: my experts, every slot
        self.rows_grad = pl(Partial(), Shard(0))
        self.out_pl = pl(Shard(0), Partial())            # [T, D]: my experts' share of my tokens
        T = xf.shape[0]
        (self.Tl, _), (self.t0, _) = compute_local_shape_and_global_offset((T, D), mesh,
                                                                           self.tokens_pl)
        (self.El, _, _), (self.e0, _, _) = compute_local_shape_and_global_offset(
            (E, C, D), mesh, self.rows_pl)

    def tokens(self, t: torch.Tensor) -> torch.Tensor:
        """A [T, ...] tensor's rows of this rank's tokens, plain."""
        if self.mesh is None:
            return t
        if tuple(t.placements) != self.tokens_pl:
            t = t.redistribute(self.mesh, self.tokens_pl)
        return t.to_local(grad_placements=self.tokens_grad)

    def slot_row(self, s: torch.Tensor, C: int) -> torch.Tensor:
        """The row of slot ``s`` (= e C + c of this rank's experts) in the
        [El * C, D] rows of :meth:`dispatched` and :meth:`expert_rows`: s
        itself, or on a mesh slot-major c El + e, so that the exchanges over
        the token axes split and join the slots' dim, the leading one, and
        need no concatenation."""
        return s if self.mesh is None else (s % C) * self.El + s // C

    def dispatched(self, rows: torch.Tensor, C: int) -> torch.Tensor:
        """[El * C, D] rows of this rank's tokens for its experts (in
        :meth:`slot_row` order) -> the [E, C, D] dispatch buffer: on a mesh
        the token axes' rows summed, each rank keeping its share of the
        slots (a reduce-scatter over the token axes)."""
        D = rows.shape[-1]
        if self.mesh is None:
            return rows.view(self.El, C, D)
        from torch.distributed.tensor import DTensor

        shape = (C, self.E, D)
        h = DTensor.from_local(rows.view(C, self.El, D), self.mesh, _slot_major(self.dispatch_pl),
                               run_check=False, shape=shape, stride=contiguous_stride(shape))
        return h.redistribute(self.mesh, _slot_major(self.experts_pl)).transpose(0, 1).contiguous()

    def expert_rows(self, ho: torch.Tensor) -> torch.Tensor:
        """[E, C, D] expert outputs -> this rank's experts' rows, plain and
        every slot (an all-gather over the token axes on a mesh), as
        [El * C, D] in :meth:`slot_row` order."""
        if self.mesh is None:
            return ho.reshape(-1, ho.shape[-1])
        hot = ho.transpose(0, 1)
        if tuple(hot.placements) != _slot_major(self.rows_pl):
            hot = hot.redistribute(self.mesh, _slot_major(self.rows_pl))
        rows = hot.to_local(grad_placements=_slot_major(self.rows_grad))
        return rows.reshape(-1, rows.shape[-1])

    def combined(self, out: torch.Tensor, shape) -> torch.Tensor:
        """[Tl, D] this rank's experts' share of its tokens' outputs -> the
        output in the tokens' layout (summed over the expert axes)."""
        if self.mesh is None:
            return out
        from torch.distributed.tensor import DTensor

        out = DTensor.from_local(out, self.mesh, self.out_pl, run_check=False, shape=shape,
                                 stride=contiguous_stride(shape))
        return out.redistribute(self.mesh, self.tokens_pl)


def _slot_major(placements) -> tuple:
    """[E, C, D] placements as those of its [C, E, D] transpose."""
    from torch.distributed.tensor import Shard

    return tuple(Shard(1 - p.dim) if isinstance(p, Shard) and p.dim in (0, 1) else p
                 for p in placements)


class _Combine(torch.autograd.Function):
    """Each token's k gathered rows [T, k, D] summed with their weights
    [T, k]: ``(rows * w[..., None]).sum(1)``.  The backward pass forms the
    weights' gradient as one [k, D] x [D] product a token, where autograd
    would keep a weighted [T, k, D] copy and make two more."""

    @staticmethod
    def forward(ctx, rows, w):
        ctx.save_for_backward(rows, w)
        return (rows * w[..., None]).sum(1)

    @staticmethod
    def backward(ctx, g):
        rows, w = ctx.saved_tensors
        return g[:, None, :] * w[..., None], torch.bmm(rows, g[..., None])[..., 0]


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
    sh = _Shards(xf, p.w_gate, E, C)
    if sh.mesh is not None and tuple(xf.placements) != sh.tokens_pl:
        xf = xf.redistribute(sh.mesh, sh.tokens_pl)
    gates = torch.softmax(tp_product(xf.float(), p.router), dim=-1)        # [T, E]
    weights, ids = _top_k(gates, K)                                        # [T, K]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)

    # The routing's bookkeeping is integer work on the [tokens * K] ids, the
    # same on every rank of a mesh: there the ids are replicated and it runs
    # on the whole plain tensor (DTensor has no rule for writing a plain
    # tensor in place from a DTensor).
    flat_ids = whole(ids).reshape(-1)                                      # [T*K]
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
    # Each of this rank's tokens' k assignments, in token order: its sorted
    # position, its slot (within this rank's experts) and whether it is kept.
    unsort = torch.empty_like(sort)
    unsort[sort] = pos
    mine = unsort[sh.t0 * K:(sh.t0 + sh.Tl) * K]
    s, kept = slot[mine], keep[mine]
    if sh.El < E:                                   # this rank holds some of the experts
        s = s - sh.e0 * C
        kept = kept & (s >= 0) & (s < sh.El * C)
        s = s.clamp(0, sh.El * C - 1)

    # Dispatch: the [El*C, D] buffer filled from this rank's tokens (kept
    # slots are distinct; the others go to one spare row past the end, never
    # read: the JAX package's mode="drop").  On a mesh the token axes' rows
    # are then summed.
    s = sh.slot_row(s, C)
    buf = torch.zeros((sh.El * C + 1, D), dtype=x.dtype, device=dev)
    buf[torch.where(kept, s, sh.El * C).view(sh.Tl, K)] = sh.tokens(xf)[:, None]
    h = sh.dispatched(buf[:sh.El * C], C)
    del buf                                         # the experts' inputs are h now

    # Expert GLU FFN, batched over experts.
    if cfg.activation == "gelu_glu":
        hg = F.gelu(torch.bmm(h, p.w_gate.to(x.dtype)), approximate="tanh")
    else:
        hg = F.silu(torch.bmm(h, p.w_gate.to(x.dtype)))
    hu = torch.bmm(h, p.w_up.to(x.dtype))
    ho = sh.expert_rows(torch.bmm(hg * hu, p.w_down.to(x.dtype)))

    # Combine: each assignment's weighted output (zero where not kept),
    # summed over each token's k.
    w = torch.where(kept, sh.tokens(weights).reshape(-1), 0.0)
    gathered = ho[s].view(sh.Tl, K, D)
    del ho                                          # every slot of the gathered rows
    out = sh.combined(_Combine.apply(gathered, w.view(sh.Tl, K).to(x.dtype)), (tokens, D))
    return out.reshape(B, T, D), aux
