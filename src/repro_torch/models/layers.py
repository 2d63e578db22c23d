"""Common model building blocks, the port of ``src/repro/models/layers.py``.

Functions over parameter modules; the parameters keep the JAX package's
names and its ``x @ w`` layout ([d_in, d_out]).  The initialisers take a
``torch.Generator`` (on the device they allocate on); on the ``meta`` device
they allocate nothing.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import contiguous_stride, is_dtensor, tp_product

Device = Union[str, torch.device]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


def param(x: torch.Tensor) -> nn.Parameter:
    """An inference parameter (no gradient)."""
    return nn.Parameter(x, requires_grad=False)


def _needs_grad(args) -> bool:
    return any(a.requires_grad for a in args if isinstance(a, torch.Tensor)) or any(
        p.requires_grad for a in args if isinstance(a, nn.Module) for p in a.parameters())


def remat_call(fn: Callable, *args, remat: bool):
    """``fn(*args)``; when ``remat`` is true, grad mode is on and a tensor
    or module among ``args`` requires a gradient, under
    ``torch.utils.checkpoint`` (non-reentrant), the counterpart of the JAX
    package's ``jax.checkpoint``: the block keeps only its inputs for the
    backward pass and recomputes the rest.  Otherwise (serving frozen
    weights, or under ``torch.no_grad()``) it is a plain call."""
    if remat and torch.is_grad_enabled() and _needs_grad(args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# -- initialisers -----------------------------------------------------------

def generator(device: torch.device, seed: int) -> Optional[torch.Generator]:
    """A ``torch.Generator`` seeded with ``seed`` on ``device`` (None on
    ``meta``, where nothing is drawn)."""
    if device.type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _normal(gen: Optional[torch.Generator], shape, device: Device) -> torch.Tensor:
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)


def dense_init(gen, d_in: int, d_out: int, dtype=torch.float32, device: Device = "cuda"):
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return (_normal(gen, (d_in, d_out), device) * scale).to(dtype)


def embed_init(gen, vocab: int, d: int, dtype=torch.float32, device: Device = "cuda"):
    return (_normal(gen, (vocab, d), device) * 0.02).to(dtype)


# -- norms ------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Under autograd through :class:`_RMSNorm`, which keeps x and the
    per-row scale for the backward pass, not the float32 intermediates
    autograd would keep.  A DTensor whose last dim is whole is normed on
    each rank's rows (:func:`_on_local_rows`)."""
    grad = torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad)
    norm = (lambda t, sc: _RMSNorm.apply(t, sc, eps)) if grad else \
        (lambda t, sc: _rmsnorm(t, sc, eps))
    if is_dtensor(x):
        y = _on_local_rows(norm, x, (scale,), free=tuple(range(x.ndim - 1)))
        if y is not None:
            return y
        return _rmsnorm(x, scale, eps)
    return norm(x, scale)


def _on_local_rows(fn, x, params=(), positions=None, *, free):
    """``fn`` on each rank's shard of the DTensor ``x`` (and each of
    ``params``, replicated, with its share of their gradients, and
    ``positions``' rows), the result placed as ``x``; None where ``x`` is
    sharded on a dim outside ``free`` or holds a pending sum.  For ops that
    act on each row of the last dim alone (a norm, a rotary embedding):
    DTensor's rules may replicate such an op's operands over every mesh dim
    (torch 2.11: the rotary embedding's ``stack`` on heads sharded over
    ``model`` became the whole [B, T, H, hd] on every rank)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    pl = tuple(x.placements)
    if any(p.is_partial() or (isinstance(p, Shard) and p.dim % x.ndim not in free) for p in pl):
        return None
    if any(is_dtensor(q) and not all(isinstance(p, Replicate) for p in q.placements)
           for q in params):
        return None
    args = [x.to_local(grad_placements=pl)]
    for q in params:
        args.append(q.to_local(grad_placements=tuple(
            Partial() if isinstance(p, Shard) else Replicate() for p in pl))
            if is_dtensor(q) else q)
    if positions is not None:                 # a DTensor [B, T], or a plain [1, T]
        if is_dtensor(positions):
            positions = positions.redistribute(x.device_mesh, tuple(
                Shard(0) if p == Shard(0) else Replicate() for p in pl)).to_local()
        args.append(positions)
    return DTensor.from_local(fn(*args), x.device_mesh, pl, run_check=False, shape=x.shape,
                              stride=contiguous_stride(x.shape))


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """:func:`_rmsnorm`'s values; the backward pass recomputes x̂ = x r
    (r = rsqrt(mean(x²) + eps)) and forms dx = r (g - x̂ mean(g x̂)) with
    g = dy (1 + scale), dscale = Σ dy x̂, in float32."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        xf = x.float()
        r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, scale, r)
        return ((xf * r) * (1.0 + scale.float())).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale, r = ctx.saved_tensors
        xhat = x * r                           # float32 (r is): no float32 copy of x
        dscale = (dy * xhat).reshape(-1, x.shape[-1]).sum(0)
        g = dy * (1.0 + scale.float())
        # In place on the two buffers made here, the rows' dot products by
        # a batched product: two row-sized float32 buffers at most.
        dot = torch.einsum("...d,...d->...", g, xhat)[..., None] / x.shape[-1]
        dx = g.sub_(xhat.mul_(dot)).mul_(r)
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """A DTensor whose last dim is whole is normed on each rank's rows
    (:func:`_on_local_rows`)."""
    if is_dtensor(x):
        y = _on_local_rows(lambda t, sc, b: layernorm(t, sc, b, eps), x, (scale, bias),
                           free=tuple(range(x.ndim - 1)))
        if y is not None:
            return y
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class Norm(nn.Module):
    """``{"scale"}`` (rms, zeros: the scale multiplies by ``1 + scale``) or
    ``{"scale", "bias"}`` (ln, ones and zeros); float32 like the JAX params."""

    def __init__(self, d: int, kind: str, device: Device = "cuda"):
        super().__init__()
        if kind == "rms":
            self.scale = param(torch.zeros(d, dtype=torch.float32, device=device))
        else:
            self.scale = param(torch.ones(d, dtype=torch.float32, device=device))
            self.bias = param(torch.zeros(d, dtype=torch.float32, device=device))


def apply_norm(p: Norm, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "rms":
        return rmsnorm(x, p.scale)
    return layernorm(x, p.scale, p.bias)


# -- rotary embeddings ------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device: Device = "cpu") -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., T, H, D]; positions: broadcastable to [..., T].  The split-half
    rotation, the two halves joined by ``stack(..., dim=-2).reshape`` as in
    the JAX package (the same values as a last-axis concatenate).  A
    DTensor x sharded on its batch and heads only rotates each rank's shard
    (:func:`_on_local_rows`)."""
    if is_dtensor(x):
        y = _on_local_rows(lambda t, pos: apply_rope(t, pos, theta), x, positions=positions,
                           free=(0, x.ndim - 2))
        if y is not None:
            return y
    freqs = rope_freqs(x.shape[-1], theta, x.device)                 # [D/2]
    angles = positions[..., None].float() * freqs                    # [..., T, D/2]
    cos = torch.cos(angles)[..., None, :]                            # [..., T, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    # dim counted from the front: DTensor 2.11 shifts a shard wrongly for dim=-2
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=x.ndim - 1)
    return out.reshape(x.shape).to(x.dtype)


# -- MLP --------------------------------------------------------------------

class MLP(nn.Module):
    """``w_gate``/``w_up``/``w_down`` for the GLU activations, ``w_up``/
    ``w_down`` for plain GELU."""

    def __init__(self, gen, d: int, f: int, activation: str, dtype=torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        if activation.endswith("_glu"):
            self.w_gate = param(dense_init(gen, d, f, dtype, device))
        self.w_up = param(dense_init(gen, d, f, dtype, device))
        self.w_down = param(dense_init(gen, f, d, dtype, device))


def mlp_forward(p: MLP, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu_glu":
        h = F.silu(tp_product(x, p.w_gate)) * tp_product(x, p.w_up)
    elif activation == "gelu_glu":
        h = F.gelu(tp_product(x, p.w_gate), approximate="tanh") * tp_product(x, p.w_up)
    elif activation == "gelu":
        h = F.gelu(tp_product(x, p.w_up), approximate="tanh")
    else:
        raise ValueError(activation)
    return tp_product(h, p.w_down)


# -- losses -----------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy; logits [..., V] upcast to float32."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
