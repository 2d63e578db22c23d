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
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
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
    the JAX package (the same values as a last-axis concatenate)."""
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
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    elif activation == "gelu_glu":
        h = F.gelu(x @ p.w_gate, approximate="tanh") * (x @ p.w_up)
    elif activation == "gelu":
        h = F.gelu(x @ p.w_up, approximate="tanh")
    else:
        raise ValueError(activation)
    return h @ p.w_down


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
