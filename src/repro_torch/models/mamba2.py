"""Mamba2 block (SSD), the port of ``src/repro/models/mamba2.py``: used
inside the Zamba2 hybrid.  Prefill runs the SSD scan (kernel K8); a T = 1
step with state runs :func:`mamba2_decode_step`."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import on_batch_and_heads, tp_product
from repro_torch.kernels.common import as_device
from repro_torch.kernels.mamba2_scan import mamba2_decode_step, mamba2_scan
from repro_torch.models.layers import Device, Norm, _normal, dense_init, param, rmsnorm


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim, ssm_state)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_headdim
    assert d_inner % P == 0
    return d_inner, d_inner // P, P, cfg.ssm_state


class Block(nn.Module):
    """``norm``, ``in_proj`` ([D, 2 d_inner + 2 N + H]), the depthwise conv
    ``conv_w`` [W, d_inner + 2 N] / ``conv_b``, ``dt_bias``, ``A_log``,
    ``D``, ``gate_norm`` and ``out_proj``, with the JAX dtypes."""

    def __init__(self, gen, cfg: ModelConfig, dtype, device: Device):
        super().__init__()
        D = cfg.d_model
        d_inner, H, P, N = dims(cfg)
        conv_dim = d_inner + 2 * N
        f32 = dict(dtype=torch.float32, device=device)
        self.norm = Norm(D, "rms", device)
        self.in_proj = param(dense_init(gen, D, 2 * d_inner + 2 * N + H, dtype, device))
        self.conv_w = param((_normal(gen, (cfg.ssm_conv_width, conv_dim), device) * 0.2)
                            .to(dtype))
        self.conv_b = param(torch.zeros(conv_dim, **f32))
        self.dt_bias = param(torch.zeros(H, **f32))
        self.A_log = param(torch.log(torch.linspace(1.0, 8.0, H, **f32)))
        self.D = param(torch.ones(H, **f32))
        self.gate_norm = param(torch.zeros(d_inner, **f32))
        self.out_proj = param(dense_init(gen, d_inner, D, dtype, device))


def _split_proj(u: torch.Tensor, cfg: ModelConfig):
    d_inner, H, P, N = dims(cfg)
    return torch.split(u, [d_inner, d_inner + 2 * N, H], dim=-1)   # z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  xBC [B, T, C]; w [W, C].

    Returns (activated output, new conv state = the last W-1 inputs, f32)."""
    W, T = w.shape[0], xBC.shape[1]
    if conv_state is None:
        pad = xBC.new_zeros((xBC.shape[0], W - 1, xBC.shape[2]))
    else:
        pad = conv_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], 1)                         # [B, T+W-1, C]
    out = xp[:, 0:T] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + T] * w[i]
    out = F.silu(out + b.to(out.dtype))
    return out, xp[:, -(W - 1):].float()


def block_forward(p: Block, x: torch.Tensor, cfg: ModelConfig, *,
                  kernel_mode: str = "auto", state: Optional[dict] = None):
    """x [B, T, D] -> (out [B, T, D], new state ``{"conv", "ssm"}``), a
    pre-norm residual block.  ``state`` (conv + ssm) enables T = 1 decode;
    None is prefill, through K8."""
    B, T, D = x.shape
    d_inner, H, P, N = dims(cfg)
    h = rmsnorm(x, p.norm.scale)
    z, xBC, dt_raw = _split_proj(tp_product(h, p.in_proj), cfg)
    conv_state = None if state is None else state["conv"]
    xBC, new_conv = _causal_conv(xBC, p.conv_w, p.conv_b, conv_state)
    xs, Bm, C = torch.split(xBC, [d_inner, N, N], dim=-1)
    xs = xs.reshape(B, T, H, P).transpose(1, 2)           # [B, H, T, P]
    dt = F.softplus(dt_raw.float() + p.dt_bias).transpose(1, 2)   # [B, H, T]
    A = -torch.exp(p.A_log)

    if T == 1 and state is not None:
        y, new_ssm = mamba2_decode_step(xs[:, :, 0], dt[:, :, 0], A, Bm[:, 0].float(),
                                        C[:, 0].float(), p.D, state["ssm"])
        y = y[:, :, None, :]
    else:
        y, new_ssm = on_batch_and_heads(
            lambda *a: mamba2_scan(*a, kernel_mode=kernel_mode),
            (xs, dt, A, Bm.float(), C.float(), p.D),
            ((0, 1), (0, 1), (None, 0), (0, None), (0, None), (None, 0)), ((0, 1), (0, 1)))
    y = y.transpose(1, 2).reshape(B, T, d_inner)
    y = y * F.silu(z.to(y.dtype))
    y = rmsnorm(y, p.gate_norm)
    out = x + tp_product(y.to(x.dtype), p.out_proj)
    return out, {"conv": new_conv, "ssm": new_ssm}


def init_block_state(cfg: ModelConfig, batch: int, *, device: Device = "cuda") -> dict:
    d_inner, H, P, N = dims(cfg)
    z = dict(dtype=torch.float32, device=as_device(device))
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_inner + 2 * N), **z),
        "ssm": torch.zeros((batch, H, N, P), **z),
    }
