"""AdamW with a cosine schedule and global-norm clipping, the port of
``src/repro/train/optimizer.py``.

The parameters are an ``nn.Module``; the state is ``{"m": {name: float32},
"v": {name: float32}, "step": int32 0-d}`` keyed by the module's parameter
names.  The arithmetic is the JAX package's, operation for operation: no
float32 master copy (a bf16 parameter is updated in float32 and rounded
back), the clip scale cast to the gradient's dtype, the bias corrections in
float32 from the int32 step, weight decay on every parameter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a float32 tensor): linear warm-up,
    then a cosine decay to ``min_lr_ratio * lr``."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_state(params: nn.Module) -> Dict:
    """Zero float32 moments for every parameter, on its device, and step 0."""
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.named_parameters()}
    dev = next(iter(zeros.values())).device if zeros else torch.device("cpu")
    return {"m": zeros, "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the summed squares of every gradient, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """(gradients scaled to a global norm of at most ``max_norm``, the norm
    before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


@torch.no_grad()
def apply_updates(params: nn.Module, grads: Dict[str, torch.Tensor], state: Dict,
                  cfg: OptimizerConfig):
    """One AdamW step.  The parameters and the moments are written in
    place (call it only once every gradient exists); returns (params, new
    state, {"grad_norm", "lr"}), the metrics 0-d float32 tensors on the
    parameters' device."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    stepf = step.float()
    lr = schedule(cfg, stepf)
    b1, b2 = cfg.betas
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    for name, p in params.named_parameters():
        gf = grads[name].float()
        m, v = state["m"][name], state["v"][name]
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
