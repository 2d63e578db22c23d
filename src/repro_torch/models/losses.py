"""Chunked (vocab-safe) cross-entropy, the port of
``src/repro/models/losses.py``.

Materialising [B, T, V] logits is out of reach at production shapes
(internvl2-2b's 92,608-word vocabulary over 2,048 tokens is 760 MB a
sequence in float32).  The loss therefore walks sequence blocks: each block
computes its [B, block, V] float32 logits, reduces them to per-token NLL and
drops them, and when the inputs require a gradient the block body is
recomputed in the backward pass (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``),
so one block's logits are alive at a time.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import aligned


def _block_nll(h: torch.Tensor, head: torch.Tensor,
               y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed NLL, count of valid labels) of one block, both float32."""
    logits = (h @ head).float()                                   # [B, blk, V]
    logz = torch.logsumexp(logits, dim=-1)
    gold = aligned(logits, y).gather(-1, y.clamp(min=0).long()[..., None])[..., 0]
    valid = (y >= 0).float()
    return ((logz - gold) * valid).sum(), valid.sum()


def chunked_cross_entropy(
    hidden: torch.Tensor,   # [B, T, D] final (normed) hidden states
    head: torch.Tensor,     # [D, V]
    labels: torch.Tensor,   # [B, T] targets aligned with hidden positions; -1 is ignored
    *,
    block: int = 512,
) -> torch.Tensor:
    """Mean NLL over the valid (non-negative) labels, a float32 scalar."""
    B, T, D = hidden.shape
    block = min(block, T)
    nb = -(-T // block)
    pad = nb * block - T
    if pad:   # appended by concatenation: DTensor's pad rule (torch 2.11) breaks the layout
        hidden = torch.cat([hidden, torch.zeros_like(hidden[:, :pad])], dim=1)
        labels = torch.cat([labels, torch.full_like(labels[:, :pad], -1)], dim=1)
    remat = torch.is_grad_enabled() and (hidden.requires_grad or head.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nb):
        h, y = hidden[:, i * block:(i + 1) * block], labels[:, i * block:(i + 1) * block]
        if remat:
            nll, valid = checkpoint(_block_nll, h, head, y, use_reentrant=False)
        else:
            nll, valid = _block_nll(h, head, y)
        total = total + nll
        count = count + valid
    return total / torch.clamp(count, min=1.0)
