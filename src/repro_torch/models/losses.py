"""Chunked (vocab-safe) cross-entropy, the port of
``src/repro/models/losses.py``.

Materialising [B, T, V] logits is out of reach at production shapes
(internvl2-2b's 92,608-word vocabulary over 2,048 tokens is 760 MB a
sequence in float32).  The loss therefore walks sequence blocks: each block
computes its [B, block, V] float32 logits, reduces them to per-token NLL and
drops them, and when the inputs require a gradient the block body is
recomputed in the backward pass (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``),
so one block's logits are alive at a time.

On a mesh each block stays sharded B over the data axes and V over
``model``, as in the JAX package: the product runs on each rank's shards
(:class:`repro_torch.distributed.sharding.VocabShards`) and only [B, block]
rows cross ranks — the max, the sum of exponentials and the gold logit,
each reduced over the vocabulary's mesh dims.  Plain tensors take the same
formula with identities for the collectives.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import VocabShards


def _block_nll(h: torch.Tensor, head: torch.Tensor, y: torch.Tensor,
               shards: VocabShards) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed NLL, count of valid labels) of one block's rank-local rows,
    both float32."""
    logits = (h @ head).float()                    # [B, blk, V] ([B/data, blk, V/model])
    m = shards.max_vocab(logits.amax(-1))          # the shift carries no gradient
    logz = torch.log(shards.sum_vocab(torch.exp(logits - m[..., None]).sum(-1))) + m
    gold = shards.sum_vocab(shards.gold(logits, y))
    valid = (y >= 0).float()
    return ((logz - gold) * valid).sum(), valid.sum()


def chunked_cross_entropy(
    hidden: torch.Tensor,   # [B, T, D] final (normed) hidden states
    head: torch.Tensor,     # [D, V]
    labels: torch.Tensor,   # [B, T] targets aligned with hidden positions; -1 is ignored
    *,
    block: int = 512,
) -> torch.Tensor:
    """Mean NLL over the valid (non-negative) labels, a float32 scalar (on
    a mesh a replicated DTensor)."""
    shards = VocabShards(hidden, head)
    hidden, head, labels = shards.hidden, shards.head, shards.rows(labels)
    B, T, D = hidden.shape
    block = min(block, T)
    nb = -(-T // block)
    pad = nb * block - T
    if pad:   # appended by concatenation, as on DTensors (torch 2.11's pad rule breaks them)
        hidden = torch.cat([hidden, torch.zeros_like(hidden[:, :pad])], dim=1)
        labels = torch.cat([labels, torch.full_like(labels[:, :pad], -1)], dim=1)
    remat = torch.is_grad_enabled() and (hidden.requires_grad or head.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nb):
        h, y = hidden[:, i * block:(i + 1) * block], labels[:, i * block:(i + 1) * block]
        if remat:
            nll, valid = checkpoint(_block_nll, h, head, y, shards, use_reentrant=False)
        else:
            nll, valid = _block_nll(h, head, y, shards)
        total = total + nll
        count = count + valid
    return shards.replicated(shards.sum_batch(total) /
                             torch.clamp(shards.sum_batch(count), min=1.0))
