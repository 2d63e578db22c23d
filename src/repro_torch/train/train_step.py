"""Step factories, the port of ``src/repro/train/train_step.py``.

Only :func:`make_prefill_step` is ported.  ``make_loss_fn`` and
``make_train_step`` (with the optimizer, gradient accumulation and gradient
compression) wait for ROADMAP.md, section 1, item 9.6.
"""
from __future__ import annotations

from typing import Callable

from repro_torch import models
from repro_torch.configs.base import ModelConfig


def make_prefill_step(cfg: ModelConfig, *, kernel_mode: str = "auto") -> Callable:
    """Inference prefill: ``step(params, batch) -> next-token logits [B, V]``
    of a prompt batch (``batch["tokens"]`` [B, T]) through the family's
    ``forward``.  ``auto`` runs the kernels for data on the card (the JAX
    package defaults to ``reference`` here, its dry-run choice)."""
    def step(params, batch):
        logits, _ = models.forward(params, batch, cfg, kernel_mode=kernel_mode)
        return logits[:, -1]
    return step
