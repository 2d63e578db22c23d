"""Model zoo, the port of ``src/repro/models/__init__.py``: family dispatch
for init, forward and the loss.

Families: ``dense`` and ``moe`` (:mod:`repro_torch.models.transformer`),
``ssm`` (:mod:`repro_torch.models.rwkv6`), ``hybrid``
(:mod:`repro_torch.models.zamba2`), ``encdec``
(:mod:`repro_torch.models.whisper`) and ``vlm``
(:mod:`repro_torch.models.vlm`).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

# Families whose forward takes the token ids alone; the others take the batch.
_TOKENS_ONLY = ("dense", "moe", "ssm", "hybrid")


def get_family_module(cfg: ModelConfig):
    from repro_torch.models import rwkv6, transformer, vlm, whisper, zamba2
    families = {"dense": transformer, "moe": transformer, "ssm": rwkv6, "hybrid": zamba2,
                "encdec": whisper, "vlm": vlm}
    if cfg.family not in families:
        raise ValueError(f"unknown model family {cfg.family!r} ({cfg.name}); "
                         f"expected one of {tuple(families)}")
    return families[cfg.family]


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    return get_family_module(cfg).init(cfg, seed=seed, device=device)


def forward(params, batch: dict, cfg: ModelConfig, **kw):
    """batch: a dict with the family's inputs (``tokens`` [B, T]; with
    ``patch_embeds`` for vlm, ``frames`` for encdec); returns (logits,
    aux)."""
    mod = get_family_module(cfg)
    if cfg.family in _TOKENS_ONLY:
        return mod.forward(params, batch["tokens"], cfg, **kw)
    return mod.forward(params, batch, cfg, **kw)


def forward_hidden(params, batch: dict, cfg: ModelConfig, **kw):
    """(final-normed hidden, unembedding matrix, aux)."""
    mod = get_family_module(cfg)
    if cfg.family in _TOKENS_ONLY:
        return mod.forward_hidden(params, batch["tokens"], cfg, **kw)
    return mod.forward_hidden(params, batch, cfg, **kw)


def loss_fn(params, batch: dict, cfg: ModelConfig, *, ce_block: int = 512,
            **kw) -> torch.Tensor:
    """Next-token loss through the vocab-safe chunked cross-entropy, plus
    the aux loss: the targets are ``batch["labels"]`` if the batch has them,
    else its ``tokens``, shifted by one."""
    from repro_torch.models.losses import chunked_cross_entropy

    hidden, head, aux = forward_hidden(params, batch, cfg, **kw)
    labels = batch["labels"] if "labels" in batch else batch["tokens"]
    return chunked_cross_entropy(hidden[:, :-1], head, labels[:, 1:], block=ce_block) + aux
