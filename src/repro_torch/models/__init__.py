"""Model zoo, the port of ``src/repro/models/__init__.py``: family dispatch
for init and forward.

Ported families: ``dense`` (:mod:`repro_torch.models.transformer`), ``ssm``
(:mod:`repro_torch.models.rwkv6`) and ``hybrid``
(:mod:`repro_torch.models.zamba2`); every other family raises
``NotImplementedError`` naming its roadmap item.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

_NOT_PORTED = {
    "moe": "ROADMAP.md, section 1, item 9.2 (moe.py)",
    "encdec": "ROADMAP.md, section 1, item 9.5 (whisper.py)",
    "vlm": "ROADMAP.md, section 1, item 9.5 (vlm.py)",
}


def get_family_module(cfg: ModelConfig):
    if cfg.family == "dense":
        from repro_torch.models import transformer
        return transformer
    if cfg.family == "ssm":
        from repro_torch.models import rwkv6
        return rwkv6
    if cfg.family == "hybrid":
        from repro_torch.models import zamba2
        return zamba2
    where = _NOT_PORTED.get(cfg.family, "no roadmap item")
    raise NotImplementedError(f"model family {cfg.family!r} ({cfg.name}) is not ported "
                              f"yet: {where}")


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    return get_family_module(cfg).init(cfg, seed=seed, device=device)


def forward(params, batch: dict, cfg: ModelConfig, **kw):
    """batch: a dict with ``tokens`` [B, T] (every ported family takes
    tokens); returns (logits, aux)."""
    return get_family_module(cfg).forward(params, batch["tokens"], cfg, **kw)


def forward_hidden(params, batch: dict, cfg: ModelConfig, **kw):
    """(final-normed hidden, unembedding matrix, aux)."""
    return get_family_module(cfg).forward_hidden(params, batch["tokens"], cfg, **kw)
