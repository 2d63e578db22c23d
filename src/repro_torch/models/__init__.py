"""Model zoo, the port of ``src/repro/models/__init__.py``: family dispatch.

Only the dense family is ported (the decoder-only transformer of
:mod:`repro_torch.models.transformer`); every other family raises
``NotImplementedError`` naming its roadmap item.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

_NOT_PORTED = {
    "moe": "ROADMAP.md, section 1, item 9.2 (moe.py)",
    "hybrid": "ROADMAP.md, section 1, item 9.3 (mamba2.py, zamba2.py, kernel K8)",
    "ssm": "ROADMAP.md, section 1, item 9.4 (rwkv6.py, kernel K7)",
    "encdec": "ROADMAP.md, section 1, item 9.5 (whisper.py)",
    "vlm": "ROADMAP.md, section 1, item 9.5 (vlm.py)",
}


def get_family_module(cfg: ModelConfig):
    if cfg.family == "dense":
        from repro_torch.models import transformer
        return transformer
    where = _NOT_PORTED.get(cfg.family, "no roadmap item")
    raise NotImplementedError(f"model family {cfg.family!r} ({cfg.name}) is not ported "
                              f"yet: {where}")


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    return get_family_module(cfg).init(cfg, seed=seed, device=device)
