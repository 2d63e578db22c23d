"""InternVL2-style VLM, the port of ``src/repro/models/vlm.py``: a stub ViT
frontend + the dense GQA LM backbone.

The modality frontend is a stub: the batch supplies precomputed patch
embeddings [B, num_image_tokens, D] (the InternViT + MLP projector's output).
The LM backbone is :mod:`repro_torch.models.transformer`; image tokens are
prepended to the text embeddings.  Decode is the dense transformer's: the
image prefix lives in the paged pools like any prompt (the engine serves the
backbone text-only).  The loss waits for the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm

init = tfm.init  # backbone params only; the frontend is a stub

# Decode: identical to the dense transformer (ctx_len counts image + text
# tokens).
decode_step = tfm.decode_step


def _backbone(params: tfm.Transformer, batch: dict, cfg: ModelConfig, kernel_mode: str):
    """(hidden over image + text [B, I + T, D], aux, I)."""
    patch = batch["patch_embeds"]
    x_text = tfm.embed_tokens(params, cfg, batch["tokens"])
    x = torch.cat([patch.to(x_text.dtype), x_text], dim=1)
    x, aux = tfm.backbone(params, x, cfg, kernel_mode=kernel_mode)
    return x, aux, patch.shape[1]


def forward(params: tfm.Transformer, batch: dict, cfg: ModelConfig, *,
            kernel_mode: str = "auto", remat: bool = True):
    """batch: {patch_embeds [B, I, D], tokens [B, T_text]} -> (logits over
    the text positions [B, T_text, V], aux).  ``remat`` has no effect."""
    x, aux, i = _backbone(params, batch, cfg, kernel_mode)
    return tfm.unembed(params, cfg, x[:, i:]), aux


def forward_hidden(params: tfm.Transformer, batch: dict, cfg: ModelConfig, *,
                   kernel_mode: str = "auto", remat: bool = True):
    """(final-normed hidden over the text positions, unembedding matrix,
    aux)."""
    x, aux, i = _backbone(params, batch, cfg, kernel_mode)
    x = apply_norm(params.final_norm, x, cfg.norm)
    return x[:, i:], tfm.head_matrix(params, cfg), aux
