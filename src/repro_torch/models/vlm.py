"""InternVL2-style VLM, the port of ``src/repro/models/vlm.py``: a stub ViT
frontend + the dense GQA LM backbone.

The modality frontend is a stub: the batch supplies precomputed patch
embeddings [B, num_image_tokens, D] (the InternViT + MLP projector's output).
The LM backbone is :mod:`repro_torch.models.transformer`; image tokens are
prepended to the text embeddings.  Decode is the dense transformer's: the
image prefix lives in the paged pools like any prompt (the engine serves the
backbone text-only).  The loss masks the image positions out: it is taken
over the text positions alone.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, cross_entropy

init = tfm.init  # backbone params only; the frontend is a stub

# Decode: identical to the dense transformer (ctx_len counts image + text
# tokens).
decode_step = tfm.decode_step


def _backbone(params: tfm.Transformer, batch: dict, cfg: ModelConfig, kernel_mode: str,
              remat: bool):
    """(hidden over image + text [B, I + T, D], aux, I)."""
    patch = batch["patch_embeds"]
    x_text = tfm.embed_tokens(params, cfg, batch["tokens"])
    x = torch.cat([patch.to(x_text.dtype), x_text], dim=1)
    x, aux = tfm.backbone(params, x, cfg, kernel_mode=kernel_mode, remat=remat)
    return x, aux, patch.shape[1]


def forward(params: tfm.Transformer, batch: dict, cfg: ModelConfig, *,
            kernel_mode: str = "auto", remat: bool = True):
    """batch: {patch_embeds [B, I, D], tokens [B, T_text]} -> (logits over
    the text positions [B, T_text, V], aux)."""
    x, aux, i = _backbone(params, batch, cfg, kernel_mode, remat)
    return tfm.unembed(params, cfg, x[:, i:]), aux


def loss_fn(params: tfm.Transformer, batch: dict, cfg: ModelConfig, **kw) -> torch.Tensor:
    """Next-token cross entropy over the text positions from the full
    logits, plus aux (:func:`repro_torch.models.loss_fn` takes the
    vocab-safe chunked route instead)."""
    logits, aux = forward(params, batch, cfg, **kw)
    return cross_entropy(logits[:, :-1], batch["tokens"][:, 1:]) + aux


def forward_hidden(params: tfm.Transformer, batch: dict, cfg: ModelConfig, *,
                   kernel_mode: str = "auto", remat: bool = True):
    """(final-normed hidden over the text positions, unembedding matrix,
    aux)."""
    x, aux, i = _backbone(params, batch, cfg, kernel_mode, remat)
    x = apply_norm(params.final_norm, x, cfg.norm)
    return x[:, i:], tfm.head_matrix(params, cfg), aux
