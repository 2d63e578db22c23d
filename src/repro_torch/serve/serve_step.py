"""serve_step builders, the port of ``src/repro/serve/serve_step.py``:
one-token decode per architecture family.

Every builder returns ``step(params, inputs) -> (logits, new_state)`` where
``inputs`` matches :func:`repro_torch.configs.registry.input_specs` for the
decode shapes.  KV state uses the global-view SPARTA layout (the partition
axis explicit, :mod:`repro_torch.models.paged_global`).  The port loops over
the layers where the JAX package scans them, and updates the pools in
place; ``new_state`` holds them.

Kernels: the enc-dec step's cross-attention runs K5 (one query row against
the encoder's keys); the hybrid step's Mamba2 blocks and the ssm step decode
by their recurrences; the paged attention over the partitions is plain
tensor ops, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import aligned, gather_rows, is_dtensor
from repro_torch.models import mamba2
from repro_torch.models import rwkv6 as rwkv6_m
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper
from repro_torch.models.layers import apply_norm
from repro_torch.models.paged_global import decode_block_global


def _dense_serve(cfg: ModelConfig, kernel_mode: str):
    def step(params, inputs):
        tokens, ctx = inputs["tokens"], inputs["ctx_len"]
        k_pools, v_pools = inputs["k_pools"], inputs["v_pools"]
        x = tfm.embed_tokens(params, cfg, tokens[:, None])
        for i, lp in enumerate(params.layers):
            x, _, _ = decode_block_global(lp, x, cfg, k_pools[i], v_pools[i],
                                          inputs["tables"], ctx)
        logits = tfm.unembed(params, cfg, x)[:, 0]
        return logits, {"k_pools": k_pools, "v_pools": v_pools}
    return step


def _hybrid_serve(cfg: ModelConfig, kernel_mode: str):
    def step(params, inputs):
        tokens, ctx = inputs["tokens"], inputs["ctx_len"]
        k_pools, v_pools = inputs["k_pools"], inputs["v_pools"]
        x = gather_rows(params.embed, tokens.long())[:, None, :]
        conv, ssm = [], []
        for g, group in enumerate(params.mamba):
            for j, mp in enumerate(group):
                st = {"conv": inputs["conv_state"][g, j], "ssm": inputs["ssm_state"][g, j]}
                x, new = mamba2.block_forward(mp, x, cfg, kernel_mode=kernel_mode, state=st)
                conv.append(new["conv"])
                ssm.append(new["ssm"])
            x, _, _ = decode_block_global(params.shared_attn, x, cfg, k_pools[g], v_pools[g],
                                          inputs["tables"], ctx)
        x = apply_norm(params.final_norm, x, cfg.norm)
        logits = (x @ params.lm_head)[:, 0]
        shape = inputs["conv_state"].shape[:2]
        return logits, {"conv_state": torch.stack(conv).unflatten(0, shape),
                        "ssm_state": torch.stack(ssm).unflatten(0, shape),
                        "k_pools": k_pools, "v_pools": v_pools}
    return step


def _ssm_serve(cfg: ModelConfig, kernel_mode: str):
    def step(params, inputs):
        state = {k: inputs[k] for k in ("tm_shift", "cm_shift", "wkv")}
        return rwkv6_m.decode_step(params, inputs["tokens"], cfg, state,
                                   kernel_mode=kernel_mode)
    return step


def _encdec_serve(cfg: ModelConfig, kernel_mode: str):
    def step(params, inputs):
        tokens, ctx = inputs["tokens"], inputs["ctx_len"]
        k_pools, v_pools = inputs["k_pools"], inputs["v_pools"]
        pos = (ctx - 1).long()
        x = gather_rows(params.embed, tokens.long())[:, None, :] + \
            params.dec_pos[pos][:, None, :]
        for i, lp in enumerate(params.dec_layers):
            x, _, _ = decode_block_global(whisper.self_attention_block(lp), x, cfg,
                                          k_pools[i], v_pools[i], inputs["tables"], ctx,
                                          skip_mlp=True)
            x = whisper.cross_attention_and_mlp(lp, x, cfg, inputs["cross_k"][i],
                                                inputs["cross_v"][i], kernel_mode=kernel_mode)
        x = apply_norm(params.dec_norm, x, cfg.norm)
        logits = (x @ params.embed.T)[:, 0]
        return logits, {"k_pools": k_pools, "v_pools": v_pools}
    return step


def _placed(logits, new_state, inputs):
    """The sharded step's outputs in ``sharding.serve_output_specs``'
    placements: logits [B, V] with B as the tokens and V over ``model``,
    each new state tensor as its input."""
    from torch.distributed.tensor import Replicate, Shard

    tok = inputs["tokens"]
    want = tuple(p if isinstance(p, Shard) else Shard(1) if name == "model" else Replicate()
                 for p, name in zip(tok.placements, tok.device_mesh.mesh_dim_names))
    if tuple(logits.placements) != want:
        logits = logits.redistribute(tok.device_mesh, want)
    return logits, {k: aligned(v, inputs[k]) for k, v in new_state.items()}


def make_serve_step(cfg: ModelConfig, *, kernel_mode: str = "auto") -> Callable:
    """Returns ``step(params, inputs) -> (logits [B, V], new_state)`` for the
    decode shapes.  ``auto`` runs the kernels for data on the card (the JAX
    package defaults to ``reference`` here, its dry-run choice).

    The same step serves a sharded state: parameters placed by
    ``shard_params(..., mode="serve")`` and inputs by
    ``sharding.shard_serve_inputs``.  It then runs under
    ``implicit_replication`` (a plain tensor the model makes counts as
    replicated), each rank reads only its own partitions' pages
    (:mod:`repro_torch.models.paged_global`), and the outputs come back in
    ``serve_output_specs``' placements.  Run it with
    ``kernel_mode="reference"`` there, as the JAX package's dry run does."""
    step = {
        "dense": _dense_serve,
        "moe": _dense_serve,
        "vlm": _dense_serve,
        "hybrid": _hybrid_serve,
        "ssm": _ssm_serve,
        "encdec": _encdec_serve,
    }[cfg.family](cfg, kernel_mode)

    def serve(params, inputs):
        if not is_dtensor(inputs["tokens"]):
            return step(params, inputs)
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            return _placed(*step(params, inputs), inputs)
    return serve
