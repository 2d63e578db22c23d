"""Deterministic host-sharded synthetic data pipeline, the port of
``src/repro/data/pipeline.py`` (numpy only; the same bytes as the JAX
package's for the same config, step and host).

Every batch is a pure function of (step, host_id), stateless Philox
streams, so there is no data-loader state to checkpoint or lose: any host
can recompute any shard after a failure.  Token streams are
Zipf-distributed with short-range repetition structure, so language-model
losses descend.  The batches are numpy arrays; moving them to the device is
the caller's job.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global_batch {self.global_batch} does not split over "
                             f"{self.num_hosts} hosts")
        return self.global_batch // self.num_hosts


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    # Philox keyed by (seed, step, host): independent, reproducible streams.
    return np.random.Generator(np.random.Philox(key=cfg.seed, counter=[0, 0, step, cfg.host_id]))


def token_batch(cfg: DataConfig, step: int) -> np.ndarray:
    """[host_batch, seq_len] int32: Zipf unigrams + local bigram copies."""
    rng = _rng_for(cfg, step)
    B, S, V = cfg.host_batch, cfg.seq_len, cfg.vocab
    toks = (rng.zipf(1.3, size=(B, S)) - 1).clip(max=V - 1).astype(np.int32)
    # Learnable structure: with p = 0.5 a token repeats its predecessor
    # shifted by +1 (mod V), a pattern an LM head picks up quickly.
    rep = rng.random((B, S)) < 0.5
    shifted = np.roll(toks, 1, axis=1)
    return np.where(rep, (shifted + 1) % V, toks)


def batch_for_model(cfg: DataConfig, model: ModelConfig, step: int) -> Dict[str, np.ndarray]:
    """The family's batch dict (the inputs ``registry.input_specs`` names):
    ``tokens``, with float32 ``patch_embeds`` [B, num_image_tokens, D] for
    vlm and ``frames`` [B, seq_len, D] for encdec."""
    rng = _rng_for(cfg, step + 1_000_003)
    toks = token_batch(cfg, step)
    if model.family == "vlm":
        i = model.num_image_tokens
        patch = rng.standard_normal((cfg.host_batch, i, model.d_model)).astype(np.float32) * 0.02
        return {"patch_embeds": patch, "tokens": toks}
    if model.family == "encdec":
        frames = rng.standard_normal(
            (cfg.host_batch, cfg.seq_len, model.d_model)).astype(np.float32) * 0.02
        return {"frames": frames, "tokens": toks}
    return {"tokens": toks}
