"""Model architecture schema, the port's copy of ``src/repro/configs/base.py``.

Every architecture provides a module ``repro_torch.configs.<arch_id>``
exporting ``CONFIG`` (the published dims) and ``smoke()`` (a reduced
same-family config for CPU tests).  The shape cells (``ShapeConfig``,
``SHAPES``, ``cell_applicable``) say which (arch x shape) cells are defined;
``repro_torch.configs.registry.input_specs`` gives each cell's inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    activation: str = "silu_glu"  # silu_glu | gelu_glu | gelu
    norm: str = "rms"             # rms | ln
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    # SSM / hybrid (rwkv6 uses head size = ssm_state; mamba2 uses all three)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    hybrid_period: int = 0        # shared attention block every k SSM layers
    # Encoder-decoder
    encoder_layers: int = 0
    # VLM (stub frontend supplies this many precomputed patch embeddings)
    num_image_tokens: int = 0
    embed_scale: bool = False     # gemma-style sqrt(d_model) embedding scale
    dtype: str = "bfloat16"
    # Serving
    kv_page_size: int = 256       # tokens per SPARTA KV page

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic context handling (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.num_layers
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # rwkv6-style
            tm = D * (self.q_dim * 3) + D * D + D * D  # r/k/v(+g) + w-lora approx + out
            cm = 2 * D * F
            return emb + L * (tm + cm)
        att = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
        glu = 3 if self.activation.endswith("_glu") else 2
        if self.moe is not None:
            ffn = self.moe.num_experts * glu * D * self.moe.d_ff_expert + D * self.moe.num_experts
        else:
            ffn = glu * D * F
        if self.family == "hybrid":
            d_inner = self.ssm_expand * D
            m2 = D * (2 * d_inner + 2 * self.ssm_state) + d_inner * D
            return emb + L * m2 + (att + glu * D * F)  # shared attn counted once
        body = L * (att + ffn)
        if self.encoder_layers:
            body += self.encoder_layers * (att + ffn) + L * att  # + cross-attn
        return emb + body


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode

    @property
    def lowers_serve_step(self) -> bool:
        return self.kind in ("decode", "long_decode")


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "long_decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cell_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is (arch x shape) a defined cell?  Returns (ok, reason-if-not):
    long_500k needs sub-quadratic attention, so it runs for the SSM and
    hybrid families only."""
    if shape.kind == "long_decode" and not model.supports_long_context:
        return False, "pure full-attention arch: 500k decode skipped per assignment"
    return True, ""
