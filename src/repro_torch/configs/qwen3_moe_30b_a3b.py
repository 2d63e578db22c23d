"""qwen3-moe-30b-a3b: 48L MoE 128 experts top-8 — [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936,
    activation="silu_glu", norm="rms", qk_norm=True, rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=64, vocab=256, qk_norm=True, dtype="float32",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64),
    )
