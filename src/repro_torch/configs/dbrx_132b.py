"""dbrx-132b: 40L fine-grained MoE 16 experts top-4 — [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352,
    activation="silu_glu", norm="ln", rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, norm="ln", dtype="float32",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    )
