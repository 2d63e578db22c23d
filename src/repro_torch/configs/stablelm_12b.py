"""stablelm-12b: dense 40L GQA(32q/8kv) — [hf:stabilityai/stablelm-2-1_6b; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=160,
    d_ff=13824, vocab=100352,
    activation="silu_glu", norm="ln", rope_theta=10_000.0,
)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, activation="silu_glu", norm="ln", dtype="float32",
    )
