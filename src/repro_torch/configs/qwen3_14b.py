"""qwen3-14b: dense 40L GQA(40q/8kv) + qk-norm — [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=17408, vocab=151936,
    activation="silu_glu", norm="rms", qk_norm=True, rope_theta=1_000_000.0,
)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, qk_norm=True, dtype="float32",
    )
