"""starcoder2-7b: dense 32L GQA(36q/4kv), plain-GELU MLP — [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4, head_dim=128,
    d_ff=18432, vocab=49152,
    activation="gelu", norm="ln", rope_theta=100_000.0,
)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=256, vocab=256, activation="gelu", norm="ln", dtype="float32",
    )
