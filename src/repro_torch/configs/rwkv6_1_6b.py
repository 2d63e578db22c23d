"""rwkv6-1.6b "Finch": attention-free, data-dependent decay — [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=7168, vocab=65536,
    norm="ln", ssm_headdim=64,
)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=0, num_kv_heads=0, head_dim=0,
        d_ff=128, vocab=256, norm="ln", ssm_headdim=16, dtype="float32",
    )
