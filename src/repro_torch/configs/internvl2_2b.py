"""internvl2-2b: InternViT stub + InternLM2 backbone — [arXiv:2404.16821; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=92608,  # published 92553, padded to x64 for sharding
    activation="silu_glu", norm="rms", rope_theta=1_000_000.0,
    num_image_tokens=256, tie_embeddings=True,
)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, num_image_tokens=8, tie_embeddings=True, dtype="float32",
    )
