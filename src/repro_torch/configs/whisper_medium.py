"""whisper-medium: 24L enc + 24L dec, conv frontend stubbed — [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51904,  # published 51865, padded to x64 for sharding
    activation="gelu", norm="ln", rope_theta=0.0,
    encoder_layers=24, tie_embeddings=True,
)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, activation="gelu", norm="ln", rope_theta=0.0,
        encoder_layers=2, tie_embeddings=True, dtype="float32",
    )
