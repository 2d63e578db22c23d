"""gemma-7b: dense 28L MHA(16q/16kv) head_dim=256, GeGLU — [arXiv:2403.08295; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000,
    activation="gelu_glu", norm="rms", rope_theta=10_000.0,
    tie_embeddings=True, embed_scale=True,
)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, activation="gelu_glu",
        tie_embeddings=True, embed_scale=True, dtype="float32",
    )
