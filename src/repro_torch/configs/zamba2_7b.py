"""zamba2-7b: Mamba2 backbone + shared attention — [arXiv:2411.15242].

81 Mamba2 layers in 27 groups of 3; the single shared attention+MLP block
(32 MHA heads, d_ff 14336) is applied after every group (27 applications,
one weight set).  Per-invocation LoRA deltas of the published model are
omitted (DESIGN.md assumptions log).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000,
    activation="gelu_glu", norm="rms", rope_theta=10_000.0,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, hybrid_period=3,
)

def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, ssm_state=16, ssm_headdim=16, ssm_expand=2,
        hybrid_period=2, dtype="float32",
    )
