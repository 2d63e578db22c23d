from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    merge_partials,
    paged_attention,
    paged_attention_partial,
)
