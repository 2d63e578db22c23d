from repro_torch.kernels.tlb_sim.ops import (  # noqa: F401
    tlb_sim,
    tlb_sim_batched,
    tlb_sim_batched_carry,
)
