from repro_torch.kernels.system_sim.ops import (
    resolve_system_mode,
    system_sim_batched,
    system_sim_batched_carry,
)
from repro_torch.kernels.system_sim.ref import system_sim_batched_carry_ref

__all__ = ["system_sim_batched", "system_sim_batched_carry",
           "system_sim_batched_carry_ref", "resolve_system_mode"]
