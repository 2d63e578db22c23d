from repro_torch.kernels.timeline.ops import (
    FP_COLS,
    IP_COLS,
    TimelineParams,
    envelope_of,
    pack_params,
    resolve_timeline_mode,
    timeline_init_state_batched,
    timeline_sim,
    timeline_sim_batched,
    timeline_sim_batched_carry,
)

__all__ = ["TimelineParams", "timeline_sim", "timeline_sim_batched",
           "timeline_sim_batched_carry", "timeline_init_state_batched",
           "pack_params", "resolve_timeline_mode", "envelope_of", "FP_COLS", "IP_COLS"]
