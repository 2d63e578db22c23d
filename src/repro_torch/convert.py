"""Carry configuration and sweep-stream state across from the JAX package.

The simulator has no weights: what crosses between the two packages is
configuration (frozen dataclasses, passed as ``dataclasses.asdict`` of the
JAX objects) and the carried state of a sweep stream (its ``export_state()``
dict of numpy arrays).  Nothing here imports the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.sparta import SystemLatencies, TLBConfig
from repro_torch.core.timeline import TimelineConfig
from repro_torch.core.tlbsim import Device, SystemSimConfig
from repro_torch.kernels.common import as_device


def tlb_config_from_fields(fields: dict) -> TLBConfig:
    """The port's :class:`TLBConfig` from ``asdict`` of the JAX one."""
    return TLBConfig(**fields)


def _optional_tlb(fields: Optional[dict]) -> Optional[TLBConfig]:
    return None if fields is None else tlb_config_from_fields(fields)


def system_config_from_fields(fields: dict) -> SystemSimConfig:
    """The port's :class:`SystemSimConfig` from ``asdict`` of the JAX one
    (its nested TLB configs arrive as dicts, or None when absent)."""
    return SystemSimConfig(
        **{**fields,
           "cache": _optional_tlb(fields["cache"]),
           "accel_tlb": _optional_tlb(fields["accel_tlb"]),
           "mem_tlb": tlb_config_from_fields(fields["mem_tlb"])})


def latencies_from_fields(fields: dict) -> SystemLatencies:
    """The port's :class:`SystemLatencies` from ``asdict`` of the JAX one."""
    return SystemLatencies(**fields)


def timeline_config_from_fields(fields: dict) -> TimelineConfig:
    """The port's :class:`TimelineConfig` from ``asdict`` of the JAX one."""
    return TimelineConfig(**fields)


def stream_state_from_numpy(arrays: dict, device: Device = "cuda") -> dict:
    """A JAX sweep stream's ``export_state()`` dict as tensors on ``device``,
    the input of the port stream's ``import_state``.  Every array keeps its
    dtype (int32 LRU state and MSHR counts, float32 timeline times); the
    access counter ``now`` is int64."""
    dev = as_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.int64) if k == "now" else np.array(v))
            .to(dev) for k, v in arrays.items()}
