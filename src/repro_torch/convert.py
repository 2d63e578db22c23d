"""Carry configuration and LRU state across from the JAX package.

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


def stream_state_from_numpy(arrays: dict, device: Device = "cuda") -> dict:
    """A JAX sweep stream's ``export_state()`` dict as tensors on ``device``,
    the input of the port stream's ``import_state`` (state arrays int32, the
    access counter ``now`` int64)."""
    dev = as_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.int64 if k == "now" else np.int32))
            .to(dev) for k, v in arrays.items()}
