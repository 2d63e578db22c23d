"""Carry configuration, sweep-stream state and model weights across from the
JAX package.

What crosses between the two packages is configuration (frozen dataclasses,
passed as ``dataclasses.asdict`` of the JAX objects), the carried state of a
sweep stream (its ``export_state()`` dict of numpy arrays), a model's
parameter pytree as numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``) and a recurrent model's decode state the same way.  Nothing here
imports the JAX package.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

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


# -- model parameters ----------------------------------------------------------

def _flatten(tree: dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def port_param_leaves(tree: dict) -> Iterator[Tuple[str, object]]:
    """``(port parameter name, (leaf, index or None))`` for each leaf of a
    JAX parameter pytree (nested dicts; leaves are arrays or anything with
    ``shape``).  The leaves the JAX package stacks are split: ``layers/...``
    on a leading [L] axis (dense, MoE, rwkv6) and whisper's
    ``enc_layers/...`` and ``dec_layers/...`` become ``<stack>.i....`` with
    index i, and zamba2's ``mamba/...`` on [G, per] becomes
    ``mamba.g.j....`` with index (g, j).  MoE's stacked expert axis stays a
    parameter axis."""
    for name, leaf in _flatten(tree):
        stack = name.split(".", 1)[0]
        if stack in ("layers", "enc_layers", "dec_layers"):
            for i in range(leaf.shape[0]):
                yield f"{stack}.{i}.{name[len(stack) + 1:]}", (leaf, i)
        elif name.startswith("mamba."):
            for g in range(leaf.shape[0]):
                for j in range(leaf.shape[1]):
                    yield f"mamba.{g}.{j}.{name[len('mamba.'):]}", (leaf, (g, j))
        else:
            yield name, (leaf, None)


def _tensor_of(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")      # a writable copy the tensor owns
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it to numpy
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: dict, cfg, device: Device = "cuda"):
    """The port's parameter module of ``cfg``'s family (any of the six)
    holding the JAX parameter pytree ``tree`` of numpy arrays, so
    both packages compute the same function.  Every leaf must match the
    port's parameter of the same name in shape and dtype."""
    from repro_torch import models

    dev = as_device(device)
    model = models.init(cfg, device="meta")
    state = {}
    for name, (leaf, i) in port_param_leaves(tree):
        state[name] = _tensor_of(np.asarray(leaf if i is None else leaf[i]), dev)
    want = model.state_dict()
    for name, t in state.items():
        if name in want and (t.shape != want[name].shape or t.dtype != want[name].dtype):
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} does not match the port's "
                             f"{tuple(want[name].shape)} {want[name].dtype}")
    model.load_state_dict(state, strict=True, assign=True)
    return model.requires_grad_(False)


def decode_state_from_numpy(tree: dict, cfg, device: Device = "cuda") -> dict:
    """A JAX recurrent decode state (``init_decode_state`` / ``decode_step``
    of rwkv6 or zamba2, as a dict of numpy arrays) as the port's state dict
    on ``device``, every array's dtype kept.  Each leaf must have the shape
    and dtype of the port's ``init_decode_state`` for ``cfg`` at the same
    batch."""
    from repro_torch import models

    dev = as_device(device)
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError(f"{cfg.name} ({cfg.family}) keeps no recurrent decode state")
    state = {k: _tensor_of(np.asarray(v), dev) for k, v in tree.items()}
    batch = state["wkv" if cfg.family == "ssm" else "ssm"].shape[
        1 if cfg.family == "ssm" else 2]
    want = models.get_family_module(cfg).init_decode_state(cfg, batch, device="meta")
    if sorted(state) != sorted(want):
        raise ValueError(f"decode state keys {sorted(state)}, expected {sorted(want)}")
    for k, t in state.items():
        if t.shape != want[k].shape or t.dtype != want[k].dtype:
            raise ValueError(f"{k}: {tuple(t.shape)} {t.dtype} does not match the port's "
                             f"{tuple(want[k].shape)} {want[k].dtype}")
    return state
