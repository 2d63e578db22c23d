"""Carry configuration, sweep-stream state and model weights across from the
JAX package.

What crosses between the two packages is configuration (frozen dataclasses,
passed as ``dataclasses.asdict`` of the JAX objects), the carried state of a
sweep stream (its ``export_state()`` dict of numpy arrays), a model's
parameter pytree as numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``), a recurrent model's decode state the same way, and a training
state (parameters and AdamW moments) in both directions: the JAX package
stacks layers on a leading axis, the port keeps one module a layer, and
:func:`port_param_leaves` / :func:`jax_layout` map one layout onto the
other.  Nothing here imports the JAX package.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

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


def stack_index(name: str) -> Tuple[str, Tuple[int, ...]]:
    """(JAX leaf name, index into its stacked leaf) of a port parameter
    name, the inverse of :func:`port_param_leaves` for one name:
    ``layers.3.attn.wq`` -> (``layers.attn.wq``, (3,)); an unstacked
    leaf's index is ()."""
    parts = name.split(".")
    if parts[0] in ("layers", "enc_layers", "dec_layers") and parts[1].isdigit():
        return ".".join([parts[0]] + parts[2:]), (int(parts[1]),)
    if parts[0] == "mamba" and parts[1].isdigit() and parts[2].isdigit():
        return ".".join([parts[0]] + parts[3:]), (int(parts[1]), int(parts[2]))
    return name, ()


def jax_layout(named: Dict[str, torch.Tensor]) -> dict:
    """The JAX package's nested parameter tree of ``named`` (port
    parameter name -> tensor; a module's parameters or an AdamW moment
    dict) as CPU tensors, the inverse of :func:`port_param_leaves`:
    ``layers.i.x`` (and whisper's ``enc_layers`` / ``dec_layers``) stacked
    on a leading [L] axis, zamba2's ``mamba.g.j.x`` on [G, per].  Every
    slice is copied from its device straight into its place in the stacked
    leaf, so the tree owns its memory."""
    groups: Dict[str, list] = {}
    for name, t in named.items():
        leaf, idx = stack_index(name)
        groups.setdefault(leaf, []).append((idx, t))
    tree: dict = {}
    for leaf, items in groups.items():
        items.sort(key=lambda it: it[0])
        idxs = [i for i, _ in items]
        lead = tuple(max(i[d] for i in idxs) + 1 for d in range(len(idxs[0])))
        if len(idxs) != int(np.prod(lead)) or len(set(idxs)) != len(idxs):
            raise ValueError(f"{leaf}: the stacked indices {idxs} do not fill {lead}")
        first = items[0][1]
        out = torch.empty(lead + tuple(first.shape), dtype=first.dtype)
        for idx, t in items:
            out[idx].copy_(t.detach())
        node = tree
        *path, last = leaf.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = out
    return tree


def _numpy_of(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy array of the same dtype; bfloat16 as
    ml_dtypes' bfloat16 (how JAX hands bf16 arrays to numpy)."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only where bf16 leaves must leave torch as numpy

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_to_numpy(model, cfg) -> dict:
    """The JAX parameter pytree of ``model`` (a port module of ``cfg``'s
    family) as numpy arrays, stacked as the JAX package stacks it: the
    inverse of :func:`params_from_numpy`."""
    tree = jax_layout(dict(model.named_parameters()))
    want = {name for name, _ in port_param_leaves(tree)}
    have = set(_family_names(cfg))
    if want != have:
        raise ValueError(f"{cfg.name}: the module's parameters do not make the family's tree "
                         f"(missing {sorted(have - want)[:5]}, extra {sorted(want - have)[:5]})")
    return _map_tree(_numpy_of, tree)


def _family_names(cfg) -> list:
    """The parameter names of ``cfg``'s family module (on ``meta``)."""
    from repro_torch import models

    return [n for n, _ in models.init(cfg, device="meta").named_parameters()]


def opt_state_to_numpy(state: dict) -> dict:
    """``init_state``'s tree (``m`` and ``v`` keyed by port parameter
    names) in the JAX package's layout, as numpy arrays: ``m`` and ``v``
    stacked like the parameters, ``step`` an int32 0-d array."""
    return {"m": _map_tree(_numpy_of, jax_layout(state["m"])),
            "v": _map_tree(_numpy_of, jax_layout(state["v"])),
            "step": np.asarray(state["step"].detach().cpu().numpy(), dtype=np.int32)}


def opt_state_from_numpy(tree: dict, device: Device = "cuda") -> dict:
    """A JAX ``init_state`` tree of numpy arrays (``m``, ``v`` and ``step``)
    as the port's optimizer state on ``device``: the moments split per
    layer and keyed by port parameter names."""
    dev = as_device(device)

    def split(moments: dict) -> dict:
        return {name: _tensor_of(np.asarray(leaf if i is None else leaf[i]), dev)
                for name, (leaf, i) in port_param_leaves(moments)}

    return {"m": split(tree["m"]), "v": split(tree["v"]),
            "step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32, device=dev)}


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
