"""Sharding rules: parameters, optimizer state, inputs, outputs; the port of
``src/repro/distributed/sharding.py``.

Train: TP over ``model`` on heads / FFN-hidden / vocab / experts, FSDP
(ZeRO-3-style) over ``data`` (and ``pod``) on the complementary dim of every
large matrix; optimizer state inherits the parameter specs.

Serve: TP over ``model`` only (weights must be gatherable per token without
FSDP all-gathers on the critical path); SPARTA KV pools shard their explicit
partition axis over ``model`` — or over (data, model) jointly for the
single-sequence long-context shape.

A spec is a tuple with the entries of the JAX package's ``PartitionSpec``:
per tensor dim ``None`` (replicated), a mesh axis name, or a tuple of names
(one dim over several axes, major first).  The rules match the JAX leaf's
path (``layers/attn/wq``), at the JAX leaf's rank: a port parameter
``layers.3.attn.wq`` is slice 3 of that stacked leaf
(:func:`repro_torch.convert.stack_index`), and its spec drops the stacked
leading entries, which the rules never shard.  :func:`placements` turns a
spec into DTensor placements on a :class:`DeviceMesh`; :func:`shard_params`,
:func:`shard_opt_state` and :func:`shard_batch` place a training state and
a batch with them, :func:`shard_serve_inputs` a serve step's state.
"""
from __future__ import annotations

import math
import re
import sys
from typing import Any, Dict, Mapping, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig

Spec = Tuple[Any, ...]


def data_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else "data"


# (regex on path suffix, trailing-dim axes) — earlier rules win.
# `F` = fsdp axis placeholder, `T` = tensor axis, None = replicated dim.
_TRAIN_RULES: Tuple[Tuple[str, Tuple[Any, ...]], ...] = (
    (r"moe/(w_gate|w_up)$",   ("T", "F", None)),      # [E, D, F]
    (r"moe/w_down$",          ("T", None, "F")),      # [E, F, D]
    (r"moe/router$",          ("F", None)),           # [D, E]
    (r"embed$",               ("T", "F")),            # [V, D]
    (r"lm_head$",             ("F", "T")),            # [D, V]
    (r"dec_pos$",             ("F", None)),           # [maxpos, D]
    (r"(attn|cm)/(wq|wk|wv)$", ("F", "T")),
    (r"attn/wo$",             ("T", "F")),
    (r"tm/(wr|wk|wv|wg)$",    ("F", "T")),
    (r"tm/wo$",               ("T", "F")),
    (r"tm/w_lora_a$",         ("F", None)),
    (r"tm/w_lora_b$",         (None, "F")),
    (r"cm/wr$",               ("F", "T")),
    (r"(mlp/)?(w_gate|w_up)$", ("F", "T")),           # [D, F]
    (r"(mlp/)?w_down$",       ("T", "F")),            # [F, D]
    (r"in_proj$",             ("F", "T")),
    (r"out_proj$",            ("T", "F")),
    (r"conv_w$",              (None, "T")),
    (r"(conv_b|gate_norm)$",  ("T",)),
)


def spec_for_param(path_str: str, ndim: int, fsdp, tp, *, serve: bool = False) -> Spec:
    """The spec of the JAX leaf at ``path_str`` (``/``-joined) of rank
    ``ndim``: the entries of the JAX package's ``PartitionSpec``, ``()``
    where it replicates."""
    for pat, dims in _TRAIN_RULES:
        if re.search(pat, path_str):
            axes = []
            for d in dims:
                if d == "F":
                    axes.append(None if serve else fsdp)
                elif d == "T":
                    axes.append(tp)
                else:
                    axes.append(None)
            pad = ndim - len(axes)
            if pad < 0:  # scalar-ish param matched a matrix rule; replicate
                return ()
            return tuple([None] * pad + axes)
    return ()  # norms, biases, small vectors: replicated


def _named(params) -> Dict[str, Any]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(params, cfg: ModelConfig, *, mode: str = "train",
                multi_pod: bool = False) -> Dict[str, Spec]:
    """{port parameter name: spec with one entry per dim of that tensor}
    for ``params`` (a parameter module, or a dict of its named tensors; the
    meta device will do)."""
    from repro_torch.convert import stack_index

    fsdp = data_axes(multi_pod)
    serve = mode == "serve"
    out = {}
    for name, t in _named(params).items():
        leaf, idx = stack_index(name)
        ndim = t.ndim + len(idx)
        spec = spec_for_param(leaf.replace(".", "/"), ndim, fsdp, "model", serve=serve)
        spec = spec + (None,) * (ndim - len(spec))
        if any(s is not None for s in spec[:len(idx)]):
            raise ValueError(f"{name}: the rule shards the stacked axes of {leaf} ({spec})")
        out[name] = spec[len(idx):]
    return out


def opt_state_specs(params, cfg: ModelConfig, *, multi_pod: bool = False) -> Dict[str, Any]:
    ps = param_specs(params, cfg, mode="train", multi_pod=multi_pod)
    return {"m": ps, "v": ps, "step": ()}


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                multi_pod: bool = False) -> Dict[str, Spec]:
    """Input shardings for train/prefill batches."""
    dp = data_axes(multi_pod)
    if cfg.family == "vlm":
        return {"patch_embeds": (dp, None, None), "tokens": (dp, None)}
    if cfg.family == "encdec":
        return {"frames": (dp, None, None), "tokens": (dp, None)}
    return {"tokens": (dp, None)}


def serve_partition_axes(shape: ShapeConfig, *, multi_pod: bool = False):
    """Mesh axes acting as SPARTA partitions for this decode shape.

    Normal decode: the ``model`` axis (batch shards over data).  The
    single-sequence long-context shape spreads pages over EVERY axis."""
    if shape.kind == "long_decode":
        return (("pod", "data", "model") if multi_pod else ("data", "model"))
    return "model"


def serve_input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                      multi_pod: bool = False) -> Dict[str, Spec]:
    dp = data_axes(multi_pod)
    part = serve_partition_axes(shape, multi_pod=multi_pod)
    long = shape.kind == "long_decode"
    bdp = None if long else dp  # batch=1 cannot shard
    specs: Dict[str, Spec] = {"tokens": (bdp,), "ctx_len": (bdp,)}
    if cfg.family == "ssm":
        tp = "model"
        specs.update({
            "tm_shift": (None, bdp, tp),
            "cm_shift": (None, bdp, tp),
            "wkv": (None, bdp, tp, None, None),
        })
        return specs
    pool = (None, bdp, part, None, None, None, None)
    specs.update({
        "k_pools": pool,
        "v_pools": pool,
        "tables": (bdp, part, None),
    })
    if cfg.family == "hybrid":
        specs["conv_state"] = (None, None, bdp, None, "model" if not long else None)
        specs["ssm_state"] = (None, None, bdp, "model" if not long else None, None, None)
    if cfg.family == "encdec":
        specs["cross_k"] = (None, bdp, None, "model", None)
        specs["cross_v"] = (None, bdp, None, "model", None)
    return specs


def serve_output_specs(cfg: ModelConfig, shape: ShapeConfig, *, multi_pod: bool = False):
    """(logits spec, new-state specs dict)."""
    dp = data_axes(multi_pod)
    long = shape.kind == "long_decode"
    bdp = None if long else dp
    inp = serve_input_specs(cfg, shape, multi_pod=multi_pod)
    state_keys = {
        "ssm": ("tm_shift", "cm_shift", "wkv"),
        "hybrid": ("conv_state", "ssm_state", "k_pools", "v_pools"),
    }.get(cfg.family, ("k_pools", "v_pools"))  # cross KV is input-only
    return (bdp, "model"), {k: inp[k] for k in state_keys}


# ---------------------------------------------------------------------------
# Placing tensors on a mesh.
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor.  No DTensor exists before its module is
    imported, so this never imports it: an import statement inside the
    model hooks below would cost microseconds on every layer of every
    serving step."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(i)`` where tensor dim i names that axis, ``Replicate()``
    elsewhere.  A dim over several axes (``("pod", "data")``) shards over
    them major first, which must be the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh has {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: {axes} are not in the mesh's order {names}")
        for j in idx:
            if isinstance(out[j], Shard):
                raise ValueError(f"spec {spec} uses mesh axis {names[j]!r} twice")
            out[j] = Shard(i)
    return tuple(out)


def distribute(t: torch.Tensor, mesh, spec: Spec):
    """``t`` (the whole tensor, the same on every rank) as a DTensor on
    ``mesh`` placed by ``spec``; each rank keeps its own shard, nothing is
    sent.  On the mesh's device type."""
    from torch.distributed.tensor import distribute_tensor

    if len(spec) > t.ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {t.ndim} dims")
    return distribute_tensor(t.detach(), mesh, placements(spec, mesh), src_data_rank=None)


def _multi_pod(mesh) -> bool:
    return "pod" in tuple(mesh.mesh_dim_names)


def place_params(module: nn.Module, mesh, specs: Mapping[str, Spec]) -> nn.Module:
    """Replace each parameter of ``module`` by a DTensor parameter placed
    by ``specs[name]``, keeping ``requires_grad``; returns the module."""
    for name, p in list(module.named_parameters()):
        owner, _, attr = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        sub.register_parameter(attr, nn.Parameter(distribute(p, mesh, specs[name]),
                                                  requires_grad=p.requires_grad))
    return module


def shard_params(module: nn.Module, cfg: ModelConfig, mesh, *, mode: str = "train") -> nn.Module:
    """Place a parameter module on ``mesh`` by :func:`param_specs` (multi-pod
    where the mesh has a ``pod`` axis), in place."""
    return place_params(module, mesh,
                        param_specs(module, cfg, mode=mode, multi_pod=_multi_pod(mesh)))


def shard_opt_state(opt_state: Dict, cfg: ModelConfig, mesh) -> Dict:
    """``init_state``'s tree on ``mesh``: each moment placed as its
    parameter, the step replicated."""
    specs = param_specs(opt_state["m"], cfg, mode="train", multi_pod=_multi_pod(mesh))
    return {"m": {n: distribute(t, mesh, specs[n]) for n, t in opt_state["m"].items()},
            "v": {n: distribute(t, mesh, specs[n]) for n, t in opt_state["v"].items()},
            "step": distribute(opt_state["step"], mesh, ())}


def shard_batch(batch: Dict[str, torch.Tensor], cfg: ModelConfig, mesh) -> Dict:
    """A global batch (the same on every rank) sharded over the data axes
    by :func:`batch_specs`; a key the specs do not name shards its leading
    dim the same way."""
    dp = data_axes(_multi_pod(mesh))
    specs = batch_specs(cfg, None, multi_pod=_multi_pod(mesh))   # the shape is not read
    return {k: distribute(v, mesh, specs.get(k, (dp,))) for k, v in batch.items()}


def shard_serve_inputs(inputs: Dict[str, torch.Tensor], cfg: ModelConfig,
                       shape: ShapeConfig, mesh) -> Dict:
    """A serve step's inputs (whole tensors, the same on every rank) placed
    by :func:`serve_input_specs` for ``shape`` (multi-pod where the mesh has
    a ``pod`` axis): pools and tables with B over the data axes and P over
    the partition axes, each rank keeping its own shard."""
    specs = serve_input_specs(cfg, shape, multi_pod=_multi_pod(mesh))
    return {k: distribute(v, mesh, specs[k]) for k, v in inputs.items()}


def gather_rows(table, ids):
    """``table[ids]`` (an embedding lookup), the rows in ``ids``'s
    placements.  For a DTensor table the ids are replicated for the lookup
    and the rows redistributed afterwards: the lookup's backward (an
    ``index_put``) fails in DTensor on sharded ids (torch 2.11: "Shard dim
    -1 in placements ... must be normalized"), and ``F.embedding`` fails on
    the train layout in both versions (an ``IndexError``).

    A table sharded on its rows only (the serve layout: vocab over
    ``model``) is read shard-locally instead (:func:`_vocab_parallel_rows`):
    DTensor's rule for the index would all-gather the whole table."""
    if not (is_dtensor(table) and is_dtensor(ids)):
        return table[ids]
    from torch.distributed.tensor import Replicate, Shard

    if all(isinstance(p, Replicate) or p == Shard(0) for p in table.placements) \
            and Shard(0) in table.placements:
        return _vocab_parallel_rows(table, ids)
    whole = ids.redistribute(ids.device_mesh, (Replicate(),) * ids.device_mesh.ndim)
    return aligned(table[whole], ids)


def _vocab_parallel_rows(table, ids):
    """``table[ids]`` for a table sharded on dim 0 only: each rank looks the
    ids up in its own rows (zeros for ids it does not hold), and one
    all-reduce (a sum with one non-zero term, exact) over the mesh dims that
    shard the table gives every rank its rows, in ``ids``'s batch
    placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = table.device_mesh
    vocab = [p == Shard(0) for p in table.placements]
    rows = tuple(Replicate() if v else p for v, p in zip(vocab, ids.placements))
    if tuple(ids.placements) != rows:
        ids = ids.redistribute(mesh, rows)
    local, mine_ids = table.to_local(), ids.to_local()
    v0 = compute_local_shape_and_global_offset(table.shape, mesh, table.placements)[1][0]
    rel = mine_ids - v0
    held = (rel >= 0) & (rel < local.shape[0])
    got = torch.where(held[..., None], local[rel.clamp(0, max(local.shape[0] - 1, 0))], 0)
    shape = (*ids.shape, table.shape[1])
    pending = tuple(Partial("sum") if v else p for v, p in zip(vocab, rows))
    return DTensor.from_local(got, mesh, pending, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride()
                              ).redistribute(mesh, rows)


def batch_only(x):
    """``x`` unchanged, or, for a DTensor, ``x`` sharded on its leading
    (batch) dim where it is and replicated on every other mesh dim (a
    pending partial sum reduced).  The plain attention's einsums flatten
    [B, Hkv, G] into one batch dim, which DTensor refuses when a dim after
    the first is sharded (torch 2.11: "Attempted to flatten multiple
    dimensions, with dimension 1 being sharded")."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def whole(x):
    """``x`` unchanged, or, for a DTensor, the whole tensor as a plain tensor
    on every rank (a shard all-gathered, a pending partial sum reduced):
    MoE's [tokens, k] routing ids, where DTensor's index rules fail on a
    sharded dim."""
    return x.full_tensor() if is_dtensor(x) else x


def replicate_dim(x, dim: int, parts: int):
    """``x`` unchanged, or, for a DTensor whose dim ``dim`` is sharded over
    mesh axes whose sizes' product does not divide ``parts``, ``x``
    redistributed with that dim replicated along those axes.  DTensor
    cannot split a dim into ``parts`` groups unless each shard holds whole
    groups (the view of [..., H*hd] as [..., H, hd], GQA's Hq heads as
    [Hkv, G]), where XLA's partitioner reshards by itself."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim %= x.ndim
    mesh, pl = x.device_mesh, list(x.placements)
    over = [j for j, p in enumerate(pl) if isinstance(p, Shard) and p.dim == dim]
    if parts % math.prod(mesh.size(j) for j in over) == 0:
        return x
    for j in over:
        pl[j] = Replicate()
    return x.redistribute(mesh, tuple(pl))


def aligned(x, like):
    """``x`` redistributed to ``like``'s placements when both are DTensors
    on one mesh (and differ), else ``x``: the loss gathers its gold logits
    [B, blk, V] by labels [B, blk] row for row, where DTensor's rule for a
    gather from vocab-sharded or partial logits fails."""
    if not (is_dtensor(x) and is_dtensor(like)) or x.placements == like.placements:
        return x
    return x.redistribute(like.device_mesh, like.placements)


def pin(x):
    """``x``, and in the backward pass its gradient redistributed to ``x``'s
    placements (a DTensor redistribute to its own placements: the identity
    forward, a constraint on the cotangent, as ``with_sharding_constraint``
    constrains both).  Where a view merged dims in the forward pass, the
    gradient arriving at it must split them again (the same rule as
    :func:`replicate_dim`'s)."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, x.placements)


# ---------------------------------------------------------------------------
# Activation sharding policy (perf iteration 1 of the JAX package,
# EXPERIMENTS.md §Perf).
#
# With small-KV-head GQA archs (starcoder2 kv=4 vs model=16) GSPMD loses the
# batch sharding inside the attention layer and falls back to all-reducing
# full [B, T, D] f32 activations INSIDE the layer x KV-block loops (observed:
# 3 x 19.3 GB x 256 trips on starcoder2 train_4k).  Explicit constraints at
# block boundaries pin activations to (batch->data, heads->model-if-divisible)
# and cut per-device collective traffic by ~100x.  Here a constraint is a
# DTensor ``redistribute`` to the policy's placements.
# ---------------------------------------------------------------------------

_ACT_POLICY: dict = {}


def set_activation_policy(*, dp, tp: str = "model", tp_size: int = 0):
    """Enable activation constraints: a DTensor activation is redistributed
    on its own mesh (a plain tensor passes unchanged)."""
    _ACT_POLICY.update(dp=dp, tp=tp, tp_size=tp_size)


def clear_activation_policy():
    _ACT_POLICY.clear()


def _constrain(x, spec: Spec):
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def constrain_btd(x):
    """[B, T, D] residual-stream activations: batch over data."""
    if not _ACT_POLICY:
        return x
    return _constrain(x, (_ACT_POLICY["dp"], None, None))


def constrain_bthd(x, n_heads: int):
    """[B, T, H, hd] head-major activations: heads over model if divisible."""
    if not _ACT_POLICY:
        return x
    tp = _ACT_POLICY["tp"] if _ACT_POLICY["tp_size"] and n_heads % _ACT_POLICY["tp_size"] == 0 \
        else None
    return _constrain(x, (_ACT_POLICY["dp"], None, tp, None))
