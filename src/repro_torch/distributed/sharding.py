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

Where DTensor's own rules would gather a whole batch, a whole vocabulary or
every head onto each rank (they price only their inputs' redistribution),
the models compute on each rank's shards and place the result themselves:
:func:`tp_product` (the Megatron column- and row-parallel products after
the FSDP gather), :class:`VocabShards` (the vocab-parallel loss),
:func:`shard_heads` (attention over each rank's heads),
:func:`on_batch_and_heads` (the scans), :class:`HeadShards` (the Mamba2
block on each rank's heads) and :func:`gather_rows` (the vocab-parallel
embedding lookup).  Each is the identity on plain tensors
and runs the single-device ops on a one-rank mesh.
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


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``, for
    ``DTensor.from_local``; computed, not read off an empty tensor, which
    would be a whole global-shape tensor on a meta-device trace."""
    stride, step = [], 1
    for n in reversed(tuple(shape)):
        stride.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(stride))


def gather_rows(table, ids):
    """``table[ids]`` (an embedding lookup), the rows in ``ids``'s
    placements.

    A DTensor table is read shard-locally (:func:`_vocab_parallel_rows`):
    a train-mode table (V over ``model``, D over the data axes) first has
    its D dim gathered (the FSDP all-gather GSPMD makes), and each rank then
    looks its own tokens up in its own rows.  DTensor's rules would
    all-gather the whole table (serve layout) or look the whole batch up
    and move the rows to ``ids``'s placements (train layout: the whole
    batch's [B, T, D] rows on every rank where the mesh has no
    all-to-all); ``F.embedding`` fails on the train layout in both versions
    (an ``IndexError``), and the lookup's backward (an ``index_put``) on
    sharded ids in torch 2.11 ("Shard dim -1 in placements ... must be
    normalized")."""
    if not (is_dtensor(table) and is_dtensor(ids)):
        return table[ids]
    from torch.distributed.tensor import Replicate, Shard

    if any(isinstance(p, Shard) and p.dim % table.ndim == 1 for p in table.placements):
        table = table.redistribute(table.device_mesh, tuple(
            Replicate() if isinstance(p, Shard) and p.dim % table.ndim == 1 else p
            for p in table.placements))
    if all(isinstance(p, Replicate) or p == Shard(0) for p in table.placements):
        return _vocab_parallel_rows(table, ids)
    whole = ids.redistribute(ids.device_mesh, (Replicate(),) * ids.device_mesh.ndim)
    return aligned(table[whole], ids)


def _vocab_parallel_rows(table, ids):
    """``table[ids]`` for a table sharded on dim 0 only (or replicated):
    each rank looks the ids up in its own rows (zeros for ids it does not
    hold), and one all-reduce (a sum with one non-zero term, exact) over the
    mesh dims that shard the table gives every rank its rows, in ``ids``'s
    batch placements.  The table's gradient returns as each rank's partial
    sum over the mesh dims that shard the ids."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = table.device_mesh
    vocab = [p == Shard(0) for p in table.placements]
    rows = tuple(Replicate() if v else p for v, p in zip(vocab, ids.placements))
    if tuple(ids.placements) != rows:
        ids = ids.redistribute(mesh, rows)
    local = table.to_local(grad_placements=tuple(
        Shard(0) if v else Partial() if isinstance(r, Shard) else Replicate()
        for v, r in zip(vocab, rows)))
    mine_ids = ids.to_local()
    v0 = compute_local_shape_and_global_offset(table.shape, mesh, table.placements)[1][0]
    rel = mine_ids - v0
    held = (rel >= 0) & (rel < local.shape[0])
    got = torch.where(held[..., None], local[rel.clamp(0, max(local.shape[0] - 1, 0))], 0)
    shape = (*ids.shape, table.shape[1])
    pending = tuple(Partial("sum") if v else p for v, p in zip(vocab, rows))
    return DTensor.from_local(got, mesh, pending, run_check=False, shape=shape,
                              stride=contiguous_stride(shape)
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


def _fsdp(w):
    """``w`` unchanged, or, for a DTensor weight with a dim sharded over the
    data axes (train mode's FSDP), ``w`` with that dim gathered and its
    shards over ``model`` kept: the FSDP all-gather GSPMD makes before a
    product (its backward a reduce-scatter of the gradient).  DTensor's own
    rule for ``x @ w`` with x's batch over the data axes instead shards the
    contraction and all-reduces the whole [B/data, T, d_out] product over
    ``model`` (it prices only the inputs' redistribution)."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(w.device_mesh.mesh_dim_names or ())
    want = tuple(Replicate() if isinstance(p, Shard) and names[j] in ("pod", "data") else p
                 for j, p in enumerate(w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def tp_product(x, w):
    """``x @ w`` for a weight ``w`` [d_in, d_out] (``x`` [..., d_in]).

    For a DTensor weight the product runs on each rank's shards by the
    Megatron rules, after :func:`_fsdp` gathers the weight's data-axes dims:
    over a mesh dim that shards d_out (column-parallel) ``x`` is whole and
    the output sharded on its last dim; over one that shards d_in
    (row-parallel) ``x`` is sharded on its last dim and the output's
    partial sums are all-reduced; over any other dim ``x`` keeps its batch
    shard (or stays replicated) and the output follows it.  (A pending sum
    left to the next op can reach a norm's mean, whose ``Partial("avg")``
    DTensor cannot take a gradient back into.)  The gradients return in the
    matching layouts (partial sums where a dim was contracted).  DTensor's
    own rules may instead shard the contraction where ``x`` is replicated,
    or gather an operand in the backward pass, and each leaves a product
    larger than the rank's share: they price only the inputs'
    redistribution.  Plain weights multiply as they are."""
    if not is_dtensor(w):
        return x @ w
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    w = _fsdp(w)
    mesh, last = w.device_mesh, x.ndim - 1
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    x_pl, out_pl, gx_pl, gw_pl = [], [], [], []
    for pw, px in zip(w.placements, x.placements):
        if pw == Shard(1):                      # column-parallel
            x_pl.append(Replicate()), out_pl.append(Shard(last))
            gx_pl.append(Partial()), gw_pl.append(Shard(1))
        elif pw == Shard(0):                    # row-parallel
            x_pl.append(Shard(last)), out_pl.append(Partial())
            gx_pl.append(Shard(last)), gw_pl.append(Shard(0))
        else:
            keep = Shard(0) if px == Shard(0) else Replicate()
            x_pl.append(keep), out_pl.append(keep)
            gx_pl.append(keep), gw_pl.append(Partial() if keep == Shard(0) else Replicate())
    if tuple(x.placements) != tuple(x_pl):
        x = x.redistribute(mesh, tuple(x_pl))
    out = x.to_local(grad_placements=gx_pl) @ w.to_local(grad_placements=gw_pl)
    shape = (*x.shape[:-1], w.shape[1])
    out = DTensor.from_local(out, mesh, tuple(out_pl), run_check=False, shape=shape,
                             stride=contiguous_stride(shape))
    if any(p.is_partial() for p in out_pl):
        out = out.redistribute(mesh, tuple(Replicate() if p.is_partial() else p
                                           for p in out_pl))
    return out


def on_batch_and_heads(fn, args, dims, out_dims):
    """``fn(*args)``, for DTensor ``args`` on each rank's shards: a scan or
    other op whose batch rows and heads are independent.  ``dims`` gives
    each arg's (batch dim, head dim), None where it has none; ``out_dims``
    the same for each of ``fn``'s outputs.  The first arg with both sets
    the split: its batch where it is sharded over a mesh dim, its heads
    where they are, every other mesh dim replicated.  Each rank runs ``fn``
    on its rows and heads (an arg without a batch or head dim whole on that
    mesh dim, its gradient returned as a partial sum there), and the
    outputs are placed as the split says.  DTensor would otherwise dispatch
    each of the scan's many small ops (its propagation costs each one
    milliseconds on a 16x16 mesh).  Plain args: ``fn(*args)``."""
    ref = next(a for a, d in zip(args, dims) if d == (0, 1))
    if not is_dtensor(ref):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = ref.device_mesh
    role = ["b" if p == Shard(0) else "h" if p == Shard(1) else None for p in ref.placements]
    B, H = ref.shape[0], ref.shape[1]

    def pl(d, grad: bool):
        out = []
        for r in role:
            i = None if r is None else d[0] if r == "b" else d[1]
            out.append(Replicate() if r is None else Shard(i) if i is not None
                       else Partial() if grad else Replicate())
        return tuple(out)

    local = []
    for a, d in zip(args, dims):
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, (Replicate(),) * mesh.ndim, run_check=False)
        if tuple(a.placements) != pl(d, False):
            a = a.redistribute(mesh, pl(d, False))
        local.append(a.to_local(grad_placements=pl(d, True)))
    outs = []
    for o, d in zip(fn(*local), out_dims):
        shape = list(o.shape)
        if d[0] is not None:
            shape[d[0]] = B
        if d[1] is not None:
            shape[d[1]] = H
        outs.append(DTensor.from_local(o, mesh, pl(d, False), run_check=False,
                                       shape=tuple(shape), stride=contiguous_stride(shape)))
    return tuple(outs)


def shard_heads(x):
    """``x`` unchanged, or, for a DTensor [B, T, H, hd], ``x`` with its batch
    where it is sharded (dim 0) and its heads sharded over every other mesh
    dim, unevenly where the dims' sizes do not divide H (DTensor chunks a
    dim): each rank then norms, rotates and attends only its own heads
    (:func:`repro_torch.models.attention.attend`).  Replicated heads go
    there by a local chunk."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard

    want = tuple(p if isinstance(p, Shard) and p.dim == 0 else Shard(2) for p in x.placements)
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


class VocabShards:
    """The rank-local operands of an unembedding ``hidden @ head`` (hidden
    [B, ..., D], head [D, V]) with the vocabulary kept sharded, and the
    collectives that reduce over it.

    For a DTensor head the head is gathered on D (the FSDP all-gather GSPMD
    makes) and keeps V where it is (over ``model``), and ``hidden`` keeps
    its batch over every other mesh dim (the data axes) and is replicated
    over the vocabulary's: a rank-local product is then the rank's
    [B/data, ..., V/model] block of the logits, with no other collective.
    ``hidden`` and ``head`` are those local tensors; their gradients return
    as partial sums (``hidden`` over the vocabulary's mesh dims, ``head``
    over the batch's), which DTensor reduces.  ``offset`` is the global
    index of the rank's first vocabulary column.  For plain tensors every
    collective is the identity and the operands are the tensors given.
    """

    def __init__(self, hidden: torch.Tensor, head: torch.Tensor):
        self.hidden, self.head, self.offset = hidden, head, 0
        self.mesh, self.vocab_dims, self.batch_dims = None, (), ()
        if not is_dtensor(head):
            return
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        mesh = self.mesh = head.device_mesh
        vocab = [isinstance(p, Shard) and p.dim % head.ndim == 1 for p in head.placements]
        self.vocab_dims = tuple(j for j, v in enumerate(vocab) if v)
        self.batch_dims = tuple(j for j, v in enumerate(vocab) if not v)
        head_pl = tuple(Shard(1) if v else Replicate() for v in vocab)
        self._rows = tuple(Replicate() if v else Shard(0) for v in vocab)
        if not is_dtensor(hidden):
            hidden = DTensor.from_local(hidden, mesh, (Replicate(),) * mesh.ndim,
                                        run_check=False)
        self.hidden = hidden.redistribute(mesh, self._rows).to_local(
            grad_placements=tuple(Partial() if v else Shard(0) for v in vocab))
        self.head = head.redistribute(mesh, head_pl).to_local(
            grad_placements=tuple(Shard(1) if v else Partial() for v in vocab))
        self.offset = compute_local_shape_and_global_offset(head.shape, mesh, head_pl)[1][1]

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows (leading dim) of ``x`` (a DTensor or a whole
        tensor), those of ``hidden``: the labels of its tokens."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor, Replicate

        if not is_dtensor(x):
            x = DTensor.from_local(x, self.mesh, (Replicate(),) * self.mesh.ndim,
                                   run_check=False)
        return x.redistribute(self.mesh, self._rows).to_local()

    def gold(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """``logits[..., labels]`` where the rank holds the label's column,
        else 0 (a −1 label gives 0 everywhere): summed over the vocabulary
        (:meth:`sum_vocab`) it is the gold logit."""
        rel = labels.long() - self.offset
        held = (rel >= 0) & (rel < logits.shape[-1])
        got = logits.gather(-1, rel.clamp(0, max(logits.shape[-1] - 1, 0))[..., None])[..., 0]
        return torch.where(held, got, torch.zeros((), dtype=got.dtype, device=got.device))

    def max_vocab(self, x: torch.Tensor) -> torch.Tensor:
        """The max of ``x`` over the vocabulary's mesh dims; no gradient."""
        return _all_reduce(x.detach(), "max", self.mesh, self.vocab_dims)

    def sum_vocab(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the vocabulary's mesh dims; the gradient
        passes through (each rank's result is used alike, as a replicated
        value)."""
        return _SumOver.apply(x, self.mesh, self.vocab_dims)

    def sum_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the batch's mesh dims, as :meth:`sum_vocab`."""
        return _SumOver.apply(x, self.mesh, self.batch_dims)

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, the same value on every rank, as a replicated DTensor
        (plain ``x`` unchanged), so that a sum with a DTensor term (MoE's
        aux loss) hands the gradient back to the rank-local graph as a
        plain tensor."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor, Replicate

        return DTensor.from_local(x, self.mesh, (Replicate(),) * self.mesh.ndim,
                                  run_check=False)


class HeadShards:
    """A rank's share of a block's H heads, for a block computed on plain
    local tensors between two DTensor activations (the Mamba2 block: its
    ``in_proj`` output is laid out [z | x | B | C | dt], so a column shard
    of it falls on no head boundary, and DTensor would replicate it).

    ``x`` ([B, ..., D], a DTensor) keeps its batch where it is sharded
    (dim 0); every other mesh dim splits the heads, ranks in mesh order,
    ``ceil(H / parts)`` a rank (the last ranks may hold fewer, or none).
    ``lo:hi`` are the rank's heads, :meth:`rows` its rows of ``x``,
    :meth:`weight` hands out a whole parameter, :meth:`sum_heads` and
    :meth:`place` reduce over the heads' mesh dims.  Every gradient returns
    as a partial sum where the rank saw only part of the work.  The object
    holds no tensor, so a checkpointed function may take it as an
    argument."""

    def __init__(self, x, H: int):
        from torch.distributed.tensor import Partial, Replicate, Shard

        self.mesh, self.shape = x.device_mesh, tuple(x.shape)
        x = batch_only(x)
        batch = [p == Shard(0) for p in x.placements]
        self.head_dims = tuple(j for j, b in enumerate(batch) if not b)
        coord, idx, parts = self.mesh.get_coordinate(), 0, 1
        for j in self.head_dims:
            idx, parts = idx * self.mesh.size(j) + coord[j], parts * self.mesh.size(j)
        per = -(-H // parts)
        self.lo = min(idx * per, H)
        self.hi = min(self.lo + per, H)
        self._partial = tuple(Shard(0) if b else Partial() for b in batch)
        self._summed = tuple(Shard(0) if b else Replicate() for b in batch)

    def rows(self, x) -> torch.Tensor:
        """The rank's rows of the DTensor ``x`` (the one this was made from),
        its gradient a partial sum over the heads' mesh dims."""
        return batch_only(x).to_local(grad_placements=self._partial)

    def weight(self, w):
        """The whole of parameter ``w`` as a plain tensor on every rank (its
        shards all-gathered), its gradient a partial sum on every mesh dim."""
        if not is_dtensor(w):
            return w
        from torch.distributed.tensor import Partial, Replicate

        n = w.device_mesh.ndim
        return w.redistribute(w.device_mesh, (Replicate(),) * n).to_local(
            grad_placements=(Partial(),) * n)

    def sum_heads(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the rank-local ``x`` over the heads' mesh dims; its
        gradient summed alike, since each rank uses the sum differently."""
        return _AllReduceSum.apply(x, self.mesh, self.head_dims)

    def place(self, out: torch.Tensor):
        """The rank-local ``out`` [B/data, ..., D], a partial sum over the
        heads' mesh dims, summed and placed as ``x`` was: rows where they
        were, replicated over the heads' dims (row-parallel ``out_proj``)."""
        from torch.distributed.tensor import DTensor

        shape = (self.shape[0], *out.shape[1:])
        return DTensor.from_local(out, self.mesh, self._partial, run_check=False, shape=shape,
                                  stride=contiguous_stride(shape)
                                  ).redistribute(self.mesh, self._summed)


def _all_reduce(x: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    """``x`` reduced by ``op`` over each of ``mesh``'s dims ``dims`` in turn
    (functional collectives, which the dry run's trace counts)."""
    if not dims:
        return x
    import torch.distributed._functional_collectives as funcol

    for d in dims:
        x = funcol.all_reduce(x, op, (mesh, d))
        if isinstance(x, funcol.AsyncCollectiveTensor):
            x = x.wait()
    return x


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) in the forward pass, the identity in the backward
    pass: every rank of the group goes on with the same sum, so the
    gradient each rank receives is already the sum's."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        return _all_reduce(x, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _AllReduceSum(torch.autograd.Function):
    """All-reduce (sum) in both passes: each rank goes on with the sum in a
    computation of its own, so the sum's gradient is the sum of the
    ranks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return _all_reduce(x, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous(), "sum", ctx.mesh, ctx.dims), None, None


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
