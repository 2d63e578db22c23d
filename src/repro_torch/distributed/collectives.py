"""Explicit collective schedules, the port of
``src/repro/distributed/collectives.py``.

``hierarchical_psum`` — the multi-pod gradient reduction: reduce-scatter
over the intra-pod axes, all-reduce the (1/N-sized) shards over the
inter-pod ``pod`` axis, all-gather back.  Inter-pod traffic per rank drops
from full-gradient to gradient/N_intra; combine with
:mod:`repro_torch.distributed.compression` for another 4-20x.  The
collectives are ``torch.distributed``'s ``reduce_scatter_tensor``,
``all_reduce`` and ``all_gather_into_tensor`` (the counterparts of
``psum_scatter``, ``psum`` and ``all_gather``) over the process groups of
the mesh's axes.

``local_dispatch_ep`` (the JAX package's plan for its next iteration,
EXPERIMENTS.md §Perf cell C; a plan, not code, in either package): the
landed MoE layer uses a *global* sort-based dispatch whose argsort +
scatter over the [T*K]-sharded assignment stream is the dominant collective
in every MoE train/prefill cell.  The fix keeps dispatch local-first:

  1. per data shard: top-k, LOCAL argsort by expert, LOCAL capacity rank
     (no cross-shard traffic at all);
  2. one ``all_to_all`` over the model axis moves each shard's per-expert
     slices to the expert owners ([tokens_local*K, D] bf16);
  3. expert FFN on local experts;
  4. reverse ``all_to_all`` + weighted combine (local scatter-add).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def _axis_group(mesh, axes: Sequence[str]):
    """(process group over the mesh axes ``axes`` jointly, its size): one
    axis's own group, or for several axes the group of the ranks that share
    every other coordinate, ordered row-major over ``axes``.  Every rank
    makes every such group, in one order, as ``new_group`` requires."""
    import torch.distributed as dist

    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0]), mesh.size(mesh.mesh_dim_names.index(axes[0]))
    names = tuple(mesh.mesh_dim_names)
    inner = [names.index(a) for a in axes]
    outer = [j for j in range(len(names)) if j not in inner]
    size = math.prod(mesh.size(j) for j in inner)
    ranks = mesh.mesh.permute(*outer, *inner).reshape(-1, size)
    me, mine = dist.get_rank(), None
    for row in ranks.tolist():
        g = dist.new_group(ranks=row)
        if me in row:
            mine = g
    return mine, size


def hierarchical_psum(mesh, *, intra_axes=("data",), inter_axis="pod"):
    """Returns f(grads)->grads performing RS(intra) -> AR(inter) -> AG(intra).

    ``grads`` is a tensor or a dict tree of this rank's tensors; the result
    is their sum over every rank of the ``intra_axes`` x ``inter_axis``
    sub-mesh, each leaf flattened, padded to a multiple of the intra size
    and un-padded.  Equivalent to a flat all-reduce over those axes but
    moves only 1/N_intra of the bytes over the inter-pod axis.  The groups
    are made here, once, on every rank (a collective call)."""
    import torch.distributed as dist

    if isinstance(intra_axes, str):
        intra_axes = (intra_axes,)
    intra, n = _axis_group(mesh, intra_axes)
    inter, _ = _axis_group(mesh, (inter_axis,))

    def one(g: torch.Tensor) -> torch.Tensor:
        flat = g.reshape(-1)
        pad = (-flat.numel()) % n
        if pad:
            flat = F.pad(flat, (0, pad))
        flat = flat.contiguous()
        shard = torch.empty(flat.numel() // n, dtype=flat.dtype, device=flat.device)
        dist.reduce_scatter_tensor(shard, flat, group=intra)
        dist.all_reduce(shard, group=inter)
        full = torch.empty_like(flat)
        dist.all_gather_into_tensor(full, shard, group=intra)
        return full[: g.numel()].reshape(g.shape)

    def reduce_tree(grads):
        if isinstance(grads, dict):
            return {k: reduce_tree(v) for k, v in grads.items()}
        return one(grads)

    return reduce_tree


def hierarchical_psum_shardmapped(mesh, grads_spec):
    """The variant for replicated-gradient trees.  In JAX it wraps
    :func:`hierarchical_psum` in ``shard_map`` (``in_specs=(grads_spec,)``,
    every device its own copy).  torch has no ``shard_map``: each rank
    already runs the function on its own tensors, so this returns
    :func:`hierarchical_psum`'s function itself; ``grads_spec`` (replicated
    specs) is accepted for the signature's sake."""
    del grads_spec
    return hierarchical_psum(mesh)

