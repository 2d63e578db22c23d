"""GPipe-style pipeline parallelism over point-to-point sends, the port of
``src/repro/distributed/pipeline.py``.

A ``stage`` mesh axis runs layer groups as pipeline stages; microbatches
stream through with the classic (M + S - 1)-tick schedule.  Each rank holds
only its stage's weights; activations hop stage -> stage with
``torch.distributed`` sends and receives (the counterpart of ``ppermute``:
point-to-point, no broadcast traffic), and the last stage's outputs are
broadcast to the stage group at the end (JAX returns them as one global
array).

This is the third parallelism dimension for the 1000+-node regime (e.g.
(pp=4, data=8, model=16) x pods); it is exercised by the tests on small
meshes and, with one stage, on the card.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.sharding import is_dtensor


def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _own_stage(a, me: int):
    """This rank's slice of a leaf with a leading [S] stage axis: a whole
    stack's row ``me``, or a DTensor sharded over the stage axis's local
    [1, ...] row."""
    if is_dtensor(a):
        local = a.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"a stage-sharded leaf holds {local.shape[0]} stages on one rank")
        return local[0]
    return a[me]


def pipeline_apply(
    stage_fn: Callable,     # (stage_params, x [mb, ...]) -> y [mb, ...]
    stage_params,           # tree, leaves with leading [S] stage axis
    x: torch.Tensor,        # [M, mb, ...] microbatched input (stage-0 feed)
    mesh,
    *,
    axis: str = "stage",
) -> torch.Tensor:
    """Returns the last stage's outputs [M, mb, ...] on every rank of the
    stage group.  Stage 0 injects microbatch ``min(t, M - 1)`` at tick t;
    stage s works on microbatch t - s, which counts when 0 <= t - s < M
    (ticks outside that window compute nothing: JAX computes and masks
    them, with the same result)."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    S = mesh.size(tuple(mesh.mesh_dim_names).index(axis))
    me = mesh.get_local_rank(axis)
    M = x.shape[0]
    params = _map(lambda a: _own_stage(a, me), stage_params)
    nxt = dist.get_global_rank(group, me + 1) if me < S - 1 else None
    prv = dist.get_global_rank(group, me - 1) if me > 0 else None

    buf = torch.zeros_like(x[0])             # activation entering this stage
    outs = torch.zeros_like(x)
    for t in range(M + S - 1):
        mb = t - me
        valid = 0 <= mb < M
        if valid:
            y = stage_fn(params, x[min(t, M - 1)] if me == 0 else buf)
            if me == S - 1:
                outs[mb] = y.to(outs.dtype)
        else:
            y = torch.zeros_like(buf)
        # Shift activations to the next stage (the last stage's go nowhere:
        # JAX's ring sends them to stage 0, which reads its own input).
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group))
        if prv is not None:
            buf = torch.empty_like(buf)
            ops.append(dist.P2POp(dist.irecv, buf, prv, group))
        for req in dist.batch_isend_irecv(ops) if ops else []:
            req.wait()
    if S > 1:
        dist.broadcast(outs, src=dist.get_global_rank(group, S - 1), group=group)
    return outs


def split_layers_into_stages(stacked_layer_params, num_stages: int):
    """[L, ...] layer stack -> [S, L/S, ...] stage-major stack."""
    def reshape(a):
        L = a.shape[0]
        assert L % num_stages == 0, (L, num_stages)
        return a.reshape((num_stages, L // num_stages) + tuple(a.shape[1:]))
    return _map(reshape, stacked_layer_params)
