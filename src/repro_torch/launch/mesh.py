"""Device meshes, the port of ``src/repro/launch/mesh.py``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` whose
``mesh_dim_names`` are the JAX package's axis names.  Its ranks are the
processes of one ``torch.distributed`` world: NCCL for ``"cuda"``, gloo for
``"cpu"``, never one in place of the other.  :func:`make_mesh` starts that
world when none exists: from torchrun's ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT`` where they are set, else as a one-rank
world on an in-process ``HashStore`` (no network port).  A caller that
starts its own world (a ``FileStore``, say, or the dry run's ``fake``
backend, whose collectives move nothing) calls
``torch.distributed.init_process_group`` first; :func:`make_mesh` then uses
it.  :func:`destroy` tears the world down.

NCCL gives each rank its own card, so one H100 holds a one-rank world and a
1 x 1 mesh; meshes of more ranks run here under gloo on the CPU.
"""
from __future__ import annotations

import math
import os
from typing import Sequence, Tuple, Union

import torch

from repro_torch.kernels.common import as_device

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_world(device: Union[str, torch.device] = "cuda") -> Tuple[int, int]:
    """Start the process group for ``device`` if none exists; returns
    (rank, world size).  On a CUDA device each rank takes card
    ``LOCAL_RANK`` (or its rank modulo the cards present) before the group
    starts, as NCCL needs.  An existing group of the other backend is an
    error, and so is an NCCL group that does not start."""
    import torch.distributed as dist

    dev = as_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        have = str(dist.get_backend())
        if backend not in have and have != "fake":   # the dry run's world: no data moves
            raise RuntimeError(f"a {have} process group exists; a {dev.type} mesh needs "
                               f"{backend}")
        return dist.get_rank(), dist.get_world_size()
    from_env = all(k in os.environ for k in _TORCHRUN_ENV)
    rank = int(os.environ["RANK"]) if from_env else 0
    kw = {}
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    if from_env:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    return dist.get_rank(), dist.get_world_size()


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: Union[str, torch.device] = "cuda"):
    """Arbitrary logical meshes for tests / elastic restarts: a
    ``DeviceMesh`` of ``shape`` named ``axes`` over the world's ranks in
    row-major order (the last axis fastest, as ``jax.make_mesh`` lays out
    devices).  The world must hold exactly ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    dev = as_device(device)
    _, world = init_world(dev)
    if math.prod(shape) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {math.prod(shape)} ranks; "
                         f"the world has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Union[str, torch.device] = "cuda"):
    """16x16 = 256 ranks/pod (data, model); 2x16x16 = 512 ranks multi-pod.

    The ``pod`` axis joins pods over the slower inter-pod network and is used
    only for data parallelism / hierarchical gradient reduction."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def destroy() -> None:
    """Tear down the process group, if one exists."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
