"""Elastic scaling: restart a job on a different rank count, the port of
``src/repro/runtime/elastic.py``.

Checkpoints are mesh-agnostic (numpy + manifest, the JAX package's layout),
so elasticity is a policy question: pick a new mesh factorisation for the
surviving ranks, rebuild the specs, and ``restore_resharded``.  The model
axis is kept fixed (TP degree is baked into kernel-efficiency choices); the
data (and pod) axes absorb the change.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    dropped_devices: int

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_remesh(available_devices: int, *, model_axis: int = 16,
                pod_size: Optional[int] = None) -> RemeshPlan:
    """Largest (data, model) mesh fitting the surviving ranks.

    E.g. 256 chips with 3 dead -> 253 available -> 15x16 = 240 used,
    13 idle spares (kept warm as replacements)."""
    if available_devices < model_axis:
        raise ValueError(f"need >= {model_axis} devices, have {available_devices}")
    data = available_devices // model_axis
    used = data * model_axis
    return RemeshPlan(shape=(data, model_axis), axes=("data", "model"),
                      dropped_devices=available_devices - used)


def elastic_restore(ckpt_root, cfg: ModelConfig, plan: RemeshPlan, template,
                    *, step: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda"):
    """Rebuild (params, opt_state) on the new mesh, ``plan.size`` ranks of
    the world (started here if none is).  ``template`` is
    ``{"params": module, "opt_state": init_state(module)}`` of plain
    tensors; it is filled from the checkpoint and placed by the training
    specs.  Returns (state, step, mesh)."""
    from repro_torch.checkpoint.checkpoint import restore_resharded

    mesh = make_mesh(plan.shape, plan.axes, device=device)
    multi_pod = "pod" in plan.axes
    pspecs = shd.param_specs(template["params"], cfg, mode="train", multi_pod=multi_pod)
    ospecs = shd.opt_state_specs(template["params"], cfg, multi_pod=multi_pod)
    tree, step = restore_resharded(
        ckpt_root, template, mesh, {"params": pspecs, "opt_state": ospecs}, step=step,
    )
    return tree, step, mesh
