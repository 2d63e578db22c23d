"""Step factories, the port of ``src/repro/train/train_step.py``.

The training step differentiates ``models.loss_fn`` with
``torch.autograd.grad`` (nothing accumulates in ``.grad``), the counterpart
of ``jax.value_and_grad``, and applies :mod:`repro_torch.train.optimizer`'s
AdamW in place.  It runs ``kernel_mode="reference"`` by default, as the JAX
package does: the kernels have no backward pass and refuse autograd
(:func:`repro_torch.kernels.common.refuse_autograd`), and the plain
attention and scans are the training path in both packages.

The same step trains a sharded state: parameters, moments and batch as
DTensors (:mod:`repro_torch.distributed.sharding`), the counterpart of the
JAX step under ``jit`` with shardings.  It then runs under
``implicit_replication`` (a plain tensor the model makes, positions or a
mask, counts as replicated, as an unsharded constant does under GSPMD),
each gradient is redistributed to its parameter's placements (JAX's
``out_shardings``; the FSDP reduce-scatter), and the metrics come back as
plain tensors.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch
from torch import nn

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import is_dtensor, tp_product, whole
from repro_torch.train.optimizer import OptimizerConfig, apply_updates


def make_loss_fn(cfg: ModelConfig, *, kernel_mode: str = "reference",
                 remat: bool = True) -> Callable:
    """``loss_fn(params, batch) -> float32 scalar``."""
    def loss_fn(params, batch):
        return models.loss_fn(params, batch, cfg, kernel_mode=kernel_mode, remat=remat)
    return loss_fn


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: OptimizerConfig = OptimizerConfig(),
    *,
    kernel_mode: str = "reference",
    remat: bool = True,
    microbatches: int = 1,
    compress_grads: Callable | None = None,
) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``params`` (an ``nn.Module``, gradients turned on for it) and
    the moments are updated in place once every gradient exists, so a step
    that raises before then leaves them as they were.  ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr``, 0-d float32 tensors on the device
    (the step never waits for the card).

    ``microbatches`` > 1 splits the leading batch axis into that many
    contiguous parts, adds their gradients into float32 zeros and divides
    loss and gradients by the count.  ``compress_grads`` transforms the
    ``{name: grad}`` dict before the optimizer."""
    loss_fn = make_loss_fn(cfg, kernel_mode=kernel_mode, remat=remat)

    def value_and_grad(params: nn.Module, names, leaves, batch):
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # A parameter the loss does not reach gets zeros, as under jax.grad.
        return loss.detach(), {n: torch.zeros_like(p) if g is None else _placed_like(g, p)
                               for n, p, g in zip(names, leaves, grads)}

    def step(params: nn.Module, opt_state: Dict, batch: Dict):
        params.requires_grad_(True)
        names, leaves = zip(*params.named_parameters())
        if not _sharded(leaves):
            return _step(params, names, leaves, opt_state, batch)
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            params, opt_state, metrics = _step(params, names, leaves, opt_state, batch)
        return params, opt_state, {k: whole(v) for k, v in metrics.items()}

    def _step(params: nn.Module, names, leaves, opt_state: Dict, batch: Dict):
        if microbatches == 1:
            loss, grads = value_and_grad(params, names, leaves, batch)
        else:
            if any(x.shape[0] % microbatches for x in batch.values()):
                raise ValueError(f"batch {[tuple(x.shape) for x in batch.values()]} does not "
                                 f"split into {microbatches} microbatches")
            size = {k: x.shape[0] // microbatches for k, x in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            grads = {n: torch.zeros_like(p.detach(), dtype=torch.float32)
                     for n, p in zip(names, leaves)}
            for i in range(microbatches):
                mb = {k: x[i * size[k]:(i + 1) * size[k]] for k, x in batch.items()}
                loss_i, g_i = value_and_grad(params, names, leaves, mb)
                loss = loss + loss_i
                for n, g in g_i.items():
                    grads[n] += g
                del g_i
            loss = loss / microbatches
            for g in grads.values():
                g.div_(microbatches)
        if compress_grads is not None:
            grads = compress_grads(grads)
        params, opt_state, om = apply_updates(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return step


def _sharded(leaves) -> bool:
    return any(is_dtensor(p) for p in leaves)


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements; else ``g``."""
    if is_dtensor(g) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_prefill_step(cfg: ModelConfig, *, kernel_mode: str = "auto") -> Callable:
    """Inference prefill: ``step(params, batch) -> next-token logits [B, V]``
    of a prompt batch (``batch["tokens"]`` [B, T]) through the family's
    ``forward_hidden``: only the last position is unembedded, so the
    [B, T, V] logits are never built (the JAX package slices them from the
    whole product; the values agree up to the GEMM's rounding).  On DTensor
    parameters it runs under ``implicit_replication``, as the train step,
    and the logits come back with the batch over the data axes and V over
    ``model`` (:func:`sharding.tp_product`), the JAX dry run's
    ``P(dp, "model")``.  ``auto`` runs the kernels for data on the
    card (the JAX package defaults to ``reference`` here, its dry-run
    choice)."""
    def step(params, batch):
        scope = contextlib.nullcontext()
        if _sharded(list(params.parameters())):
            from torch.distributed.tensor.experimental import implicit_replication

            scope = implicit_replication()
        with scope:
            hidden, head, _ = models.forward_hidden(params, batch, cfg, kernel_mode=kernel_mode)
            return tp_product(hidden[:, -1], head)
    return step
