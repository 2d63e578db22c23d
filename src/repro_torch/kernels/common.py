"""Shared kernel-dispatch helpers.

Every kernel package exposes ``ops.py`` with public ops that take
``kernel_mode``:

* ``"reference"`` — the plain PyTorch version (``ref.py``).  It runs on any
                    device; on the card it is what ``chip_smoke.py`` holds the
                    kernels against.
* ``"cuda"``      — the hand-written CUDA kernel (``kernel.py`` +
                    ``csrc/*.cu``), on a CUDA device only.
* ``"auto"``      — ``"cuda"`` when the data lies on a CUDA device,
                    ``"reference"`` when it lies on the CPU.

The TLB sweep (:mod:`repro_torch.core.sweep`) accepts one extra mode,
``"stackdist"``, the exact stack-distance engine of
:mod:`repro_torch.core.stackdist`, and its ``"auto"`` may choose it.

There is no fallback from the card to the CPU: a CUDA device on a machine
without one raises.

The kernels have no autograd rule (``ctypes`` launches), so an op whose
kernel branch would take inputs that require a gradient while grad mode is
on raises (:func:`refuse_autograd`) instead of returning a result that no
gradient flows through; training runs ``kernel_mode="reference"``.

Each kernel's wrapper counts its launches in its module's ``launches`` and
in the calling thread's open :func:`launch_tally`, which is how the shard
scheduler's workers (threads or processes) report what they launched.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Sequence, Union

import torch

VALID_MODES = ("auto", "reference", "cuda")
SWEEP_MODES = VALID_MODES + ("stackdist",)


def as_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            f"pass device='cpu' to run the plain versions on the CPU")
    return dev


def resolve_mode(
    kernel_mode: str,
    device: Union[str, torch.device],
    *,
    valid: Sequence[str] = VALID_MODES,
) -> str:
    """Validate ``kernel_mode`` against ``valid`` and resolve ``"auto"`` for
    data on ``device``."""
    if kernel_mode not in valid:
        raise ValueError(f"kernel_mode={kernel_mode!r}; expected one of {tuple(valid)}")
    dev = as_device(device)
    if kernel_mode == "auto":
        return "cuda" if dev.type == "cuda" else "reference"
    if kernel_mode == "cuda" and dev.type != "cuda":
        raise ValueError(
            f"kernel_mode='cuda' needs data on a CUDA device, got device={str(dev)!r}")
    return kernel_mode


def refuse_autograd(op: str, kernel_mode: str, device: Union[str, torch.device],
                    *inputs) -> None:
    """Raise ``RuntimeError`` if ``kernel_mode`` would take ``op`` to its
    CUDA kernel (``"cuda"``, or ``"auto"`` with data on a CUDA device) while
    grad mode is on and any tensor of ``inputs`` requires a gradient.
    Called before the mode is resolved, so ``"cuda"`` on CPU tensors under
    autograd raises this and not the device error."""
    if kernel_mode == "reference" or not torch.is_grad_enabled():
        return
    if kernel_mode == "auto" and torch.device(device).type != "cuda":
        return
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{op}: the CUDA kernel has no backward pass, and its inputs require a "
            f"gradient (kernel_mode={kernel_mode!r} under autograd); the JAX package "
            f"cannot differentiate its Pallas kernels either.  Train with "
            f'kernel_mode="reference" (the default of make_train_step), or run the '
            f"kernel under torch.no_grad()")


_TALLY = threading.local()


@contextlib.contextmanager
def launch_tally() -> Iterator[Dict[str, int]]:
    """Count the kernel launches the calling thread makes inside the block:
    yields a dict, kernel name -> launches, filled as the wrappers launch.
    Tallies nest; the inner one counts alone while it is open."""
    outer = getattr(_TALLY, "counts", None)
    counts: Dict[str, int] = {}
    _TALLY.counts = counts
    try:
        yield counts
    finally:
        _TALLY.counts = outer


def note_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to the calling thread's open
    tally, if it has one (each wrapper calls this where it adds one to its
    module's ``launches``)."""
    counts = getattr(_TALLY, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + 1
