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
