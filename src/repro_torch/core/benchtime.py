"""Wall-clock measurement for the port's benchmarks.

:func:`measure` keeps the contract of the JAX package's
``src/repro/core/benchtime.py``:

1. **Asynchronous launches**: CUDA work returns before the card finishes, so
   every rep ends in ``torch.cuda.synchronize()`` inside its timed window.
2. **Warm-up**: the warm-up calls (which may build kernels) are synchronised
   too, so their work cannot overlap the first timed rep.
3. **Min of N**: wall-time noise is one-sided, so the point statistic is the
   minimum over reps, reported with the spread.

:func:`device_metadata` stamps what a row was measured on.
"""
from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Any, Callable, Tuple

import torch

SCHEMA_VERSION = 2


def block(x: Any) -> Any:
    """Wait for the card to finish all queued work; returns ``x``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return x


@dataclasses.dataclass(frozen=True)
class Measurement:
    """Synchronised per-rep wall times (seconds, run order) + the last result."""

    times_s: Tuple[float, ...]
    result: Any = None

    @property
    def best_s(self) -> float:
        return min(self.times_s)

    @property
    def mean_s(self) -> float:
        return sum(self.times_s) / len(self.times_s)

    @property
    def spread_frac(self) -> float:
        """(max - min) / min — 0 for a perfectly stable measurement."""
        lo = self.best_s
        return (max(self.times_s) - lo) / lo if lo > 0 else 0.0

    @property
    def best_us(self) -> float:
        return self.best_s * 1e6


def measure(fn: Callable, *args, reps: int = 5, warmup: int = 1,
            **kwargs) -> Measurement:
    """Min-of-``reps`` wall-clock timing of ``fn(*args, **kwargs)``, each rep
    and each warm-up call ending in a device synchronise."""
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    for _ in range(warmup):
        block(fn(*args, **kwargs))
    times, res = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        res = block(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return Measurement(times_s=tuple(times), result=res)


def nvidia_smi_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` for
    card 0, e.g. ``"NVIDIA H100 80GB HBM3, 700.00 W"``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_metadata() -> dict:
    """Schema stamp for a recorded benchmark row: what it was measured on.
    Raises when there is no card: a measurement never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_metadata: no CUDA device; device numbers "
                           "come only from a run on the card")
    return {
        "schema_version": SCHEMA_VERSION,
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi_name_power(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
