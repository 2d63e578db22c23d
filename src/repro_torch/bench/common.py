"""Shared plumbing of the port's figure drivers: trace cache, CSV output,
claim checks and the device clock."""
from __future__ import annotations

import functools
import time
from typing import List

import torch

from repro_torch.core import traces
from repro_torch.kernels.common import as_device

GIB = 1 << 30

# Paper's four index workloads (Table 2).
W4 = ("bst_external", "bst_internal", "hash_table", "skip_list")


@functools.lru_cache(maxsize=16)
def trace(workload: str, *, n_ops: int = 40_000, seed: int = 0,
          footprint_bytes: int = 128 * GIB, max_accesses: int = 1_400_000):
    """One workload's trace, generated once per process for these arguments
    (the figure drivers' 128 GiB footprint and 1.4 M-access cap)."""
    return traces.generate(workload, n_ops=n_ops, seed=seed,
                           footprint_bytes=footprint_bytes,
                           max_accesses=max_accesses)


def synced_clock(device) -> float:
    """``time.perf_counter()`` after the card (if ``device`` is one) has
    finished all queued work."""
    if as_device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


class Claim:
    """A checked reproduction claim (paper §7), printed and returned."""

    def __init__(self, name: str, desc: str, value: float, band: tuple, unit: str = ""):
        self.name, self.desc, self.value, self.band, self.unit = name, desc, value, band, unit
        self.ok = band[0] <= value <= band[1]

    def row(self) -> dict:
        return {
            "claim": self.name, "description": self.desc,
            "value": self.value, "band": list(self.band),
            "unit": self.unit, "ok": self.ok,
        }

    def __str__(self):
        mark = "PASS" if self.ok else "MISS"
        return (f"[{mark}] {self.name}: {self.value:.3g}{self.unit} "
                f"(band {self.band[0]:.3g}..{self.band[1]:.3g}) — {self.desc}")


def print_csv(title: str, header: List[str], rows: List[list]):
    print(f"\n# {title}")
    print(",".join(header))
    for r in rows:
        print(",".join(f"{x:.4g}" if isinstance(x, float) else str(x) for x in r))
