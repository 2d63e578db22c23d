"""Golden hit counts for the port's figure sweeps, computed by the JAX package.

Not a test module (pytest does not collect it).  Run from the repository root

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden.py

to rewrite ``tests/data/torch_golden_sweeps.json``: for the full-size Fig 10
and Fig 4 sweeps of the four index workloads, each workload's access count and
the sha256 of its ``lines.tobytes()``, and per (config, structure) the hit
count over the whole stream and after warm-up.  ``chip_smoke.py`` reads the
file on the card, without JAX; ``tests/test_torch_golden.py`` recomputes the
small ``hash_table`` entries so the file cannot drift from the reference.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import sys
import time

import numpy as np

from repro.core import traces
from repro.core.sparta import TLBConfig
from repro.core.sweep import TLBSweepSpec, sweep_system, sweep_tlb
from repro.core.tlbsim import SystemSimConfig

GOLDEN = pathlib.Path(__file__).resolve().parent / "data" / "torch_golden_sweeps.json"

W4 = ("bst_external", "bst_internal", "hash_table", "skip_list")
WARMUP_FRAC = 0.25
FOOTPRINT_BYTES = 128 << 30
MAX_ACCESSES = 1_400_000

# The figure drivers' own tables (benchmarks/fig10_performance.py and
# benchmarks/fig4_tlb_sensitivity.py), repeated so this helper needs only the
# package; tests/test_torch_golden.py holds them equal to the drivers'.
FIG10_N_OPS = 25_000
FIG10_CACHE = TLBConfig(entries=256, ways=4)
FIG10_ACCEL_TLB = TLBConfig(entries=128, ways=4)
FIG10_MEM_TLB = TLBConfig(entries=128, ways=4)
FIG10_CONFIGS = (
    ("conv-4K", 1, 12, "conventional"),
    ("conv-2M", 1, 21, "conventional"),
    ("sparta8-4K", 8, 12, "sparta"),
    ("sparta8-2M", 8, 21, "sparta"),
    ("sparta32-4K", 32, 12, "sparta"),
    ("sparta32-2M", 32, 21, "sparta"),
    ("sparta128-2M", 128, 21, "sparta"),
    ("dipta", 1, 12, "dipta"),
    ("ideal", 1, 12, "ideal"),
)
FIG4_N_OPS = 40_000
FIG4_SIZES = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
FIG4_CONFIGS = (
    ("conv-4K", 1, 12),
    ("conv-2M", 1, 21),
    ("sparta4-4K", 4, 12),
    ("sparta4-2M", 4, 21),
    ("sparta128-4K", 128, 12),
    ("sparta128-2M", 128, 21),
)


def fig10_system_configs():
    return [
        SystemSimConfig(
            cache=FIG10_CACHE,
            accel_tlb=FIG10_ACCEL_TLB if design == "conventional" else None,
            mem_tlb=FIG10_MEM_TLB, num_partitions=parts, page_shift=shift,
            accel_probe_on_miss_only=True)
        for _, parts, shift, design in FIG10_CONFIGS
    ]


def fig4_specs():
    return [
        TLBSweepSpec(TLBConfig(entries=int(s), ways=4),
                     num_partitions=parts, page_shift=shift)
        for _, parts, shift in FIG4_CONFIGS
        for s in FIG4_SIZES
    ]


def trace_lines(workload: str, n_ops: int) -> np.ndarray:
    return traces.generate(workload, n_ops=n_ops, seed=0,
                           footprint_bytes=FOOTPRINT_BYTES,
                           max_accesses=MAX_ACCESSES).lines


def _counts(hits: np.ndarray, n0: int) -> list:
    """[hits over the whole stream, hits after warm-up] per row of ``hits``."""
    return [[int(h.sum()), int(h[n0:].sum())] for h in hits]


def _trace_header(lines: np.ndarray) -> dict:
    return {"num_accesses": int(lines.shape[0]),
            "sha256": hashlib.sha256(lines.tobytes()).hexdigest()}


def fig10_entry(workload: str, n_ops: int = FIG10_N_OPS) -> dict:
    lines = trace_lines(workload, n_ops)
    ev = sweep_system(lines, fig10_system_configs(), kernel_mode="reference")
    n0 = int(lines.shape[0] * WARMUP_FRAC)
    return {**_trace_header(lines),
            "cache": _counts(ev.cache_hit, n0),
            "accel": _counts(ev.accel_tlb_hit, n0),
            "mem": _counts(ev.mem_tlb_hit, n0)}


def fig4_entry(workload: str, n_ops: int = FIG4_N_OPS) -> dict:
    lines = trace_lines(workload, n_ops)
    res = sweep_tlb(lines, fig4_specs())  # JAX "auto": the stack-distance engine
    n0 = int(lines.shape[0] * WARMUP_FRAC)
    return {**_trace_header(lines), "tlb": _counts(res.hits, n0)}


def main() -> None:
    out = {
        "warmup_frac": WARMUP_FRAC,
        "fig10": {"n_ops": FIG10_N_OPS, "configs": [c[0] for c in FIG10_CONFIGS],
                  "workloads": {}},
        "fig4": {"n_ops": FIG4_N_OPS,
                 "specs": [[label, s] for label, *_ in FIG4_CONFIGS for s in FIG4_SIZES],
                 "workloads": {}},
    }
    for fig, entry in (("fig10", fig10_entry), ("fig4", fig4_entry)):
        for w in W4:
            t0 = time.perf_counter()
            out[fig]["workloads"][w] = entry(w)
            print(f"{fig} {w}: {out[fig]['workloads'][w]['num_accesses']} accesses "
                  f"in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
