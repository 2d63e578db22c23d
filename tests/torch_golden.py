"""Golden outputs for the port's figure sweeps, computed by the JAX package.

Not a test module (pytest does not collect it).  Run from the repository root

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden.py [--only sweeps|timeline]

to rewrite

* ``tests/data/torch_golden_sweeps.json``: for the full-size Fig 10 and Fig 4
  sweeps of the four index workloads, each workload's access count and the
  sha256 of its ``lines.tobytes()``, and per (config, structure) the hit
  count over the whole stream and after warm-up;
* ``tests/data/torch_golden_timeline.json``: for the full-size Fig 11 and
  Fig 5 drivers, the trace headers, per timeline spec its length, the sha256
  of its float32 latency / overhead / done bytes and its ``summary()``, the
  Fig 5 miss-ratio grid's hit counts, and the claim values.

``chip_smoke.py`` reads both files on the card, without JAX;
``tests/test_torch_golden.py`` recomputes small ``hash_table`` entries so the
files cannot drift from the reference.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys
import time

import numpy as np

from repro.core import timeline, traces
from repro.core.sparta import SystemLatencies, TLBConfig
from repro.core.sweep import TLBSweepSpec, sweep_system, sweep_tlb
from repro.core.tlbsim import SystemSimConfig

DATA = pathlib.Path(__file__).resolve().parent / "data"
GOLDEN = DATA / "torch_golden_sweeps.json"
GOLDEN_TIMELINE = DATA / "torch_golden_timeline.json"

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


# The timeline figures' tables (benchmarks/fig11_tail_latency.py and
# benchmarks/fig5_contention.py), repeated likewise.
FIG11_N_OPS = 8_000
FIG11_CAP = 400_000
FIG11_ACCELS = (1, 2, 4, 8, 16)
FIG11_CACHE = TLBConfig(entries=256, ways=4)
FIG11_ACCEL_TLB = TLBConfig(entries=128, ways=4)
FIG11_MEM_TLB = TLBConfig(entries=128, ways=4)
FIG11_PARTITIONS = 32
QUEUES = timeline.TimelineConfig(mshrs=8, tlb_ports=1, dram_banks=16)
FIG5_N_OPS = 12_000
FIG5_TL_CAP = 40_000
FIG5_MAX_ACCESSES = 1_200_000
FIG5_THREADS = (1, 2, 4, 8, 16)
FIG5_PARTS = (1, 4, 16, 64)
FIG5_TLB = TLBConfig(entries=128, ways=4)
FIG5_CACHE = TLBConfig(entries=256, ways=4)


def _f32_digest(x: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(x, dtype=np.float32).tobytes()).hexdigest()


def timeline_entry(res) -> dict:
    """One timeline spec's golden record."""
    return {"n": int(res.latency.shape[0]),
            "latency": _f32_digest(res.latency),
            "overhead": _f32_digest(res.overhead),
            "done": _f32_digest(res.done),
            "summary": res.summary()}


def fig11_system_configs():
    return [
        SystemSimConfig(cache=FIG11_CACHE, accel_tlb=FIG11_ACCEL_TLB,
                        mem_tlb=FIG11_MEM_TLB, num_partitions=1, page_shift=12),
        SystemSimConfig(cache=FIG11_CACHE, accel_tlb=None, mem_tlb=FIG11_MEM_TLB,
                        num_partitions=FIG11_PARTITIONS, page_shift=12),
    ]


def fig11_workload(workload: str, n_ops: int = FIG11_N_OPS, cap: int = FIG11_CAP,
                   accels=FIG11_ACCELS):
    """(interleaved lines, [TimelineSpec] in the driver's order) of one
    workload: per accel count, conventional then SPARTA-32."""
    inter = traces.interleave(
        traces.thread_traces(workload, accels[-1], n_ops=n_ops, seed=7))[:cap]
    evs = sweep_system(inter, fig11_system_configs(), kernel_mode="reference")
    specs = []
    for A in accels:
        ids = timeline.round_robin_accel_ids(inter.shape[0], A)
        specs.append(timeline.TimelineSpec(inter, evs[0], "conventional", cfg=QUEUES,
                                           num_accelerators=A, accel_ids=ids))
        specs.append(timeline.TimelineSpec(inter, evs[1], "sparta", cfg=QUEUES,
                                           num_partitions=FIG11_PARTITIONS,
                                           num_accelerators=A, accel_ids=ids))
    return inter, specs


def fig11_claims(p99_max: dict) -> dict:
    """C9a / C9b from the (conventional, SPARTA) p99 overhead per workload
    at the largest accelerator count, by the driver's rules."""
    wins = sum(1 for w in W4 if p99_max[w][1] < p99_max[w][0])
    red = [p99_max[w][0] / max(p99_max[w][1], 1e-9) for w in W4]
    return {"C9a": float(wins), "C9b": float(np.mean(red))}


def fig11_golden() -> dict:
    lat = SystemLatencies(n_sockets=8)
    headers, specs, spans = {}, [], {}
    for w in W4:
        inter, sp = fig11_workload(w)
        headers[w] = _trace_header(inter)
        spans[w] = (len(specs), len(specs) + len(sp))
        specs += sp
    res = timeline.sweep_timeline(specs, lat, kernel_mode="reference")
    out = {w: [timeline_entry(r) for r in res[a:b]] for w, (a, b) in spans.items()}
    p99_max = {w: (res[b - 2].overhead_percentile(99), res[b - 1].overhead_percentile(99))
               for w, (_, b) in spans.items()}
    return {"n_ops": FIG11_N_OPS, "cap": FIG11_CAP, "accels": list(FIG11_ACCELS),
            "specs": [[A, d] for A in FIG11_ACCELS for d in ("conventional", "sparta")],
            "traces": headers, "timeline": out, "claims": fig11_claims(p99_max)}


def fig5_interleaved(workload: str, threads: int, n_ops: int = FIG5_N_OPS) -> np.ndarray:
    return traces.interleave(
        traces.thread_traces(workload, threads, n_ops=n_ops, seed=7))[:FIG5_MAX_ACCESSES]


def fig5_specs():
    return [TLBSweepSpec(FIG5_TLB, num_partitions=p, page_shift=12) for p in FIG5_PARTS]


def fig5_grid_entry(workload: str, n_ops: int = FIG5_N_OPS) -> dict:
    """Per thread count: the trace header and per spec [hits, post-warm-up
    hits] (``sweep_tlb`` "auto", the stack-distance engine), plus the miss
    ratios the claims read."""
    out = {}
    for t in FIG5_THREADS:
        inter = fig5_interleaved(workload, t, n_ops)
        res = sweep_tlb(inter, fig5_specs())
        n0 = int(inter.shape[0] * WARMUP_FRAC)
        out[str(t)] = {**_trace_header(inter), "tlb": _counts(res.hits, n0),
                       "miss_ratios": [float(x) for x in res.miss_ratios]}
    return out


def fig5_timeline_entry(workload: str, n_ops: int = FIG5_N_OPS,
                        tl_cap: int = FIG5_TL_CAP) -> list:
    """The timeline half of one workload: SPARTA at 16 threads over the
    first ``tl_cap`` accesses, one record per partition count."""
    sl = fig5_interleaved(workload, FIG5_THREADS[-1], n_ops)[:tl_cap]
    evs = sweep_system(sl, [
        SystemSimConfig(cache=FIG5_CACHE, accel_tlb=None, mem_tlb=FIG5_TLB,
                        num_partitions=p, page_shift=12) for p in FIG5_PARTS],
        kernel_mode="reference")
    specs = [timeline.TimelineSpec(sl, evs[i], "sparta", cfg=QUEUES, num_partitions=p,
                                   num_accelerators=FIG5_THREADS[-1])
             for i, p in enumerate(FIG5_PARTS)]
    res = timeline.sweep_timeline(specs, SystemLatencies(n_sockets=8),
                                  kernel_mode="reference")
    return [timeline_entry(r) for r in res]


def fig5_claims(grid: dict) -> dict:
    """C3a / C3b from the grid's miss ratios, by the driver's rules."""
    def mr(w, p, t):
        return grid[w][str(t)]["miss_ratios"][FIG5_PARTS.index(p)]

    bumps = [mr(w, 1, 16) - mr(w, 1, 1) for w in W4]
    wins = sum(1 for w in W4 if mr(w, 16, 16) < mr(w, 1, 1))
    return {"C3a": float(np.mean(bumps)), "C3b": float(wins)}


def fig5_golden() -> dict:
    grid = {w: fig5_grid_entry(w) for w in W4}
    return {"n_ops": FIG5_N_OPS, "tl_cap": FIG5_TL_CAP, "threads": list(FIG5_THREADS),
            "parts": list(FIG5_PARTS), "grid": grid,
            "timeline": {w: fig5_timeline_entry(w) for w in W4},
            "claims": fig5_claims(grid)}


def _write(path: pathlib.Path, out: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1) + "\n")


def write_sweeps() -> None:
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
    _write(GOLDEN, out)


def write_timeline() -> None:
    out = {"warmup_frac": WARMUP_FRAC}
    for fig, make in (("fig11", fig11_golden), ("fig5", fig5_golden)):
        t0 = time.perf_counter()
        out[fig] = make()
        print(f"{fig} in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    _write(GOLDEN_TIMELINE, out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Write the port's golden files from JAX.")
    ap.add_argument("--only", choices=("sweeps", "timeline"),
                    help="write only this file (default: both)")
    args = ap.parse_args(argv)
    if args.only in (None, "sweeps"):
        write_sweeps()
    if args.only in (None, "timeline"):
        write_timeline()


if __name__ == "__main__":
    main()
