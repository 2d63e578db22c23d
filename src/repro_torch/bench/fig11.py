"""Fig 11 (beyond-paper): translation-induced tail latency under contention.

The port of the JAX package's ``benchmarks/fig11_tail_latency.py`` (same
configs, trace sizes, spec order and claim bands).  The cycle-approximate
timeline engine (:mod:`repro_torch.core.timeline`) puts 1-16 accelerators on
the shared memory-side structures and measures the p50/p99 of the
*translation-induced* per-access latency (queue waits included) for
conventional vs SPARTA-32, with bounded MSHRs, one service port per partition
TLB and banked DRAM.

Each workload's stream is the interleave of one thread trace per accelerator of
the largest count, generated once; every accelerator count replays it with a
different round-robin issuer assignment, so one
:func:`~repro_torch.core.sweep.sweep_system` call per workload feeds every
cell, and the whole (workload x accel-count x design) matrix — 40 sims at
full size — runs as ONE :func:`~repro_torch.core.timeline.sweep_timeline`
launch.  ``kernel_mode`` is passed through unmodified: ``"stackdist"``
raises.

Claims (C9): at 16 accelerators SPARTA's p99 translation-induced latency is
below conventional's for every workload, by a mean factor of 1.5-100x.

    python -m repro_torch.bench.fig11 [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.bench.common import W4, Claim, print_csv, synced_clock
from repro_torch.core import timeline, traces
from repro_torch.core.sparta import SystemLatencies, TLBConfig
from repro_torch.core.sweep import sweep_system
from repro_torch.core.tlbsim import SystemSimConfig

CACHE = TLBConfig(entries=256, ways=4)      # 16 KB virtual cache
ACCEL_TLB = TLBConfig(entries=128, ways=4)  # conventional accel-side TLB
MEM_TLB = TLBConfig(entries=128, ways=4)    # per-partition memory-side TLB
PARTITIONS = 32
QUEUES = timeline.TimelineConfig(mshrs=8, tlb_ports=1, dram_banks=16)
ACCELS = (1, 2, 4, 8, 16)
ACCELS_QUICK = (1, 4, 16)


def system_configs():
    """(conventional, SPARTA-32) joint-pipeline configs of every workload."""
    return [
        SystemSimConfig(cache=CACHE, accel_tlb=ACCEL_TLB, mem_tlb=MEM_TLB,
                        num_partitions=1, page_shift=12),
        SystemSimConfig(cache=CACHE, accel_tlb=None, mem_tlb=MEM_TLB,
                        num_partitions=PARTITIONS, page_shift=12),
    ]


def interleaved(workload: str, a_max: int, n_ops: int, cap: int) -> np.ndarray:
    """The workload's stream: ``a_max`` thread traces interleaved, capped."""
    streams = traces.thread_traces(workload, a_max, n_ops=n_ops, seed=7)
    return traces.interleave(streams)[:cap]


def run(quick: bool = False, kernel_mode: str = "auto", *, device="cuda",
        n_ops: Optional[int] = None, cap: Optional[int] = None,
        accels: Optional[Sequence[int]] = None, verbose: bool = True) -> dict:
    """Run Fig 11 on ``device``; returns the claims and what they came from:
    ``rows``, ``specs`` and ``results`` (spec order: per workload, per
    accel count, conventional then SPARTA), ``cells``, ``lines`` (the
    interleaved streams), ``accels``, ``cap``, ``seconds`` (per-phase wall
    time, host clock ending in a device synchronise) and ``accesses``."""
    accels = tuple(accels or (ACCELS_QUICK if quick else ACCELS))
    n_ops = n_ops or (1_000 if quick else 8_000)
    cap = cap or (24_000 if quick else 400_000)
    lat = SystemLatencies(n_sockets=8)
    a_max = accels[-1]
    seconds = {"traces": 0.0, "system": 0.0}
    specs, cells, lines, accesses = [], [], {}, {}
    for w in W4:
        t0 = time.perf_counter()
        inter = interleaved(w, a_max, n_ops, cap)
        seconds["traces"] += time.perf_counter() - t0
        t0 = synced_clock(device)
        evs = sweep_system(inter, system_configs(), kernel_mode=kernel_mode, device=device)
        seconds["system"] += synced_clock(device) - t0
        lines[w], accesses[w] = inter, int(inter.shape[0])
        for A in accels:
            ids = timeline.round_robin_accel_ids(inter.shape[0], A)
            specs.append(timeline.TimelineSpec(
                inter, evs[0], "conventional", cfg=QUEUES,
                num_accelerators=A, accel_ids=ids))
            specs.append(timeline.TimelineSpec(
                inter, evs[1], "sparta", cfg=QUEUES,
                num_partitions=PARTITIONS, num_accelerators=A, accel_ids=ids))
            cells.append((w, A))
    t0 = synced_clock(device)
    results = timeline.sweep_timeline(specs, lat, kernel_mode=kernel_mode, device=device)
    seconds["timeline"] = synced_clock(device) - t0

    rows = []
    p99 = {}       # (workload, A) -> (conventional, sparta)
    for i, (w, A) in enumerate(cells):
        conv, spa = results[2 * i], results[2 * i + 1]
        p99[(w, A)] = (conv.overhead_percentile(99), spa.overhead_percentile(99))
        rows.append([
            w, A,
            conv.overhead_percentile(50), spa.overhead_percentile(50),
            conv.overhead_percentile(99), spa.overhead_percentile(99),
            conv.mean_latency, spa.mean_latency,
            conv.throughput, spa.throughput,
        ])

    wins = sum(1 for w in W4 if p99[(w, a_max)][1] < p99[(w, a_max)][0])
    c9a = Claim("C9a", f"SPARTA p99 translation latency < conventional at {a_max} accels (workloads won)",
                float(wins), (4, 4), "/4")
    red = [p99[(w, a_max)][0] / max(p99[(w, a_max)][1], 1e-9) for w in W4]
    c9b = Claim("C9b", f"p99 translation-tail reduction conv/SPARTA at {a_max} accels (mean)",
                float(np.mean(red)), (1.5, 100.0), "x")
    if verbose:
        print_csv(
            "Fig11 translation-induced latency tails vs accelerators",
            ["workload", "accels", "conv_p50", "sparta_p50", "conv_p99",
             "sparta_p99", "conv_mean_lat", "sparta_mean_lat",
             "conv_throughput", "sparta_throughput"],
            rows)
        print(c9a)
        print(c9b)
    return {"claims": [c9a, c9b], "rows": rows, "accels": accels, "cap": cap,
            "specs": specs, "results": results, "cells": cells, "lines": lines,
            "seconds": seconds, "accesses": accesses}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="n_ops 1,000, cap 24,000, accelerators 1, 4, 16")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--kernel-mode", default="auto", choices=("auto", "cuda", "reference"))
    args = ap.parse_args(argv)
    claims = run(args.quick, args.kernel_mode, device=args.device)["claims"]
    return 0 if all(c.ok for c in claims) else 1


if __name__ == "__main__":
    raise SystemExit(main())
