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
:func:`~repro_torch.core.scheduler.run_sweep_system` call per workload feeds
every cell, and the whole (workload x accel-count x design) matrix — 40 sims
at full size — runs as ONE
:func:`~repro_torch.core.scheduler.run_sweep_timeline` call.  Every sweep
goes through the shard scheduler, as the JAX driver's does: crash-safe,
resumable, sharded when ``sched`` asks for it.  ``kernel_mode`` is passed
through unmodified: ``"stackdist"`` raises.

Claims (C9): at 16 accelerators SPARTA's p99 translation-induced latency is
below conventional's for every workload, by a mean factor of 1.5-100x.

    python -m repro_torch.bench.fig11 [--quick] [--device cpu] [--resume]
        [--chunk-accesses N] [--workers N] [--shards N] [--deadline S]
        [--executor auto|serial|thread|process] [--cap N] [--out PATH]

The main writes the rows, claims, per-spec sha256 digests of latency /
overhead / done and the crash-safety record to ``--out`` (default
``build/repro_torch/cache/figs/fig11.json``).  It keeps its checkpoints
under ``<root>/ckpt/fig11/``, its calibration tables under
``<root>/calibration/`` and its run log (and each process worker's) under
``<root>/runlogs/``, where ``<root>`` is ``build/repro_torch/cache/``, or the
directory of ``--out`` when one is given: a run with an ``--out`` of its own
touches no other run's checkpoints.  Exit 75 when preempted (rerun with
``--resume``), 79 (``EX_DEGRADED``) when shards were quarantined, else 0
if every claim holds and 1 if not.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.bench import common
from repro_torch.bench.common import W4, Claim, crash_safety, print_csv, synced_clock
from repro_torch.core import timeline, traces
from repro_torch.core.orchestrator import Preempted, SweepRunConfig
from repro_torch.core.scheduler import (EX_DEGRADED, fork_server, run_sweep_system,
                                        run_sweep_timeline)
from repro_torch.core.sparta import SystemLatencies, TLBConfig
from repro_torch.core.tlbsim import SystemSimConfig
from repro_torch.runtime import telemetry

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
        accels: Optional[Sequence[int]] = None, verbose: bool = True,
        run_cfg: Optional[SweepRunConfig] = None, sched=None) -> dict:
    """Run Fig 11 on ``device``; returns the claims and what they came from:
    ``rows``, ``specs`` and ``results`` (spec order: per workload, per
    accel count, conventional then SPARTA), ``cells``, ``lines`` (the
    interleaved streams), ``accels``, ``cap``, ``seconds`` (per-phase wall
    time, host clock ending in a device synchronise), ``accesses`` and
    ``crash_safety``.  ``run_cfg`` (default: no checkpoints) and ``sched``
    (default: unsharded) go to the scheduler."""
    accels = tuple(accels or (ACCELS_QUICK if quick else ACCELS))
    n_ops = n_ops or (1_000 if quick else 8_000)
    cap = cap or (24_000 if quick else 400_000)
    lat = SystemLatencies(n_sockets=8)
    rc = run_cfg or SweepRunConfig()
    metas = {}
    a_max = accels[-1]
    seconds = {"traces": 0.0, "system": 0.0}
    specs, cells, lines, accesses = [], [], {}, {}
    for w in W4:
        t0 = time.perf_counter()
        inter = interleaved(w, a_max, n_ops, cap)
        seconds["traces"] += time.perf_counter() - t0
        t0 = synced_clock(device)
        evs, metas[f"system-{w}"] = run_sweep_system(
            inter, system_configs(), kernel_mode=kernel_mode, run=rc,
            name=f"system-{w}", sched=sched, device=device)
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
    results, metas["timeline"] = run_sweep_timeline(
        specs, lat, kernel_mode=kernel_mode, run=rc, name="timeline", sched=sched,
        device=device)
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
            "seconds": seconds, "accesses": accesses, "crash_safety": crash_safety(metas)}


def main(argv=None) -> int:
    """The standalone entry point with the reference's resume and scheduler
    options (``smoke_resume`` / ``smoke_sched`` SIGTERM it mid-sweep and
    rerun it with ``--resume``, or SIGKILL one of its ``--workers``
    mid-shard)."""
    telemetry.setup_logging()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="n_ops 1,000, cap 24,000, accelerators 1, 4, 16")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--kernel-mode", default="auto", choices=("auto", "cuda", "reference"))
    ap.add_argument("--resume", action="store_true",
                    help="re-enter from the last committed chunk checkpoint")
    ap.add_argument("--chunk-accesses", type=int, default=None,
                    help="checkpoint-commit granularity (trace accesses)")
    ap.add_argument("--workers", type=int, default=1,
                    help="parallel sweep workers (sharded scheduler)")
    ap.add_argument("--shards", type=int, default=0,
                    help="shards per engine call (0 = auto, 2x workers)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-shard straggler deadline (seconds)")
    ap.add_argument("--executor", default="auto",
                    choices=("auto", "serial", "thread", "process"))
    ap.add_argument("--cap", type=int, default=None,
                    help="accesses of each workload's stream (default 24,000 / 400,000)")
    ap.add_argument("--out", default=None,
                    help="where the rows, claims, digests and crash-safety record go "
                         "(default build/repro_torch/cache/figs/fig11.json); its "
                         "directory then holds the run's checkpoints and run logs")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out) if args.out else common.FIGS / "fig11.json"
    root = out.parent if args.out else common.CACHE
    sched = common.sched_config(workers=args.workers, shards=args.shards,
                                deadline=args.deadline, executor=args.executor, root=root)
    # The fork server imports torch while this process makes the traces, and
    # is stopped before this process exits.
    forking = sched is not None and sched.resolve_executor() == "process" \
        and sched.mp_context == "forkserver"
    rc = common.run_config("fig11", resume=args.resume, chunk_accesses=args.chunk_accesses,
                           root=root)
    try:
        with fork_server() if forking else contextlib.nullcontext(), \
                telemetry.run_scope(root / "runlogs" / "fig11.jsonl", run="fig11"):
            res = run(args.quick, args.kernel_mode, device=args.device, cap=args.cap,
                      run_cfg=rc, sched=sched)
    except Preempted as p:
        print(f"fig11: {p}", file=sys.stderr)
        return 75   # EX_TEMPFAIL: rerun with --resume
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "rows": res["rows"], "claims": [c.row() for c in res["claims"]],
        "digests": common.timeline_digests(res["results"]),
        "crash_safety": res["crash_safety"]}, indent=1, default=float))
    if common.degraded_runs():
        print("fig11: degraded — quarantined shards (see crash_safety in "
              f"{out})", file=sys.stderr)
        return EX_DEGRADED
    return 0 if all(c.ok for c in res["claims"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
