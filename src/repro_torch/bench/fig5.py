"""Fig 5: thread contention on shared memory-side TLBs.

The port of the JAX package's ``benchmarks/fig5_contention.py``, both
halves, with its sizes, tables and claim bands.  Miss rate vs (threads x
partitions) with 128-entry 4-way TLBs per partition: each interleaved
thread trace runs ONE :func:`~repro_torch.core.scheduler.run_sweep_tlb` call
for all partition counts, which under ``"auto"`` takes the exact
stack-distance engine, as the JAX driver's does.

The beyond-paper **timeline half** asks what the contention costs in
cycles: at 16 threads, the p99 translation-induced latency of a SPARTA
memory side with P partitions (bounded TLB ports + banked DRAM, Fig 11's
queueing config), over the first 40,000 accesses of each workload's
16-thread trace.  One :func:`~repro_torch.core.scheduler.run_sweep_system`
per workload feeds all partition counts and all 16 cells run as ONE
:func:`~repro_torch.core.scheduler.run_sweep_timeline` call.  Every sweep
goes through the shard scheduler, crash-safe and resumable, sharded when
``sched`` asks for it.

Claims (C3): contention on a single shared TLB grows with threads, but
partitioning makes it vanish; (16 partitions, 16 threads) beats (1
partition, 1 thread) at equal aggregate entries/thread.

    python -m repro_torch.bench.fig5 [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import logging
import time
from typing import Optional

import numpy as np

from repro_torch.bench.common import W4, Claim, crash_safety, print_csv, run_config, synced_clock
from repro_torch.core import timeline, traces
from repro_torch.core.orchestrator import Preempted, SweepRunConfig
from repro_torch.core.scheduler import run_sweep_system, run_sweep_timeline, run_sweep_tlb
from repro_torch.core.sparta import SystemLatencies, TLBConfig
from repro_torch.core.sweep import TLBSweepSpec
from repro_torch.core.tlbsim import SystemSimConfig

THREADS = (1, 2, 4, 8, 16)
PARTS = (1, 4, 16, 64)
TLB = TLBConfig(entries=128, ways=4)
CACHE = TLBConfig(entries=256, ways=4)  # virtual cache for the timeline half
QUEUES = timeline.TimelineConfig(mshrs=8, tlb_ports=1, dram_banks=16)
MAX_ACCESSES = 1_200_000                # the miss-ratio grid's trace cap

_LOG = logging.getLogger("repro_torch.bench.fig5")


def specs():
    """One TLB spec per partition count, in ``PARTS`` order."""
    return [TLBSweepSpec(TLB, num_partitions=p, page_shift=12) for p in PARTS]


def system_configs():
    """The timeline half's SPARTA joint-pipeline configs, in ``PARTS`` order."""
    return [SystemSimConfig(cache=CACHE, accel_tlb=None, mem_tlb=TLB,
                            num_partitions=p, page_shift=12) for p in PARTS]


def run(quick: bool = False, kernel_mode: str = "auto", *, device="cuda",
        n_ops: Optional[int] = None, tl_cap: Optional[int] = None,
        verbose: bool = True, run_cfg: Optional[SweepRunConfig] = None,
        sched=None) -> dict:
    """Run Fig 5 on ``device``; returns the claims and what they came from:
    ``results`` (miss ratios per workload and partition count, over
    threads), ``rows``, ``hits`` (the grid's batched hit bits per
    ``"{workload}/t{threads}"``), ``lines`` (the grid's traces), the
    timeline half's ``timeline_specs``, ``timeline`` results,
    ``timeline_p99`` and ``timeline_rows``, ``seconds`` (per-phase wall
    time, host clock ending in a device synchronise), ``accesses`` and
    ``crash_safety``.  ``run_cfg`` (default: no checkpoints) and ``sched``
    (default: unsharded) go to the scheduler."""
    n_ops = n_ops or (4_000 if quick else 12_000)
    tl_cap = tl_cap or (12_000 if quick else 40_000)
    rc = run_cfg or SweepRunConfig()
    metas = {}
    t_max = THREADS[-1]
    seconds = {"traces": 0.0, "grid": 0.0}
    results, hits, lines, accesses = {}, {}, {}, {}
    inter_max = {}  # workload -> the t_max interleaved trace (timeline reuse)
    for w in W4:
        grid = np.empty((len(PARTS), len(THREADS)))
        for i_t, t in enumerate(THREADS):
            t0 = time.perf_counter()
            streams = traces.thread_traces(w, t, n_ops=n_ops, seed=7)
            inter = traces.interleave(streams)[:MAX_ACCESSES]
            seconds["traces"] += time.perf_counter() - t0
            if t == t_max:
                inter_max[w] = inter
            t0 = synced_clock(device)
            batched, metas[f"tlb-{w}-t{t}"] = run_sweep_tlb(
                inter, specs(), kernel_mode=kernel_mode, run=rc,
                name=f"tlb-{w}-t{t}", sched=sched, device=device)
            grid[:, i_t] = batched.miss_ratios
            seconds["grid"] += synced_clock(device) - t0
            key = f"{w}/t{t}"
            hits[key], lines[key], accesses[key] = batched, inter, int(inter.shape[0])
        for i_p, p in enumerate(PARTS):
            results[f"{w}/P{p}"] = [float(x) for x in grid[i_p]]
    rows = [[w, p] + results[f"{w}/P{p}"] for w in W4 for p in PARTS]

    # C3a: contention on 1 partition (16 threads vs 1 thread miss increase).
    bumps = [results[f"{w}/P1"][-1] - results[f"{w}/P1"][0] for w in W4]
    c3a = Claim("C3a", "single shared TLB: miss ratio increases with 16 threads (mean bump)",
                float(np.mean(bumps)), (0.005, 1.0), "")
    # C3b: partitioning beats contention: (16 part, 16 thr) < (1 part, 1 thr).
    wins = sum(
        1 for w in W4
        if results[f"{w}/P16"][THREADS.index(16)] < results[f"{w}/P1"][0]
    )
    c3b = Claim("C3b", "(16 partitions, 16 threads) < (1 partition, 1 thread) miss ratio (workloads won)",
                float(wins), (3, 4), "/4")

    # --- timeline half: queueing cost of contention at max threads ----------
    # The grid is what sweep-only modes ("stackdist") are for; the joint
    # system sweep and the timeline engine reject them, so this half runs
    # with "auto" instead — loudly, as the reference driver does.
    tl_mode = kernel_mode
    if kernel_mode == "stackdist":
        tl_mode = "auto"
        _LOG.warning(
            "fig5 timeline half: kernel_mode=%r is sweep_tlb-only; running "
            "the system sweep + timeline half with 'auto'", kernel_mode)
    lat = SystemLatencies(n_sockets=8)
    tl_specs = []
    t0 = synced_clock(device)
    for w in W4:
        sl = inter_max[w][:tl_cap]  # slice of the already-streamed trace
        evs, metas[f"system-{w}"] = run_sweep_system(
            sl, system_configs(), kernel_mode=tl_mode, run=rc, name=f"system-{w}",
            sched=sched, device=device)
        for i_p, p in enumerate(PARTS):
            tl_specs.append(timeline.TimelineSpec(
                sl, evs[i_p], "sparta", cfg=QUEUES, num_partitions=p,
                num_accelerators=t_max))
    seconds["system"] = synced_clock(device) - t0
    t0 = synced_clock(device)
    tl_res, metas["timeline"] = run_sweep_timeline(
        tl_specs, lat, kernel_mode=tl_mode, run=rc, name="timeline", sched=sched,
        device=device)
    seconds["timeline"] = synced_clock(device) - t0
    tl_p99, tl_rows = {}, []
    for i, w in enumerate(W4):
        per_w = tl_res[i * len(PARTS):(i + 1) * len(PARTS)]
        tl_p99[w] = [r.overhead_percentile(99) for r in per_w]
        tl_rows.append([w] + tl_p99[w])

    if verbose:
        print_csv("Fig5 miss ratio vs threads",
                  ["workload", "partitions"] + [str(t) for t in THREADS], rows)
        print_csv(
            f"Fig5 timeline half: p99 translation latency at {t_max} threads (SPARTA, queued)",
            ["workload"] + [f"P{p}" for p in PARTS], tl_rows)
        print(c3a)
        print(c3b)
    return {"claims": [c3a, c3b], "results": results, "rows": rows, "hits": hits,
            "lines": lines, "tl_cap": tl_cap,
            "timeline_specs": tl_specs, "timeline": tl_res, "timeline_p99": tl_p99,
            "timeline_rows": tl_rows, "seconds": seconds, "accesses": accesses,
            "crash_safety": crash_safety(metas)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="n_ops 4,000 and a 12,000-access timeline half")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--kernel-mode", default="auto",
                    choices=("auto", "stackdist", "cuda", "reference"))
    args = ap.parse_args(argv)
    try:
        claims = run(args.quick, args.kernel_mode, device=args.device,
                     run_cfg=run_config("fig5"))["claims"]
    except Preempted as p:
        print(f"fig5: {p}", file=sys.stderr)
        return 75   # EX_TEMPFAIL: the checkpoints under build/repro_torch/cache/ckpt stay
    return 0 if sum(not c.ok for c in claims) <= 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
