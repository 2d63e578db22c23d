"""Fig 10 (+ §7.7): end-to-end performance — SPARTA vs conventional vs DIPTA
vs ideal, 8-socket 128 GB machine, 16 KB virtual caches.

The port of the JAX package's ``benchmarks/fig10_performance.py`` (same
configs, trace sizes and claim bands).  Per workload the joint trace
simulation (:func:`repro_torch.core.sweep.sweep_system`, one batched pass for
all nine designs) provides (cache, accel-TLB, memory-TLB) hit rates, and the
Fig 3 timeline/CPI model turns them into speedups over conventional-4K.
Each workload's sweep goes through the shard scheduler
(:func:`repro_torch.core.scheduler.run_sweep_system`), as the JAX driver's
does: crash-safe and resumable, sharded when ``sched`` asks for it.
Claims (C6): conventional 2MB gains only ~14%; SPARTA-32 improves ~1.57x
(4K), within ~94% of ideal; translation overhead drops ~31.5x on average (up
to 47x); (C8) idealized DIPTA trails SPARTA due to way misprediction.

    python -m repro_torch.bench.fig10 [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np

from repro_torch.bench.common import (W4, Claim, crash_safety, print_csv, run_config,
                                     synced_clock, trace)
from repro_torch.core import cpi
from repro_torch.core.orchestrator import Preempted, SweepRunConfig
from repro_torch.core.scheduler import run_sweep_system
from repro_torch.core.sparta import SystemLatencies, TLBConfig
from repro_torch.core.tlbsim import SystemSimConfig

CACHE = TLBConfig(entries=256, ways=4)      # 16 KB virtual cache
ACCEL_TLB = TLBConfig(entries=128, ways=4)  # baseline accel-side TLB
MEM_TLB = TLBConfig(entries=128, ways=4)
CONFIGS = (  # (label, partitions, page_shift, design)
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


def system_configs():
    """The nine designs as joint-pipeline configs, in ``CONFIGS`` order."""
    return [
        SystemSimConfig(
            cache=CACHE,
            accel_tlb=ACCEL_TLB if design == "conventional" else None,
            mem_tlb=MEM_TLB, num_partitions=parts, page_shift=shift,
            accel_probe_on_miss_only=True,
        )
        for _, parts, shift, design in CONFIGS
    ]


def run(quick: bool = False, kernel_mode: str = "auto", *, device="cuda",
        n_ops: Optional[int] = None, verbose: bool = True,
        run_cfg: Optional[SweepRunConfig] = None, sched=None) -> dict:
    """Run Fig 10 on ``device``; returns the claims and what they came from:
    ``rows`` (speedups), ``perfs`` (per workload and design), ``events``
    (the batched hit bits), ``seconds`` (per-workload sweep wall time, host
    clock ending in a device synchronise), ``accesses`` and
    ``crash_safety`` (:func:`repro_torch.bench.common.crash_safety`).
    ``run_cfg`` (default: no checkpoints) and ``sched`` (default: unsharded)
    go to the scheduler."""
    n_ops = n_ops or (8_000 if quick else 25_000)
    lat = SystemLatencies(n_sockets=8)
    rc = run_cfg or SweepRunConfig()
    metas = {}
    speedups = {c[0]: [] for c in CONFIGS}
    overhead_reduction = []
    overhead_reduction_2m = []
    rows, perfs_all, events, seconds, accesses = [], {}, {}, {}, {}
    for w in W4:
        tr = trace(w, n_ops=n_ops)
        ipa = tr.instr_per_access
        t0 = synced_clock(device)
        evs, metas[f"system-{w}"] = run_sweep_system(
            tr.lines, system_configs(), kernel_mode=kernel_mode, run=rc,
            name=f"system-{w}", sched=sched, device=device)
        seconds[w] = synced_clock(device) - t0
        events[w], accesses[w] = evs, tr.num_accesses
        perfs = {}
        for i_c, (label, parts, shift, design) in enumerate(CONFIGS):
            perfs[label] = cpi.evaluate_design(
                design, evs[i_c], lat, instr_per_access=ipa, workload=w,
            )
        perfs_all[w] = perfs
        base = perfs["conv-4K"]
        row = [w]
        for label, *_ in CONFIGS:
            s = perfs[label].speedup_over(base)
            speedups[label].append(float(s))
            row.append(float(s))
        rows.append(row)
        overhead_reduction.append(
            base.access.translation_overhead
            / max(perfs["sparta128-2M"].access.translation_overhead, 1e-9)
        )
        overhead_reduction_2m.append(
            perfs["conv-2M"].access.translation_overhead
            / max(perfs["sparta128-2M"].access.translation_overhead, 1e-9)
        )

    mean = {k: float(np.mean(v)) for k, v in speedups.items()}
    frac_ideal = mean["sparta32-4K"] / mean["ideal"]
    claims = [
        Claim("C6a", "conventional 2MB mean speedup (paper: ~1.14x)",
              mean["conv-2M"], (1.0, 1.45), "x"),
        Claim("C6b", "SPARTA-32 4K mean speedup (paper: ~1.57x)",
              mean["sparta32-4K"], (1.3, 1.9), "x"),
        Claim("C6c", "SPARTA-32 4K fraction of ideal (paper: 93.7%)",
              frac_ideal, (0.85, 1.0), ""),
        Claim("C6d", "translation overhead reduction, mean (paper: 31.5x)",
              float(np.mean(overhead_reduction)), (10.0, 80.0), "x"),
        Claim("C6e", "translation overhead reduction, max (paper: up to 47x)",
              float(np.max(overhead_reduction)), (15.0, 200.0), "x"),
        Claim("C6f", "overhead reduction over huge pages, mean (paper: 19x)",
              float(np.mean(overhead_reduction_2m)), (4.0, 60.0), "x"),
        Claim("C8", "SPARTA-32 4K beats idealized DIPTA (workloads won)",
              float(sum(1 for a, b in zip(speedups["sparta32-4K"], speedups["dipta"])
                        if a >= b)),
              (3, 4), "/4"),
    ]
    if verbose:
        print_csv("Fig10 speedup over conventional-4K",
                  ["workload"] + [c[0] for c in CONFIGS], rows)
        for c in claims:
            print(c)
    return {"claims": claims, "rows": rows, "mean": mean,
            "overhead_reduction": [float(x) for x in overhead_reduction],
            "overhead_reduction_2m": [float(x) for x in overhead_reduction_2m],
            "perfs": perfs_all, "events": events, "seconds": seconds,
            "accesses": accesses, "crash_safety": crash_safety(metas)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="n_ops 8,000 instead of 25,000")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--kernel-mode", default="auto", choices=("auto", "cuda", "reference"))
    args = ap.parse_args(argv)
    try:
        claims = run(args.quick, args.kernel_mode, device=args.device,
                     run_cfg=run_config("fig10"))["claims"]
    except Preempted as p:
        print(f"fig10: {p}", file=sys.stderr)
        return 75   # EX_TEMPFAIL: the checkpoints under build/repro_torch/cache/ckpt stay
    return 0 if sum(not c.ok for c in claims) <= 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
