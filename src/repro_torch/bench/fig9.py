"""Fig 9: accelerator-side TLB capacity under SPARTA with physical caches.

The port of the JAX package's ``benchmarks/fig9_accel_tlb.py`` (same
configs, trace sizes and claim bands).  SPARTA-8, 16 KB 4-way physical
cache per accelerator, accel-side TLB swept 1..128 entries; the rightmost
point is SPARTA with a virtual cache and NO accelerator-side translation
hardware.  Baseline: conventional translation with a 128-entry accel TLB
and perfect MMU caches (virtual cache).  Per workload the baseline, the
eight capacities and the no-TLB point ride ONE
:func:`repro_torch.core.scheduler.run_sweep_system` call of 10 configs, as
the JAX driver's does: crash-safe and resumable (on the card, K2 over the
trace's chunks), sharded when ``sched`` asks for it.

Claims (C7): ~8 accel-TLB entries suffice to beat the 128-entry baseline;
capacity beyond that gives diminishing returns.

    python -m repro_torch.bench.fig9 [--quick] [--device cpu]
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

ENTRIES = (1, 2, 4, 8, 16, 32, 64, 128)
P = 8
MEM_TLB = TLBConfig(entries=128, ways=4)
CACHE = TLBConfig(entries=256, ways=4)  # 16KB / 64B lines


def system_configs():
    """The baseline, the accel-TLB capacities in ``ENTRIES`` order, then
    SPARTA-8 with a virtual cache and no accel TLB."""
    cfgs = [SystemSimConfig(
        cache=CACHE, accel_tlb=TLBConfig(entries=128, ways=4),
        mem_tlb=MEM_TLB, num_partitions=1, accel_probe_on_miss_only=True)]
    cfgs += [SystemSimConfig(
        cache=CACHE, accel_tlb=TLBConfig(entries=e, ways=4),
        mem_tlb=MEM_TLB, num_partitions=P, accel_probe_on_miss_only=False)
        for e in ENTRIES]
    cfgs.append(SystemSimConfig(cache=CACHE, accel_tlb=None, mem_tlb=MEM_TLB,
                                num_partitions=P))
    return cfgs


def run(quick: bool = False, kernel_mode: str = "auto", *, device="cuda",
        n_ops: Optional[int] = None, verbose: bool = True,
        run_cfg: Optional[SweepRunConfig] = None, sched=None) -> dict:
    """Run Fig 9 on ``device``; returns the claims and what they came from:
    ``results`` (speedups over the baseline per workload, ``ENTRIES`` then
    the no-TLB point), ``rows``, ``events`` (the batched hit bits),
    ``seconds`` (per-workload sweep wall time, host clock ending in a device
    synchronise), ``accesses`` and ``crash_safety``.  ``run_cfg`` (default:
    no checkpoints) and ``sched`` (default: unsharded) go to the
    scheduler."""
    n_ops = n_ops or (8_000 if quick else 25_000)
    lat = SystemLatencies()
    cfgs = system_configs()
    rc = run_cfg or SweepRunConfig()
    metas = {}
    results, rows, events, seconds, accesses = {}, [], {}, {}, {}
    for w in W4:
        tr = trace(w, n_ops=n_ops)
        ipa = tr.instr_per_access
        t0 = synced_clock(device)
        evs, metas[f"system-{w}"] = run_sweep_system(
            tr.lines, cfgs, kernel_mode=kernel_mode, run=rc, name=f"system-{w}",
            sched=sched, device=device)
        seconds[w] = synced_clock(device) - t0
        events[w], accesses[w] = evs, tr.num_accesses
        base = cpi.evaluate_design("conventional", evs[0], lat, instr_per_access=ipa)
        line = []
        for i_e, _ in enumerate(ENTRIES):
            sp = cpi.evaluate_design("sparta", evs[1 + i_e], lat, instr_per_access=ipa,
                                     physical_cache=True)
            line.append(float(sp.speedup_over(base)))
        sp_v = cpi.evaluate_design("sparta", evs[len(cfgs) - 1], lat, instr_per_access=ipa)
        line.append(float(sp_v.speedup_over(base)))
        results[w] = line
        rows.append([w] + line)

    idx8 = ENTRIES.index(8)
    wins8 = sum(1 for w in W4 if results[w][idx8] >= 1.0)
    gains = [results[w][-2] - results[w][idx8] for w in W4]  # 128 vs 8 entries
    claims = [
        Claim("C7a", "SPARTA with 8 accel-TLB entries beats 128-entry baseline (workloads won)",
              float(wins8), (3, 4), "/4"),
        Claim("C7b", "beyond 8 entries: diminishing returns (mean extra speedup 8->128)",
              float(np.mean(gains)), (-0.2, 0.25), "x"),
    ]
    if verbose:
        print_csv("Fig9 speedup vs accel TLB entries",
                  ["workload"] + [str(e) for e in ENTRIES] + ["virt$ no TLB"], rows)
        for c in claims:
            print(c)
    return {"claims": claims, "results": results, "rows": rows, "events": events,
            "seconds": seconds, "accesses": accesses, "crash_safety": crash_safety(metas)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="n_ops 8,000 instead of 25,000")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--kernel-mode", default="auto", choices=("auto", "cuda", "reference"))
    args = ap.parse_args(argv)
    try:
        claims = run(args.quick, args.kernel_mode, device=args.device,
                     run_cfg=run_config("fig9"))["claims"]
    except Preempted as p:
        print(f"fig9: {p}", file=sys.stderr)
        return 75   # EX_TEMPFAIL: the checkpoints under build/repro_torch/cache/ckpt stay
    return 0 if sum(not c.ok for c in claims) <= 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
