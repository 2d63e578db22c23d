"""Fig 4: TLB miss ratio vs TLB size — conventional vs SPARTA-4 / SPARTA-128,
4 KB and 2 MB pages, 128 GB working sets.

The port of the JAX package's ``benchmarks/fig4_tlb_sensitivity.py`` (same
sizes, configs, trace sizes and claim bands); every (config, size) point of
a workload rides one :func:`repro_torch.core.sweep.sweep_tlb` call, which
under ``kernel_mode="auto"`` takes the exact stack-distance engine (every
spec has 4 ways), as the JAX driver's does.
Claims (C2): memory-side TLBs need ~4x fewer entries than conventional
accelerator-side TLBs for the same miss ratio; SPARTA-128 + 2 MB with a
handful of entries beats conventional 2048-entry TLBs.

    python -m repro_torch.bench.fig4 [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.bench.common import W4, Claim, print_csv, synced_clock, trace
from repro_torch.core.sparta import TLBConfig
from repro_torch.core.sweep import TLBSweepSpec, sweep_tlb

SIZES = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
CONFIGS = (  # (label, partitions, page_shift)
    ("conv-4K", 1, 12),
    ("conv-2M", 1, 21),
    ("sparta4-4K", 4, 12),
    ("sparta4-2M", 4, 21),
    ("sparta128-4K", 128, 12),
    ("sparta128-2M", 128, 21),
)


def specs(sizes: Sequence[int] = SIZES):
    """Every (config, size) point, config-major."""
    return [
        TLBSweepSpec(TLBConfig(entries=int(s), ways=4),
                     num_partitions=parts, page_shift=shift)
        for _, parts, shift in CONFIGS
        for s in sizes
    ]


def _match_size(sizes, curve, target_miss):
    """Smallest TLB size achieving miss <= target."""
    for s, m in zip(sizes, curve):
        if m <= target_miss:
            return s
    return None


def run(quick: bool = False, kernel_mode: str = "auto", *, device="cuda",
        n_ops: Optional[int] = None, sizes: Optional[Sequence[int]] = None,
        verbose: bool = True) -> dict:
    """Run Fig 4 on ``device``; returns the claims and what they came from:
    ``results`` (miss-ratio curves), ``hits`` (the batched hit bits),
    ``seconds`` (per-workload sweep wall time, host clock ending in a device
    synchronise) and ``accesses``."""
    n_ops = n_ops or (10_000 if quick else 40_000)
    sizes = tuple(sizes or (SIZES[:7] if quick else SIZES))
    results, rows, hits, seconds, accesses = {}, [], {}, {}, {}
    for w in W4:
        tr = trace(w, n_ops=n_ops)
        t0 = synced_clock(device)
        res = sweep_tlb(tr.lines, specs(sizes), kernel_mode=kernel_mode, device=device)
        seconds[w] = synced_clock(device) - t0
        hits[w], accesses[w] = res, tr.num_accesses
        mr = res.miss_ratios.reshape(len(CONFIGS), len(sizes))
        for (label, _, _), curve in zip(CONFIGS, mr):
            results[f"{w}/{label}"] = list(map(float, curve))
            rows.append([w, label] + list(map(float, curve)))

    # C2a: entries ratio conventional/memory-side for equal miss (4K pages).
    ratios = []
    for w in W4:
        conv = results[f"{w}/conv-4K"]
        sp = results[f"{w}/sparta4-4K"]
        for s, m in zip(sizes, conv):
            match = _match_size(sizes, sp, m)
            if match and match < s:
                ratios.append(s / match)
    c2a = Claim("C2a", "conventional needs ~4x the entries of SPARTA memory-side TLBs (mean)",
                float(np.mean(ratios)) if ratios else 0.0, (2.0, 64.0), "x")

    # C2b: SPARTA-128 2M @ 4 entries vs conventional @ 2048 entries (4K & 2M).
    wins = 0
    for w in W4:
        best_conv = min(results[f"{w}/conv-4K"][-1], results[f"{w}/conv-2M"][-1])
        if results[f"{w}/sparta128-2M"][0] <= best_conv + 1e-9:
            wins += 1
    c2b = Claim("C2b", "SPARTA-128+2MB with 4 entries beats conventional 2048 entries (workloads won)",
                float(wins), (3, 4), "/4")

    if verbose:
        print_csv("Fig4 miss ratio vs entries",
                  ["workload", "config"] + [str(s) for s in sizes], rows)
        print(c2a)
        print(c2b)
    return {"claims": [c2a, c2b], "sizes": sizes, "results": results, "rows": rows,
            "hits": hits, "seconds": seconds, "accesses": accesses}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="n_ops 10,000 and the 7 smallest sizes")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--kernel-mode", default="auto", choices=("auto", "stackdist", "cuda", "reference"))
    args = ap.parse_args(argv)
    claims = run(args.quick, args.kernel_mode, device=args.device)["claims"]
    return 0 if sum(not c.ok for c in claims) <= 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
