"""Fig 2: page-walk (L2 TLB miss) rate vs memory footprint.

The port of the JAX package's ``benchmarks/fig2_pagewalk.py`` (same
footprints, TLB, trace sizes and claim band).  A Broadwell-class
1.5K-entry L2 TLB is probed with each workload at footprints 1..128 GB;
misses per kilo-instruction rise with footprint (claim C1).  Each of the
32 traces runs one :func:`repro_torch.core.tlbsim.simulate_tlb`, a single
config: on the card, one launch of K1 (``tlb_sim``) at B = 1.

    python -m repro_torch.bench.fig2 [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np

from repro_torch.bench.common import GIB, W4, Claim, print_csv, synced_clock
from repro_torch.core import tlbsim, traces
from repro_torch.core.sparta import TLBConfig

FOOTPRINTS_GB = (1, 2, 4, 8, 16, 32, 64, 128)
TLB = TLBConfig(entries=1536, ways=4)  # Broadwell-class L2 TLB
MAX_ACCESSES = 1_400_000


def fig2_trace(workload: str, gb: int, n_ops: int):
    """One point's trace: Zipf-popular keys for the hash table
    (memcached-style), since the absolute hot-set size against the TLB's
    reach is what Fig 2 sweeps."""
    return traces.generate(workload, n_ops=n_ops, footprint_bytes=gb * GIB,
                           zipf_keys=1.4 if workload == "hash_table" else 0.0,
                           max_accesses=MAX_ACCESSES)


def run(quick: bool = False, *, device="cuda", n_ops: Optional[int] = None,
        verbose: bool = True) -> dict:
    """Run Fig 2 on ``device``; returns the claims and what they came from:
    ``curves`` (MPKI per workload over footprints), ``rows``, ``hits`` (the
    :class:`~repro_torch.core.tlbsim.TLBResult` per ``"{workload}/{gb}"``),
    ``lines`` (the traces), ``seconds`` (trace generation and the TLB
    simulations, host clock ending in a device synchronise) and
    ``accesses``."""
    n_ops = n_ops or (10_000 if quick else 30_000)
    rows, curves, hits, lines, accesses = [], {}, {}, {}, {}
    seconds = {"traces": 0.0, "tlb": 0.0}
    for w in W4:
        mpki = []
        for gb in FOOTPRINTS_GB:
            t0 = time.perf_counter()
            tr = fig2_trace(w, gb, n_ops)
            seconds["traces"] += time.perf_counter() - t0
            t0 = synced_clock(device)
            res = tlbsim.simulate_tlb(tr.vpns(12), TLB, device=device)
            walks_per_access = res.miss_ratio
            seconds["tlb"] += synced_clock(device) - t0
            mpki.append(1000.0 * walks_per_access / tr.instr_per_access)
            key = f"{w}/{gb}"
            hits[key], lines[key], accesses[key] = res, tr.lines, tr.num_accesses
        curves[w] = mpki
        rows.append([w] + mpki)

    growth = [curves[w][-1] / max(curves[w][0], 1e-9) for w in W4]
    # Synthetic traces are conservative vs the paper's Pin traces; the claim
    # is the qualitative monotone growth: mean ratio + monotone fraction.
    mono = float(np.mean([np.mean(np.diff(curves[w]) >= -1e-6) for w in W4]))
    c1 = Claim(
        "C1", f"page-walk MPKI grows with footprint (128GB/1GB mean ratio; monotone frac={mono:.2f})",
        float(np.mean(growth)), (1.15, 1e6), "x",
    )
    if verbose:
        print_csv("Fig2 page-walk MPKI vs footprint (GB)",
                  ["workload"] + [str(g) for g in FOOTPRINTS_GB], rows)
        print(c1)
    return {"claims": [c1], "curves": curves,
            "monotone_frac": mono, "rows": rows, "hits": hits, "lines": lines,
            "seconds": seconds, "accesses": accesses}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="n_ops 10,000 instead of 30,000")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    claims = run(args.quick, device=args.device)["claims"]
    return 0 if sum(not c.ok for c in claims) <= 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
