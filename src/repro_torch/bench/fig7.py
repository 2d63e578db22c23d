"""Fig 7: TLB miss penalty, conventional vs SPARTA, 2- vs 8-socket machines.

The port of the JAX package's ``benchmarks/fig7_miss_penalty.py`` (same
machines and claim bands).  Pure timeline arithmetic (Fig 3) on the host:
the conventional page walk pays a full network round trip before the data
fetch; SPARTA's walk is one local DRAM access because the PTE is co-located
in the partition.  Claims (C5).  Like every driver of ``repro_torch.bench``
it returns the claims with what they came from and writes no file.

    python -m repro_torch.bench.fig7
"""
from __future__ import annotations

import argparse
import time

from repro_torch.bench.common import Claim, print_csv
from repro_torch.core.sparta import SystemLatencies, conventional_timelines, sparta_timelines

SOCKETS = (2, 8)


def run(quick: bool = False, *, verbose: bool = True) -> dict:
    """Run Fig 7 (``quick`` changes nothing: the figure is arithmetic);
    returns the claims and what they came from: ``rows``, ``cycles`` (per
    machine the conventional and SPARTA miss cycles and their ratio) and
    ``seconds``."""
    t0 = time.perf_counter()
    rows, cycles, reductions = [], {}, {}
    for sockets in SOCKETS:
        lat = SystemLatencies(n_sockets=sockets)
        _, _, _, conv_miss = conventional_timelines(lat)
        _, _, _, sp_miss = sparta_timelines(lat)
        norm = sp_miss / conv_miss
        reductions[sockets] = conv_miss / sp_miss
        rows.append([f"{sockets}-socket", float(conv_miss), float(sp_miss), float(norm)])
        cycles[f"{sockets}socket"] = {
            "conventional_cycles": float(conv_miss),
            "sparta_cycles": float(sp_miss),
            "normalized": float(norm),
        }
    lat = SystemLatencies()
    claims = [
        Claim("C5a", "SPARTA miss penalty ~= one local DRAM access (8-socket cycles)",
              cycles["8socket"]["sparta_cycles"],
              (0.0, lat.l_dram + 2 * lat.l_tlb + 1), "cy"),
        Claim("C5b", "bigger machine => bigger reduction (8-socket/2-socket reduction ratio)",
              reductions[8] / reductions[2], (1.05, 10.0), "x"),
    ]
    if verbose:
        print_csv("Fig7 miss penalty", ["machine", "conventional_cy", "sparta_cy", "normalized"],
                  rows)
        for c in claims:
            print(c)
    return {"claims": claims, "rows": rows, "cycles": cycles,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    claims = run()["claims"]
    return 0 if sum(not c.ok for c in claims) <= 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
