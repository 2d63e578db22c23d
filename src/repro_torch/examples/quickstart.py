"""Quickstart: the paper's result in three steps, the port of the JAX
package's ``examples/quickstart.py``.

1. Generate an index-traversal trace (paper Table 2 workload).
2. Compare conventional vs SPARTA memory-side TLBs (Fig 4): one TLB
   simulation a partition count, through the ``tlb_sim`` kernel on the card.
3. Run the Fig 10 CPI model: the joint cache + TLB pipeline through the
   ``system_sim`` kernel, then the end-to-end speedup and overhead reduction.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The simulators are bit-identical to the JAX package's, so every printed
number is the JAX example's.
"""
from __future__ import annotations

import argparse

from repro_torch.core import cpi, tlbsim, traces
from repro_torch.core.sparta import SystemLatencies, TLBConfig
from repro_torch.core.tlbsim import SystemSimConfig, simulate_system
from repro_torch.kernels.common import as_device

GIB = 1 << 30
PARTITIONS = (1, 4, 32, 128)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = as_device(args.device)
    lines = []

    def say(text: str = "") -> None:
        print(text)
        lines.extend(text.splitlines() or [""])

    say("=== SPARTA quickstart ===")
    tr = traces.generate("bst_internal", n_ops=20_000, footprint_bytes=128 * GIB)
    say(f"workload=bst_internal accesses={tr.num_accesses:,} footprint=128GiB")

    miss = {}
    for P in PARTITIONS:
        miss[P] = tlbsim.miss_ratio(tr.vpns(12), 128, num_partitions=P, device=dev)
        label = "conventional" if P == 1 else f"SPARTA-{P}  "
        say(f"  {label} 128-entry TLB{'s' if P > 1 else ' '}: miss ratio {miss[P]:.3f}")

    lat = SystemLatencies(n_sockets=8)
    base_ev = simulate_system(tr.lines, SystemSimConfig(
        accel_tlb=TLBConfig(entries=128, ways=4), num_partitions=1), device=dev)
    sp_ev = simulate_system(tr.lines, SystemSimConfig(num_partitions=32), device=dev)
    ipa = tr.instr_per_access
    base = cpi.evaluate_design("conventional", base_ev, lat, instr_per_access=ipa)
    sp = cpi.evaluate_design("sparta", sp_ev, lat, instr_per_access=ipa)
    ideal = cpi.evaluate_design("ideal", sp_ev, lat, instr_per_access=ipa)
    before, after = base.access.translation_overhead, sp.access.translation_overhead
    say(f"\nspeedup over conventional: SPARTA-32 {sp.speedup_over(base):.2f}x "
        f"(ideal {ideal.speedup_over(base):.2f}x)")
    say(f"translation overhead: {before:.0f} -> {after:.1f} cycles/access "
        f"({before / after:.1f}x reduction)")
    return {"accesses": tr.num_accesses,
            "miss_ratio": {str(P): m for P, m in miss.items()},
            "speedup": sp.speedup_over(base), "ideal_speedup": ideal.speedup_over(base),
            "overhead_conventional": before, "overhead_sparta": after,
            "overhead_reduction": before / after, "lines": lines}


if __name__ == "__main__":
    main()
