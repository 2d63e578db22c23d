"""Fig 8: multiprogramming impact on BST-External's TLB miss ratio.

The port of the JAX package's ``benchmarks/fig8_multiprog.py`` (same mixes,
trace sizes, cap and claim bands).  Thread mixes: 1/2/4 BST-E threads
(shared dataset — SPARTA avoids redundant caching of shared translations),
then unrelated apps join: +4 HashTable, then +4 BST-I and +4 SkipList.
Partitioning absorbs the added contention (claims C3c, C3d).  Each mix's
interleaved trace runs ONE :func:`repro_torch.core.scheduler.run_sweep_tlb`
call for all partition counts, as the JAX driver's does, which under
``"auto"`` takes the exact stack-distance engine (K3; 4 ways).

A thread's trace seed is ``seed + 31 * i + hash(w) % 97`` in the JAX
driver: Python's string hash is salted per process (``PYTHONHASHSEED``), so
its mixes differ from one process to the next.  ``run`` keeps that default
and takes the salts (``hash(w) % 97`` per workload) as ``salts`` to
reproduce a given process's mixes.

    python -m repro_torch.bench.fig8 [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Mapping, Optional

import numpy as np

from repro_torch.bench.common import GIB, Claim, crash_safety, print_csv, run_config, synced_clock
from repro_torch.core import traces
from repro_torch.core.orchestrator import Preempted, SweepRunConfig
from repro_torch.core.scheduler import run_sweep_tlb
from repro_torch.core.sparta import TLBConfig
from repro_torch.core.sweep import TLBSweepSpec

PARTS = (1, 4, 16, 64)
TLB = TLBConfig(entries=128, ways=4)
CAP = 2_400_000
SEED = 11
FP32 = 32 * GIB
MIXES = {  # name -> [(workload, threads, footprint, base offset in GiB)]
    "bst_e_x1": [("bst_external", 1, FP32, 0)],
    "bst_e_x2": [("bst_external", 2, FP32, 0)],
    "bst_e_x4": [("bst_external", 4, FP32, 0)],
    "+hash_x4": [("bst_external", 4, FP32, 0), ("hash_table", 4, FP32, 32)],
    "+bsti+skip": [("bst_external", 4, FP32, 0), ("hash_table", 4, FP32, 32),
                   ("bst_internal", 4, FP32, 64), ("skip_list", 4, FP32, 96)],
}


def default_salts() -> Dict[str, int]:
    """This process's ``hash(w) % 97`` for every workload of ``MIXES``."""
    return {w: hash(w) % 97 for spec in MIXES.values() for w, *_ in spec}


def specs():
    """One TLB spec per partition count, in ``PARTS`` order (VPN stream)."""
    return [TLBSweepSpec(TLB, num_partitions=p) for p in PARTS]


def _mix(n_ops, seed, spec, salts: Optional[Mapping[str, int]] = None):
    """The interleaved lines of one mix, each access's stream index and the
    streams' workloads; ``spec``: list of (workload, threads, footprint,
    base_offset_gb)."""
    salts = default_salts() if salts is None else salts
    streams = []
    for w, t, fp, off in spec:
        for i in range(t):
            tr = traces.generate(w, n_ops=n_ops, seed=seed + 31 * i + salts[w],
                                 footprint_bytes=fp,
                                 thread_slice=(i / t, (i + 1) / t) if t > 1 else (0.0, 1.0),
                                 scatter_nodes=True)
            streams.append((w, tr.lines + (off * GIB >> 6)))
    n = min(s.shape[0] for _, s in streams)
    inter = traces.interleave([s[:n] for _, s in streams])
    who = np.tile(np.arange(len(streams)), n)[: inter.shape[0]]
    names = [w for w, _ in streams]
    return inter, who, names


def run(quick: bool = False, kernel_mode: str = "auto", *, device="cuda",
        n_ops: Optional[int] = None, salts: Optional[Mapping[str, int]] = None,
        verbose: bool = True, run_cfg: Optional[SweepRunConfig] = None,
        sched=None) -> dict:
    """Run Fig 8 on ``device``; returns the claims and what they came from:
    ``results`` (BST-E miss ratio per mix over ``PARTS``), ``rows``,
    ``bste`` (per mix and P, the BST-E threads' [post-warm-up hits,
    accesses]), ``hits`` (the batched hit bits per mix), ``lines`` (the
    capped interleaved traces), ``salts``, ``seconds`` (trace generation and
    the sweeps, host clock ending in a device synchronise), ``accesses`` and
    ``crash_safety``.  ``run_cfg`` (default: no checkpoints) and ``sched``
    (default: unsharded) go to the scheduler."""
    n_ops = n_ops or (4_000 if quick else 10_000)
    salts = dict(default_salts() if salts is None else salts)
    rc = run_cfg or SweepRunConfig()
    metas = {}
    results, rows, bste, hits, lines, accesses = {}, [], {}, {}, {}, {}
    seconds = {"traces": 0.0, "sweeps": 0.0}
    for name, spec in MIXES.items():
        t0 = time.perf_counter()
        inter, who, names = _mix(n_ops, SEED, spec, salts)
        inter = inter[:CAP]
        who = who[:inter.shape[0]]
        seconds["traces"] += time.perf_counter() - t0
        t0 = synced_clock(device)
        batched, metas[f"tlb-{name}"] = run_sweep_tlb(
            inter >> (12 - 6), specs(), kernel_mode=kernel_mode, run=rc,
            name=f"tlb-{name}", sched=sched, device=device)
        seconds["sweeps"] += synced_clock(device) - t0
        n0 = batched.hits.shape[1] - batched.n_warm
        # Miss ratio observed by the BST-E threads only; the hit bits leave
        # the device once per mix.
        is_bste = np.array([w == "bst_external" for w in names])[who[n0:]]
        warm = batched.hits[:, n0:].cpu().numpy()[:, is_bste]
        counts = [[int(h.sum()), int(h.size)] for h in warm]
        line = [1.0 - h / c if c else 1.0 for h, c in counts]
        results[name], bste[name] = line, counts
        hits[name], lines[name], accesses[name] = batched, inter, int(inter.shape[0])
        rows.append([name] + line)

    # Paper §7.3.1: unrelated apps increase contention, but "despite the
    # increased contention, SPARTA manages to significantly reduce the TLB
    # miss ratio through partitioning".
    bump1 = results["+bsti+skip"][0] - results["bst_e_x4"][0]
    full = results["+bsti+skip"]
    claims = [
        Claim("C3c", "unrelated apps raise BST-E misses on the shared TLB (bump@P1)",
              float(bump1), (0.005, 1.0), ""),
        Claim("C3d", "partitioning cuts BST-E misses under the full multiprogrammed mix ((P1-P64)/P1)",
              float((full[0] - full[-1]) / max(full[0], 1e-9)), (0.15, 1.0), ""),
    ]
    if verbose:
        print_csv("Fig8 BST-E miss ratio vs partitions", ["mix"] + [f"P{p}" for p in PARTS], rows)
        for c in claims:
            print(c)
    return {"claims": claims, "results": results, "rows": rows, "bste": bste, "hits": hits,
            "lines": lines, "salts": salts, "seconds": seconds, "accesses": accesses,
            "crash_safety": crash_safety(metas)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="n_ops 4,000 instead of 10,000")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--kernel-mode", default="auto",
                    choices=("auto", "stackdist", "cuda", "reference"))
    args = ap.parse_args(argv)
    try:
        claims = run(args.quick, args.kernel_mode, device=args.device,
                     run_cfg=run_config("fig8"))["claims"]
    except Preempted as p:
        print(f"fig8: {p}", file=sys.stderr)
        return 75   # EX_TEMPFAIL: the checkpoints under build/repro_torch/cache/ckpt stay
    return 0 if sum(not c.ok for c in claims) <= 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
