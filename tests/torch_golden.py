"""Golden outputs for the port's figure sweeps, computed by the JAX package.

Not a test module (pytest does not collect it).  Run from the repository root

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden.py [--only sweeps|timeline|figs|examples]

to rewrite

* ``tests/data/torch_golden_sweeps.json``: for the full-size Fig 10 and Fig 4
  sweeps of the four index workloads, each workload's access count and the
  sha256 of its ``lines.tobytes()``, and per (config, structure) the hit
  count over the whole stream and after warm-up;
* ``tests/data/torch_golden_timeline.json``: for the full-size Fig 11 and
  Fig 5 drivers, the trace headers, per timeline spec its length, the sha256
  of its float32 latency / overhead / done bytes and its ``summary()``, the
  Fig 5 miss-ratio grid's hit counts, and the claim values;
* ``tests/data/torch_golden_figs.json``: for the full-size Fig 2, 6, 7, 8
  and 9 drivers, each trace's length and sha256 with its hit or fault
  counts (Fig 2 per (workload, footprint) the TLB's hits; Fig 8 per mix
  the salts its seeds were made with and per partition count the BST-E
  threads' post-warm-up hits and accesses; Fig 9 per (workload, config,
  structure) the hit counts; Fig 6 the deduplicated page stream and the
  fault counts of both curves; Fig 7 the cycles), and every claim value;
* ``tests/data/torch_golden_examples.json``: ``examples/quickstart.py`` run
  by the JAX package (~5 s): its printed lines and the numbers behind them
  (the miss ratio at each partition count, the speedups, the translation
  overheads), which ``repro_torch.examples.quickstart`` must equal.

``chip_smoke.py`` reads the files on the card, without JAX;
``tests/test_torch_golden.py`` recomputes small ``hash_table`` entries so the
files cannot drift from the reference.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys
import time

import numpy as np

from repro.core import cpi, pagetable, timeline, tlbsim, traces
from repro.core.sparta import (SystemLatencies, TLBConfig, conventional_timelines,
                               sparta_timelines)
from repro.core.sweep import TLBSweepSpec, sweep_system, sweep_tlb
from repro.core.tlbsim import SystemSimConfig

DATA = pathlib.Path(__file__).resolve().parent / "data"
GOLDEN = DATA / "torch_golden_sweeps.json"
GOLDEN_TIMELINE = DATA / "torch_golden_timeline.json"
GOLDEN_FIGS = DATA / "torch_golden_figs.json"
GOLDEN_EXAMPLES = DATA / "torch_golden_examples.json"
ROOT = DATA.parents[1]

W4 = ("bst_external", "bst_internal", "hash_table", "skip_list")
WARMUP_FRAC = 0.25
FOOTPRINT_BYTES = 128 << 30
MAX_ACCESSES = 1_400_000

# The figure drivers' own tables (benchmarks/fig10_performance.py and
# benchmarks/fig4_tlb_sensitivity.py), repeated so this helper needs only the
# package; tests/test_torch_golden.py holds them equal to the drivers'.
FIG10_N_OPS = 25_000
FIG10_CACHE = TLBConfig(entries=256, ways=4)
FIG10_ACCEL_TLB = TLBConfig(entries=128, ways=4)
FIG10_MEM_TLB = TLBConfig(entries=128, ways=4)
FIG10_CONFIGS = (
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
FIG4_N_OPS = 40_000
FIG4_SIZES = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
FIG4_CONFIGS = (
    ("conv-4K", 1, 12),
    ("conv-2M", 1, 21),
    ("sparta4-4K", 4, 12),
    ("sparta4-2M", 4, 21),
    ("sparta128-4K", 128, 12),
    ("sparta128-2M", 128, 21),
)


def fig10_system_configs():
    return [
        SystemSimConfig(
            cache=FIG10_CACHE,
            accel_tlb=FIG10_ACCEL_TLB if design == "conventional" else None,
            mem_tlb=FIG10_MEM_TLB, num_partitions=parts, page_shift=shift,
            accel_probe_on_miss_only=True)
        for _, parts, shift, design in FIG10_CONFIGS
    ]


def fig4_specs():
    return [
        TLBSweepSpec(TLBConfig(entries=int(s), ways=4),
                     num_partitions=parts, page_shift=shift)
        for _, parts, shift in FIG4_CONFIGS
        for s in FIG4_SIZES
    ]


def trace_lines(workload: str, n_ops: int) -> np.ndarray:
    return traces.generate(workload, n_ops=n_ops, seed=0,
                           footprint_bytes=FOOTPRINT_BYTES,
                           max_accesses=MAX_ACCESSES).lines


def _counts(hits: np.ndarray, n0: int) -> list:
    """[hits over the whole stream, hits after warm-up] per row of ``hits``."""
    return [[int(h.sum()), int(h[n0:].sum())] for h in hits]


def _trace_header(lines: np.ndarray) -> dict:
    return {"num_accesses": int(lines.shape[0]),
            "sha256": hashlib.sha256(lines.tobytes()).hexdigest()}


def fig10_entry(workload: str, n_ops: int = FIG10_N_OPS) -> dict:
    lines = trace_lines(workload, n_ops)
    ev = sweep_system(lines, fig10_system_configs(), kernel_mode="reference")
    n0 = int(lines.shape[0] * WARMUP_FRAC)
    return {**_trace_header(lines),
            "cache": _counts(ev.cache_hit, n0),
            "accel": _counts(ev.accel_tlb_hit, n0),
            "mem": _counts(ev.mem_tlb_hit, n0)}


def fig4_entry(workload: str, n_ops: int = FIG4_N_OPS) -> dict:
    lines = trace_lines(workload, n_ops)
    res = sweep_tlb(lines, fig4_specs())  # JAX "auto": the stack-distance engine
    n0 = int(lines.shape[0] * WARMUP_FRAC)
    return {**_trace_header(lines), "tlb": _counts(res.hits, n0)}


# The timeline figures' tables (benchmarks/fig11_tail_latency.py and
# benchmarks/fig5_contention.py), repeated likewise.
FIG11_N_OPS = 8_000
FIG11_CAP = 400_000
FIG11_ACCELS = (1, 2, 4, 8, 16)
FIG11_CACHE = TLBConfig(entries=256, ways=4)
FIG11_ACCEL_TLB = TLBConfig(entries=128, ways=4)
FIG11_MEM_TLB = TLBConfig(entries=128, ways=4)
FIG11_PARTITIONS = 32
QUEUES = timeline.TimelineConfig(mshrs=8, tlb_ports=1, dram_banks=16)
FIG5_N_OPS = 12_000
FIG5_TL_CAP = 40_000
FIG5_MAX_ACCESSES = 1_200_000
FIG5_THREADS = (1, 2, 4, 8, 16)
FIG5_PARTS = (1, 4, 16, 64)
FIG5_TLB = TLBConfig(entries=128, ways=4)
FIG5_CACHE = TLBConfig(entries=256, ways=4)


def _f32_digest(x: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(x, dtype=np.float32).tobytes()).hexdigest()


def timeline_entry(res) -> dict:
    """One timeline spec's golden record."""
    return {"n": int(res.latency.shape[0]),
            "latency": _f32_digest(res.latency),
            "overhead": _f32_digest(res.overhead),
            "done": _f32_digest(res.done),
            "summary": res.summary()}


def fig11_system_configs():
    return [
        SystemSimConfig(cache=FIG11_CACHE, accel_tlb=FIG11_ACCEL_TLB,
                        mem_tlb=FIG11_MEM_TLB, num_partitions=1, page_shift=12),
        SystemSimConfig(cache=FIG11_CACHE, accel_tlb=None, mem_tlb=FIG11_MEM_TLB,
                        num_partitions=FIG11_PARTITIONS, page_shift=12),
    ]


def fig11_workload(workload: str, n_ops: int = FIG11_N_OPS, cap: int = FIG11_CAP,
                   accels=FIG11_ACCELS):
    """(interleaved lines, [TimelineSpec] in the driver's order) of one
    workload: per accel count, conventional then SPARTA-32."""
    inter = traces.interleave(
        traces.thread_traces(workload, accels[-1], n_ops=n_ops, seed=7))[:cap]
    evs = sweep_system(inter, fig11_system_configs(), kernel_mode="reference")
    specs = []
    for A in accels:
        ids = timeline.round_robin_accel_ids(inter.shape[0], A)
        specs.append(timeline.TimelineSpec(inter, evs[0], "conventional", cfg=QUEUES,
                                           num_accelerators=A, accel_ids=ids))
        specs.append(timeline.TimelineSpec(inter, evs[1], "sparta", cfg=QUEUES,
                                           num_partitions=FIG11_PARTITIONS,
                                           num_accelerators=A, accel_ids=ids))
    return inter, specs


def fig11_claims(p99_max: dict) -> dict:
    """C9a / C9b from the (conventional, SPARTA) p99 overhead per workload
    at the largest accelerator count, by the driver's rules."""
    wins = sum(1 for w in W4 if p99_max[w][1] < p99_max[w][0])
    red = [p99_max[w][0] / max(p99_max[w][1], 1e-9) for w in W4]
    return {"C9a": float(wins), "C9b": float(np.mean(red))}


def fig11_golden() -> dict:
    lat = SystemLatencies(n_sockets=8)
    headers, specs, spans = {}, [], {}
    for w in W4:
        inter, sp = fig11_workload(w)
        headers[w] = _trace_header(inter)
        spans[w] = (len(specs), len(specs) + len(sp))
        specs += sp
    res = timeline.sweep_timeline(specs, lat, kernel_mode="reference")
    out = {w: [timeline_entry(r) for r in res[a:b]] for w, (a, b) in spans.items()}
    p99_max = {w: (res[b - 2].overhead_percentile(99), res[b - 1].overhead_percentile(99))
               for w, (_, b) in spans.items()}
    return {"n_ops": FIG11_N_OPS, "cap": FIG11_CAP, "accels": list(FIG11_ACCELS),
            "specs": [[A, d] for A in FIG11_ACCELS for d in ("conventional", "sparta")],
            "traces": headers, "timeline": out, "claims": fig11_claims(p99_max)}


def fig5_interleaved(workload: str, threads: int, n_ops: int = FIG5_N_OPS) -> np.ndarray:
    return traces.interleave(
        traces.thread_traces(workload, threads, n_ops=n_ops, seed=7))[:FIG5_MAX_ACCESSES]


def fig5_specs():
    return [TLBSweepSpec(FIG5_TLB, num_partitions=p, page_shift=12) for p in FIG5_PARTS]


def fig5_grid_entry(workload: str, n_ops: int = FIG5_N_OPS) -> dict:
    """Per thread count: the trace header and per spec [hits, post-warm-up
    hits] (``sweep_tlb`` "auto", the stack-distance engine), plus the miss
    ratios the claims read."""
    out = {}
    for t in FIG5_THREADS:
        inter = fig5_interleaved(workload, t, n_ops)
        res = sweep_tlb(inter, fig5_specs())
        n0 = int(inter.shape[0] * WARMUP_FRAC)
        out[str(t)] = {**_trace_header(inter), "tlb": _counts(res.hits, n0),
                       "miss_ratios": [float(x) for x in res.miss_ratios]}
    return out


def fig5_timeline_entry(workload: str, n_ops: int = FIG5_N_OPS,
                        tl_cap: int = FIG5_TL_CAP) -> list:
    """The timeline half of one workload: SPARTA at 16 threads over the
    first ``tl_cap`` accesses, one record per partition count."""
    sl = fig5_interleaved(workload, FIG5_THREADS[-1], n_ops)[:tl_cap]
    evs = sweep_system(sl, [
        SystemSimConfig(cache=FIG5_CACHE, accel_tlb=None, mem_tlb=FIG5_TLB,
                        num_partitions=p, page_shift=12) for p in FIG5_PARTS],
        kernel_mode="reference")
    specs = [timeline.TimelineSpec(sl, evs[i], "sparta", cfg=QUEUES, num_partitions=p,
                                   num_accelerators=FIG5_THREADS[-1])
             for i, p in enumerate(FIG5_PARTS)]
    res = timeline.sweep_timeline(specs, SystemLatencies(n_sockets=8),
                                  kernel_mode="reference")
    return [timeline_entry(r) for r in res]


def fig5_claims(grid: dict) -> dict:
    """C3a / C3b from the grid's miss ratios, by the driver's rules."""
    def mr(w, p, t):
        return grid[w][str(t)]["miss_ratios"][FIG5_PARTS.index(p)]

    bumps = [mr(w, 1, 16) - mr(w, 1, 1) for w in W4]
    wins = sum(1 for w in W4 if mr(w, 16, 16) < mr(w, 1, 1))
    return {"C3a": float(np.mean(bumps)), "C3b": float(wins)}


def fig5_golden() -> dict:
    grid = {w: fig5_grid_entry(w) for w in W4}
    return {"n_ops": FIG5_N_OPS, "tl_cap": FIG5_TL_CAP, "threads": list(FIG5_THREADS),
            "parts": list(FIG5_PARTS), "grid": grid,
            "timeline": {w: fig5_timeline_entry(w) for w in W4},
            "claims": fig5_claims(grid)}


# The Fig 2, 6, 7, 8 and 9 drivers' tables (benchmarks/fig2_pagewalk.py,
# fig6_pagefault.py, fig7_miss_penalty.py, fig8_multiprog.py,
# fig9_accel_tlb.py), repeated likewise.
GIB = 1 << 30
FIG2_N_OPS = 30_000
FIG2_FOOTPRINTS_GB = (1, 2, 4, 8, 16, 32, 64, 128)
FIG2_TLB = TLBConfig(entries=1536, ways=4)
FIG8_N_OPS = 10_000
FIG8_SEED = 11
FIG8_CAP = 2_400_000
FIG8_PARTS = (1, 4, 16, 64)
FIG8_TLB = TLBConfig(entries=128, ways=4)
FIG8_MIXES = {
    "bst_e_x1": [("bst_external", 1, 32 * GIB, 0)],
    "bst_e_x2": [("bst_external", 2, 32 * GIB, 0)],
    "bst_e_x4": [("bst_external", 4, 32 * GIB, 0)],
    "+hash_x4": [("bst_external", 4, 32 * GIB, 0), ("hash_table", 4, 32 * GIB, 32)],
    "+bsti+skip": [("bst_external", 4, 32 * GIB, 0), ("hash_table", 4, 32 * GIB, 32),
                   ("bst_internal", 4, 32 * GIB, 64), ("skip_list", 4, 32 * GIB, 96)],
}
FIG9_N_OPS = 25_000
FIG9_ENTRIES = (1, 2, 4, 8, 16, 32, 64, 128)
FIG9_P = 8
FIG9_MEM_TLB = TLBConfig(entries=128, ways=4)
FIG9_CACHE = TLBConfig(entries=256, ways=4)
FIG6_N_OPS = 120_000
FIG6_MEM_FRACS = (0.75, 0.81, 0.88, 0.94, 0.97, 1.0, 1.03, 1.06, 1.12)
FIG6_NODE_OVERHEAD_FRAC = 0.003
FIG6_JITTER = 0.04


def fig2_entry(workload: str, n_ops: int = FIG2_N_OPS) -> dict:
    """Per footprint: the trace header, [hits, post-warm-up hits] of the
    1,536-entry TLB and the MPKI the claim reads."""
    out = {}
    for gb in FIG2_FOOTPRINTS_GB:
        tr = traces.generate(workload, n_ops=n_ops, footprint_bytes=gb * GIB,
                             zipf_keys=1.4 if workload == "hash_table" else 0.0,
                             max_accesses=MAX_ACCESSES)
        res = tlbsim.simulate_tlb(tr.vpns(12), FIG2_TLB)
        n0 = tr.num_accesses - res.n_warm
        out[str(gb)] = {**_trace_header(tr.lines), "tlb": _counts(res.hits[None], n0)[0],
                        "mpki": 1000.0 * res.miss_ratio / tr.instr_per_access}
    return out


def fig2_claims(entries: dict) -> dict:
    """C1 from the MPKI curves, by the driver's rule."""
    last, first = str(FIG2_FOOTPRINTS_GB[-1]), str(FIG2_FOOTPRINTS_GB[0])
    growth = [entries[w][last]["mpki"] / max(entries[w][first]["mpki"], 1e-9) for w in W4]
    return {"C1": float(np.mean(growth))}


def fig8_salts() -> dict:
    """This process's ``hash(w) % 97``, the JAX driver's seed salt."""
    return {w: hash(w) % 97 for spec in FIG8_MIXES.values() for w, *_ in spec}


def fig8_mix(n_ops: int, seed: int, spec, salts: dict):
    """The JAX driver's ``_mix`` with the salts given."""
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
    return inter, who, [w for w, _ in streams]


def fig8_entry(name: str, salts: dict, n_ops: int = FIG8_N_OPS) -> dict:
    """One mix: the capped trace's header and per partition count the BST-E
    threads' [post-warm-up hits, accesses] (``sweep_tlb`` "auto", the
    stack-distance engine), plus the miss ratios the claims read."""
    inter, who, names = fig8_mix(n_ops, FIG8_SEED, FIG8_MIXES[name], salts)
    inter = inter[:FIG8_CAP]
    who = who[:inter.shape[0]]
    res = sweep_tlb(inter >> 6, [TLBSweepSpec(FIG8_TLB, num_partitions=p) for p in FIG8_PARTS])
    n0 = res.hits.shape[1] - res.n_warm
    is_bste = np.array([w == "bst_external" for w in names])[who[n0:]]
    bste, miss = [], []
    for h in res.hits:
        h = h[n0:][is_bste]
        bste.append([int(h.sum()), int(h.size)])
        miss.append(float(1.0 - h.mean()) if h.size else 1.0)
    return {**_trace_header(inter), "bste": bste, "miss_ratios": miss}


def fig8_claims(entries: dict) -> dict:
    """C3c / C3d from the BST-E miss ratios, by the driver's rules."""
    full = entries["+bsti+skip"]["miss_ratios"]
    return {"C3c": float(full[0] - entries["bst_e_x4"]["miss_ratios"][0]),
            "C3d": float((full[0] - full[-1]) / max(full[0], 1e-9))}


def fig9_system_configs():
    cfgs = [SystemSimConfig(cache=FIG9_CACHE, accel_tlb=TLBConfig(entries=128, ways=4),
                            mem_tlb=FIG9_MEM_TLB, num_partitions=1,
                            accel_probe_on_miss_only=True)]
    cfgs += [SystemSimConfig(cache=FIG9_CACHE, accel_tlb=TLBConfig(entries=e, ways=4),
                             mem_tlb=FIG9_MEM_TLB, num_partitions=FIG9_P,
                             accel_probe_on_miss_only=False) for e in FIG9_ENTRIES]
    cfgs.append(SystemSimConfig(cache=FIG9_CACHE, accel_tlb=None, mem_tlb=FIG9_MEM_TLB,
                                num_partitions=FIG9_P))
    return cfgs


def fig9_entry(workload: str, n_ops: int = FIG9_N_OPS) -> dict:
    """As :func:`fig10_entry` for Fig 9's ten configs, plus the speedups the
    claims read."""
    lines = trace_lines(workload, n_ops)
    cfgs = fig9_system_configs()
    ev = sweep_system(lines, cfgs, kernel_mode="reference")
    n0 = int(lines.shape[0] * WARMUP_FRAC)
    lat, ipa = SystemLatencies(), traces.INSTR_PER_ACCESS[workload]
    base = cpi.evaluate_design("conventional", ev[0], lat, instr_per_access=ipa)
    speedups = [float(cpi.evaluate_design("sparta", ev[1 + i], lat, instr_per_access=ipa,
                                          physical_cache=True).speedup_over(base))
                for i in range(len(FIG9_ENTRIES))]
    speedups.append(float(cpi.evaluate_design("sparta", ev[len(cfgs) - 1], lat,
                                              instr_per_access=ipa).speedup_over(base)))
    return {**_trace_header(lines),
            "cache": _counts(ev.cache_hit, n0),
            "accel": _counts(ev.accel_tlb_hit, n0),
            "mem": _counts(ev.mem_tlb_hit, n0),
            "speedups": speedups}


def fig9_claims(entries: dict) -> dict:
    """C7a / C7b from the speedups, by the driver's rules."""
    idx8 = FIG9_ENTRIES.index(8)
    res = {w: entries[w]["speedups"] for w in W4}
    return {"C7a": float(sum(1 for w in W4 if res[w][idx8] >= 1.0)),
            "C7b": float(np.mean([res[w][-2] - res[w][idx8] for w in W4]))}


def fig6_pages(n_ops: int = FIG6_N_OPS) -> np.ndarray:
    """The driver's page stream: rocksdb's 4 KB pages, consecutive repeats
    removed."""
    vpns = traces.generate("rocksdb", n_ops=n_ops, seed=0, footprint_bytes=16 * GIB,
                           max_accesses=2_000_000).vpns(12)
    return vpns[np.concatenate([[True], vpns[1:] != vpns[:-1]])]


def fig6_golden(n_ops: int = FIG6_N_OPS) -> dict:
    """The page stream's header and unique pages, the memory sizes, and both
    curves' fault rates and counts; the claims by the driver's rules."""
    vpns = fig6_pages(n_ops)
    n = int(vpns.shape[0])
    unique = int(np.unique(vpns).size)
    frames = [max(32, int(fr * unique)) for fr in FIG6_MEM_FRACS]
    overhead = max(1, int(FIG6_NODE_OVERHEAD_FRAC * unique))
    c1 = pagetable.page_fault_curve(vpns, frames)
    c32 = pagetable.page_fault_curve(vpns, frames, num_partitions=32,
                                     node_overhead_frames=overhead,
                                     node_capacity_jitter=FIG6_JITTER)
    ref_idx = FIG6_MEM_FRACS.index(0.94)
    need = next((fr for fr, f in zip(FIG6_MEM_FRACS, c32) if f <= c1[ref_idx]), None)
    offset = (need - FIG6_MEM_FRACS[ref_idx]) * 16.0 if need else float("nan")
    return {"n_ops": n_ops, **_trace_header(vpns), "unique": unique, "frames": frames,
            "overhead_frames": overhead,
            "rates_1": [float(x) for x in c1], "rates_32": [float(x) for x in c32],
            "faults_1": [int(round(x * n)) for x in c1],
            "faults_32": [int(round(x * n)) for x in c32],
            "claims": {"C4a": float(c32[0] - c32[-1]), "C4b": float(offset)}}


def fig7_golden() -> dict:
    """The miss cycles of both machines and the claims, by the driver's rules."""
    out, red = {}, {}
    for sockets in (2, 8):
        lat = SystemLatencies(n_sockets=sockets)
        conv, sp = conventional_timelines(lat)[3], sparta_timelines(lat)[3]
        red[sockets] = conv / sp
        out[f"{sockets}socket"] = {"conventional_cycles": float(conv),
                                   "sparta_cycles": float(sp),
                                   "normalized": float(sp / conv)}
    return {"cycles": out, "claims": {"C5a": out["8socket"]["sparta_cycles"],
                                      "C5b": float(red[8] / red[2])}}


def _timed(what: str, make):
    t0 = time.perf_counter()
    out = make()
    print(f"{what} in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return out


def figs_golden() -> dict:
    salts = fig8_salts()
    fig2 = {w: _timed(f"fig2 {w}", lambda: fig2_entry(w)) for w in W4}
    fig8 = {name: _timed(f"fig8 {name}", lambda: fig8_entry(name, salts))
            for name in FIG8_MIXES}
    fig9 = {w: _timed(f"fig9 {w}", lambda: fig9_entry(w)) for w in W4}
    return {
        "warmup_frac": WARMUP_FRAC,
        "fig2": {"n_ops": FIG2_N_OPS, "footprints_gb": list(FIG2_FOOTPRINTS_GB),
                 "workloads": fig2, "claims": fig2_claims(fig2)},
        "fig8": {"n_ops": FIG8_N_OPS, "cap": FIG8_CAP, "parts": list(FIG8_PARTS),
                 "salts": salts, "mixes": fig8, "claims": fig8_claims(fig8)},
        "fig9": {"n_ops": FIG9_N_OPS, "entries": list(FIG9_ENTRIES), "workloads": fig9,
                 "claims": fig9_claims(fig9)},
        "fig6": _timed("fig6", fig6_golden),
        "fig7": fig7_golden(),
    }


def jax_quickstart() -> dict:
    """``examples/quickstart.py`` run in this process by the JAX package:
    its printed lines and the numbers it printed, at full precision (each
    ``tlbsim.miss_ratio`` result is recorded as the example calls it)."""
    import contextlib
    import io
    import runpy

    real, miss = tlbsim.miss_ratio, []

    def recording(*args, **kw):
        miss.append((kw.get("num_partitions", 1), real(*args, **kw)))
        return miss[-1][1]

    out = io.StringIO()
    tlbsim.miss_ratio = recording
    try:
        with contextlib.redirect_stdout(out):
            g = runpy.run_path(str(ROOT / "examples" / "quickstart.py"), run_name="__main__")
    finally:
        tlbsim.miss_ratio = real
    base, sp, ideal = g["base"], g["sp"], g["ideal"]
    before, after = base.access.translation_overhead, sp.access.translation_overhead
    return {"accesses": g["tr"].num_accesses, "miss_ratio": {str(P): m for P, m in miss},
            "speedup": sp.speedup_over(base), "ideal_speedup": ideal.speedup_over(base),
            "overhead_conventional": before, "overhead_sparta": after,
            "overhead_reduction": before / after, "lines": out.getvalue().splitlines()}


def _write(path: pathlib.Path, out: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1) + "\n")


def write_sweeps() -> None:
    out = {
        "warmup_frac": WARMUP_FRAC,
        "fig10": {"n_ops": FIG10_N_OPS, "configs": [c[0] for c in FIG10_CONFIGS],
                  "workloads": {}},
        "fig4": {"n_ops": FIG4_N_OPS,
                 "specs": [[label, s] for label, *_ in FIG4_CONFIGS for s in FIG4_SIZES],
                 "workloads": {}},
    }
    for fig, entry in (("fig10", fig10_entry), ("fig4", fig4_entry)):
        for w in W4:
            t0 = time.perf_counter()
            out[fig]["workloads"][w] = entry(w)
            print(f"{fig} {w}: {out[fig]['workloads'][w]['num_accesses']} accesses "
                  f"in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    _write(GOLDEN, out)


def write_timeline() -> None:
    out = {"warmup_frac": WARMUP_FRAC}
    for fig, make in (("fig11", fig11_golden), ("fig5", fig5_golden)):
        t0 = time.perf_counter()
        out[fig] = make()
        print(f"{fig} in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    _write(GOLDEN_TIMELINE, out)


def write_figs() -> None:
    t0 = time.perf_counter()
    _write(GOLDEN_FIGS, figs_golden())
    print(f"figs in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)


def write_examples() -> None:
    _write(GOLDEN_EXAMPLES, {"source": "examples/quickstart.py run by the JAX package",
                             "quickstart": jax_quickstart()})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Write the port's golden files from JAX.")
    ap.add_argument("--only", choices=("sweeps", "timeline", "figs", "examples"),
                    help="write only this file (default: all four)")
    args = ap.parse_args(argv)
    if args.only in (None, "sweeps"):
        write_sweeps()
    if args.only in (None, "timeline"):
        write_timeline()
    if args.only in (None, "figs"):
        write_figs()
    if args.only in (None, "examples"):
        write_examples()


if __name__ == "__main__":
    main()
