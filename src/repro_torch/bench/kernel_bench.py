"""Kernel and engine benchmarks on the card (the port of
``benchmarks/kernel_bench.py``).

* **Kernel rows**: each kernel family's CUDA kernel held against its plain
  version on the same inputs, at the shapes of the JAX package's kernel
  bench (drawn from ``numpy.random.default_rng(0)`` in its order):
  bit-identity for K1 ``tlb_sim``, K2 ``system_sim``, K3 ``stackdist`` and
  K4 ``timeline``; 2e-5 for K5 ``flash_attention`` and K6
  ``paged_attention``, 5e-4 for K7 ``rwkv6_scan`` and K8 ``mamba2_scan`` (the
  tolerances of tests/test_kernels.py).  A row that disagrees raises.
* **Engine benches** ``sweep``, ``timeline``, ``timeline_batched`` and
  ``system_batched``: each backend of the engine timed through
  :func:`repro_torch.core.benchtime.measure` (every rep ends in a
  synchronise).  The kernel takes one warm-up and ``ENGINE_REPS`` reps; a
  plain version (a Python loop of small ops a trace step on the card) one
  rep and no warm-up, at the sizes of :data:`SIZES`, which the plain
  versions bound.  Each backend's outputs must be bit-identical, or the row
  is not recorded.

Each engine row is stamped with :func:`benchtime.device_metadata` (the card's
name and power limit; it refuses the CPU), appended to the port's own
history (:data:`HISTORY_PATH`, or ``--history``; never the JAX package's
``BENCH_sweep.json``) under a file lock and ``os.replace``, and fed to
:func:`repro_torch.core.dispatch.ingest_bench_entries` (the kernel's time
as ``t_cuda_s``), which is how ``kernel_mode="auto"`` learns measured rates.
``--check`` verifies the history (every row bit-identical, every required
bench present) and runs :mod:`repro_torch.bench.perfcheck`'s band gate;
``--update-refs`` re-baselines ``references.json`` from it.

    PYTHONPATH=src python -m repro_torch.bench.kernel_bench --quick     # on the card
    PYTHONPATH=src python -m repro_torch.bench.kernel_bench --check --history PATH
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.bench.common import CACHE, print_csv
from repro_torch.kernels._build import BUILD_DIR

HISTORY_PATH = BUILD_DIR / "bench_history.json"
CALIBRATION_DIR = CACHE / "calibration"

ENGINE_REPS = 2          # the kernel's reps after one warm-up (min kept)
KERNEL_REPS = 5          # a kernel row's reps
# Per bench, (quick, full) sizes: the sweep's and the timeline's accesses,
# the batched timeline's accesses a sim, the system sweep's accesses.  The
# JAX package's quick sizes (120,000 / 30,000 / 8,000 / 10,000) are the full
# ones here: on the card the plain versions take 0.26 ms (the sweep) to
# 1.65 ms (the timeline) a trace step, and the looped system sweep 1 ms a
# step a config (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, the kernel benches).
SIZES = {"sweep": (12_000, 120_000), "timeline": (2_000, 30_000),
         "timeline_batched": (300, 8_000), "system_batched": (1_000, 10_000)}
TOLERANCES = {"flash_attention": 2e-5, "paged_attention": 2e-5, "rwkv6_scan": 5e-4,
              "mamba2_scan": 5e-4, "tlb_sim": 0.0, "system_sim": 0.0,
              "stackdist_scan": 0.0, "timeline_sim": 0.0}
# Every engine the gate requires a row of: a silently skipped engine fails.
REQUIRED_BENCHES = ("sweep", "timeline", "timeline_batched", "system_batched")


def _size(bench: str, quick: bool) -> int:
    return SIZES[bench][0 if quick else 1]


def _section(name: str, profile: bool):
    if not profile:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


# ---------------------------------------------------------------------------
# The kernel rows.
# ---------------------------------------------------------------------------

def _kernel_cases(dev):
    """(name, kernel call, plain call, error of a result against the other)
    for each kernel family, inputs drawn as the JAX kernel bench draws them."""
    import torch

    from repro_torch.core import traces
    from repro_torch.core.sparta import TLBConfig
    from repro_torch.core.sweep import sweep_system
    from repro_torch.core.tlbsim import SystemSimConfig
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_scan import mamba2_scan
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.stackdist import stack_scan
    from repro_torch.kernels.timeline import TimelineParams, timeline_sim
    from repro_torch.kernels.tlb_sim import tlb_sim

    rng = np.random.default_rng(0)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x)).to(dev, dtype)

    def max_abs(a, b):
        return float(max((x.float() - y.float()).abs().max() for x, y in zip(a, b)))

    def mismatch(a, b):
        return float(sum((x != y).float().mean() for x, y in zip(a, b)))

    cases = []
    B, Hq, Hkv, T, D = 2, 8, 2, 256, 64
    q, k, v = (t(rng.standard_normal(s)) for s in ((B, Hq, T, D), (B, Hkv, T, D),
                                                    (B, Hkv, T, D)))
    cases.append(("flash_attention",
                  lambda m: (flash_attention(q, k, v, kernel_mode=m),), max_abs))

    slots, page, pages = 64, 32, 8
    q1 = t(rng.standard_normal((B, Hq, D)))
    kp, vp = (t(rng.standard_normal((slots, page, Hkv, D))) for _ in range(2))
    tbl = t(rng.choice(slots, (B, pages), replace=False), torch.int32)
    ctx = t(rng.integers(1, pages * page, B), torch.int32)
    cases.append(("paged_attention",
                  lambda m: (paged_attention(q1, kp, vp, tbl, ctx, kernel_mode=m),), max_abs))

    Bh, H, Ts, N = 2, 4, 128, 32
    r, kk, vv = (t(rng.standard_normal((Bh, H, Ts, N)) * 0.5) for _ in range(3))
    w = t(rng.uniform(0.8, 0.999, (Bh, H, Ts, N)))
    u = t(rng.standard_normal((H, N)) * 0.5)
    cases.append(("rwkv6_scan",
                  lambda m: rwkv6_scan(r, kk, vv, w, u, chunk=32, kernel_mode=m), max_abs))

    P, Nst = 32, 16
    x = t(rng.standard_normal((Bh, H, Ts, P)) * 0.5)
    dt = t(rng.uniform(0.001, 0.1, (Bh, H, Ts)))
    A = t(-rng.uniform(0.5, 4.0, (H,)))
    Bm, C = (t(rng.standard_normal((Bh, Ts, Nst)) * 0.5) for _ in range(2))
    Dp = t(rng.standard_normal((H,)))
    cases.append(("mamba2_scan",
                  lambda m: mamba2_scan(x, dt, A, Bm, C, Dp, chunk=32, kernel_mode=m), max_abs))

    s = t(rng.integers(0, 64, 4096), torch.int32)
    tg = t(rng.integers(0, 50, 4096), torch.int32)
    cases.append(("tlb_sim", lambda m: (tlb_sim(s, tg, 64, 4, kernel_mode=m),), mismatch))

    L, Cs, W = 8, 128, 4
    tags = t(rng.integers(0, 40, (L, Cs)), torch.int32)
    flags = np.zeros((L, Cs), bool)
    flags[:, 0] = True
    flags[rng.random((L, Cs)) < 0.02] = True
    flags = t(flags, torch.bool)
    init = t(rng.integers(0, 40, (L, W)), torch.int32)
    cases.append(("stackdist_scan",
                  lambda m: stack_scan(tags, flags, init, kernel_mode=m), mismatch))

    n = 4096
    tp = TimelineParams(mem_tlb=True, num_accels=4, mshrs=4, num_partitions=8, tlb_ports=2,
                        dram_banks=8)
    cols = (t(rng.integers(0, tp.num_accels, n), torch.int32),
            t(rng.integers(0, tp.num_partitions, n), torch.int32),
            t(rng.integers(0, tp.dram_banks, n), torch.int32),
            t(rng.integers(0, tp.dram_banks, n), torch.int32),
            t(rng.random(n) < 0.5, torch.int32), t(rng.random(n) < 0.6, torch.int32),
            t(rng.random(n) < 0.7, torch.int32), torch.zeros(n, device=dev))
    cases.append(("timeline_sim", lambda m: timeline_sim(*cols, tp, kernel_mode=m), mismatch))

    # K2 has no row in the JAX kernel bench: its system_batched bench's
    # first two configs on 4,096 accesses, one launch.
    lines = traces.generate("bst_external", n_ops=2 * 4096 // 5, max_accesses=4096).lines
    cache, mem = TLBConfig(entries=256, ways=4), TLBConfig(entries=128, ways=4)
    cfgs = [SystemSimConfig(cache=cache, accel_tlb=TLBConfig(entries=128, ways=4),
                            mem_tlb=mem, num_partitions=1, page_shift=12),
            SystemSimConfig(cache=cache, accel_tlb=None, mem_tlb=mem, num_partitions=32,
                            page_shift=12)]

    def system(m):
        ev = sweep_system(lines, cfgs, kernel_mode=m, device=dev)
        return ev.cache_hit, ev.accel_tlb_hit, ev.mem_tlb_hit

    cases.append(("system_sim", system, mismatch))
    return cases


def kernel_rows(device="cuda", *, profile: bool = False) -> List[list]:
    """[name, us a kernel call, us a plain call, error, tolerance] a kernel
    family, the kernel timed over ``KERNEL_REPS`` reps after a warm-up, the
    plain version once (its result is what the kernel's is held against).
    Raises ``AssertionError`` naming a kernel that disagrees."""
    from repro_torch.core.benchtime import measure
    from repro_torch.kernels.common import as_device

    dev = as_device(device)
    if dev.type != "cuda":
        raise RuntimeError("kernel_rows: the kernels run on the card only")
    rows = []
    for name, call, error in _kernel_cases(dev):
        with _section(f"kernel:{name}", profile):
            m_cuda = measure(call, "cuda", reps=KERNEL_REPS)
            m_plain = measure(call, "reference", reps=1, warmup=0)
        err = error(m_cuda.result, m_plain.result)
        rows.append([name, m_cuda.best_us, m_plain.best_us, err, TOLERANCES[name]])
    print_csv("Kernel benches (CUDA kernel against its plain version, same inputs)",
              ["kernel", "us_per_call(cuda)", "us_per_call(plain)", "max_err_vs_plain",
               "tolerance"], rows)
    bad = [(r[0], r[3], r[4]) for r in rows if not r[3] <= r[4]]
    assert not bad, f"kernels disagree with their plain versions: {bad}"
    return rows


# ---------------------------------------------------------------------------
# The history and the calibration store.
# ---------------------------------------------------------------------------

def append_entry(entry: dict, path: pathlib.Path = HISTORY_PATH, *,
                 metadata: Optional[dict] = None) -> dict:
    """Append ``entry``, stamped with ``metadata`` (default: the card's
    :func:`benchtime.device_metadata`), to the history at ``path`` under a
    file lock, committing by a temporary file and ``os.replace`` (a reader
    never sees a torn file, concurrent runs never lose a row).  A corrupt
    history raises and is left as it is.  Returns the stamped row."""
    from repro_torch.checkpoint.checkpoint import file_lock
    from repro_torch.core.benchtime import device_metadata

    path = pathlib.Path(path)
    row = {**(device_metadata() if metadata is None else metadata), **entry}
    path.parent.mkdir(parents=True, exist_ok=True)
    with file_lock(path.with_name(path.name + ".lock")):
        hist = {"history": []}
        if path.exists():
            try:
                prior = json.loads(path.read_text())
            except json.JSONDecodeError as e:
                raise RuntimeError(f"{path} exists but is not valid JSON ({e}); refusing to "
                                   f"overwrite the recorded history") from e
            if not isinstance(prior, dict):
                raise RuntimeError(f"{path} is valid JSON but not a {{'history': [...]}} "
                                   f"document; refusing to overwrite it")
            hist = prior
        hist.setdefault("history", []).append(row)
        tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}")
        tmp.write_text(json.dumps(hist, indent=1))
        os.replace(tmp, path)
    return row


def record_calibration(row: dict, calibration_dir: pathlib.Path = CALIBRATION_DIR) -> int:
    """Feed a stamped row's per-backend times to the dispatch calibration
    table of its card under ``calibration_dir``; returns the rates
    recorded.  A store that cannot be written is reported, not raised: the
    bench's own result stands."""
    from repro_torch.core import dispatch

    keys = ("schema_version", "platform", "device_kind")
    try:
        store = dispatch.CalibrationStore.for_dir(
            calibration_dir, device={k: row[k] for k in keys if k in row})
        n = dispatch.ingest_bench_entries(store, [row])
        print(f"  calibration: {n} backend rate(s) recorded -> {store.path}")
        return n
    except (OSError, dispatch.CalibrationCorruptError) as e:
        print(f"  calibration: NOT recorded ({e})")
        return 0


def _record(entry: dict, identical: bool, history: pathlib.Path,
            calibration_dir: pathlib.Path) -> dict:
    """Assert, then record: a diverging backend's time is not a result."""
    assert identical, f"{entry['bench']}: a backend diverged from the plain version"
    row = append_entry(entry, history)
    record_calibration(row, calibration_dir)
    return row


def _timed(fn: Callable, *, kernel: bool):
    from repro_torch.core.benchtime import measure

    m = (measure(fn, reps=ENGINE_REPS) if kernel else measure(fn, reps=1, warmup=0))
    return m, m.result


def _entry(bench: str, quick: bool, **kw) -> dict:
    return {"written_at": time.strftime("%Y-%m-%d %H:%M:%S"), "bench": bench, "backend": "cuda", "mode": "cuda",
            "quick": quick, **kw}


# ---------------------------------------------------------------------------
# The engine benches.
# ---------------------------------------------------------------------------

def _sweep_bench(quick, dev, history, calibration_dir) -> dict:
    """Fig 4-style TLB sweep: the plain version, the stack-distance engine
    (K3) and the set-parallel kernel (K1) on one trace, 8 specs."""
    from repro_torch.core import traces
    from repro_torch.core.sparta import TLBConfig
    from repro_torch.core.sweep import TLBSweepSpec, sweep_tlb

    n_acc = _size("sweep", quick)
    tr = traces.generate("bst_external", n_ops=2 * n_acc // 5, max_accesses=n_acc)
    specs = [TLBSweepSpec(TLBConfig(entries=e, ways=4), num_partitions=p, page_shift=12)
             for p in (1, 128) for e in (64, 128, 256, 512)]

    def run(mode):
        return lambda: sweep_tlb(tr.lines, specs, kernel_mode=mode, device=dev).hits

    (m_ref, ref), (m_sd, sd), (m_k, kern) = (
        _timed(run(mode), kernel=mode != "reference")
        for mode in ("reference", "stackdist", "cuda"))
    identical = bool(ref.equal(sd) and ref.equal(kern))
    entry = _entry("sweep", quick, n_accesses=int(tr.num_accesses), n_configs=len(specs),
                   t_reference_s=m_ref.best_s, t_stackdist_s=m_sd.best_s,
                   t_cuda_s=m_k.best_s, speedup=m_ref.best_s / m_k.best_s,
                   bit_identical=identical, reps=ENGINE_REPS,
                   spread_frac={"t_stackdist_s": m_sd.spread_frac,
                                "t_cuda_s": m_k.spread_frac})
    print_csv(f"Sweep engine (Fig 4-style, {tr.num_accesses} accesses, 8 configs)",
              ["backend", "seconds", "vs_reference"],
              [["reference", m_ref.best_s, 1.0],
               ["stackdist (K3)", m_sd.best_s, m_ref.best_s / m_sd.best_s],
               ["cuda (K1)", m_k.best_s, m_ref.best_s / m_k.best_s]])
    print(f"  stackdist and cuda bit-identical to reference: {identical}")
    return _record(entry, identical, history, calibration_dir)


def _timeline_bench(quick, dev, history, calibration_dir) -> dict:
    """Fig 11-style single timeline (4 accelerators, SPARTA-32): the plain
    version against K4."""
    from repro_torch.core import timeline, traces
    from repro_torch.core.sparta import SystemLatencies, TLBConfig
    from repro_torch.core.sweep import sweep_system
    from repro_torch.core.tlbsim import SystemSimConfig

    n_acc = _size("timeline", quick)
    streams = traces.thread_traces("bst_external", 4, n_ops=max(2 * n_acc // 20, 200), seed=7)
    inter = traces.interleave(streams)[:n_acc]
    ev = sweep_system(inter, [SystemSimConfig(
        cache=TLBConfig(entries=256, ways=4), accel_tlb=None,
        mem_tlb=TLBConfig(entries=128, ways=4), num_partitions=32, page_shift=12)],
        device=dev)[0]
    lat = SystemLatencies()
    kw = dict(cfg=timeline.TimelineConfig(mshrs=8, tlb_ports=1, dram_banks=16),
              num_partitions=32, num_accelerators=4, device=dev)

    def run(mode):
        return lambda: timeline.simulate_timeline(inter, ev, "sparta", lat, kernel_mode=mode,
                                                  **kw)

    (m_ref, ref), (m_k, kern) = (_timed(run(m), kernel=m == "cuda")
                                 for m in ("reference", "cuda"))
    identical = all(np.array_equal(getattr(ref, f), getattr(kern, f))
                    for f in ("latency", "overhead", "done"))
    entry = _entry("timeline", quick, n_accesses=int(inter.shape[0]),
                   t_reference_s=m_ref.best_s, t_cuda_s=m_k.best_s,
                   speedup=m_ref.best_s / m_k.best_s, bit_identical=identical,
                   reps=ENGINE_REPS, spread_frac={"t_cuda_s": m_k.spread_frac})
    print_csv(f"Timeline engine (Fig 11-style, {inter.shape[0]} accesses, 4 accels, SPARTA-32)",
              ["backend", "seconds", "vs_reference"],
              [["reference", m_ref.best_s, 1.0], ["cuda (K4)", m_k.best_s,
                                                  m_ref.best_s / m_k.best_s]])
    print(f"  timeline kernel bit-identical to reference: {identical}")
    return _record(entry, identical, history, calibration_dir)


def _timeline_batched_bench(quick, dev, history, calibration_dir) -> dict:
    """Fig 11-scale batched timeline: per-sim plain calls, the batched plain
    version and the batched kernel (K4)."""
    from repro_torch.core import timeline, traces
    from repro_torch.core.sparta import SystemLatencies, TLBConfig
    from repro_torch.core.sweep import sweep_system
    from repro_torch.core.tlbsim import SystemSimConfig

    workloads = (("bst_external", "hash_table") if quick else
                 ("bst_external", "bst_internal", "hash_table", "skip_list"))
    accel_counts = (1, 4, 16) if quick else (1, 2, 4, 8, 16)
    n_acc = _size("timeline_batched", quick)
    lat = SystemLatencies(n_sockets=8)
    queues = timeline.TimelineConfig(mshrs=8, tlb_ports=1, dram_banks=16)
    cache, mem = TLBConfig(entries=256, ways=4), TLBConfig(entries=128, ways=4)
    specs = []
    for w in workloads:
        streams = traces.thread_traces(w, max(accel_counts), n_ops=max(2 * n_acc // 20, 200),
                                       seed=7)
        inter = traces.interleave(streams)[:n_acc]
        evs = sweep_system(inter, [
            SystemSimConfig(cache=cache, accel_tlb=TLBConfig(entries=128, ways=4),
                            mem_tlb=mem, num_partitions=1, page_shift=12),
            SystemSimConfig(cache=cache, accel_tlb=None, mem_tlb=mem, num_partitions=32,
                            page_shift=12)], device=dev)
        for A in accel_counts:
            ids = timeline.round_robin_accel_ids(inter.shape[0], A)
            specs.append(timeline.TimelineSpec(inter, evs[0], "conventional", cfg=queues,
                                               num_accelerators=A, accel_ids=ids))
            specs.append(timeline.TimelineSpec(inter, evs[1], "sparta", cfg=queues,
                                               num_partitions=32, num_accelerators=A,
                                               accel_ids=ids))

    def looped():
        return [timeline.simulate_timeline(
            sp.lines, sp.events, sp.design, lat, cfg=sp.cfg, num_partitions=sp.num_partitions,
            num_accelerators=sp.num_accelerators, accel_ids=sp.accel_ids,
            kernel_mode="reference", device=dev) for sp in specs]

    def batched(mode):
        return lambda: timeline.sweep_timeline(specs, lat, kernel_mode=mode, device=dev)

    m_loop, ref = _timed(looped, kernel=False)
    m_bat, bat = _timed(batched("reference"), kernel=False)
    m_k, kern = _timed(batched("cuda"), kernel=True)

    def same(xs):
        return all(np.array_equal(getattr(x, f), getattr(r, f))
                   for x, r in zip(xs, ref) for f in ("latency", "overhead", "done"))

    identical = same(bat) and same(kern)
    entry = _entry("timeline_batched", quick, n_sims=len(specs), n_accesses=int(n_acc),
                   t_looped_s=m_loop.best_s, t_batched_s=m_bat.best_s, t_cuda_s=m_k.best_s,
                   speedup=m_loop.best_s / m_k.best_s, bit_identical=identical,
                   reps=ENGINE_REPS, spread_frac={"t_cuda_s": m_k.spread_frac})
    print_csv(f"Batched timeline engine ({len(specs)} sims x {n_acc} accesses)",
              ["backend", "seconds", "vs_looped"],
              [["looped reference (per-sim)", m_loop.best_s, 1.0],
               ["batched reference", m_bat.best_s, m_loop.best_s / m_bat.best_s],
               ["batched cuda (K4)", m_k.best_s, m_loop.best_s / m_k.best_s]])
    print(f"  batched reference and cuda bit-identical to the looped reference: {identical}")
    return _record(entry, identical, history, calibration_dir)


def _system_batched_bench(quick, dev, history, calibration_dir) -> dict:
    """Fig 10's design grid (9 heterogeneous configs) on one trace:
    per-config plain calls, the batched plain version and the batched
    kernel (K2)."""
    from repro_torch.core import traces
    from repro_torch.core.sparta import TLBConfig
    from repro_torch.core.sweep import sweep_system
    from repro_torch.core.tlbsim import SystemSimConfig

    n_acc = _size("system_batched", quick)
    tr = traces.generate("bst_external", n_ops=2 * n_acc // 5, max_accesses=n_acc)
    cache, accel = TLBConfig(entries=256, ways=4), TLBConfig(entries=128, ways=4)
    mem = TLBConfig(entries=128, ways=4)
    cfgs = [SystemSimConfig(cache=cache, accel_tlb=accel, mem_tlb=mem, num_partitions=1,
                            page_shift=s) for s in (12, 21)]
    cfgs += [SystemSimConfig(cache=cache, accel_tlb=None, mem_tlb=mem, num_partitions=p,
                             page_shift=s) for p, s in ((8, 12), (8, 21), (32, 12), (32, 21),
                                                        (128, 21))]
    cfgs += [SystemSimConfig(cache=None, accel_tlb=None, mem_tlb=mem, num_partitions=32,
                             page_shift=12),
             SystemSimConfig(cache=cache, accel_tlb=TLBConfig(entries=8, ways=4), mem_tlb=mem,
                             num_partitions=8, page_shift=12, accel_probe_on_miss_only=False)]
    fields = ("cache_hit", "accel_tlb_hit", "mem_tlb_hit")

    def looped():
        return [sweep_system(tr.lines, [c], kernel_mode="reference", device=dev)
                for c in cfgs]

    def batched(mode):
        return lambda: sweep_system(tr.lines, cfgs, kernel_mode=mode, device=dev)

    m_loop, ref = _timed(looped, kernel=False)
    m_bat, bat = _timed(batched("reference"), kernel=False)
    m_k, kern = _timed(batched("cuda"), kernel=True)

    def same(b):
        return all(getattr(b, f)[i].equal(getattr(r, f)[0])
                   for i, r in enumerate(ref) for f in fields)

    identical = same(bat) and same(kern)
    entry = _entry("system_batched", quick, n_configs=len(cfgs),
                   n_accesses=int(tr.num_accesses), t_looped_s=m_loop.best_s,
                   t_batched_s=m_bat.best_s, t_cuda_s=m_k.best_s,
                   speedup=m_loop.best_s / m_k.best_s, bit_identical=identical,
                   reps=ENGINE_REPS, spread_frac={"t_cuda_s": m_k.spread_frac})
    print_csv(f"Batched system sweep ({len(cfgs)} configs x {tr.num_accesses} accesses)",
              ["backend", "seconds", "vs_looped"],
              [["looped reference (per-config)", m_loop.best_s, 1.0],
               ["batched reference", m_bat.best_s, m_loop.best_s / m_bat.best_s],
               ["batched cuda (K2)", m_k.best_s, m_loop.best_s / m_k.best_s]])
    print(f"  batched reference and cuda bit-identical to the looped reference: {identical}")
    return _record(entry, identical, history, calibration_dir)


ENGINE_BENCHES = {"sweep": _sweep_bench, "timeline": _timeline_bench,
                  "timeline_batched": _timeline_batched_bench,
                  "system_batched": _system_batched_bench}


def run(quick: bool = False, *, device="cuda", history: pathlib.Path = HISTORY_PATH,
        calibration_dir: pathlib.Path = CALIBRATION_DIR, profile: bool = False) -> dict:
    """The kernel rows, then every engine bench on the card; returns
    ``{"claims": [], "kernels": rows, "entries": recorded rows}`` (the
    benches check no paper claim).  ``profile`` marks each part with a
    ``record_function`` for an enclosing ``torch.profiler`` trace."""
    from repro_torch.kernels.common import as_device

    dev = as_device(device)
    rows = kernel_rows(dev, profile=profile)
    entries = []
    for name, bench in ENGINE_BENCHES.items():
        with _section(f"{name}_bench", profile):
            entries.append(bench(quick, dev, pathlib.Path(history),
                                 pathlib.Path(calibration_dir)))
    return {"claims": [], "kernels": rows, "entries": entries}


def check_bench_history(path: pathlib.Path = HISTORY_PATH,
                        refs_path: Optional[pathlib.Path] = None) -> dict:
    """The gate over a recorded history: fails (``SystemExit``) on a corrupt
    file, a row with a bit-identity violation, a required bench with no row,
    or a wall time outside its band in the references
    (:func:`repro_torch.bench.perfcheck.check_perf_history`).  Returns the
    band gate's summary (``{}`` when there is no history yet)."""
    from repro_torch.bench import perfcheck

    path = pathlib.Path(path)
    if not path.exists():
        return {}
    hist = perfcheck.load_history(path).get("history", [])
    bad = [(i, e) for i, e in enumerate(hist)
           if any(k.endswith("bit_identical") and e[k] is False for k in e)]
    if bad:
        lines = "\n".join(f"  history[{i}]: bench={e.get('bench', 'sweep')!r} "
                          f"written_at={e.get('written_at')!r}" for i, e in bad)
        raise SystemExit(f"{path} records {len(bad)} non-bit-identical row(s):\n{lines}")
    seen = {e.get("bench", "sweep") for e in hist}
    missing = [b for b in REQUIRED_BENCHES if b not in seen]
    if missing:
        raise SystemExit(f"{path} has no recorded row for bench(es) {missing}; run "
                         f"`python -m repro_torch.bench.kernel_bench` on the card")
    print(f"  {path.name}: all {len(hist)} recorded rows bit-identical "
          f"({', '.join(REQUIRED_BENCHES)} covered)")
    return perfcheck.check_perf_history(path, refs_path or perfcheck.REFS_PATH, history=hist)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="the smaller sizes of SIZES")
    ap.add_argument("--history", type=pathlib.Path, default=HISTORY_PATH)
    ap.add_argument("--calibration-dir", type=pathlib.Path, default=CALIBRATION_DIR)
    ap.add_argument("--refs", type=pathlib.Path, default=None,
                    help="references for the band gate (default: the package's)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the benches into DIR")
    ap.add_argument("--check", action="store_true",
                    help="verify the history: bit-identity, required benches, the band gate")
    ap.add_argument("--update-refs", action="store_true",
                    help="re-baseline the references from the history, then run the gate")
    args = ap.parse_args(argv)
    if args.update_refs:
        from repro_torch.bench import perfcheck

        hist = perfcheck.load_history(args.history).get("history", [])
        perfcheck.update_references(hist, args.refs or perfcheck.REFS_PATH)
        check_bench_history(args.history, args.refs)
    elif args.check:
        check_bench_history(args.history, args.refs)
    else:
        with _profiler(args.profile):
            run(args.quick, history=args.history,
                calibration_dir=args.calibration_dir, profile=bool(args.profile))
    return 0


@contextlib.contextmanager
def _profiler(out_dir):
    """A ``torch.profiler`` trace (CPU and CUDA activity) written to
    ``out_dir`` as a Chrome trace, or nothing when ``out_dir`` is None."""
    if not out_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
    print(f"  profiler trace written to {out / 'trace.json'}")


if __name__ == "__main__":
    raise SystemExit(main())
