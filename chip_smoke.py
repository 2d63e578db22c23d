#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path — the Fig 10 joint-system sweep and the Fig 4 TLB
sweep at full figure size, and their resumable streams — through the
hand-written CUDA kernels K1 (``tlb_sim``), K2 (``system_sim``) and K3
(``stackdist``'s stack scan), and fails (exit code 1, no result line) if
anything is wrong.  One JSON line per phase:

1. ``device``: the card, and its name and power limit from ``nvidia-smi``;
2. ``build``: the kernels built for ``sm_90a`` from the sources in this
   checkout, with ptxas's register / stack / spill lines;
3. ``kernel_vs_plain``: each op entry point on the card against its plain
   PyTorch version on the same inputs (tolerance 0: hits, depths and carried
   state bit-identical), and ``engines_agree``: the stack-distance sweep
   equal to the sequential one;
4. ``fig10`` / 5. ``fig4`` / 6. ``streams``: the main path.  The figure
   drivers on the card, with wall times, claims, and every hit count held
   against the JAX reference's golden file
   ``tests/data/torch_golden_sweeps.json``; then the chunked sweep streams
   over ``skip_list``, equal to the monolithic sweeps.  The kernels' launch
   counters are set to 0 before Fig 10 and read after the streams
   (``main_path``);
7. ``timing``: kernel time with CUDA events at the shapes the main path gave
   each kernel, beside the least time the card could take (bytes over
   3.35 TB/s, or 32-bit compares over 67 T/s), and the plain version's time
   on the same calls over a 20,000-access prefix, where kernel and plain
   outputs must again be bit-identical.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power limit,
and last ``{"ok": true, "device": {...}}``.  Needs one card; imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

GOLDEN = ROOT / "tests" / "data" / "torch_golden_sweeps.json"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12        # 32-bit rate outside the tensor cores (data sheet, fp32)
STREAM_CHUNK = 65_537          # accesses per stream chunk (odd on purpose)
PREFIX = 20_000                # accesses of the plain-version timing prefix
CHECK_ACCESSES = 20_037        # PREFIX plus an odd-length tail

FAILURES = []


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(what: str) -> None:
    FAILURES.append(what)
    print(f"FAIL: {what}", file=sys.stderr, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs one CUDA card", file=sys.stderr)
        return 1

    from repro_torch.bench import fig4, fig10
    from repro_torch.bench.common import trace
    from repro_torch.core.benchtime import device_metadata
    from repro_torch.kernels import _build

    meta = device_metadata()
    name, smi = meta["device_kind"], meta["nvidia_smi"]
    emit("device", **meta)

    t0 = time.perf_counter()
    lib = _build.load()
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=lib.build_s,
         library=str(lib.path.relative_to(ROOT)),
         ptxas=[ln.strip() for ln in lib.log.splitlines()
                if ln.startswith("==") or "registers" in ln or "spill" in ln
                or "Compiling entry" in ln])

    errs = check_kernels_against_plain(torch, trace)
    golden = json.loads(GOLDEN.read_text())
    launches, runs = run_main_path(torch, fig10, fig4, trace, golden)
    kernels = time_kernels(torch, fig10, fig4, trace, errs, launches, runs)

    print(json.dumps({"kernels": kernels}), flush=True)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}",
              file=sys.stderr, flush=True)
        return 1
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


# ---------------------------------------------------------------------------
# Phase 3: every op entry point on the card against its plain version.
# ---------------------------------------------------------------------------

def _tlb_check_specs():
    from repro_torch.core.sparta import TLBConfig
    from repro_torch.core.sweep import TLBSweepSpec

    return [  # mixed geometry, partitions, page sizes, entries < ways
        TLBSweepSpec(TLBConfig(entries=64, ways=4), 1, 12),
        TLBSweepSpec(TLBConfig(entries=16, ways=2), 4, 12),
        TLBSweepSpec(TLBConfig(entries=2, ways=4), 128, 21),
        TLBSweepSpec(TLBConfig(entries=128, ways=8), 32, 12),
        TLBSweepSpec(TLBConfig(entries=4, ways=4), 1, 21),
        TLBSweepSpec(TLBConfig(entries=1024, ways=4), 4, 12),
        TLBSweepSpec(TLBConfig(entries=32, ways=1), 8, 12),
        TLBSweepSpec(TLBConfig(entries=256, ways=16), 128, 12),
    ]


def _system_check_cfgs():
    from repro_torch.core.sparta import TLBConfig
    from repro_torch.core.tlbsim import SystemSimConfig

    return [  # the heterogeneous 8-config batch of tests/test_system_sweep.py
        SystemSimConfig(),
        SystemSimConfig(cache=None, num_partitions=8),
        SystemSimConfig(accel_tlb=TLBConfig(entries=8, ways=4),
                        num_partitions=4, accel_probe_on_miss_only=False),
        SystemSimConfig(accel_tlb=TLBConfig(entries=2, ways=4),
                        page_shift=21, num_partitions=32),
        SystemSimConfig(mem_tlb=TLBConfig(entries=64, ways=8)),
        SystemSimConfig(cache=TLBConfig(entries=512, ways=8), num_partitions=16),
        SystemSimConfig(cache=None, accel_tlb=TLBConfig(entries=16, ways=2),
                        num_partitions=2, accel_probe_on_miss_only=False),
        SystemSimConfig(page_shift=21, num_partitions=128),
    ]


def _max_abs_err(torch, got, want) -> int:
    """Largest absolute difference over matching tensors (bool as 0/1)."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return 2**31
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def _compare(torch, op: str, kernel: str, got, want, **shape) -> int:
    err = _max_abs_err(torch, got, want)
    emit("kernel_vs_plain", op=op, kernel=kernel, equal=err == 0,
         max_abs_err=err, tolerance=0, **shape)
    if err != 0:
        fail(f"{op}: kernel differs from its plain version (max abs err {err})")
    return err


def _carry_chunks(fn, n: int, cuts):
    """Run ``fn(lo, hi, carried)`` over the chunks split at ``cuts``."""
    out, carried = [], None
    bounds = [0, *cuts, n]
    for lo, hi in zip(bounds, bounds[1:]):
        res, carried = fn(lo, hi, carried)
        out.append(res)
    return out, carried


def check_kernels_against_plain(torch, trace) -> dict:
    """Phase 3.  Returns the largest error per kernel (0 when bit-identical)."""
    from repro_torch.core.sweep import _envelope, _sweep_keys, _system_layout, _system_streams
    from repro_torch.core.tlbsim import as_tensor, padded_tlb_state, system_flags
    from repro_torch.kernels.system_sim import system_sim_batched, system_sim_batched_carry
    from repro_torch.kernels.tlb_sim import tlb_sim, tlb_sim_batched, tlb_sim_batched_carry

    dev = torch.device("cuda")
    lines = as_tensor(trace("bst_internal", n_ops=1_000).lines[:CHECK_ACCESSES], dev)
    n = lines.shape[0]
    cuts = (7_001, 13_337)
    errs = {"tlb_sim": 0, "system_sim": 0, "stackdist": 0}

    # K1 ops on eight heterogeneous TLB specs.
    specs = _tlb_check_specs()
    set_b, tag_b = _sweep_keys(lines, specs)
    geoms = [sp.geometry for sp in specs]
    ts, w, valid = _envelope(geoms, range(len(specs)))
    shape = {"configs": len(specs), "accesses": n}
    for op, fn in (
        ("tlb_sim", lambda m: [tlb_sim(set_b[0], tag_b[0], *geoms[0], kernel_mode=m)]),
        ("tlb_sim_batched", lambda m: [tlb_sim_batched(set_b, tag_b, ts, w, valid,
                                                       kernel_mode=m)]),
    ):
        got, want = fn("cuda"), fn("reference")
        errs["tlb_sim"] = max(errs["tlb_sim"], _compare(torch, op, "tlb_sim", got, want,
                                                        **shape))

    def tlb_chunk(mode):
        def step(lo, hi, carried):
            tags, last = carried or padded_tlb_state(len(specs), ts + 1, w, valid, device=dev)
            h, tags, last = tlb_sim_batched_carry(
                set_b[:, lo:hi].contiguous(), tag_b[:, lo:hi].contiguous(),
                tags, last, lo, kernel_mode=mode)
            return h, (tags, last)
        hs, state = _carry_chunks(step, n, cuts)
        return [torch.cat(hs, 1), *state]

    errs["tlb_sim"] = max(errs["tlb_sim"], _compare(
        torch, "tlb_sim_batched_carry", "tlb_sim", tlb_chunk("cuda"),
        tlb_chunk("reference"), cuts=list(cuts), **shape))

    # K2 ops on the heterogeneous 8-config system batch.
    cfgs = _system_check_cfgs()
    streams = _system_streams(lines, cfgs)
    flags = system_flags(cfgs, dev)
    geos, _ = _system_layout(cfgs)
    envs = [_envelope(geo, range(len(cfgs))) for geo in geos]
    geom = tuple(x for e in envs for x in e[:2])
    valid3 = tuple(e[2] for e in envs)
    shape = {"configs": len(cfgs), "accesses": n}
    got = system_sim_batched(*streams, flags, geom, valid3, kernel_mode="cuda")
    want = system_sim_batched(*streams, flags, geom, valid3, kernel_mode="reference")
    errs["system_sim"] = _compare(torch, "system_sim_batched", "system_sim", got, want,
                                  **shape)

    def sys_chunk(mode):
        def step(lo, hi, carried):
            state = carried or tuple(
                x for e in envs
                for x in padded_tlb_state(len(cfgs), e[0] + 1, e[1], e[2], device=dev))
            hs, state = system_sim_batched_carry(
                *(s[:, lo:hi].contiguous() for s in streams), flags, state, lo,
                kernel_mode=mode)
            return torch.stack(hs), state
        hs, state = _carry_chunks(step, n, cuts)
        return [torch.cat(hs, 2), *state]

    errs["system_sim"] = max(errs["system_sim"], _compare(
        torch, "system_sim_batched_carry", "system_sim", sys_chunk("cuda"),
        sys_chunk("reference"), cuts=list(cuts), **shape))

    # K3 on the lane layout of the eight specs' set-mappings: both passes of
    # a depth computation (from empty stacks, then from the lane carries),
    # the whole depth computation, and the sweep it serves.
    from repro_torch.core import stackdist as sd
    from repro_torch.core.sweep import sweep_tlb
    from repro_torch.kernels.stackdist import stack_scan

    block, cap = 256, 16
    for op, (got, want) in _scan_passes(torch, sd, stack_scan, set_b, tag_b, block, cap):
        errs["stackdist"] = max(errs["stackdist"], _compare(
            torch, op, "stackdist", got, want, streams=len(specs), accesses=n,
            lanes=got[0].shape[0], steps=block, slots=cap))
    got, want = (sd.stack_depths_batched(set_b, tag_b, cap=cap, kernel_mode=m, block=block)
                 for m in ("cuda", "reference"))
    errs["stackdist"] = max(errs["stackdist"], _compare(
        torch, "stack_depths_batched", "stackdist", [got], [want], streams=len(specs),
        accesses=n, cap=cap, block=block))
    hits_sd = sweep_tlb(lines, specs, kernel_mode="stackdist", device=dev).hits
    hits_seq = sweep_tlb(lines, specs, kernel_mode="cuda", device=dev).hits
    agree = torch.equal(hits_sd, hits_seq)
    emit("engines_agree", what="sweep_tlb stackdist (K3) vs sequential (K1)",
         equal=agree, **shape)
    if not agree:
        fail("sweep_tlb: the stack-distance engine differs from the sequential kernel")
    return errs


def _scan_passes(torch, sd, stack_scan, set_b, tag_b, block: int, cap: int):
    """Both K3 passes of a depth computation over the streams ``set_b`` /
    ``tag_b``, each run as the kernel and as the plain version on the same
    inputs: ``[(op, (kernel outputs, plain outputs)), ...]``."""
    tags_l, seg_l, _ = sd._lane_layout(set_b, tag_b, block)
    G, NP = tags_l.shape
    tags_b, seg_b = tags_l.reshape(-1, block), seg_l.reshape(-1, block)
    empty = torch.full((tags_b.shape[0], cap), -1, dtype=torch.int32, device=tags_b.device)
    first = [stack_scan(tags_b, seg_b, empty, kernel_mode=m) for m in ("cuda", "reference")]
    carries = sd._lane_prefix(first[1][1].reshape(G, NP // block, cap),
                              seg_l.reshape(G, NP // block, block).any(2))
    carries = carries.reshape(-1, cap).contiguous()
    second = [stack_scan(tags_b, seg_b, carries, kernel_mode=m) for m in ("cuda", "reference")]
    return [("stack_scan (from empty stacks)", first), ("stack_scan (from lane carries)", second)]


# ---------------------------------------------------------------------------
# Phases 4-5: the figure drivers at full size, against the golden counts.
# ---------------------------------------------------------------------------

def _counts(hits, n_warm: int):
    """[[whole stream, after warm-up] per config] of a bool [B, N] tensor."""
    n0 = hits.shape[1] - n_warm
    return [list(p) for p in zip(hits.sum(1).tolist(), hits[:, n0:].sum(1).tolist())]


def _check_golden(fig: str, entry: dict, lines, counts: dict) -> int:
    """Number of mismatches between this run and the golden entry."""
    bad = 0
    if entry["num_accesses"] != lines.shape[0]:
        fail(f"{fig}: {lines.shape[0]} accesses, golden {entry['num_accesses']}")
        bad += 1
    if entry["sha256"] != hashlib.sha256(lines.tobytes()).hexdigest():
        fail(f"{fig}: trace bytes differ from the golden trace")
        bad += 1
    for key, got in counts.items():
        if got != entry[key]:
            diff = sum(a != b for a, b in zip(got, entry[key]))
            fail(f"{fig}: {key} hit counts differ from golden in {diff} config(s)")
            bad += 1
    return bad


def _counters() -> dict:
    """Kernel name -> the wrapper module whose ``launches`` counts it."""
    from repro_torch.kernels.stackdist import kernel as k3
    from repro_torch.kernels.system_sim import kernel as k2
    from repro_torch.kernels.tlb_sim import kernel as k1

    return {"tlb_sim": k1, "system_sim": k2, "stackdist": k3}


def _launches() -> dict:
    return {name: m.launches for name, m in _counters().items()}


def run_main_path(torch, fig10, fig4, trace, golden):
    """Phases 4-6 with the launch counters set to 0 before and read after."""
    for m in _counters().values():
        m.launches = 0
    res10 = fig10.run(device="cuda", verbose=False)
    after10 = _launches()
    bad = 0
    for w, ev in res10["events"].items():
        counts = {k: _counts(getattr(ev, f), ev.n_warm) for k, f in (
            ("cache", "cache_hit"), ("accel", "accel_tlb_hit"), ("mem", "mem_tlb_hit"))}
        bad += _check_golden(f"fig10/{w}", golden["fig10"]["workloads"][w],
                             trace(w, n_ops=golden["fig10"]["n_ops"]).lines, counts)
    emit("fig10", accesses=res10["accesses"], seconds=res10["seconds"],
         total_seconds=sum(res10["seconds"].values()),
         claims=[c.row() for c in res10["claims"]], mean_speedup=res10["mean"],
         golden_rows=3 * len(res10["events"]) * len(fig10.CONFIGS),
         golden_mismatches=bad, launches=after10)

    res4 = fig4.run(device="cuda", verbose=False)
    after4 = _launches()
    bad = 0
    for w, res in res4["hits"].items():
        bad += _check_golden(f"fig4/{w}", golden["fig4"]["workloads"][w],
                             trace(w, n_ops=golden["fig4"]["n_ops"]).lines,
                             {"tlb": _counts(res.hits, res.n_warm)})
    emit("fig4", accesses=res4["accesses"], seconds=res4["seconds"],
         total_seconds=sum(res4["seconds"].values()),
         claims=[c.row() for c in res4["claims"]],
         golden_rows=len(res4["hits"]) * len(fig4.specs()),
         golden_mismatches=bad,
         launches={k: after4[k] - after10[k] for k in after4})

    runs = {"fig10": res10, "fig4": res4}
    check_streams(torch, fig10, fig4, trace, runs, after4)
    total = _launches()
    emit("main_path", launches=total)
    for k, v in total.items():
        if v <= 0:
            fail(f"the main path launched the {k} kernel {v} times")
    return total, runs


# ---------------------------------------------------------------------------
# Phase 6: chunked streams equal the monolithic sweeps.
# ---------------------------------------------------------------------------

def check_streams(torch, fig10, fig4, trace, runs, before: dict) -> None:
    from repro_torch.core.sweep import SystemSweepStream, TLBSweepStream

    t0 = time.perf_counter()
    lines = trace("skip_list", n_ops=25_000).lines
    stream = SystemSweepStream(fig10.system_configs())
    parts = [stream.run_chunk(lines[i:i + STREAM_CHUNK])
             for i in range(0, len(lines), STREAM_CHUNK)]
    ev = runs["fig10"]["events"]["skip_list"]
    sys_equal = all(
        torch.equal(torch.cat([p[k] for p in parts], 1), getattr(ev, f))
        for k, f in enumerate(("cache_hit", "accel_tlb_hit", "mem_tlb_hit")))

    lines4 = trace("skip_list", n_ops=40_000).lines
    stream4 = TLBSweepStream(fig4.specs())
    hits = torch.cat([stream4.run_chunk(lines4[i:i + STREAM_CHUNK])
                      for i in range(0, len(lines4), STREAM_CHUNK)], 1)
    tlb_equal = torch.equal(hits, runs["fig4"]["hits"]["skip_list"].hits)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _launches().items()}
    emit("streams", workload="skip_list", chunk=STREAM_CHUNK,
         chunks=-(-len(lines) // STREAM_CHUNK), system_equal=sys_equal,
         tlb_equal=tlb_equal, seconds=time.perf_counter() - t0, launches=launches)
    if not (sys_equal and tlb_equal):
        fail("chunked streams differ from the monolithic sweeps")
    if not (launches["tlb_sim"] and launches["system_sim"]):
        fail("the stream paths did not launch both sequential kernels")


# ---------------------------------------------------------------------------
# Phase 7: kernel times, bounds and the plain version's time.
# ---------------------------------------------------------------------------

def _event_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, CUDA events, after a
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _tlb_stream_calls(torch, specs, lines, chunk: int):
    """The K1 launches of ``TLBSweepStream`` over ``lines`` in chunks of
    ``chunk`` accesses: (wrapper arguments, bytes, compares) per group and
    chunk, with the state each call receives on the main path (the kernel
    runs once here to carry it)."""
    from repro_torch.core.sweep import TLBSweepStream, _index, _sweep_keys
    from repro_torch.core.tlbsim import as_tensor
    from repro_torch.kernels.tlb_sim.kernel import tlb_sim_carry_cuda

    dev = torch.device("cuda")
    stream = TLBSweepStream(specs)
    geoms = [sp.geometry for sp in specs]
    set_b, tag_b = _sweep_keys(as_tensor(lines, dev), specs)
    state = list(stream._state)
    calls = []
    for lo in range(0, set_b.shape[1], chunk):
        for gi, g in enumerate(stream.groups):
            ix = _index(g, dev)
            args = (set_b[ix, lo:lo + chunk].contiguous(),
                    tag_b[ix, lo:lo + chunk].contiguous(), *state[gi], lo)
            B, L = args[0].shape
            nbytes = B * L * (4 + 4 + 1) + 2 * 2 * state[gi][0].numel() * 4
            ops = 2 * L * sum(geoms[i][1] for i in g)   # a tag and a stamp compare per way
            calls.append((args, nbytes, ops))
            state[gi] = tlb_sim_carry_cuda(*args)[1:]
    return calls


def _tlb_sweep_calls(torch, specs, lines_list):
    """The K1 launches of ``sweep_tlb(kernel_mode="cuda")``, the sequential
    path that "auto" leaves for specs with more than 16 ways: one per trace,
    the whole batch on its envelope."""
    from repro_torch.core.sweep import _envelope, _sweep_keys
    from repro_torch.core.tlbsim import as_tensor, padded_tlb_state

    dev = torch.device("cuda")
    ts, w, valid = _envelope([sp.geometry for sp in specs], range(len(specs)))
    calls = []
    for lines in lines_list:
        set_b, tag_b = _sweep_keys(as_tensor(lines, dev), specs)
        calls.append((set_b, tag_b,
                      *padded_tlb_state(len(specs), ts, w, valid, device=dev), 0))
    return calls


def _system_calls(torch, cfgs, lines_list, events_list):
    """The K2 launches of ``sweep_system``: one per trace, the whole batch
    on its envelope."""
    from repro_torch.core.sweep import _envelope, _system_layout, _system_streams
    from repro_torch.core.tlbsim import as_tensor, padded_tlb_state, system_flags

    dev = torch.device("cuda")
    geos, _ = _system_layout(cfgs)
    flags = system_flags(cfgs, dev)
    envs = [_envelope(geo, range(len(cfgs))) for geo in geos]
    calls = []
    for lines, ev in zip(lines_list, events_list):
        streams = _system_streams(as_tensor(lines, dev), cfgs)
        state = tuple(x for e in envs
                      for x in padded_tlb_state(len(cfgs), e[0], e[1], e[2], device=dev))
        B, L = streams[0].shape
        nbytes = B * L * (6 * 4 + 1) + 3 * 4 * B + 2 * sum(s.numel() * 4 for s in state)
        # Compares the result needs: the cache probe where there is a cache,
        # the accel probe where it runs (every access, or the cache misses of
        # a virtual cache), the mem probe on cache misses.
        ops = 0
        for i, c in enumerate(cfgs):
            misses = int((~ev.cache_hit[i]).sum())
            ways = [x[i][1] for x in geos]
            ops += 2 * ways[0] * L * (c.cache is not None)
            ops += 2 * ways[1] * (c.accel_tlb is not None) * (
                misses if c.accel_probe_on_miss_only else L)
            ops += 2 * ways[2] * misses
        calls.append(((streams, flags, state, 0), nbytes, ops))
    return calls


def _scan_calls(torch, specs, lines_list):
    """The K3 launches of ``sweep_tlb``'s stack-distance engine: both passes
    of every stream chunk of every trace, with the lane carries the main
    path computes between them (the kernel runs once here for them)."""
    from repro_torch.core import stackdist as sd
    from repro_torch.core.sweep import _keys_for_mapping, _mapping_key
    from repro_torch.core.tlbsim import as_tensor
    from repro_torch.kernels.stackdist.kernel import stack_scan_cuda

    dev = torch.device("cuda")
    block = 1024                           # stack_depths_batched's default
    cap = max(sp.cfg.effective_ways for sp in specs)
    calls = []
    for lines in lines_list:
        addrs = as_tensor(lines, dev)
        rows = [_keys_for_mapping(addrs, *k) for k in dict.fromkeys(map(_mapping_key, specs))]
        tags_l, seg_l, _ = sd._lane_layout(torch.stack([r[0] for r in rows]),
                                           torch.stack([r[1] for r in rows]), block)
        G, NP = tags_l.shape
        step = sd._chunk_streams(G, NP)
        for g0 in range(0, G, step):
            t_b = tags_l[g0:g0 + step].reshape(-1, block)
            s_b = seg_l[g0:g0 + step].reshape(-1, block)
            L = t_b.shape[0]
            empty = torch.full((L, cap), -1, dtype=torch.int32, device=dev)
            _, finals = stack_scan_cuda(t_b, s_b, empty)
            carries = sd._lane_prefix(finals.reshape(-1, NP // block, cap),
                                      s_b.reshape(-1, NP // block, block).any(2))
            nbytes = L * block * (4 + 1 + 4) + 2 * L * cap * 4
            for init in (empty, carries.reshape(L, cap).contiguous()):
                calls.append(((t_b, s_b, init), nbytes, L * block * cap))
    return calls


def _bound(nbytes: int, ops: int):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _outputs(torch, x) -> list:
    """A kernel's outputs (nested tuples of tensors) as a flat list."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _outputs(torch, y)]


def time_kernels(torch, fig10, fig4, trace, errs, launches, runs) -> list:
    """Phase 7.  Each kernel is timed on the calls the main path gave it; its
    plain version runs the same calls over a 20,000-access prefix of the
    same trace, and the kernel's outputs there must equal the plain ones."""
    from repro_torch.bench.common import W4
    from repro_torch.core.sweep import sweep_system
    from repro_torch.kernels.stackdist.kernel import stack_scan_cuda
    from repro_torch.kernels.stackdist.ref import stack_scan_ref
    from repro_torch.kernels.system_sim.kernel import system_sim_carry_cuda
    from repro_torch.kernels.system_sim.ref import system_sim_batched_carry_ref
    from repro_torch.kernels.tlb_sim.kernel import tlb_sim_carry_cuda
    from repro_torch.kernels.tlb_sim.ref import tlb_sim_batched_carry_ref

    specs, cfgs = fig4.specs(), fig10.system_configs()
    fig4_lines = [trace(w, n_ops=40_000).lines for w in W4]
    fig10_lines = [trace(w, n_ops=25_000).lines for w in W4]
    skip4 = trace("skip_list", n_ops=40_000).lines
    skip10 = trace("skip_list", n_ops=25_000).lines
    events = runs["fig10"]["events"]
    kernels = (
        ("tlb_sim", tlb_sim_carry_cuda, tlb_sim_batched_carry_ref,
         lambda: _tlb_stream_calls(torch, specs, skip4, STREAM_CHUNK),
         lambda: _tlb_stream_calls(torch, specs, skip4[:PREFIX], PREFIX),
         f"TLBSweepStream over skip_list (1.4 M accesses) x 60 Fig 4 specs, "
         f"{STREAM_CHUNK}-access chunks, state groups of 52, 6 and 2",
         ["src/repro/kernels/tlb_sim/kernel.py:219",
          "src/repro/kernels/tlb_sim/kernel.py:259",
          "src/repro/kernels/tlb_sim/kernel.py:85"]),
        ("system_sim", system_sim_carry_cuda, system_sim_batched_carry_ref,
         lambda: _system_calls(torch, cfgs, fig10_lines, [events[w] for w in W4]),
         lambda: _system_calls(torch, cfgs, [skip10[:PREFIX]],
                               [sweep_system(skip10[:PREFIX], cfgs)]),
         "Fig 10: 4 traces (3.06 M accesses) x 9 configs, one launch per trace",
         ["src/repro/kernels/system_sim/kernel.py:270",
          "src/repro/kernels/system_sim/kernel.py:220"]),
        ("stackdist", stack_scan_cuda, stack_scan_ref,
         lambda: _scan_calls(torch, specs, fig4_lines),
         lambda: _scan_calls(torch, specs, [skip4[:PREFIX]]),
         "Fig 4: 4 traces (4.06 M accesses) x 60 set-mappings, 1024-access "
         "lanes, 4 slots, two passes per stream chunk",
         ["src/repro/kernels/stackdist/kernel.py:63"]),
    )
    out = []
    for name, kernel, plain, make_calls, make_prefix, shape, replaces in kernels:
        calls = make_calls()
        ms = _event_ms(torch, lambda: [kernel(*a) for a, _, _ in calls], reps=3)
        prefix_calls = make_prefix()
        ms_prefix = _event_ms(torch, lambda: [kernel(*a) for a, _, _ in prefix_calls],
                              reps=3)
        got = [kernel(*a) for a, _, _ in prefix_calls]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = [plain(*a) for a, _, _ in prefix_calls]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = _compare(torch, f"{name} (main-path calls, first {PREFIX} accesses)", name,
                       _outputs(torch, got), _outputs(torch, want), calls=len(prefix_calls))
        nbytes, ops = sum(c[1] for c in calls), sum(c[2] for c in calls)
        bound_ms, bound_by = _bound(nbytes, ops)
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
               "replaces": replaces[0], "also_replaces": replaces[1:],
               "launches": launches[name], "max_abs_err": max(errs[name], err),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": None,
               "shape": shape, "kernel_launches_timed": len(calls),
               "bytes": nbytes, "operations": ops,
               "plain_shape": f"the same calls on the first {PREFIX} accesses",
               "ms_at_plain_shape": ms_prefix}
        del calls, prefix_calls, got, want
        emit("timing", **row)
        out.append(row)

    # Fig 4's specs on K1 in one launch per trace, for comparison with the
    # stack-distance engine that "auto" gives them.
    calls = _tlb_sweep_calls(torch, specs, fig4_lines)
    emit("timing_fig4_sequential", kernel="tlb_sim", kernel_launches_timed=len(calls),
         ms=_event_ms(torch, lambda: [tlb_sim_carry_cuda(*a) for a in calls], reps=1),
         shape="Fig 4: 4 traces (4.06 M accesses) x 60 specs, one launch per trace")
    return out


if __name__ == "__main__":
    sys.exit(main())
