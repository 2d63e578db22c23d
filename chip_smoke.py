#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's three main paths through its hand-written CUDA kernels
and fails (exit code 1, no result line) if anything is wrong.  The simulator's:
the Fig 10 joint-system sweep and the Fig 4 TLB sweep, the Fig 11 and Fig 5
timeline figures, Figs 2, 7, 8, 9 and 6, all at full figure size, and
their resumable streams,
through K1 (``tlb_sim``), K2 (``system_sim``), K3 (``stackdist``'s stack
scan) and K4 (``timeline``).  The serving engine's: qwen3-14b at its
published width (40 layers, bf16 weights from a seeded generator on the
card) served by ``SpartaEngine``, through K5 (``flash_attention``, prefill)
and K6 (``paged_attention``, decode).  The state-space families': rwkv6-1.6b
and zamba2-7b at their published widths (bf16 weights from a seeded
generator), ``make_prefill_step`` and the recurrent decode steps, through K7
(``rwkv6_scan``), K8 (``mamba2_scan``) and, for zamba2's shared attention,
K5 and K6.  One JSON line per phase:

1. ``device``: the card, and its name and power limit from ``nvidia-smi``;
2. ``build``: the kernels built for ``sm_90a`` from the sources in this
   checkout, with ptxas's register / stack / spill lines; K1's, K2's, K3's,
   K4's, K6's, K7's and K8's kernels must spill nothing;
3. ``kernel_vs_plain``: each simulator op entry point on the card against
   its plain PyTorch version on the same inputs (tolerance 0: hits, depths,
   timeline latency / overhead / done and carried state bit-identical), K1
   and K2 also on the skewed and edge cases of ``tests/_lru_cases.py``
   (every access in one set; a set per access over 65,537 rows; a hot set;
   1-33 ways; an empty chunk; stamps up to 2**31 - 2), chunk by chunk;
   ``engines_agree``: the stack-distance sweep equal to the sequential one;
   and K3 on the edge cases of ``tests/_stack_cases.py`` (both designs of
   its plan and the P each case forces: segment starts on parts' first
   steps and at every step, padding tags, ragged parts and tiles, C = 1 to
   16,384, 1-40 slots);
4. the simulator's main path, with the kernels' launch counters set to 0
   before it and read after it (``main_path``): ``fig10`` and ``fig4``,
   every hit count held against the JAX reference's golden file
   ``tests/data/torch_golden_sweeps.json``; ``streams``, the chunked LRU
   sweep streams over ``skip_list``, equal to the monolithic sweeps;
   ``fig11`` and ``fig5``, every timeline spec's latency / overhead / done
   held by sha256 of its float32 bytes, and the Fig 5 grid's hit counts,
   against ``tests/data/torch_golden_timeline.json``; ``timeline_stream``,
   the chunked timeline stream over Fig 11's specs, equal to the monolithic
   sweep.  Then ``orchestrator``, a main path of its own: the crash-safe
   ``run_sweep_*`` of ``repro_torch.core.orchestrator`` over Fig 10's
   skip_list trace and 9 configs (K2b), Fig 11's 40 specs (K4c) and Fig
   4's specs on skip_list (``auto``: the stack-distance engine, K3,
   monolithic; ``kernel_mode="cuda"``: streamed through K1c), clean,
   killed after a chunk's checkpoint and resumed, preempted by a SIGTERM to
   this process and resumed, with two injected OOMs (exactly retry, retry,
   halve) and with every kernel attempt failing on a 4,096-access prefix
   (the out-of-memory error raised, the plain version never run); every
   result equal to the
   monolithic one and the golden files, no ladder event where nothing was
   injected, the run log's simulated accesses equal to the runs', and a
   calibration table made from the log still choosing the kernels; and
   ``orchestrator_timing``, the orchestrated wall times without and with
   checkpoints beside the monolithic sweeps and the kernels' CUDA-event
   time.  Then the paper's other figures at the JAX drivers' full sizes,
   each a main path of its own with the counters set to 0 just before it
   and read just after, every count and claim held against
   ``tests/data/torch_golden_figs.json``: ``fig2`` (32 traces, K1 at B = 1
   exactly 32 times), ``fig7`` (arithmetic, no kernel), ``fig8`` (five
   thread mixes with the golden file's seed salts, K3 and no K1), ``fig9``
   (K2 exactly 4 times) and ``fig6`` (the page-fault curves, no kernel);
   ``main_path_figures`` sums their launches.  Each phase line has its
   wall times, claims and launches;
5. ``timing``: kernel time with CUDA events at the shapes the main path gave
   each kernel, beside the least time the card could take (bytes over
   3.35 TB/s, or operations over 67 T/s), and the plain version's time on
   the same calls over a prefix of each call (20,000 accesses; 2,000 for
   K4), where kernel and plain outputs must again be bit-identical; and
   ``timing_site``, the same for single call sites: K1 at B = 1, K2 at the
   stream calls, K4 at the Fig 11, Fig 5 and stream calls and at B = 1.
   K1's and K2's lines add the set-parallel design's own floor:
   ``longest_bucket``, the longest (config, set) bucket of each timed call
   (K2: the cache's plus the longer of the two TLBs' over the accesses they
   apply), summed over the calls and counted with ``torch.bincount`` of the
   keys, ``ns_per_chain_step`` (time over it), and the CUDA-event time of the
   bucketing and of the LRU passes, recorded by the entry point.  K4's
   lines add its own floor: ``longest_sim``, the accesses of each call's
   longest sim (every sim is a serial chain over the call's L accesses)
   summed over the calls, ``ns_per_access`` (time over it), ``hit_share``
   (a hit's step touches acc[a] alone), ``chain_floor_ms`` (the same calls
   with every access a hit: the design's shortest step, longest_sim times)
   and ``device_ms`` (``torch.profiler``; wherever it appears it is null
   when the profiler recorded fewer launches of a kernel than the call
   site's plans expect; a ratio over device time reads ``device_ms`` where
   it is whole and ``device_ms_events``, held-stream CUDA events, where it
   is null, and ``device_time_source`` says which).  K3's ``timing`` row
   is Fig 4's 20 calls and its ``timing_site`` Fig 5's 40 grid calls, each with
   ``device_ms`` and ``device_ms_events``, the plan at each call shape
   (``plans``: P, design, threads a block, blocks), ``chain_steps`` (the
   steps a thread walks one after another, summed over the calls),
   ``ns_per_step`` and ``ns_per_step_device`` (time over it), and
   ``parts_plan_ms``: the time at each P forced on a call of each lane
   count.  The paper figures add ``timing_site`` lines for K1a at Fig 2's
   32 calls and K2a at Fig 9's 4 (the plain version takes each site's
   5,000-access prefixes in one call, the configs stacked), and K3 at Fig
   8's sweeps,
   with the fields of the lines above and the kernel's share of its
   figure's wall time; and ``page_fault``: Fig 6's stack-distance pass
   on the card (the 1-node stream and the 32-node batch), equal to the
   sequential Fenwick walk on the host over a 20,000-access prefix;
6. ``kernel_vs_plain`` for K5 and K6 through their op entry points, within
   2e-5 in float32 and 2e-2 in bfloat16 (the JAX package's tolerances): the
   JAX test shapes and head dims 32, 64, 128, 160, 256 and 112 (zamba2,
   group 1), ragged prompts, Tq = 1, Tq < Tk, the bf16 kernel's tile edges
   (63, 64, 65 and 129 query rows; causal and not), B = 2 and one
   4,096-token call at qwen3's heads; unmapped pages, a context of 0 and
   contexts that end mid-page; and the split K6's edges
   (``tests/_paged_cases.py``): contexts on and past the splits'
   boundaries, a split of unmapped pages, one page, B = 1 at 4,096 and
   1,900 keys (those two against the plain version in float64);
7. ``serve_exact``: qwen3-14b's width cut to 2 layers in float32, the same
   prompts through the engine with the kernels and with the plain versions:
   the generated tokens must be equal (continuous batching and a fork with
   copy-on-write included);
8. ``serve``, the serving main path with every launch counter set to 0
   just before it and read just after: 8 numpy-seeded prompts of 256-2,048
   tokens, 32 new tokens each, batch 4, 4 SPARTA partitions x 32 slots of
   256-token pages (a 10.7 GB float32 pool), then a fork of a finished
   request.  Every request must finish with its token count, the KV
   manager's invariants must hold after the run and after the fork, the
   logits of the first prefill and the first three decode steps must agree
   with the plain versions' on identical inputs (max difference over the
   logits' scale, at most 5e-2 in bf16), and K5 must have launched 40 times
   per prefill and K6 40 times per decode step.  The line has the prefill
   and decode wall times and tokens per second;
9. ``timing`` for K5 and K6 at the serving path's shapes: CUDA-event time,
   for K6 also ``device_ms``, its kernels' summed durations as
   ``torch.profiler`` (CUPTI) records them over the same calls (the split
   kernel and the merge; the event time holds the wrapper's host time
   between launches), and the split plan and blocks launched at each call
   shape, the plain version's time on the same calls, the bound (the larger of
   bytes over 3.35 TB/s and operations over 989 TFLOP/s in bf16 for K5, over
   67 TFLOP/s in float32 for K6), and for K5 the time of
   ``torch.nn.functional.scaled_dot_product_attention`` on the same calls,
   a yardstick only (the port never calls it), its design (``wgmma+tma``
   for bf16) and the build's seconds; K6 at its first and last main-path
   calls within 2e-5 of its plain version computed in float64 (at ~1,900
   keys the float32 plain version is itself outside 2e-5 of it; its error
   is reported);
10. ``profile``: ``torch.profiler`` over a decode step at the run's largest
   batch and a prefill of its longest prompt: the device's busy time, its
   idle share of the wall time, and the kernels that take the most;
11. ``kernel_vs_plain`` for K7 and K8 through their op entry points, outputs
   within 5e-4 in float32 (the JAX package's scan tolerance) and 2e-2 in
   bf16 (one bf16 rounding of the output), final states within 5e-4, all
   finite: the JAX test shapes, rwkv6's and zamba2's head shapes (zamba2 at
   its decays, where the TPU kernel gives NaN), T < chunk, and the bf16
   tensor-core K8's edges (heads that do not fill a block, N and P below its
   64-wide tiles); and
   ``scan_chunk_rule``: T % chunk != 0 raises;
12. ``ssm_exact``: both families at full width in float32, rwkv6 cut to 2
   layers and zamba2 to 2 groups (6 Mamba2 layers): ``make_prefill_step``
   through the kernels equals its run through the plain versions, and
   ``forward`` at every position equals a decode loop from
   ``init_decode_state``, within 1e-3 of the logits' scale with equal greedy
   tokens; ``ssm_full_depth``: the same decode-against-prefill check at full
   depth in float32; ``ssm_bf16``: at 2 layers / 2 groups in bf16, the
   decode loop's last-position logits within 1.5 times the JAX package's
   own decode-against-forward gap at that configuration
   (``tests/ssm_bf16_gap.py``);
13. ``ssm_serve``, the state-space main path, for each family with every
   launch counter set to 0 just before and read just after: full width in
   bf16, ``make_prefill_step`` on 4 prompts of 2,048 tokens (K7 24 times;
   K8 81 and K5 27 times), the same on the first prompt alone (batch 1:
   rwkv6's K7 then takes 16 columns a block), the same on 256 (rwkv6) / 128
   (zamba2) tokens, and a decode loop over those tokens plus 32 greedy tokens at batch 4
   (zamba2: 64-token pages in float32 pools [27, 12, 64, 32, 112], K6 27
   times a step); prefill tokens per second (the first, cold call, and the
   same call again once the counters are read, ``prefill_s_warm``), decode
   step time, the device's idle share of a decode step
   (``torch.profiler``), and the bf16 gap
   between the decode loop's and the prefill's last-position logits
   (reported: the JAX package's gap at full depth is not read on the CPU);
14. ``timing`` for K7 and K8 at the long prefill's calls (CUDA events, the
   plain version on the same calls, the bound: bytes over 3.35 TB/s or the
   recurrence's own operations over the rate of the unit the kernel uses,
   67 TFLOP/s in float32, or 989 TFLOP/s for the bf16 tensor-core designs;
   K7 adds its ``design``, columns a block, column slices and blocks
   launched, and ``cols_plan_ms``, its time with each column width forced,
   K8 its ``design`` and heads a block, both ``device_ms`` and both bounds,
   at the float32 and at the tensor-core rate); the same for K7 at the
   one-prompt prefill's calls as a ``timing_site`` line, and
   ``timing_site`` for K5 and K6 at zamba2's calls (K6 held to its plain
   version in float64, as in 9, with ``device_ms`` and its split plan).

Then the ``{"kernels": [...]}`` line (K1-K8), the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Needs one card;
imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import pathlib
import re
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

GOLDEN = ROOT / "tests" / "data" / "torch_golden_sweeps.json"
GOLDEN_TIMELINE = ROOT / "tests" / "data" / "torch_golden_timeline.json"
GOLDEN_FIGS = ROOT / "tests" / "data" / "torch_golden_figs.json"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12        # 32-bit rate outside the tensor cores (data sheet, fp32)
STREAM_CHUNK = 65_537          # accesses per stream chunk (odd on purpose)
PREFIX = 20_000                # accesses of the plain-version timing prefix
CHECK_ACCESSES = 20_037        # PREFIX plus an odd-length tail
STACKED_PREFIX = 5_000         # the prefix where one plain call takes a site's calls stacked
TL_BLOCK = 512                 # TimelineSweepStream's block
TL_STREAM_CHUNK = 97 * TL_BLOCK  # timeline stream chunks: a block multiple
TL_PREFIX = 2_000              # accesses of K4's plain-version timing prefix
TL_BYTES = 44                  # K4 bytes per (sim, access): 8 x 4 in, 3 x 4 out
SUMMARY_RTOL = 1e-12           # timeline summaries: numpy float64 reductions
SIM_KERNELS = ("tlb_sim", "system_sim", "stackdist", "timeline")
# The kernels whose ptxas lines must show no spill.
NO_SPILL = ("tlb_sim", "system_sim", "stackdist", "timeline", "paged_attention",
            "rwkv6_scan", "mamba2_scan")

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

    from repro_torch.bench import fig2, fig4, fig5, fig6, fig7, fig8, fig9, fig10, fig11
    from repro_torch.bench.common import trace
    from repro_torch.core.benchtime import device_metadata
    from repro_torch.kernels import _build

    import numpy

    meta = device_metadata()
    name, smi = meta["device_kind"], meta["nvidia_smi"]
    emit("device", **meta, numpy_version=numpy.__version__)

    t0 = time.perf_counter()
    lib = _build.load()
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=lib.build_s,
         library=str(lib.path.relative_to(ROOT)),
         ptxas=[ln.strip() for ln in lib.log.splitlines()
                if ln.startswith("==") or "registers" in ln or "spill" in ln
                or "Compiling entry" in ln])
    for src, spill in _spills(lib.log, NO_SPILL):
        fail(f"{src}: a kernel spills ({spill})")

    errs = check_kernels_against_plain(torch, trace)
    golden = json.loads(GOLDEN.read_text())
    golden_tl = json.loads(GOLDEN_TIMELINE.read_text())
    figs = {"fig4": fig4, "fig5": fig5, "fig10": fig10, "fig11": fig11}
    launches, runs = run_main_path(torch, figs, trace, golden, golden_tl)
    orch_launches = run_orchestrator(torch, figs, trace, runs, golden, golden_tl)
    paper = {"fig2": fig2, "fig7": fig7, "fig8": fig8, "fig9": fig9, "fig6": fig6}
    paper_launches, paper_runs = run_paper_figures(
        torch, paper, trace, json.loads(GOLDEN_FIGS.read_text()))
    launches = {k: v + paper_launches[k] + orch_launches[k] for k, v in launches.items()}
    kernels = time_kernels(torch, figs, trace, errs, launches, runs)
    del runs
    time_paper_figures(torch, paper, paper_runs)
    del paper_runs
    torch.cuda.empty_cache()

    kernels += run_serving(torch)
    kernels += run_ssm(torch)

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


def _spills(log: str, kernels) -> list:
    """(source, ptxas line) of every spilling kernel in ``log`` compiled from
    the sources of ``kernels``."""
    out, src = [], ""
    for ln in log.splitlines():
        if ln.startswith("=="):
            src = ln[2:].strip()
        elif any(f"/{k}/" in src for k in kernels):
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m and (int(m.group(1)) or int(m.group(2))):
                out.append((src, ln.strip()))
    return out


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


def _max_abs_err(torch, got, want):
    """Largest absolute difference over matching tensors (bool as 0/1).
    Float tensors must also agree bit for bit: a difference the float64
    subtraction cannot see (a sign of zero) counts as the least f32 step."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return 2**31
        if not g.numel():
            continue
        if g.is_floating_point():
            diff = float((g.double() - w.double()).abs().max())
            if diff == 0 and not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                diff = 2.0**-149
            err = max(err, diff)
        else:
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
    for k, e in check_lru_cases(torch).items():
        errs[k] = max(errs[k], e)

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
    errs["stackdist"] = max(errs["stackdist"], check_stack_cases(torch))
    errs["timeline"] = check_timeline_against_plain(torch, lines, cuts)
    return errs


@contextlib.contextmanager
def _forced_parts(k3, parts):
    """K3's plan with P forced to ``parts`` while the block runs (no change
    for ``None``)."""
    real = k3.stack_plan
    if parts is None:
        yield
        return
    k3.stack_plan = lambda L, C, W, sms: k3.plan_for_parts(L, C, W, sms, parts)
    try:
        yield
    finally:
        k3.stack_plan = real


def _k3_plan(L: int, C: int, W: int):
    """K3's plan for a call on this card."""
    from repro_torch.kernels.paged_attention.kernel import sm_count
    from repro_torch.kernels.stackdist import kernel as k3

    return k3.stack_plan(L, C, W, sm_count(0))


def check_stack_cases(torch) -> int:
    """K3 through its op on the edge cases of ``tests/_stack_cases.py``, each
    at the P it forces (the plan's own otherwise), against the plain version
    (tolerance 0).  Returns the largest error."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _stack_cases import CASES, case_inputs

    from repro_torch.kernels.stackdist import kernel as k3
    from repro_torch.kernels.stackdist import stack_scan

    dev = torch.device("cuda")
    err = 0
    for case in CASES:
        name, L, C, W, parts = case
        x = [torch.from_numpy(a).to(dev) for a in case_inputs(case)]
        with _forced_parts(k3, parts):
            got = stack_scan(*x, kernel_mode="cuda")
            plan = _k3_plan(L, C, W)
        want = stack_scan(*x, kernel_mode="reference")
        err = max(err, _compare(torch, f"stack_scan ({name})", "stackdist", got, want,
                                lanes=L, steps=C, slots=W, parts=plan.parts,
                                design=plan.design))
    return err


def check_lru_cases(torch) -> dict:
    """K1 and K2 through their carry ops on the skewed and edge cases of
    ``tests/_lru_cases.py``, chunk by chunk with the state carried, against
    their plain versions (tolerance 0).  Returns the largest error of each."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _lru_cases import chunks, k1_cases, k2_cases

    from repro_torch.core.tlbsim import padded_tlb_state
    from repro_torch.kernels.system_sim import system_sim_batched_carry
    from repro_torch.kernels.tlb_sim import tlb_sim_batched_carry

    dev = torch.device("cuda")
    errs = {"tlb_sim": 0, "system_sim": 0}
    for case in k1_cases():
        s, t = (torch.from_numpy(case[k]).to(dev) for k in ("set", "tag"))
        B, L = s.shape

        def k1_run(mode):
            state = padded_tlb_state(B, case["TS"], case["W"], case["valid"], device=dev)
            hs = []
            for lo, hi in chunks(L, case["cuts"]):
                h, *state = tlb_sim_batched_carry(
                    s[:, lo:hi].contiguous(), t[:, lo:hi].contiguous(), *state,
                    case["now0"] + lo, kernel_mode=mode)
                hs.append(h)
            return [torch.cat(hs, 1), *state]

        errs["tlb_sim"] = max(errs["tlb_sim"], _compare(
            torch, f"tlb_sim_batched_carry ({case['name']})", "tlb_sim", k1_run("cuda"),
            k1_run("reference"), configs=B, accesses=L, rows=case["TS"], ways=case["W"],
            now0=case["now0"], cuts=case["cuts"]))
    for case in k2_cases():
        streams = [torch.from_numpy(x).to(dev) for x in case["streams"]]
        flags = torch.from_numpy(case["flags"]).to(dev)
        B, L = streams[0].shape

        def k2_run(mode):
            state = tuple(x for S, W, v in case["geom"]
                          for x in padded_tlb_state(B, S, W, v, device=dev))
            hs = []
            for lo, hi in chunks(L, case["cuts"]):
                h, state = system_sim_batched_carry(
                    *(x[:, lo:hi].contiguous() for x in streams), flags, state,
                    case["now0"] + lo, kernel_mode=mode)
                hs.append(torch.stack(h))
            return [torch.cat(hs, 2), *state]

        errs["system_sim"] = max(errs["system_sim"], _compare(
            torch, f"system_sim_batched_carry ({case['name']})", "system_sim",
            k2_run("cuda"), k2_run("reference"), configs=B, accesses=L,
            geometry=[list(g[:2]) for g in case["geom"]], now0=case["now0"],
            cuts=case["cuts"]))
    return errs


def _cut_events(ev, n: int):
    """The events of a trace's first ``n`` accesses (the LRU sims are causal)."""
    from repro_torch.core.tlbsim import SystemEvents

    return SystemEvents(*(x[:n] for x in ev[:3]), n_warm=min(ev.n_warm, n))


def _timeline_check_specs(lines, evs):
    """Ten cells mixing every design, 1-16 accelerators, 0 or 8 MSHRs, 0, 1
    or 3 ports, 0 or 16 banks, 1-32 partitions and three trace lengths: the
    heterogeneous batch of tests/test_torch_timeline.py on this trace.
    ``evs``: (conventional P=1, SPARTA P=32, SPARTA P=8, 2 MB SPARTA P=4)."""
    from repro_torch.core.timeline import TimelineConfig as Q
    from repro_torch.core.timeline import TimelineSpec as S

    b, c = 15_001, 9_999
    lb, eb = lines[:b], _cut_events(evs[2], b)
    lc, ec = lines[:c], _cut_events(evs[3], c)
    return [
        S(lines, evs[0], "conventional", cfg=Q(8, 1, 16), num_accelerators=4),
        S(lines, evs[1], "sparta", cfg=Q(8, 3, 16), num_partitions=32, num_accelerators=16),
        S(lb, eb, "sparta", cfg=Q.unbounded(), num_partitions=8, num_accelerators=16),
        S(lb, eb, "dipta", cfg=Q(0, 0, 16), workload="bst_internal"),
        S(lc, ec, "ideal", cfg=Q(8, 0, 0), page_shift=21, num_accelerators=8),
        S(lb, eb, "conventional", cfg=Q(0, 3, 0)),
        S(lines, evs[1], "sparta", cfg=Q(0, 1, 0), num_partitions=32, num_accelerators=2),
        S(lines, evs[0], "dipta", cfg=Q(8, 1, 16), way_accuracy=0.6, num_accelerators=2),
        S(lc, ec, "sparta", cfg=Q(8, 3, 16), num_partitions=4, page_shift=21),
        S(lb, eb, "ideal", cfg=Q.unbounded(), num_accelerators=16),
    ]


def check_timeline_against_plain(torch, lines, cuts) -> int:
    """K4's three op entry points on the heterogeneous batch: the batched op,
    the carry op split at ``cuts`` (outputs and carried state) and the
    single-sim op (kernel B = 1 against the static-parameter oracle)."""
    from repro_torch.core import timeline as ttl
    from repro_torch.core.sparta import SystemLatencies, TLBConfig
    from repro_torch.core.sweep import sweep_system
    from repro_torch.core.tlbsim import SystemSimConfig
    from repro_torch.kernels import timeline as tl

    dev = torch.device("cuda")
    lat = SystemLatencies(n_sockets=8)
    cache, mem = TLBConfig(256, 4), TLBConfig(128, 4)
    cfgs = [SystemSimConfig(cache=cache, accel_tlb=TLBConfig(128, 4), mem_tlb=mem),
            SystemSimConfig(cache=cache, mem_tlb=mem, num_partitions=32),
            SystemSimConfig(cache=cache, mem_tlb=mem, num_partitions=8),
            SystemSimConfig(cache=cache, mem_tlb=mem, num_partitions=4, page_shift=21)]
    evs = sweep_system(lines, cfgs, device=dev)
    specs = _timeline_check_specs(lines.cpu().numpy(), [evs[i] for i in range(4)])
    stacked, fp, ip, lens = ttl._prepare(specs, lat, "chip_smoke")
    cols = [torch.from_numpy(s).to(dev) for s in stacked]
    n = cols[0].shape[1]
    shape = {"sims": len(specs), "accesses": n, "lengths": sorted(set(lens)),
             "envelope": list(tl.envelope_of(ip))}
    got, want = (tl.timeline_sim_batched(*cols, fp, ip, kernel_mode=m)
                 for m in ("cuda", "reference"))
    err = _compare(torch, "timeline_sim_batched", "timeline", got, want, **shape)

    def carry(mode):
        def step(lo, hi, carried):
            st = carried or tl.timeline_init_state_batched(
                len(specs), tl.envelope_of(ip), ip[:, 5], device=dev)
            return tl.timeline_sim_batched_carry(
                *(c[:, lo:hi].contiguous() for c in cols), fp, ip, st, kernel_mode=mode)
        ys, state = _carry_chunks(step, n, cuts)
        return [torch.cat([y[k] for y in ys], 1) for k in range(3)] + list(state)

    err = max(err, _compare(torch, "timeline_sim_batched_carry", "timeline", carry("cuda"),
                            carry("reference"), cuts=list(cuts), **shape))
    i = 1   # SPARTA-32, 16 accelerators, 3 ports per partition TLB
    inputs, params = ttl._timeline_inputs(
        specs[i].lines, specs[i].events, specs[i].design, lat, specs[i].cfg,
        specs[i].num_partitions, specs[i].page_shift, specs[i].num_accelerators,
        None, "", None)
    one = [torch.from_numpy(x).to(dev) for x in inputs]
    got, want = (tl.timeline_sim(*one, params, kernel_mode=m) for m in ("cuda", "reference"))
    return max(err, _compare(torch, "timeline_sim", "timeline", got, want,
                             sims=1, accesses=len(inputs[0]), design=specs[i].design))


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
    from repro_torch.kernels.flash_attention import kernel as k5
    from repro_torch.kernels.mamba2_scan import kernel as k8
    from repro_torch.kernels.paged_attention import kernel as k6
    from repro_torch.kernels.rwkv6_scan import kernel as k7
    from repro_torch.kernels.stackdist import kernel as k3
    from repro_torch.kernels.system_sim import kernel as k2
    from repro_torch.kernels.timeline import kernel as k4
    from repro_torch.kernels.tlb_sim import kernel as k1

    return {"tlb_sim": k1, "system_sim": k2, "stackdist": k3, "timeline": k4,
            "flash_attention": k5, "paged_attention": k6, "rwkv6_scan": k7,
            "mamba2_scan": k8}


def _f32_digest(x) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(x, dtype=np.float32).tobytes()).hexdigest()


def _header(lines) -> dict:
    return {"num_accesses": int(lines.shape[0]),
            "sha256": hashlib.sha256(lines.tobytes()).hexdigest()}


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= SUMMARY_RTOL * abs(b)


def _check_timeline_golden(fig: str, results, entries) -> int:
    """Mismatches between timeline results and their golden records: the
    length and the sha256 of each output's f32 bytes exactly, ``summary()``
    to rtol 1e-12 (numpy float64 reductions)."""
    bad = 0
    if len(results) != len(entries):
        fail(f"{fig}: {len(results)} timeline specs, golden {len(entries)}")
        return 1
    for i, (res, entry) in enumerate(zip(results, entries)):
        got = {"n": int(res.latency.shape[0]),
               **{k: _f32_digest(getattr(res, k)) for k in ("latency", "overhead", "done")}}
        for k, v in got.items():
            if v != entry[k]:
                fail(f"{fig} spec {i}: {k} differs from golden")
                bad += 1
        summary = res.summary()
        off = [k for k, v in entry["summary"].items() if not _close(summary[k], v)]
        if off:
            fail(f"{fig} spec {i}: summary {off} differ from golden")
            bad += 1
    return bad


def _check_claims(fig: str, claims, golden: dict) -> int:
    got = {c.name: c.value for c in claims}
    off = [k for k, v in golden.items() if not _close(got[k], v)]
    if off:
        fail(f"{fig}: claims {off} differ from golden ({got} vs {golden})")
    return len(off)


def run_fig11(fig11, golden: dict, before: dict) -> dict:
    """Full-size Fig 11 on the card against the golden file."""
    res = fig11.run(device="cuda", verbose=False)
    after = _launches()
    bad, k = 0, 0
    for w, lines in res["lines"].items():
        if _header(lines) != golden["traces"][w]:
            fail(f"fig11/{w}: trace differs from the golden trace")
            bad += 1
        n = len(golden["timeline"][w])
        bad += _check_timeline_golden(f"fig11/{w}", res["results"][k:k + n],
                                      golden["timeline"][w])
        k += n
    bad += _check_claims("fig11", res["claims"], golden["claims"])
    emit("fig11", accesses=res["accesses"], seconds=res["seconds"],
         total_seconds=sum(res["seconds"].values()), sims=len(res["specs"]),
         claims=[c.row() for c in res["claims"]], golden_specs=k,
         golden_mismatches=bad, launches={n: after[n] - before[n] for n in after})
    return res


def run_fig5(fig5, golden: dict, before: dict) -> dict:
    """Full-size Fig 5 (grid + timeline half) on the card against the golden file."""
    res = fig5.run(device="cuda", verbose=False)
    after = _launches()
    bad, rows = 0, 0
    for w, per_t in golden["grid"].items():
        for t, entry in per_t.items():
            key = f"{w}/t{t}"
            hits = res["hits"][key]
            bad += _check_golden(f"fig5/{key}", entry, res["lines"][key],
                                 {"tlb": _counts(hits.hits, hits.n_warm)})
            rows += len(entry["tlb"])
    k = 0
    for w, entries in golden["timeline"].items():
        bad += _check_timeline_golden(f"fig5/{w}", res["timeline"][k:k + len(entries)],
                                      entries)
        k += len(entries)
    bad += _check_claims("fig5", res["claims"], golden["claims"])
    emit("fig5", accesses=res["accesses"], seconds=res["seconds"],
         total_seconds=sum(res["seconds"].values()),
         claims=[c.row() for c in res["claims"]], timeline_p99=res["timeline_p99"],
         golden_rows=rows, golden_specs=k, golden_mismatches=bad,
         launches={n: after[n] - before[n] for n in after})
    return res


def check_timeline_stream(torch, res11: dict, before: dict) -> None:
    """``TimelineSweepStream`` over Fig 11's specs in block-multiple chunks
    equals the monolithic sweep."""
    import numpy as np

    from repro_torch.core.sparta import SystemLatencies
    from repro_torch.core.timeline import TimelineSweepStream

    t0 = time.perf_counter()
    stream = TimelineSweepStream(res11["specs"], SystemLatencies(n_sockets=8),
                                 block=TL_BLOCK)
    bounds = list(range(0, stream.n, TL_STREAM_CHUNK)) + [stream.n]
    parts = [stream.run_chunk(lo, hi) for lo, hi in zip(bounds, bounds[1:])]
    got = stream.finalize(*(np.concatenate([p[k] for p in parts], 1) for k in range(3)))
    equal = all(np.array_equal(getattr(g, k), getattr(w, k))
                for g, w in zip(got, res11["results"]) for k in ("latency", "overhead", "done"))
    launches = {k: v - before[k] for k, v in _launches().items()}
    emit("timeline_stream", specs=len(got), chunk=TL_STREAM_CHUNK, chunks=len(parts),
         groups=len(stream.groups), equal=equal, seconds=time.perf_counter() - t0,
         launches=launches)
    if not equal:
        fail("the chunked timeline stream differs from the monolithic sweep")
    if not launches["timeline"]:
        fail("the timeline stream did not launch the timeline kernel")


def _launches() -> dict:
    return {name: m.launches for name, m in _counters().items()}


def run_main_path(torch, figs, trace, golden, golden_tl):
    """Phase 4 with the launch counters set to 0 before and read after."""
    fig4, fig10 = figs["fig4"], figs["fig10"]
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
    before = _launches()
    runs["fig11"] = run_fig11(figs["fig11"], golden_tl["fig11"], before)
    before = _launches()
    runs["fig5"] = run_fig5(figs["fig5"], golden_tl["fig5"], before)
    check_timeline_stream(torch, runs["fig11"], _launches())
    total = _launches()
    emit("main_path", launches=total)
    for k in SIM_KERNELS:
        if total[k] <= 0:
            fail(f"the main path launched the {k} kernel {total[k]} times")
    return total, runs


# ---------------------------------------------------------------------------
# Phase 4b: the crash-safe orchestrator over the figures' full-size sweeps.
# ---------------------------------------------------------------------------

ORCH_KILL_AFTER = 3                # chunks committed before the simulated kill
ORCH_EXHAUST_PREFIX = 4_096        # accesses of the run whose every kernel attempt fails
HIT_FIELDS = ("cache_hit", "accel_tlb_hit", "mem_tlb_hit")
LADDER_EVENTS = ("retry", "halve")


class _Kill(BaseException):
    """A simulated process death right after a chunk's checkpoint commit."""


def _kill_after(n: int):
    def hook(i):
        if i + 1 >= n:
            raise _Kill(f"simulated death after chunk commit #{i}")
    return hook


def _oom_hook(torch, limit, seen: list):
    """``fault_hook``: raise ``torch.cuda.OutOfMemoryError`` before a
    ``cuda`` attempt, ``limit`` times (None: every time)."""
    def hook(engine, lo, hi, mode, attempt):
        if mode == "cuda" and (limit is None or len(seen) < limit):
            seen.append([lo, hi, attempt])
            raise torch.cuda.OutOfMemoryError(f"injected OOM #{len(seen)} ({engine} "
                                               f"[{lo}, {hi}))")
    return hook


def _wall(torch, fn):
    """(seconds, result) of ``fn()`` on the host clock between synchronises."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def run_orchestrator(torch, figs, trace, runs, golden, golden_tl) -> dict:
    """Phase 4b, a main path of its own (counters set to 0 just before it and
    read just after): ``run_sweep_system`` over Fig 10's 9 configs and its
    skip_list trace (K2b), ``run_sweep_timeline`` over Fig 11's 40 specs
    (K4c), ``run_sweep_tlb`` over Fig 4's specs on skip_list, under
    ``auto`` (the stack-distance engine, K3, monolithic) and streamed with
    ``kernel_mode="cuda"`` (K1c); each clean, killed after chunk
    ``ORCH_KILL_AFTER`` and resumed, one run preempted by a SIGTERM to this
    process, and the ladder injected (two OOMs at one retry: exactly retry,
    retry, halve; and every attempt failing on a prefix, which must raise
    the error and never run the plain version).  Every result must
    equal the monolithic one already in ``runs`` bit for bit (and so the
    golden files), every run that injects nothing must end with no ladder
    event on the kernel, the run log must hold the runs' spans and their
    simulated accesses, and a calibration table made from that log must
    still choose the kernels.  Then ``orchestrator_timing``: the wall time of
    the orchestrated runs without and with checkpoints beside the monolithic
    sweeps and their kernels' CUDA-event time.  Returns the launches."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="orchestrator-") as tmp:
        return _orchestrate(torch, figs, trace, runs, golden, golden_tl, pathlib.Path(tmp))


def _orchestrate(torch, figs, trace, runs, golden, golden_tl, root: pathlib.Path) -> dict:
    """The body of :func:`run_orchestrator`, its checkpoints, run log and
    calibration table under ``root``."""
    import os
    import signal

    import numpy as np

    from repro_torch.core import dispatch
    from repro_torch.core import orchestrator as orch
    from repro_torch.core.benchtime import device_metadata
    from repro_torch.core.sparta import SystemLatencies
    from repro_torch.core.sweep import sweep_system
    from repro_torch.core.timeline import sweep_timeline
    from repro_torch.kernels.system_sim import ops as k2ops
    from repro_torch.kernels.timeline import ops as k4ops
    from repro_torch.runtime import telemetry

    fig4, fig10 = figs["fig4"], figs["fig10"]
    lat = SystemLatencies(n_sockets=8)
    cfgs, specs4 = fig10.system_configs(), fig4.specs()
    lines10 = trace("skip_list", n_ops=golden["fig10"]["n_ops"]).lines
    lines4 = trace("skip_list", n_ops=golden["fig4"]["n_ops"]).lines
    ev10 = runs["fig10"]["events"]["skip_list"]
    want10 = [getattr(ev10, f).cpu().numpy() for f in HIT_FIELDS]
    want4 = runs["fig4"]["hits"]["skip_list"].hits.cpu().numpy()
    specs11, res11 = runs["fig11"]["specs"], runs["fig11"]["results"]
    want11 = [getattr(r, k) for r in res11 for k in ("latency", "overhead", "done")]
    rows, sim = {}, {"sweep_system": 0, "sweep_timeline": 0, "sweep_tlb": 0}

    def cfg(sub=None, **kw):
        return orch.SweepRunConfig(checkpoint_dir=str(root / sub) if sub else None, **kw)

    def record(name, meta, got, want, *, injected=False, mode="cuda", engine=None, work=0):
        equal = len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))
        ladder = [e["event"] for e in meta["events"] if e["event"] in LADDER_EVENTS]
        rows[name] = {"equal": equal, "events": [e["event"] for e in meta["events"]],
                      "start_mode": meta["start_mode"], "final_mode": meta["final_mode"],
                      "resumable": meta["resumable"], "chunks": meta["chunks_committed"],
                      "resumed_from": meta["resumed_from"],
                      "dispatch": {k: meta["dispatch"][k] for k in
                                   ("engine", "requested", "mode", "calibration", "reason")}}
        if not equal:
            fail(f"orchestrator {name}: differs from the monolithic result")
        if not injected and (ladder or meta["final_mode"] != mode):
            fail(f"orchestrator {name}: ladder events {ladder}, final mode "
                 f"{meta['final_mode']!r} where nothing was injected")
        if engine:
            sim[engine] += work

    def killed(name, run, sub, **kw):
        """A run killed after chunk ``ORCH_KILL_AFTER``, then resumed."""
        try:
            run(cfg(sub, on_chunk_committed=_kill_after(ORCH_KILL_AFTER), **kw))
            fail(f"orchestrator {name}: the simulated kill did not fire")
        except _Kill:
            pass
        return run(cfg(sub, resume=True, **kw))

    def system(c, lines=lines10):
        bev, meta = orch.run_sweep_system(lines, cfgs, run=c, name="fig10_skip_list")
        return [getattr(bev, f).numpy() for f in HIT_FIELDS], meta

    def timeline(c, specs=specs11, name="fig11"):
        res, meta = orch.run_sweep_timeline(specs, lat, run=c, name=name)
        return [getattr(r, k) for r in res for k in ("latency", "overhead", "done")], meta

    def tlb(c, mode="auto"):
        res, meta = orch.run_sweep_tlb(lines4, specs4, kernel_mode=mode, run=c,
                                       name="fig4_skip_list")
        return [res.hits.cpu().numpy()], meta

    n10, n11, B11 = len(lines10), max(len(sp.lines) for sp in specs11), len(specs11)
    t0 = time.perf_counter()
    for m in _counters().values():
        m.launches = 0
    with telemetry.run_scope(root / "orchestrator.jsonl", run="orchestrator",
                             device=device_metadata()) as tracer:
        # K2b: clean (its wall time, with checkpoints, is timed), killed and
        # resumed, preempted and resumed, two OOMs injected.
        ckpt10_s, (got, meta) = _wall(torch, lambda: system(cfg("sys_clean")))
        record("system clean", meta, got, want10, engine="sweep_system", work=9 * n10)
        got, meta = killed("system killed", system, "sys_kill")
        record("system killed+resumed", meta, got, want10, engine="sweep_system", work=9 * n10)
        counts = {k: _counts(torch.from_numpy(x), n10 - int(n10 * 0.25))
                  for k, x in zip(("cache", "accel", "mem"), got)}
        rows["system killed+resumed"]["golden_mismatches"] = _check_golden(
            "orchestrator/fig10", golden["fig10"]["workloads"]["skip_list"], lines10, counts)

        def sigterm(i):
            if i == 1:
                os.kill(os.getpid(), signal.SIGTERM)

        preempted_at = None
        try:
            system(cfg("sys_preempt", on_chunk_committed=sigterm))
            fail("orchestrator: the SIGTERM did not preempt the run")
        except orch.Preempted as p:
            preempted_at = p.now
        if preempted_at != 2 * orch.SweepRunConfig.chunk_accesses:
            fail(f"orchestrator: preempted at access {preempted_at}, not at the boundary "
                 f"after chunk 2")
        got, meta = system(cfg("sys_preempt", resume=True))
        record("system preempted+resumed", meta, got, want10, engine="sweep_system",
               work=9 * n10)
        rows["system preempted+resumed"]["preempted_at"] = preempted_at
        ooms = []
        got, meta = system(cfg(max_retries=1, backoff_base_s=0.0,
                               fault_hook=_oom_hook(torch, 2, ooms)))
        record("system 2 OOMs injected", meta, got, want10, injected=True,
               engine="sweep_system", work=9 * n10)
        rows["system 2 OOMs injected"]["injected"] = ooms
        if rows["system 2 OOMs injected"]["events"] != ["retry", "retry", "halve"] \
                or meta["final_mode"] != "cuda":
            fail(f"orchestrator: two injected OOMs gave {rows['system 2 OOMs injected']['events']}"
                 f" ending on {meta['final_mode']!r}, not retry, retry, halve on the kernel")

        # K4c: Fig 11's 40 specs clean, killed and resumed; one spec alone.
        ckpt11_s, (got, meta) = _wall(torch, lambda: timeline(cfg("tl_clean")))
        record("timeline clean", meta, got, want11, engine="sweep_timeline", work=B11 * n11)
        got, meta = killed("timeline killed", timeline, "tl_kill")
        record("timeline killed+resumed", meta, got, want11, engine="sweep_timeline",
               work=B11 * n11)
        entries = [e for w in runs["fig11"]["lines"] for e in golden_tl["fig11"]["timeline"][w]]
        bad = sum(_f32_digest(got[3 * i + j]) != e[k] for i, e in enumerate(entries[:B11])
                  for j, k in enumerate(("latency", "overhead", "done")))
        rows["timeline killed+resumed"]["golden_mismatches"] = bad
        if bad or len(entries) != B11:
            fail(f"orchestrator: {bad} Fig 11 outputs differ from the golden digests "
                 f"({B11} specs, golden {len(entries)})")
        got, meta = timeline(cfg(), specs=specs11[:1], name="fig11_one_sim")
        record("timeline one sim", meta, got, want11[:3], engine="sweep_timeline",
               work=len(specs11[0].lines))

        # Fig 4's specs: "auto" takes the stack-distance engine, monolithic;
        # the stream through K1c, killed and resumed.
        got, meta = tlb(cfg("tlb_auto"))
        record("tlb auto", meta, got, [want4], mode="stackdist")
        if meta["resumable"] or meta["dispatch"]["mode"] != "stackdist":
            fail(f"orchestrator: Fig 4's auto decision is {meta['dispatch']['mode']!r}, "
                 f"resumable {meta['resumable']}; expected the monolithic stackdist")
        got, meta = killed("tlb killed", lambda c: tlb(c, "cuda"), "tlb_kill")
        record("tlb cuda killed+resumed", meta, got, [want4], engine="sweep_tlb",
               work=len(specs4) * len(lines4))

        # Every kernel attempt fails on a prefix: after the retries and the
        # halves down to one block the error is raised; the plain version
        # never runs on the card.
        attempts = []
        raised = None
        try:
            system(cfg(chunk_accesses=1024, max_retries=0, backoff_base_s=0.0,
                       fault_hook=_oom_hook(torch, None, attempts)),
                   lines=lines10[:ORCH_EXHAUST_PREFIX])
        except torch.cuda.OutOfMemoryError as e:
            raised = f"{type(e).__name__}: {e}"
        rows["system exhausted prefix"] = {"raised": raised, "kernel_attempts": len(attempts)}
        if raised is None:
            fail("orchestrator: a prefix whose every kernel attempt failed did not raise")
        torch.cuda.synchronize()
        launches = _launches()
        summary = tracer.summary()
    phase_s = time.perf_counter() - t0

    log = root / "orchestrator.jsonl"
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    kinds = {r["kind"] for r in recs}
    counters = {k: summary["counters"].get(f"{k}.sim_accesses", {}).get("value")
                for k in sim}
    if not {"run_start", "span", "run_end"} <= kinds:
        fail(f"orchestrator: the run log holds only {sorted(kinds)}")
    if counters != sim:
        fail(f"orchestrator: the run log counted {counters} simulated accesses, the runs "
             f"made {sim}")
    store = dispatch.CalibrationStore.for_dir(root / "calibration")
    ingested = dispatch.ingest_runlogs(store, [log])
    calibrated = {
        "system": dispatch.decide_system("auto", cfgs, n_accesses=n10, store=store),
        "timeline B=40": dispatch.decide_timeline("auto", batch=B11, n_accesses=n11,
                                                  store=store),
        "timeline B=1": dispatch.decide_timeline("auto", batch=1, n_accesses=n11,
                                                 store=store),
        "tlb": dispatch.decide_tlb("auto", specs4, n_accesses=len(lines4), store=store)}
    for what, d in calibrated.items():
        if d.mode not in (("stackdist", "cuda") if what == "tlb" else ("cuda",)):
            fail(f"orchestrator: the calibrated table chose {d.mode!r} for {what}")
    for what in ("timeline clean", "timeline one sim"):
        if rows[what]["dispatch"]["mode"] != "cuda":
            fail(f"orchestrator: {what} chose {rows[what]['dispatch']['mode']!r}, not the "
                 f"kernel")
    for k in ("system_sim", "timeline", "tlb_sim", "stackdist"):
        if not launches[k]:
            fail(f"orchestrator: the {k} kernel was not launched")
    emit("orchestrator", runs=rows, seconds=phase_s, sim_accesses=sim,
         runlog={"records": len(recs), "kinds": sorted(kinds), "counters": counters,
                 "events": summary["events"]},
         calibration={"rates_ingested": ingested, "table": store.load()["rates"],
                      "decisions": {k: d.to_json() for k, d in calibrated.items()}},
         launches=launches)

    # The orchestrator's host cost: wall time without and with checkpoints
    # beside the monolithic sweeps and the kernels' CUDA-event time.
    mono10_s, _ = _wall(torch, lambda: sweep_system(lines10, cfgs))
    k2_mono = _recorded(k2ops, "system_sim_carry_cuda", lambda: sweep_system(lines10, cfgs))
    orch10_s, _ = _wall(torch, lambda: system(cfg()))
    k2_orch = _recorded(k2ops, "system_sim_carry_cuda", lambda: system(cfg()))
    mono11_s, _ = _wall(torch, lambda: sweep_timeline(specs11, lat))
    k4_mono = _recorded(k4ops, "timeline_carry_cuda", lambda: sweep_timeline(specs11, lat))
    orch11_s, _ = _wall(torch, lambda: timeline(cfg()))
    k4_orch = _recorded(k4ops, "timeline_carry_cuda", lambda: timeline(cfg()))
    emit("orchestrator_timing",
         fig10_trace={"accesses": n10, "configs": len(cfgs), "monolithic_s": mono10_s,
                      "orchestrated_s": orch10_s, "orchestrated_checkpointed_s": ckpt10_s,
                      "chunks": len(k2_orch),
                      "kernel_ms_monolithic": _event_ms(
                          torch, lambda: [k2ops.system_sim_carry_cuda(*a) for a in k2_mono], 1),
                      "kernel_ms_orchestrated": _event_ms(
                          torch, lambda: [k2ops.system_sim_carry_cuda(*a) for a in k2_orch], 1)},
         fig11={"sims": B11, "accesses": n11, "monolithic_s": mono11_s,
                "orchestrated_s": orch11_s, "orchestrated_checkpointed_s": ckpt11_s,
                "chunks": len(k4_orch),
                "kernel_ms_monolithic": _event_ms(
                    torch, lambda: [k4ops.timeline_carry_cuda(*a) for a in k4_mono], 1),
                "kernel_ms_orchestrated": _event_ms(
                    torch, lambda: [k4ops.timeline_carry_cuda(*a) for a in k4_orch], 1)},
         seconds=time.perf_counter() - t0 - phase_s)
    return launches


# ---------------------------------------------------------------------------
# Phase 4: chunked streams equal the monolithic sweeps.
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
# Phase 5: kernel times, bounds and the plain version's time.
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


PROFILE_TRIES = 3                  # profiled runs before a short profile counts as unrecorded


def _device_ms(torch, fn, expected: dict, calls=None) -> dict:
    """The device time of ``fn()`` in the named kernels: the sum of their
    durations as ``torch.profiler`` (CUPTI) records them over one run, after
    a warm-up run.  ``expected`` maps each kernel name (a substring of the
    profiler's kernel names) to the launches ``fn()`` makes of it, from the
    call sites' own plans (``_expect_k3``, ``_expect_k6``, ...): not always
    the wrappers' count, since K6's unsplit calls launch no merge kernel and
    K3's launches split between its designs.  The profiler now and then
    drops launches: a run that recorded fewer launches of a kernel than
    expected is profiled again, up to ``PROFILE_TRIES`` runs in all; if it
    is still short, ``device_ms`` is null (never the smaller sum) and
    ``recorded`` / ``expected`` say by how much.  A kernel recorded more
    often than expected fails the check.  With ``calls`` (functions, the
    launches of ``fn`` one by one) also ``device_ms_events``: the same calls
    enqueued in batches behind a held stream (``torch.cuda._sleep``), so the
    host is ahead and CUDA events time the device alone, the gaps between
    launches included; where ``device_ms`` is null this is the site's device
    time (``_device_time``).  ``profile_tries`` says how many runs were
    made, and ``wrapper_launches`` the launches the wrappers counted in the
    last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda")  # the tracer is recording before the calls
            torch.cuda.synchronize()
            before = _launches()
            fn()
            torch.cuda.synchronize()
            counted = sum(_launches().values()) - sum(before.values())
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and any(k in e.key for k in expected)]
        recorded = {k: sum(e.count for e in rows if k in e.key) for k in expected}
        over = {k: n for k, n in recorded.items() if n > expected[k]}
        if over or recorded == expected:
            break
    for k, n in over.items():
        fail(f"device time: torch.profiler recorded {k} {n} times, {expected[k]} launches "
             f"expected")
    whole = recorded == expected
    out = {"device_ms": sum(e.self_device_time_total for e in rows) / 1e3 if whole else None,
           "device_kernels": [{"name": e.key[:120], "launches": e.count,
                               "ms": e.self_device_time_total / 1e3} for e in rows],
           "recorded": recorded, "expected": expected,
           "profile_tries": tries, "wrapper_launches": counted}
    if calls is not None:
        out["device_ms_events"] = _held_ms(torch, calls)
    return out


def _device_time(m: dict) -> dict:
    """The device time a ratio reads, and which it is: ``device_ms`` (the
    kernels' own time in the profile) where the profile recorded every
    launch, else ``device_ms_events`` (held-stream events, the gaps between
    launches included), named in ``device_time_source``."""
    src = "device_ms" if m.get("device_ms") is not None else "device_ms_events"
    return {"device_time_ms": m[src], "device_time_source": src}


def _expect_k3(calls) -> dict:
    """K3's launches over ``calls`` by design (``stack_plan``)."""
    names = {"streamed": "stack_scan_streamed_kernel", "resident": "stack_scan_resident_kernel",
             "device-memory": "stack_scan_mem_kernel"}
    out = dict.fromkeys(names.values(), 0)
    for (t, _, init), _, _ in calls:
        L, C = t.shape
        if L and C:
            out[names[_k3_plan(L, C, init.shape[1]).design]] += 1
    return out


def _expect_k4(calls) -> dict:
    return {"timeline_kernel": sum(1 for (cols, *_), _, _ in calls if cols[0].numel())}


def _expect_k6(calls) -> dict:
    """K6's launches over ``calls``: the split kernel at every call with work,
    the merge kernel where ``split_plan`` splits the table."""
    from repro_torch.kernels.paged_attention import kernel as k6

    out = {"paged_attention_kernel": 0, "paged_merge_kernel": 0}
    for q, kp, _, table, _ in (c[:5] for c in calls):
        B, Hq, D = q.shape
        page, Hkv, pages = kp.shape[1], kp.shape[2], table.shape[1]
        if B and Hq and page and pages:
            out["paged_attention_kernel"] += 1
            out["paged_merge_kernel"] += k6.split_plan(
                B, Hkv, pages, page, k6.sm_count(0), D, Hq // Hkv).splits > 1
    return out


def _expect_scan(torch, name: str, calls) -> dict:
    """K7's or K8's launches over ``calls``: the tensor-core kernel for bf16
    inputs, the FMA kernel for float32."""
    mma, fma = SCAN_KERNELS[name]
    out = {mma: 0, fma: 0}
    for args, _ in calls:
        if args[0].numel():
            out[mma if args[0].dtype == torch.bfloat16 else fma] += 1
    return out


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
        calls.append(((streams, flags, state, 0), nbytes,
                      _system_ops(cfgs, geos, ev.cache_hit)))
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


def _measure(torch, name: str, kernel, plain, calls, prefix_calls, prefix: int,
             stacked: bool = False) -> dict:
    """CUDA-event time of ``kernel`` over ``calls`` and over ``prefix_calls``
    (the same calls cut to their first ``prefix`` accesses), the plain
    version's host-clock time over ``prefix_calls``, where the outputs must
    be bit-identical, and the bound of ``calls``.  Each call is ``(args,
    bytes, operations)``.  ``stacked``: the plain version takes the prefix
    calls in one call (:func:`_plain_stacked`)."""
    ms = _event_ms(torch, lambda: [kernel(*a) for a, _, _ in calls], reps=3)
    ms_prefix = _event_ms(torch, lambda: [kernel(*a) for a, _, _ in prefix_calls], reps=3)
    got = [kernel(*a) for a, _, _ in prefix_calls]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if stacked:
        want = _plain_stacked(torch, plain, [a for a, _, _ in prefix_calls])
    else:
        want = [plain(*a) for a, _, _ in prefix_calls]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _compare(torch, f"{name} (main-path calls, first {prefix} accesses)", name,
                   _outputs(torch, got), _outputs(torch, want), calls=len(prefix_calls))
    nbytes, ops = sum(c[1] for c in calls), sum(c[2] for c in calls)
    bound_ms, bound_by = _bound(nbytes, ops)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err, "kernel_launches_timed": len(calls), "bytes": nbytes,
            "operations": ops, "plain_shape": f"the same calls on the first {prefix} accesses",
            "ms_at_plain_shape": ms_prefix}


def _plain_stacked(torch, plain, args_list) -> list:
    """``plain`` over several calls of one geometry at once: the calls'
    tensors joined along the config axis (the plain versions loop over the
    accesses and treat every config row alike, so a row's outputs do not
    depend on the others), run once, and the outputs split back per call.
    Non-tensor arguments (``now0``) must agree across the calls."""
    def first(x):
        return x if isinstance(x, torch.Tensor) else first(x[0])

    def join(xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.cat(xs, 0)
        if isinstance(xs[0], (tuple, list)):
            return type(xs[0])(join(list(ys)) for ys in zip(*xs))
        if any(x != xs[0] for x in xs):
            raise ValueError("stacked calls differ in a non-tensor argument")
        return xs[0]

    def split(x, sizes):
        if isinstance(x, torch.Tensor):
            return list(torch.split(x, sizes, 0))
        return [type(x)(p) for p in zip(*(split(y, sizes) for y in x))]

    sizes = [first(a).shape[0] for a in args_list]
    return split(plain(*join(args_list)), sizes)


def _longest(torch, set_b, rows: int, mask=None) -> int:
    """The longest (config, set) bucket of ``set_b`` [B, L] (``rows`` sets
    per config), over the accesses ``mask`` selects."""
    keys = set_b.long() + torch.arange(set_b.shape[0], device=set_b.device)[:, None] * rows
    keys = keys if mask is None else keys[mask]
    return int(torch.bincount(keys.flatten()).max()) if keys.numel() else 0


def _chain_k1(torch, args) -> int:
    """K1's critical path in one call: its longest bucket."""
    set_b, _, tags = args[:3]
    return _longest(torch, set_b, tags.shape[1])


def _chain_k2(torch, args) -> int:
    """K2's critical path in one call: the longest cache bucket plus the
    longer of the two TLBs' longest buckets over the accesses they apply
    (the cache hits from a run of the kernel)."""
    from repro_torch.kernels.system_sim.kernel import system_sim_carry_cuda

    inputs, flags, state, _ = args
    (c_hit, _, _), _ = system_sim_carry_cuda(*args)
    has_c, has_a, miss_only = (flags[:, k, None] > 0 for k in range(3))
    do_a = has_a & (~miss_only | ~c_hit)
    rows = [state[2 * k].shape[1] for k in range(3)]
    return (_longest(torch, inputs[0], rows[0], has_c.expand_as(c_hit))
            + max(_longest(torch, inputs[2], rows[1], do_a),
                  _longest(torch, inputs[4], rows[2], ~c_hit)))


def _lru_floor(torch, name: str, kernel, calls, ms: float) -> dict:
    """The set-parallel design's own floor over ``calls``: the longest
    buckets summed (the chain its bucket threads walk), the time per chain
    step, and the CUDA-event time of each phase, recorded by the entry point
    between its launches (the sums leave out the host between calls)."""
    k1 = name == "tlb_sim"
    longest = sum((_chain_k1 if k1 else _chain_k2)(torch, a) for a, _, _ in calls)
    n = 3 if k1 else 6
    events = []
    for args, _, _ in calls:
        events.append([torch.cuda.Event(enable_timing=True) for _ in range(n)])
        kernel(*args, phase_events=events[-1])
    torch.cuda.synchronize()
    ph = [sum(e[i].elapsed_time(e[i + 1]) for e in events) for i in range(n - 1)]
    out = {"longest_bucket": longest,
           "ns_per_chain_step": ms * 1e6 / longest if longest else None}
    if k1:
        return {**out, "bucketing_ms": ph[0], "passes_ms": ph[1]}
    return {**out, "bucketing_ms": ph[0] + ph[2], "passes_ms": ph[1] + ph[3],
            "cache_pass_ms": ph[1], "tlb_pass_ms": ph[3], "pack_ms": ph[4]}


def _recorded(module, attr: str, fn) -> list:
    """The argument tuples of every call of ``module.attr`` while ``fn()``
    runs (the call itself goes through unchanged)."""
    calls = []
    undo = _recording(module, attr, calls)
    try:
        fn()
    finally:
        undo()
    return [args for args, _ in calls]


def _recording(module, attr: str, calls: list):
    """Wrap ``module.attr`` so that every call's ``(args, kwargs)`` is
    appended to ``calls`` (the call itself goes through unchanged); returns
    the function that undoes it."""
    real = getattr(module, attr)

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    setattr(module, attr, record)
    return lambda: setattr(module, attr, real)


def _system_ops(cfgs, geos, cache_hit) -> int:
    """Compares a K2 call needs: the cache probe where there is a cache, the
    accel probe where it runs (every access, or the cache misses of a
    virtual cache), the mem probe on cache misses; ``cache_hit`` bool [B, L]."""
    L, ops = cache_hit.shape[1], 0
    for i, c in enumerate(cfgs):
        misses = int((~cache_hit[i]).sum())
        ways = [x[i][1] for x in geos]
        ops += 2 * ways[0] * L * (c.cache is not None)
        ops += 2 * ways[1] * (c.accel_tlb is not None) * (
            misses if c.accel_probe_on_miss_only else L)
        ops += 2 * ways[2] * misses
    return ops


def _system_stream_calls(torch, cfgs, lines, chunk: int, events):
    """The K2 launches of ``SystemSweepStream`` over ``lines`` in chunks of
    ``chunk`` accesses, recorded from a run of the stream; ``events`` are the
    monolithic sweep's hit bits of the same trace (for the compare count)."""
    from repro_torch.core.sweep import SystemSweepStream, _system_layout
    from repro_torch.kernels.system_sim import ops as k2ops

    stream = SystemSweepStream(cfgs)
    args = _recorded(k2ops, "system_sim_carry_cuda", lambda: [
        stream.run_chunk(lines[i:i + chunk]) for i in range(0, len(lines), chunk)])
    geos, _ = _system_layout(cfgs)
    calls = []
    for inputs, flags, state, now0 in args:
        B, L = inputs[0].shape
        nbytes = B * L * (6 * 4 + 1) + 3 * 4 * B + 2 * sum(s.numel() * 4 for s in state)
        ops = _system_ops(cfgs, geos, events.cache_hit[:, now0:now0 + L])
        calls.append(((inputs, flags, state, now0), nbytes, ops))
    return calls


def _timeline_call(args):
    """(args, bytes, operations) of one K4 launch: 44 bytes per (sim,
    access), the carried state read and written once, the parameter rows;
    about 36 float32 additions, subtractions and maxima per (sim, access)
    plus one compare per port column."""
    cols, fp, ip, state = args
    B, L = cols[0].shape
    T = state[3].shape[2]
    nbytes = B * L * TL_BYTES + 2 * sum(s.numel() * 4 for s in state) + B * 15 * 4
    return args, nbytes, B * L * (36 + T)


def _timeline_prefix(call, prefix: int):
    (cols, fp, ip, state), _, _ = call
    return _timeline_call(([c[:, :prefix].contiguous() for c in cols], fp, ip, state))


def _timeline_calls(fn) -> list:
    """The K4 launches ``fn()`` makes, recorded."""
    from repro_torch.kernels.timeline import ops as k4ops

    return [_timeline_call(a) for a in _recorded(k4ops, "timeline_carry_cuda", fn)]




def _chain_floor(torch, calls, ms: float) -> dict:
    """K4's own floor: every sim is one serial chain over the call's L
    accesses (shorter sims are padded to L), so a call takes about as long
    as L steps.  ``longest_sim``: L summed over the calls; ``ns_per_access``:
    the time over it; ``hit_share``: the cache hits' share of the accesses
    (a hit's step touches acc[a] alone); ``chain_floor_ms``: the same calls
    with every access a cache hit (CUDA events), L times the shortest
    dependent step the design has."""
    from repro_torch.kernels.timeline.kernel import timeline_carry_cuda

    longest = sum(args[0][0].shape[1] for args, _, _ in calls)
    hits = sum(float(args[0][4].sum()) for args, _, _ in calls)
    all_hits = [([*cols[:4], torch.ones_like(cols[4]), *cols[5:]], *rest)
                for (cols, *rest), _, _ in calls]
    floor = _event_ms(torch, lambda: [timeline_carry_cuda(*a) for a in all_hits], reps=1)
    return {"longest_sim": longest, "ns_per_access": ms * 1e6 / max(longest, 1),
            "hit_share": hits / max(sum(args[0][4].numel() for args, _, _ in calls), 1),
            "chain_floor_ms": floor, "chain_floor_ns_per_access": floor * 1e6 / max(longest, 1)}


def time_timeline(torch, runs) -> dict:
    """K4 at each of its main-path call sites (Fig 11, Fig 5, the stream) and
    at B = 1, one ``timing_site`` line each.  Returns the sites."""
    from repro_torch.core import timeline as ttl
    from repro_torch.core.sparta import SystemLatencies
    from repro_torch.kernels import timeline as tl
    from repro_torch.kernels.timeline.kernel import timeline_carry_cuda
    from repro_torch.kernels.timeline.ref import timeline_scan_batched_carry_ref

    lat = SystemLatencies(n_sockets=8)
    res11, res5 = runs["fig11"], runs["fig5"]

    def plain(cols, fp, ip, state):
        return timeline_scan_batched_carry_ref(*cols, fp, ip, state)

    def stream_run():
        stream = ttl.TimelineSweepStream(res11["specs"], lat, block=TL_BLOCK)
        bounds = list(range(0, stream.n, TL_STREAM_CHUNK)) + [stream.n]
        for lo, hi in zip(bounds, bounds[1:]):
            stream.run_chunk(lo, hi)

    sites = {
        "K4b Fig 11": ("timeline_sim_batched_pallas", "src/repro/kernels/timeline/kernel.py:272",
                       _timeline_calls(lambda: ttl.sweep_timeline(res11["specs"], lat)),
                       f"Fig 11: {len(res11['specs'])} sims x up to {res11['cap']} accesses, "
                       f"one launch"),
        "K4b Fig 5": ("timeline_sim_batched_pallas", "src/repro/kernels/timeline/kernel.py:272",
                      _timeline_calls(lambda: ttl.sweep_timeline(res5["timeline_specs"], lat)),
                      f"Fig 5 timeline half: {len(res5['timeline_specs'])} sims x "
                      f"{res5['tl_cap']} accesses, one launch"),
        "K4c stream": ("timeline_sim_batched_pallas_carry",
                       "src/repro/kernels/timeline/kernel.py:221", _timeline_calls(stream_run),
                       f"TimelineSweepStream over Fig 11's specs, {TL_STREAM_CHUNK}-access "
                       f"chunks (plain version: the first chunk)"),
    }
    out = {}
    for site, (fn, replaces, calls, shape) in sites.items():
        m = _measure(torch, "timeline", timeline_carry_cuda, plain, calls,
                     [_timeline_prefix(c, TL_PREFIX) for c in calls[:1 if "stream" in site
                                                                  else None]], TL_PREFIX)
        m.update(_chain_floor(torch, calls, m["ms"]))
        m.update(_device_ms(torch, lambda: [timeline_carry_cuda(*a) for a, _, _ in calls],
                            _expect_k4(calls), [lambda a=a: timeline_carry_cuda(*a)
                                                for a, _, _ in calls]))
        out[site] = m
        emit("timing_site", site=site, kernel="timeline", function=fn, replaces=replaces,
             shape=shape, **m)
        del calls

    # K4a: one sim (SPARTA-32, 16 accelerators, bst_external) through the
    # single-sim op, kernel (B = 1) against the static-parameter oracle that
    # "auto" would otherwise take: the measurement behind the rule.
    sp = res11["specs"][2 * len(res11["accels"]) - 1]
    inputs, params = ttl._timeline_inputs(
        sp.lines, sp.events, sp.design, lat, sp.cfg, sp.num_partitions, sp.page_shift,
        sp.num_accelerators, sp.accel_ids, sp.workload, sp.way_accuracy)
    one = tuple(torch.from_numpy(x).cuda() for x in inputs)
    n = one[0].shape[0]
    T = max(params.tlb_ports, 1)
    state_bytes = 4 * (2 * params.num_accels + params.num_accels * max(params.mshrs, 1)
                       + params.num_partitions * T + max(params.dram_banks, 1))

    def call(x):
        m = x[0].shape[0]
        return x, m * TL_BYTES + 2 * state_bytes + 15 * 4, m * (36 + T)

    m = _measure(torch, "timeline",
                 lambda *x: tl.timeline_sim(*x, params, kernel_mode="cuda"),
                 lambda *x: tl.timeline_sim(*x, params, kernel_mode="reference"),
                 [call(one)], [call(tuple(x[:TL_PREFIX].contiguous() for x in one))], TL_PREFIX)
    m["plain_over_kernel_at_plain_shape"] = m["plain_ms"] / m["ms_at_plain_shape"]
    all_hits = (*one[:4], torch.ones_like(one[4]), *one[5:])
    floor = _event_ms(torch, lambda: tl.timeline_sim(*all_hits, params, kernel_mode="cuda"),
                      reps=1)
    m.update(longest_sim=n, ns_per_access=m["ms"] * 1e6 / n,
             hit_share=float(one[4].float().mean()), chain_floor_ms=floor,
             chain_floor_ns_per_access=floor * 1e6 / n)
    m.update(_device_ms(torch, lambda: tl.timeline_sim(*one, params, kernel_mode="cuda"),
                        {"timeline_kernel": 1},
                        [lambda: tl.timeline_sim(*one, params, kernel_mode="cuda")]))
    out["K4a B=1"] = m
    emit("timing_site", site="K4a B=1", kernel="timeline", function="timeline_sim_pallas",
         replaces="src/repro/kernels/timeline/kernel.py:316",
         shape=f"timeline_sim: one Fig 11 sim (sparta, 16 accelerators, bst_external), "
               f"{n} accesses; plain version: the static-parameter oracle", **m)
    return out


def _k1a_calls(torch, spec, lines_list) -> list:
    """The K1 launches of ``tlb_sim`` at B = 1 (one spec), one per trace:
    (wrapper arguments, bytes, compares)."""
    calls = []
    for set_b, tag_b, tags, last, now0 in _tlb_sweep_calls(torch, [spec], lines_list):
        N, W = set_b.shape[1], tags.shape[2]
        calls.append(((set_b, tag_b, tags, last, now0),
                      N * 9 + 2 * 2 * tags.numel() * 4, 2 * N * W))
    return calls


def time_sites(torch, figs, trace, runs) -> None:
    """K1 at B = 1 (``tlb_sim``) and K2 at the stream calls, each on its own."""
    from repro_torch.kernels.system_sim.kernel import system_sim_carry_cuda
    from repro_torch.kernels.system_sim.ref import system_sim_batched_carry_ref
    from repro_torch.kernels.tlb_sim.kernel import tlb_sim_carry_cuda
    from repro_torch.kernels.tlb_sim.ref import tlb_sim_batched_carry_ref

    skip4 = trace("skip_list", n_ops=40_000).lines
    spec = figs["fig4"].specs()[9]   # conv-4K, 2048 entries: 512 sets x 4 ways
    calls = _k1a_calls(torch, spec, [skip4])
    m = _measure(torch, "tlb_sim", tlb_sim_carry_cuda, tlb_sim_batched_carry_ref,
                 calls, _k1a_calls(torch, spec, [skip4[:PREFIX]]), PREFIX)
    m.update(_lru_floor(torch, "tlb_sim", tlb_sim_carry_cuda, calls, m["ms"]))
    emit("timing_site", site="K1a B=1", kernel="tlb_sim", function="tlb_sim_pallas",
         replaces="src/repro/kernels/tlb_sim/kernel.py:85",
         shape=f"tlb_sim: one config (conv-4K, 2048 entries, 4 ways), skip_list "
               f"({skip4.shape[0]} accesses)", **m)

    cfgs = figs["fig10"].system_configs()
    skip10 = trace("skip_list", n_ops=25_000).lines
    ev = runs["fig10"]["events"]["skip_list"]
    calls = _system_stream_calls(torch, cfgs, skip10, STREAM_CHUNK, ev)
    m = _measure(torch, "system_sim", system_sim_carry_cuda, system_sim_batched_carry_ref,
                 calls, _system_stream_calls(torch, cfgs, skip10[:PREFIX], PREFIX, ev), PREFIX)
    m.update(_lru_floor(torch, "system_sim", system_sim_carry_cuda, calls, m["ms"]))
    emit("timing_site", site="K2b stream", kernel="system_sim",
         function="system_sim_batched_pallas_carry",
         replaces="src/repro/kernels/system_sim/kernel.py:220",
         shape=f"SystemSweepStream over skip_list ({skip10.shape[0]} accesses) x 9 Fig 10 "
               f"configs, {STREAM_CHUNK}-access chunks", **m)


K3_FORCED_PARTS = (1, 4, 8, 16, 32)
K3_FORCED_REPS = 5


def _held_ms(torch, fns) -> float:
    """Device time of the calls ``fns`` enqueued in batches behind a held
    stream (``torch.cuda._sleep``): the host is ahead, so CUDA events time
    the device alone, the gaps between launches included."""
    total = 0.0
    for i in range(0, len(fns), HELD_BATCH):
        torch.cuda.synchronize()
        torch.cuda._sleep(HELD_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for fn in fns[i:i + HELD_BATCH]:
            fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total


def _scan_design(torch, calls, ms: float, device_time: float) -> dict:
    """K3's plan at each call shape (``plans``: lanes, steps, slots, calls,
    P, design, threads a block, blocks) and its chain: ``chain_steps``, the
    steps a thread walks one after another (its lane when P = 1, its part
    twice when P > 1), summed over the calls; ``ns_per_step`` (the event
    time over it) and ``ns_per_step_device`` (``device_time``, from
    ``_device_time``, over it)."""
    shapes, chain = {}, 0
    for (t, _, init), _, _ in calls:
        L, C, W = t.shape[0], t.shape[1], init.shape[1]
        plan = _k3_plan(L, C, W)
        chain += plan.chain_steps
        e = shapes.setdefault((L, C, W), {
            "lanes": L, "steps": C, "slots": W, "calls": 0, "parts": plan.parts,
            "design": plan.design, "threads_a_block": plan.threads, "blocks": plan.blocks,
            "chain_steps": plan.chain_steps})
        e["calls"] += 1
    return {"plans": list(shapes.values()), "chain_steps": chain,
            "ns_per_step": ms * 1e6 / max(chain, 1),
            "ns_per_step_device": device_time * 1e6 / max(chain, 1)}


def _parts_plan_ms(torch, calls) -> dict:
    """K3's time at each P forced, on one call of each lane count of
    ``calls`` (held-stream events, the mean of ``K3_FORCED_REPS`` runs):
    {lanes: {P: ms}}."""
    from repro_torch.kernels.stackdist import kernel as k3
    from repro_torch.kernels.stackdist.kernel import stack_scan_cuda

    by_lanes = {}
    for args, _, _ in calls:
        by_lanes.setdefault(args[0].shape[0], args)
    out = {}
    for L in sorted(by_lanes, reverse=True):
        args, row = by_lanes[L], {}
        for P in K3_FORCED_PARTS:
            try:
                with _forced_parts(k3, P):
                    stack_scan_cuda(*args)
                    row[str(P)] = _held_ms(torch, [lambda: stack_scan_cuda(*args)]
                                           * K3_FORCED_REPS) / K3_FORCED_REPS
            except ValueError:                # the rows do not fit at this P
                row[str(P)] = None
        out[str(L)] = row
    return out


def _k3_site(torch, specs, lines, prefix_lines, shape: str) -> dict:
    """K3 at the calls of ``sweep_tlb``'s stack-distance engine over
    ``lines``: ``_measure`` (the plain version on ``prefix_lines``), the
    device time (``torch.profiler``, and held-stream events), the plan and
    chain (``_scan_design``) and the time at each P forced
    (``parts_plan_ms``)."""
    from repro_torch.kernels.stackdist.kernel import stack_scan_cuda
    from repro_torch.kernels.stackdist.ref import stack_scan_ref

    calls = _scan_calls(torch, specs, lines)
    m = _measure(torch, "stackdist", stack_scan_cuda, stack_scan_ref, calls,
                 _scan_calls(torch, specs, prefix_lines), PREFIX)
    m.update(_device_ms(torch, lambda: [stack_scan_cuda(*a) for a, _, _ in calls],
                        _expect_k3(calls), calls=[lambda a=a: stack_scan_cuda(*a)
                                           for a, _, _ in calls]))
    m.update(_device_time(m))
    m.update(_scan_design(torch, calls, m["ms"], m["device_time_ms"]))
    m["parts_plan_ms"] = _parts_plan_ms(torch, calls)
    m["shape"] = shape
    return m


def time_stack_scan(torch, figs, trace, fig5_lines: dict, launches, err: int) -> dict:
    """K3 at Fig 4's 20 main-path calls (the ``timing`` row) and at Fig 5's
    40 grid calls (a ``timing_site`` line): CUDA-event time, device time
    (``torch.profiler``, and held-stream events), the plan and chain
    (``_scan_design``), the time at each P forced (``parts_plan_ms``), the
    bound and the plain version on a prefix.  Returns the row."""
    from repro_torch.bench.common import W4

    fig4_lines = [trace(w, n_ops=40_000).lines for w in W4]
    skip4 = trace("skip_list", n_ops=40_000).lines
    lines5 = list(fig5_lines.values())
    sites = (
        ("K3 Fig 4", figs["fig4"].specs(), fig4_lines, [skip4[:PREFIX]],
         "Fig 4: 4 traces (4.06 M accesses) x 60 set-mappings, 1024-access lanes, 4 "
         "slots, two passes per stream chunk"),
        ("K3 Fig 5 grid", figs["fig5"].specs(), lines5, [lines5[-1][:PREFIX]],
         f"Fig 5's grid: {len(lines5)} traces ({sum(len(x) for x in lines5)} accesses) x 4 "
         f"set-mappings, 1024-access lanes, 4 slots, two passes per trace"),
    )
    out = {site: _k3_site(torch, specs, lines, prefix_lines, shape)
           for site, specs, lines, prefix_lines, shape in sites}
    site5 = out["K3 Fig 5 grid"]
    emit("timing_site", site="K3 Fig 5 grid", kernel="stackdist", function="stack_scan_pallas",
         replaces="src/repro/kernels/stackdist/kernel.py:63", **site5)
    row = {"name": "stackdist", "route": "cuda",
           "source": "src/repro_torch/kernels/stackdist/csrc/stackdist.cu",
           "replaces": "src/repro/kernels/stackdist/kernel.py:63", "also_replaces": [],
           "launches": launches, "library_ms": None, **out["K3 Fig 4"],
           "max_abs_err": max(err, site5["max_abs_err"], out["K3 Fig 4"]["max_abs_err"])}
    emit("timing", **row)
    return row


def time_kernels(torch, figs, trace, errs, launches, runs) -> list:
    """Phase 5.  Each kernel is timed on the calls the main path gave it; its
    plain version runs the same calls over a prefix, and the kernel's outputs
    there must equal the plain ones."""
    from repro_torch.bench.common import W4
    from repro_torch.core.sweep import sweep_system
    from repro_torch.kernels.system_sim.kernel import system_sim_carry_cuda
    from repro_torch.kernels.system_sim.ref import system_sim_batched_carry_ref
    from repro_torch.kernels.tlb_sim.kernel import tlb_sim_carry_cuda
    from repro_torch.kernels.tlb_sim.ref import tlb_sim_batched_carry_ref

    specs, cfgs = figs["fig4"].specs(), figs["fig10"].system_configs()
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
    )
    out = []
    for name, kernel, plain, make_calls, make_prefix, shape, replaces in kernels:
        calls = make_calls()
        m = _measure(torch, name, kernel, plain, calls, make_prefix(), PREFIX)
        m.update(_lru_floor(torch, name, kernel, calls, m["ms"]))
        del calls
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
               "replaces": replaces[0], "also_replaces": replaces[1:],
               "launches": launches[name], "library_ms": None, "shape": shape,
               **m, "max_abs_err": max(errs[name], m["max_abs_err"])}
        emit("timing", **row)
        out.append(row)
    out.append(time_stack_scan(torch, figs, trace, runs["fig5"]["lines"], launches["stackdist"],
                               errs["stackdist"]))

    # K4: the row sums its two monolithic main-path sites, Fig 11 and Fig 5.
    sites = time_timeline(torch, runs)
    parts = [sites["K4b Fig 11"], sites["K4b Fig 5"]]
    nbytes, ops = sum(p["bytes"] for p in parts), sum(p["operations"] for p in parts)
    bound_ms, bound_by = _bound(nbytes, ops)
    row = {"name": "timeline", "route": "cuda",
           "source": "src/repro_torch/kernels/timeline/csrc/timeline.cu",
           "replaces": "src/repro/kernels/timeline/kernel.py:272",
           "also_replaces": ["src/repro/kernels/timeline/kernel.py:221",
                             "src/repro/kernels/timeline/kernel.py:316"],
           "launches": launches["timeline"],
           "max_abs_err": max([errs["timeline"]] + [s["max_abs_err"] for s in sites.values()]),
           "ms": sum(p["ms"] for p in parts), "plain_ms": sum(p["plain_ms"] for p in parts),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "shape": "Fig 11 (40 sims x up to 400,000 accesses) and the Fig 5 timeline "
                    "half (16 sims x 40,000), one launch each",
           "kernel_launches_timed": 2, "bytes": nbytes, "operations": ops,
           "plain_shape": f"the same calls on the first {TL_PREFIX} accesses",
           "ms_at_plain_shape": sum(p["ms_at_plain_shape"] for p in parts)}
    emit("timing", **row)
    out.append(row)
    time_sites(torch, figs, trace, runs)

    # Fig 4's specs on K1 in one launch per trace, for comparison with the
    # stack-distance engine that "auto" gives them.
    calls = _tlb_sweep_calls(torch, specs, fig4_lines)
    ms = _event_ms(torch, lambda: [tlb_sim_carry_cuda(*a) for a in calls], reps=1)
    longest = sum(_chain_k1(torch, a) for a in calls)
    emit("timing_fig4_sequential", kernel="tlb_sim", kernel_launches_timed=len(calls),
         ms=ms, longest_bucket=longest, ns_per_chain_step=ms * 1e6 / longest,
         shape="Fig 4: 4 traces (4.06 M accesses) x 60 specs, one launch per trace")
    return out


# ---------------------------------------------------------------------------
# Phases 4-5 for the paper's other figures: Figs 2, 7, 8, 9 and 6.
# ---------------------------------------------------------------------------

def _paper_phase(torch, fig: str, drive, expect: dict):
    """Drive one figure with every launch counter set to 0 just before and
    read just after.  ``expect``: kernel -> the launches the figure must
    make (None: at least one); every other kernel must make none.  Returns
    the figure's result and its launches."""
    for m in _counters().values():
        m.launches = 0
    res = drive()
    torch.cuda.synchronize()
    launches = _launches()
    for k, n in launches.items():
        want = expect.get(k, 0)
        if (n == 0) if want is None else (n != want):
            fail(f"{fig}: the {k} kernel launched {n} times, expected "
                 f"{'at least once' if want is None else want}")
    return res, launches


def _phase_line(fig: str, res: dict, launches: dict, **fields) -> None:
    seconds = res["seconds"]
    emit(fig, seconds=seconds,
         total_seconds=sum(seconds.values()) if isinstance(seconds, dict) else seconds,
         claims=[c.row() for c in res["claims"]], launches=launches, **fields)


def run_paper_figures(torch, paper, trace, golden: dict):
    """Figs 2, 7, 8, 9 and 6 at the JAX drivers' full sizes, each a main
    path of its own, every count and claim held to the JAX reference's
    ``tests/data/torch_golden_figs.json``.  Returns the launches summed over
    the five and the results the timing phase reuses."""
    from repro_torch.bench.common import W4

    fig2, fig8, fig9 = paper["fig2"], paper["fig8"], paper["fig9"]
    runs, total = {}, {k: 0 for k in _counters()}
    t0 = time.perf_counter()

    g = golden["fig2"]
    res, launches = _paper_phase(torch, "fig2", lambda: fig2.run(device="cuda", verbose=False),
                                 {"tlb_sim": len(W4) * len(fig2.FOOTPRINTS_GB)})
    bad, rows = 0, 0
    for w, per_gb in g["workloads"].items():
        for gb, entry in per_gb.items():
            key = f"{w}/{gb}"
            r = res["hits"][key]
            bad += _check_golden(f"fig2/{key}", entry, res["lines"][key],
                                 {"tlb": _counts(r.hits[None], r.n_warm)[0]})
            rows += 1
    if rows != len(res["hits"]):
        fail(f"fig2: {len(res['hits'])} traces, golden {rows}")
        bad += 1
    bad += _check_claims("fig2", res["claims"], g["claims"])
    _phase_line("fig2", res, launches, accesses=sum(res["accesses"].values()), traces=rows,
                monotone_frac=res["monotone_frac"], golden_rows=rows, golden_mismatches=bad)
    runs["fig2"] = res
    total = {k: v + launches[k] for k, v in total.items()}

    g = golden["fig7"]
    res, launches = _paper_phase(torch, "fig7", lambda: paper["fig7"].run(verbose=False), {})
    bad = int(res["cycles"] != g["cycles"])
    if bad:
        fail(f"fig7: cycles {res['cycles']} differ from golden {g['cycles']}")
    bad += _check_claims("fig7", res["claims"], g["claims"])
    _phase_line("fig7", res, launches, cycles=res["cycles"], golden_mismatches=bad)

    g = golden["fig8"]
    res, launches = _paper_phase(
        torch, "fig8", lambda: fig8.run(device="cuda", salts=g["salts"], verbose=False),
        {"stackdist": None})
    bad = 0
    for name, entry in g["mixes"].items():
        bad += _check_golden(f"fig8/{name}", entry, res["lines"][name],
                             {"bste": res["bste"][name]})
    bad += _check_claims("fig8", res["claims"], g["claims"])
    _phase_line("fig8", res, launches, accesses=res["accesses"], salts=res["salts"],
                miss_ratios=res["results"], golden_rows=len(g["mixes"]) * len(fig8.PARTS),
                golden_mismatches=bad)
    runs["fig8"] = res
    total = {k: v + launches[k] for k, v in total.items()}

    g = golden["fig9"]
    res, launches = _paper_phase(torch, "fig9", lambda: fig9.run(device="cuda", verbose=False),
                                 {"system_sim": len(W4)})
    bad, res["lines"] = 0, {}
    for w, ev in res["events"].items():
        counts = {k: _counts(getattr(ev, f), ev.n_warm) for k, f in (
            ("cache", "cache_hit"), ("accel", "accel_tlb_hit"), ("mem", "mem_tlb_hit"))}
        res["lines"][w] = trace(w, n_ops=g["n_ops"]).lines
        bad += _check_golden(f"fig9/{w}", g["workloads"][w], res["lines"][w], counts)
    bad += _check_claims("fig9", res["claims"], g["claims"])
    _phase_line("fig9", res, launches, accesses=res["accesses"], speedups=res["results"],
                golden_rows=3 * len(res["events"]) * len(fig9.system_configs()),
                golden_mismatches=bad)
    runs["fig9"] = res
    total = {k: v + launches[k] for k, v in total.items()}

    g = golden["fig6"]
    res, launches = _paper_phase(torch, "fig6", lambda: paper["fig6"].run(device="cuda",
                                                                   verbose=False), {})
    got = {**_header(res["vpns"]), "unique": res["unique"], "frames": res["frames"],
           "overhead_frames": res["overhead_frames"], "faults_1": res["faults_1"],
           "faults_32": res["faults_32"]}
    off = [k for k, v in got.items() if v != g[k]]
    if off:
        fail(f"fig6: {off} differ from golden")
    bad = len(off) + _check_claims("fig6", res["claims"], g["claims"])
    _phase_line("fig6", res, launches, accesses=res["accesses"], unique=res["unique"],
                faults_1=res["faults_1"], faults_32=res["faults_32"], golden_mismatches=bad)
    runs["fig6"] = res
    emit("main_path_figures", launches=total, seconds=time.perf_counter() - t0)
    return total, runs


def time_paper_figures(torch, paper, runs) -> None:
    """``timing_site`` lines for K1a at Fig 2's 32 calls, K2a at Fig 9's 4
    and K3 at Fig 8's sweeps, each held bit-identical to its plain version
    on a prefix of its calls (``STACKED_PREFIX`` accesses for K1a and K2a,
    whose plain version takes the site's calls in one; ``PREFIX`` for K3);
    and the ``page_fault``
    line: Fig 6's stack-distance pass on the card against the sequential
    Fenwick walk."""
    from repro_torch.core.sweep import TLBSweepSpec, sweep_system
    from repro_torch.kernels.system_sim.kernel import system_sim_carry_cuda
    from repro_torch.kernels.system_sim.ref import system_sim_batched_carry_ref
    from repro_torch.kernels.tlb_sim.kernel import tlb_sim_carry_cuda
    from repro_torch.kernels.tlb_sim.ref import tlb_sim_batched_carry_ref

    fig2, fig8, fig9 = paper["fig2"], paper["fig8"], paper["fig9"]
    t0 = time.perf_counter()
    res2 = runs["fig2"]
    spec = TLBSweepSpec(fig2.TLB)
    vpns = [lines >> 6 for lines in res2["lines"].values()]
    calls = _k1a_calls(torch, spec, vpns)
    head = min(STACKED_PREFIX, *map(len, vpns))   # the stacked prefixes share one length
    m = _measure(torch, "tlb_sim", tlb_sim_carry_cuda, tlb_sim_batched_carry_ref, calls,
                 _k1a_calls(torch, spec, [v[:head] for v in vpns]), head, stacked=True)
    m.update(_lru_floor(torch, "tlb_sim", tlb_sim_carry_cuda, calls, m["ms"]))
    wall = sum(res2["seconds"].values())
    emit("timing_site", site="K1a Fig 2", kernel="tlb_sim", function="tlb_sim_pallas",
         replaces="src/repro/kernels/tlb_sim/kernel.py:85",
         shape=f"Fig 2: {len(calls)} traces ({sum(res2['accesses'].values())} accesses) x one "
               f"config (1,536 entries, 4 ways: 384 sets), one launch each; plain version: "
               f"the {len(calls)} prefixes in one call",
         figure_seconds=wall, kernel_share_of_figure=m["ms"] / 1e3 / wall, **m)
    del calls

    res9 = runs["fig9"]
    cfgs = fig9.system_configs()
    lines9 = list(res9["lines"].values())
    calls = _system_calls(torch, cfgs, lines9, [res9["events"][w] for w in res9["lines"]])
    head = min(STACKED_PREFIX, *map(len, lines9))
    prefix = [x[:head] for x in lines9]
    m = _measure(torch, "system_sim", system_sim_carry_cuda, system_sim_batched_carry_ref,
                 calls, _system_calls(torch, cfgs, prefix, [sweep_system(x, cfgs) for x in prefix]),
                 head, stacked=True)
    m.update(_lru_floor(torch, "system_sim", system_sim_carry_cuda, calls, m["ms"]))
    wall = sum(res9["seconds"].values())
    emit("timing_site", site="K2a Fig 9", kernel="system_sim",
         function="system_sim_batched_pallas",
         replaces="src/repro/kernels/system_sim/kernel.py:270",
         shape=f"Fig 9: 4 traces ({sum(res9['accesses'].values())} accesses) x 10 configs "
               f"(accel TLBs of 1-128 entries; 1, 2 and 4 are one set each, probed by every "
               f"access), one launch per trace; plain version: the 4 prefixes in one call",
         figure_seconds=wall, kernel_share_of_figure=m["ms"] / 1e3 / wall, **m)
    del calls

    res8 = runs["fig8"]
    mixes = [lines >> 6 for lines in res8["lines"].values()]
    m = _k3_site(torch, fig8.specs(), mixes, [mixes[-1][:PREFIX]],
                 f"Fig 8: {len(mixes)} mixes ({sum(len(x) for x in mixes)} accesses) x 4 "
                 f"set-mappings, 1024-access lanes, 4 slots, two passes per stream chunk")
    wall = sum(res8["seconds"].values())
    emit("timing_site", site="K3 Fig 8", kernel="stackdist", function="stack_scan_pallas",
         replaces="src/repro/kernels/stackdist/kernel.py:63", figure_seconds=wall,
         kernel_share_of_figure=m["device_time_ms"] / 1e3 / wall, **m)
    time_page_fault(torch, runs["fig6"])
    emit("paper_figures_timing", seconds=time.perf_counter() - t0)


def time_page_fault(torch, res6: dict) -> None:
    """Fig 6's stack distances: the on-card pass (CUDA events; the 1-node
    stream and the 32-node batch) and the sequential Fenwick walk on the
    host over the first ``PREFIX`` accesses, where the two must be equal."""
    import numpy as np

    from repro_torch.core import pagetable

    vpns = res6["vpns"]
    part = vpns % 32
    streams = [vpns[part == p] for p in range(32)]
    ms_1 = _event_ms(torch, lambda: pagetable.stack_distances(vpns), reps=3)
    ms_32 = _event_ms(torch, lambda: pagetable.stack_distances_batch(streams), reps=3)
    head = vpns[:PREFIX]
    got = pagetable.stack_distances(head)
    ms_prefix = _event_ms(torch, lambda: pagetable.stack_distances(head), reps=3)
    t0 = time.perf_counter()
    want = pagetable.fenwick_stack_distances(head)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int(np.abs(got - want).max()) if want.size else 0
    n = int(vpns.shape[0])
    emit("page_fault", what="Fig 6's LRU stack distances (pagetable.stack_distances)",
         accesses=n, unique=res6["unique"], levels=max(1, (n - 1).bit_length()),
         ms_1node=ms_1, ms_32node=ms_32, ms_at_plain_shape=ms_prefix, plain_ms=plain_ms,
         plain="fenwick_stack_distances, one access a step on the host",
         plain_shape=f"the first {PREFIX} accesses", max_abs_err=err, equal=err == 0,
         figure_seconds=res6["seconds"])
    if err:
        fail(f"Fig 6 stack distances differ from the Fenwick walk (max abs err {err})")


# ---------------------------------------------------------------------------
# Phases 6-10: the serving engine on qwen3-14b through K5 and K6.
# ---------------------------------------------------------------------------

SERVE_ARCH = "qwen3-14b"
SERVE_SEED = 13
SERVE_REQUESTS = 8
SERVE_PROMPT_TOKENS = (256, 2048)  # numpy-seeded prompt lengths, inclusive
SERVE_NEW_TOKENS = 32
SERVE_FORK_TOKENS = 8
SERVE_PARTITIONS, SERVE_SLOTS, SERVE_BATCH = 4, 32, 4
SERVE_CHECKED_DECODES = 3          # decode steps held against the plain versions
EXACT_LAYERS = 2                   # serve_exact: qwen3-14b's width, 2 layers, float32
LOGITS_TOL_BF16 = 5e-2             # max |kernel - plain| / max |plain| of bf16 logits
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the JAX package's kernel tolerances
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores (data sheet)
F32_FLOPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores (data sheet)

# (B, Hq, Hkv, Tq, Tk, D, causal, dtype): the JAX test shapes
# (tests/test_kernels.py), then head dims 64, 128 (qwen3), 160 (stablelm),
# 256 (gemma) and 112 (zamba2, group 1) with ragged prompts, Tq < Tk and
# Tq = 1; then the bf16 tensor-core kernel's tile edges (64-row
# warpgroups, 128-row blocks, 128- or 64-key tiles, head dims padded to 64
# columns) and one long call at qwen3's heads.  tests/test_torch_attention.py
# holds a plain model of that kernel's arithmetic to JAX's K5 at the bf16
# cases.
FLASH_CHECKS = [
    (1, 4, 2, 64, 64, 32, True, "float32"),
    (2, 8, 8, 96, 96, 64, True, "float32"),
    (1, 4, 1, 33, 80, 64, False, "float32"),
    (2, 2, 2, 128, 128, 128, True, "bfloat16"),
    (1, 4, 2, 1, 96, 32, True, "float32"),
    (1, 8, 2, 77, 77, 64, True, "bfloat16"),
    (1, 40, 8, 1000, 1000, 128, True, "bfloat16"),
    (1, 40, 8, 333, 333, 128, True, "float32"),
    (1, 32, 8, 45, 45, 160, True, "bfloat16"),
    (2, 16, 16, 50, 50, 256, True, "float32"),
    (1, 5, 1, 20, 70, 128, True, "float32"),
    (1, 16, 16, 1, 300, 256, True, "bfloat16"),
    (1, 32, 32, 1000, 1000, 112, True, "bfloat16"),   # zamba2: head_dim 112, group 1
    (2, 32, 32, 96, 96, 112, True, "float32"),
    (1, 8, 2, 63, 63, 128, True, "bfloat16"),
    (1, 8, 2, 64, 64, 128, True, "bfloat16"),
    (1, 8, 2, 65, 65, 128, True, "bfloat16"),
    (1, 8, 2, 129, 129, 128, True, "bfloat16"),
    (1, 8, 2, 1, 4096, 128, True, "bfloat16"),
    (1, 10, 2, 100, 300, 128, True, "bfloat16"),      # Tq < Tk, group 5
    (1, 4, 2, 200, 70, 64, True, "bfloat16"),         # Tq > Tk: rows that see no key
    (1, 4, 2, 70, 70, 32, True, "bfloat16"),
    (1, 4, 2, 70, 70, 32, False, "bfloat16"),
    (1, 4, 4, 90, 90, 64, False, "bfloat16"),
    (1, 8, 2, 130, 130, 160, False, "bfloat16"),
    (1, 4, 2, 200, 200, 256, True, "bfloat16"),
    (1, 4, 4, 75, 75, 256, False, "bfloat16"),
    (2, 8, 2, 150, 150, 128, True, "bfloat16"),
    (1, 40, 8, 4096, 4096, 128, True, "bfloat16"),    # qwen3-14b's heads, one long call
]
# (B, Hq, Hkv, D, page, pages, slots, q dtype): the JAX test shapes, then
# qwen3-14b's serving shape, the other dense head dims and zamba2's shared
# attention (head_dim 112, group 1, 64-token pages); every case has
# unmapped pages inside a context, a sequence of ctx 0 and contexts that
# end mid-page.
PAGED_CHECKS = [
    (2, 8, 2, 64, 16, 4, 32, "float32"),
    (3, 4, 4, 32, 8, 6, 64, "float32"),
    (1, 16, 8, 128, 32, 3, 16, "float32"),
    (4, 40, 8, 128, 256, 9, 40, "bfloat16"),
    (4, 40, 8, 128, 256, 9, 40, "float32"),
    (3, 32, 8, 160, 64, 5, 32, "bfloat16"),
    (2, 16, 16, 256, 16, 4, 32, "float32"),
    (3, 36, 4, 128, 32, 4, 32, "float32"),
    (4, 32, 32, 112, 64, 5, 32, "bfloat16"),          # zamba2: head_dim 112, group 1
    (4, 32, 32, 112, 64, 5, 32, "float32"),
]


def _allclose_err(torch, got, want, tol: float):
    """(max abs error, every element within atol = rtol = tol) over tensors."""
    err, ok = 0.0, True
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf"), False
        d = (g.double() - w.double()).abs()
        if d.numel():
            err = max(err, float(d.max()))
            ok = ok and bool((d <= tol + tol * w.double().abs()).all())
    return err, ok


def _compare_tol(torch, op: str, kernel: str, got, want, tol: float, **shape) -> float:
    err, ok = _allclose_err(torch, got, want, tol)
    emit("kernel_vs_plain", op=op, kernel=kernel, within=ok, max_abs_err=err,
         tolerance=tol, **shape)
    if not ok:
        fail(f"{op}: kernel differs from its plain version beyond {tol} (max abs err {err})")
    return err


def _paged_case(torch, rng, B, Hq, Hkv, D, page, pages, slots, q_dtype):
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal((B, Hq, D)).astype("float32")).to(
        dev, getattr(torch, q_dtype))
    kp, vp = (torch.from_numpy(rng.standard_normal((slots, page, Hkv, D)).astype("float32"))
              .to(dev) for _ in range(2))
    tbl = [[-1] * pages for _ in range(B)]
    ctx = [0] * B
    for b in range(B):
        n = int(rng.integers(1, pages + 1))
        tbl[b][:n] = rng.choice(slots, n, replace=False).tolist()
        ctx[b] = (n - 1) * page + int(rng.integers(1, page))      # ends mid-page
        if n > 2 and b % 2:
            tbl[b][1] = -1                                         # an unmapped page
    if B > 1:
        ctx[-1] = 0
    i32 = dict(dtype=torch.int32, device=dev)
    return q, kp, vp, torch.tensor(tbl, **i32), torch.tensor(ctx, **i32)


def check_attention_against_plain(torch) -> dict:
    """Phase 6: K5 and K6 through their op entry points on the card against
    their plain versions on the same inputs."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.paged_attention import kernel as k6
    # The split kernel's edges (the card tests' too): contexts on and past the
    # splits' boundaries, a split whose pages are all unmapped, one page, and
    # B = 1 at 4,096 and 1,900 keys (those two against the plain version in
    # float64).
    sys.path.insert(0, str(ROOT / "tests"))
    from _paged_cases import EDGE_CASES, FLOAT64_EDGES, edge_inputs

    dev = torch.device("cuda")
    errs = {"flash_attention": 0.0, "paged_attention": 0.0}
    for i, (B, Hq, Hkv, Tq, Tk, D, causal, dt) in enumerate(FLASH_CHECKS):
        rng = np.random.default_rng(100 + i)
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype("float32")).to(
            dev, getattr(torch, dt)) for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D)))
        got, want = (fa.flash_attention(q, k, v, causal=causal, kernel_mode=m)
                     for m in ("cuda", "reference"))
        errs["flash_attention"] = max(errs["flash_attention"], _compare_tol(
            torch, "flash_attention", "flash_attention", [got.float()], [want.float()],
            ATTN_TOL[dt], B=B, Hq=Hq, Hkv=Hkv, Tq=Tq, Tk=Tk, D=D, causal=causal, dtype=dt))
    for i, (B, Hq, Hkv, D, page, pages, slots, dt) in enumerate(PAGED_CHECKS):
        args = _paged_case(torch, np.random.default_rng(200 + i), B, Hq, Hkv, D, page, pages,
                           slots, dt)
        shape = dict(B=B, Hq=Hq, Hkv=Hkv, D=D, page=page, pages=pages, q_dtype=dt,
                     ctx=args[4].tolist())
        got, want = (pa.paged_attention_partial(*args, kernel_mode=m)
                     for m in ("cuda", "reference"))
        errs["paged_attention"] = max(errs["paged_attention"], _compare_tol(
            torch, "paged_attention_partial", "paged_attention", list(got), list(want),
            ATTN_TOL["float32"], **shape))
        got, want = (pa.paged_attention(*args, kernel_mode=m) for m in ("cuda", "reference"))
        errs["paged_attention"] = max(errs["paged_attention"], _compare_tol(
            torch, "paged_attention", "paged_attention", [got.float()], [want.float()],
            ATTN_TOL[dt], **shape))
    for i, (B, Hq, Hkv, D, page, pages, slots, dt, edge) in enumerate(EDGE_CASES):
        plan = k6.split_plan(B, Hkv, pages, page, k6.sm_count(0), D, Hq // Hkv)
        arrs = edge_inputs(np.random.default_rng(250 + i), B, Hq, Hkv, D, page, pages, slots,
                           edge, plan.tiles_per_split * k6.TILE)
        args = [torch.from_numpy(a).to(dev) for a in arrs]
        args[0] = args[0].to(getattr(torch, dt))
        shape = dict(B=B, Hq=Hq, Hkv=Hkv, D=D, page=page, pages=pages, q_dtype=dt, edge=edge,
                     ctx=args[4].tolist(), splits=plan.splits,
                     tiles_per_split=plan.tiles_per_split)
        if edge in FLOAT64_EDGES:
            errs["paged_attention"] = max(errs["paged_attention"], _paged_main_path_check(
                torch, "paged_attention_partial (split edge)", args, {}, **shape))
            continue
        got, want = (pa.paged_attention_partial(*args, kernel_mode=m)
                     for m in ("cuda", "reference"))
        errs["paged_attention"] = max(errs["paged_attention"], _compare_tol(
            torch, "paged_attention_partial (split edge)", "paged_attention", list(got),
            list(want), ATTN_TOL["float32"], **shape))
    return errs


def _prompts(cfg, lengths, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, int(n)).tolist() for n in lengths]


def run_serve_exact(torch) -> None:
    """Phase 7: qwen3-14b's width cut to 2 layers, float32: the same prompts
    through SpartaEngine with the kernels and with the plain versions give
    equal tokens (continuous batching and a fork with copy-on-write)."""
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import registry
    from repro_torch.serve.engine import SpartaEngine

    t0 = time.perf_counter()
    cfg = dataclasses.replace(registry.get_config(SERVE_ARCH), num_layers=EXACT_LAYERS,
                              dtype="float32")
    params = models.init(cfg, seed=SERVE_SEED, device="cuda")
    lengths = (300, 37, 513, 1, 256)             # ragged, one token, a page multiple
    prompts = _prompts(cfg, lengths, SERVE_SEED)
    out, launches = {}, {}
    for mode in ("cuda", "reference"):
        before = _launches()
        eng = SpartaEngine(cfg, params, num_partitions=4, slots_per_partition=8, max_batch=2,
                           kernel_mode=mode)
        rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_to_completion()
        eng.fork_request(rids[0], max_new_tokens=4)
        eng.run_to_completion()
        eng.kv.check_invariants()
        torch.cuda.synchronize()
        out[mode] = {rid: r.generated for rid, r in eng.finished.items()}
        launches[mode] = {k: v - before[k] for k, v in _launches().items()
                          if k in ("flash_attention", "paged_attention")}
        del eng
    equal = out["cuda"] == out["reference"]
    emit("serve_exact", arch=SERVE_ARCH, layers=EXACT_LAYERS, dtype="float32",
         prompt_tokens=list(lengths), requests=len(out["cuda"]), equal_tokens=equal,
         tokens={str(k): v for k, v in out["cuda"].items()}, launches=launches,
         seconds=time.perf_counter() - t0, parameters=cfg.param_count())
    if not equal:
        fail("serve_exact: the engine's tokens through K5/K6 differ from the plain versions'")
    if not (launches["cuda"]["flash_attention"] == EXACT_LAYERS * len(prompts)
            and launches["cuda"]["paged_attention"] > 0
            and not any(launches["reference"].values())):
        fail(f"serve_exact: unexpected kernel launches {launches}")
    del params
    torch.cuda.empty_cache()


def _rel_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def run_serve(torch):
    """Phase 8, the serving main path: qwen3-14b's full CONFIG (40 layers,
    bf16 weights, 256-token pages) served by SpartaEngine at its default
    kernel mode, with every launch counter set to 0 just before and read just
    after.  The first prefill and the first decode steps are also run through
    the plain versions on identical inputs (the plain run of a decode step
    goes first: it writes the new token's KV where the kernel run, which
    reads the pool before that position, writes it again)."""
    from repro_torch import models
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import SpartaEngine

    cfg = registry.get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = models.init(cfg, seed=SERVE_SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = SpartaEngine(cfg, params, num_partitions=SERVE_PARTITIONS,
                       slots_per_partition=SERVE_SLOTS, max_batch=SERVE_BATCH)
    import numpy as np

    lengths = np.random.default_rng(SERVE_SEED).integers(
        SERVE_PROMPT_TOKENS[0], SERVE_PROMPT_TOKENS[1] + 1, SERVE_REQUESTS)
    prompts = _prompts(cfg, lengths, SERVE_SEED + 1)
    rec = {"prefill_s": [], "prefill_T": [], "decode_s": [], "decode_B": [],
           "decode_calls": [], "checks": []}
    real_prefill, real_decode = tfm.prefill_with_kv, tfm.decode_step

    def timed(fn, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    def prefill(params, tokens, cfg, *, kernel_mode):
        want = None
        if not rec["prefill_s"]:
            want = real_prefill(params, tokens, cfg, kernel_mode="reference")[0]
        res, dt = timed(real_prefill, params, tokens, cfg, kernel_mode=kernel_mode)
        if want is not None:
            rec["checks"].append(("prefill", tokens.shape[1], _rel_err(torch, res[0], want)))
        rec["prefill_s"].append(dt)
        rec["prefill_T"].append(int(tokens.shape[1]))
        return res

    def decode(params, tokens, cfg, k_pools, v_pools, table, ctx_len, *, kernel_mode):
        want = None
        if len(rec["decode_s"]) < SERVE_CHECKED_DECODES:
            want = real_decode(params, tokens, cfg, k_pools, v_pools, table, ctx_len,
                               kernel_mode="reference")[0]
        res, dt = timed(real_decode, params, tokens, cfg, k_pools, v_pools, table, ctx_len,
                        kernel_mode=kernel_mode)
        if want is not None:
            rec["checks"].append(("decode", int(tokens.shape[0]), _rel_err(torch, res[0], want)))
        rec["decode_s"].append(dt)
        rec["decode_B"].append(int(tokens.shape[0]))
        rec["decode_calls"].append((table.clone(), ctx_len.clone()))
        return res

    for m in _counters().values():
        m.launches = 0
    tfm.prefill_with_kv, tfm.decode_step = prefill, decode
    try:
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new_tokens=SERVE_NEW_TOKENS) for p in prompts]
        eng.run_to_completion()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        eng.kv.check_invariants()
        n_decode_before_fork = len(rec["decode_s"])
        fork_rid = eng.fork_request(rids[0], max_new_tokens=SERVE_FORK_TOKENS)
        eng.run_to_completion()
        torch.cuda.synchronize()
        eng.kv.check_invariants()
    finally:
        tfm.prefill_with_kv, tfm.decode_step = real_prefill, real_decode
    launches = _launches()

    counts = {rid: len(eng.finished[rid].generated) for rid in rids + [fork_rid]}
    want_counts = {**{rid: SERVE_NEW_TOKENS for rid in rids}, fork_rid: SERVE_FORK_TOKENS}
    prefill_s, decode_s = sum(rec["prefill_s"]), sum(rec["decode_s"])
    decode_tokens = sum(rec["decode_B"])
    worst = max((c[2] for c in rec["checks"]), default=float("inf"))
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    emit("serve", arch=SERVE_ARCH, layers=cfg.num_layers, d_model=cfg.d_model,
         parameters=cfg.param_count(), weight_gb=weight_bytes / 1e9,
         kv_pool_gb=2 * eng.k_pool.numel() * 4 / 1e9, page=cfg.kv_page_size,
         partitions=SERVE_PARTITIONS, slots_per_partition=SERVE_SLOTS, max_batch=SERVE_BATCH,
         requests=len(rids), prompt_tokens=[int(x) for x in lengths],
         new_tokens=SERVE_NEW_TOKENS, fork_new_tokens=SERVE_FORK_TOKENS,
         finished=len(eng.finished), token_counts_ok=counts == want_counts,
         invariants_after_run=True, invariants_after_fork=True,
         init_s=init_s, serve_s=serve_s, prefill_s=prefill_s, prefill_calls=len(rec["prefill_s"]),
         prefill_tok_per_s=sum(rec["prefill_T"]) / prefill_s, decode_s=decode_s,
         decode_steps=len(rec["decode_s"]), decode_steps_before_fork=n_decode_before_fork,
         decode_tokens=decode_tokens, decode_tok_per_s=decode_tokens / decode_s,
         decode_step_ms_mean=decode_s / len(rec["decode_s"]) * 1e3,
         decode_step_ms_min=min(rec["decode_s"]) * 1e3,
         weights_read_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
         logits_checks=[{"call": c[0], "size": c[1], "max_rel_err": c[2]} for c in rec["checks"]],
         logits_tolerance=LOGITS_TOL_BF16,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches)
    if counts != want_counts:
        fail(f"serve: token counts {counts}, expected {want_counts}")
    if len(rec["checks"]) != 1 + SERVE_CHECKED_DECODES or worst > LOGITS_TOL_BF16:
        fail(f"serve: logits through K5/K6 differ from the plain versions' by {worst} "
             f"of their scale (tolerance {LOGITS_TOL_BF16})")
    want_launches = {"flash_attention": cfg.num_layers * len(rec["prefill_s"]),
                     "paged_attention": cfg.num_layers * len(rec["decode_s"])}
    for k, n in want_launches.items():
        if launches[k] != n or n <= 0:
            fail(f"serve: {k} launched {launches[k]} times, expected {n}")
    return eng, rec, launches


def _paged_main_path_check(torch, op: str, call, kw: dict, **shape) -> float:
    """K6 at a main-path call held to its plain version computed in float64
    on the same inputs, within the float32 tolerance.  At the serving path's
    contexts (~1,900 keys) the un-normalised accumulator sums terms of either
    sign, and the float32 plain version is itself outside 2e-5 of the float64
    result at some elements (PERF.md, K6); its own error is reported beside."""
    from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    q, kp, vp, table, ctx = call
    want = list(paged_attention_ref(q.double(), kp.double(), vp.double(), table, ctx,
                                    return_residuals=True, **kw))
    plain = paged_attention_ref(*call, return_residuals=True, **kw)
    plain_err, plain_ok = _allclose_err(torch, [x.double() for x in plain], want,
                                        ATTN_TOL["float32"])
    got = [x.double() for x in paged_attention_cuda(*call, **kw)]
    return _compare_tol(torch, op, "paged_attention", got, want, ATTN_TOL["float32"],
                        reference="plain version in float64",
                        plain_float32_max_abs_err=plain_err, plain_float32_within=plain_ok,
                        **shape)


def _flash_bytes_flops(Hq, Hkv, T, D, elem: int = 2):
    """K5 on one prompt of T tokens: q, k, v read once and o written once;
    causal QK^T and PV over the T(T+1)/2 visible pairs, 2 FLOPs a MAC."""
    return (2 * Hq + 2 * Hkv) * T * D * elem, 4 * Hq * D * T * (T + 1) // 2


def _k5_design(torch, D: int) -> dict:
    """K5's bf16 design and tiles at head dim D, and the seconds the kernels'
    library took to build in this run."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import tile_plan

    plan = tile_plan(D, torch.bfloat16)
    return {"design": plan.design, "tiles": plan._asdict(),
            "build_seconds": _build.load().build_s}


HELD_BATCH = 400                   # calls enqueued behind one held stream
HELD_CYCLES = 200_000_000          # the hold, ~0.1 s: longer than 400 calls' host time
K8_KERNELS = ("mamba2_mma_kernel", "mamba2_fma_kernel")
SCAN_KERNELS = {"rwkv6_scan": ("rwkv6_mma_kernel", "rwkv6_scan_kernel"),
                "mamba2_scan": K8_KERNELS}


def _split_plans(torch, calls) -> list:
    """K6's split plan at each distinct call shape of ``calls`` (q, k_pool,
    v_pool, table, ctx, ...): splits, tiles a split, warps, and the blocks
    launched a call (splits x KV heads x sequences), with the calls."""
    from repro_torch.kernels.paged_attention import kernel as k6

    plans = {}
    for q, kp, _, table, _ in (c[:5] for c in calls):
        key = (q.shape[0], q.shape[1], kp.shape[1], kp.shape[2], kp.shape[3], table.shape[1])
        plans[key] = plans.get(key, 0) + 1
    out = []
    for (B, Hq, page, Hkv, D, pages), n in sorted(plans.items()):
        plan = k6.split_plan(B, Hkv, pages, page, k6.sm_count(0), D, Hq // Hkv)
        out.append({"B": B, "pages": pages, "page": page, "splits": plan.splits,
                    "tiles_per_split": plan.tiles_per_split, "warps": plan.warps,
                    "blocks": plan.splits * Hkv * B, "calls": n})
    return out


def time_attention(torch, eng, rec, launches, errs) -> list:
    """Phase 9: K5 and K6 at the main path's shapes, against their plain
    versions on the same calls, with K5's library yardstick
    ``scaled_dot_product_attention`` (timed here only; the port never calls
    it)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    cfg = eng.cfg
    L, Hq, Hkv, D = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    rows = []

    # K5: every prefill of the run, one call per layer, bf16 inputs.
    inputs = [tuple(torch.randn(s, generator=gen, device=dev, dtype=torch.bfloat16)
                    for s in ((1, Hq, T, D), (1, Hkv, T, D), (1, Hkv, T, D)))
              for T in rec["prefill_T"]]
    calls = [x for x in inputs for _ in range(L)]
    nbytes = flops = 0
    for T in rec["prefill_T"]:
        b, f = _flash_bytes_flops(Hq, Hkv, T, D)
        nbytes, flops = nbytes + L * b, flops + L * f
    err = errs["flash_attention"]
    for q, k, v in inputs:
        err = max(err, _compare_tol(torch, "flash_attention (main-path shape)", "flash_attention",
                                    [flash_attention_cuda(q, k, v).float()],
                                    [flash_attention_ref(q, k, v).float()], ATTN_TOL["bfloat16"],
                                    Hq=Hq, Hkv=Hkv, T=q.shape[2], D=D))
    ms = _event_ms(torch, lambda: [flash_attention_cuda(*c) for c in calls], reps=1)
    plain_ms = _event_ms(torch, lambda: [flash_attention_ref(*c) for c in calls], reps=1)
    lib_ms = _event_ms(torch, lambda: [F.scaled_dot_product_attention(
        *c, is_causal=True, enable_gqa=True) for c in calls], reps=1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:133",
           "launches": launches["flash_attention"], "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": lib_ms,
           **_k5_design(torch, D),
           "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True, "
                      "enable_gqa=True)",
           "shape": f"{SERVE_ARCH} prefill: {len(inputs)} prompts of {rec['prefill_T']} tokens "
                    f"x {L} layers, Hq {Hq}, Hkv {Hkv}, D {D}, bf16, causal",
           "kernel_launches_timed": len(calls), "bytes": nbytes, "operations": flops,
           "ms_per_prompt_all_layers": ms / len(inputs),
           "tflops": flops / ms / 1e9}
    emit("timing", **row)
    rows.append(row)
    del inputs, calls

    # K6: every decode step of the run on every layer's pool, bf16 queries,
    # the pool as it stood before the step's new token (ctx - 1).
    qs = {B: torch.randn((B, Hq, D), generator=gen, device=dev, dtype=torch.bfloat16)
          for B in set(rec["decode_B"])}
    calls, nbytes, flops = [], 0, 0
    for table, ctx in rec["decode_calls"]:
        c1 = (ctx - 1).to(torch.int32)
        B, tokens = table.shape[0], int(c1.sum())
        for i in range(L):
            calls.append((qs[B], eng.k_pool[i], eng.v_pool[i], table, c1))
        nbytes += L * (2 * tokens * Hkv * D * 4 + B * Hq * D * 2 + table.numel() * 4 + B * 4
                       + B * Hq * (D + 2) * 4)
        flops += L * 4 * tokens * Hq * D
    err = errs["paged_attention"]
    for c in (calls[0], calls[-1]):
        err = max(err, _paged_main_path_check(torch, "paged_attention_partial (main-path call)",
                                              c, {}, B=c[0].shape[0], ctx=c[4].tolist()))
    ms = _event_ms(torch, lambda: [paged_attention_cuda(*c) for c in calls], reps=1)
    dev_ms = _device_ms(torch, lambda: [paged_attention_cuda(*c) for c in calls],
                        _expect_k6(calls),
                        [lambda c=c: paged_attention_cuda(*c) for c in calls])
    dev_ms.update(_device_time(dev_ms))
    plain_ms = _event_ms(torch, lambda: [paged_attention_ref(*c, return_residuals=True)
                                         for c in calls], reps=1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    steps = len(rec["decode_calls"])
    row = {"name": "paged_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
           "replaces": "src/repro/kernels/paged_attention/kernel.py:146",
           "launches": launches["paged_attention"], "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
           "shape": f"{SERVE_ARCH} decode: {steps} steps (batch {min(rec['decode_B'])}-"
                    f"{max(rec['decode_B'])}) x {L} layers, f32 pool of {cfg.kv_page_size}-token "
                    f"pages, "
                    f"bf16 queries",
           "kernel_launches_timed": len(calls), "bytes": nbytes, "operations": flops,
           "ms_per_step_all_layers": ms / steps, "gb_per_s": nbytes / ms / 1e6,
           **dev_ms, "device_gb_per_s": nbytes / dev_ms["device_time_ms"] / 1e6,
           "split_plans": _split_plans(torch, calls)}
    emit("timing", **row)
    rows.append(row)
    return rows


PROFILE_STEPS = 3                  # decode steps under torch.profiler


def profile_serving(torch, eng, rec) -> None:
    """Phase 10: where a decode step's and a prefill's time goes, from
    ``torch.profiler`` (CUPTI) over the run's largest-batch decode step and
    its longest prompt, after the counted run: the device's busy time (the
    kernels' summed time; one stream, so they do not overlap), its idle share
    of the wall time, and the kernels that take the most.  The profiled wall
    time is longer than the plain one (the tracer's own cost); the idle share
    is given against both (kernel durations do not change under the
    tracer)."""
    from repro_torch.models import transformer as tfm

    B = max(rec["decode_B"])
    table, ctx = next((t, c) for t, c in rec["decode_calls"] if t.shape[0] == B)
    tokens = torch.zeros(B, dtype=torch.int32, device="cuda")
    T = max(rec["prefill_T"])
    prompt = torch.zeros((1, T), dtype=torch.int32, device="cuda")
    profile_line(torch, "decode_step", PROFILE_STEPS, lambda: tfm.decode_step(
        eng.params, tokens, eng.cfg, eng.k_pool, eng.v_pool, table, ctx),
        batch=B, tokens=int(ctx.sum()))
    profile_line(torch, "prefill", 1, lambda: tfm.prefill_with_kv(eng.params, prompt, eng.cfg),
                 batch=1, tokens=T)


def profile_line(torch, what: str, n: int, fn, **fields) -> dict:
    """One ``profile`` line: the wall time of ``fn()`` (mean of ``n`` runs
    after a warm-up, host clock ending in a synchronise), the same under
    ``torch.profiler``, the device's busy time (the kernels' summed time; one
    stream, so they do not overlap), its idle share of both wall times, and
    the kernels that take the most.  Returns the line's fields."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # Kernel rows only: an operator's row repeats its kernels' device time.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    line = dict(what=what, **fields, runs=n, wall_ms=wall_ms, wall_ms_profiled=prof_wall_ms,
                device_busy_ms=busy_ms,
                device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
                device_idle_share_profiled=(1 - busy_ms / prof_wall_ms) if busy_ms else None,
                device_ops_per_run=sum(e.count for e in events) / n,
                top=[{"name": e.key[:80], "ms": e.self_device_time_total / 1e3 / n,
                      "calls": e.count / n} for e in top])
    emit("profile", **line)
    if not busy_ms:
        print(f"profile: torch.profiler recorded no device time for {what}",
              file=sys.stderr, flush=True)
    return line


def run_serving(torch) -> list:
    """Phases 6-10; returns the K5 and K6 rows of the kernels line."""
    t0 = time.perf_counter()
    errs = check_attention_against_plain(torch)
    torch.cuda.empty_cache()
    run_serve_exact(torch)
    torch.cuda.reset_peak_memory_stats()
    eng, rec, launches = run_serve(torch)
    rows = time_attention(torch, eng, rec, launches, errs)
    profile_serving(torch, eng, rec)
    del eng
    torch.cuda.empty_cache()
    emit("serving_phases", seconds=time.perf_counter() - t0)
    return rows



# ---------------------------------------------------------------------------
# Phases 11-14: the state-space families through K7 and K8.
# ---------------------------------------------------------------------------

SSM_ARCHS = ("rwkv6-1.6b", "zamba2-7b")
SSM_SEED = 14
SCAN_TOL = {"float32": 5e-4, "bfloat16": 2e-2}   # bf16: one output rounding (2^-8)
SSM_EXACT_LAYERS = {"rwkv6-1.6b": 2, "zamba2-7b": 6}   # rwkv6 2 layers, zamba2 2 groups
SSM_EXACT_TOKENS = 128
SSM_EXACT_TOL = 1e-3               # max |a - b| / max |b| of float32 logits
# ssm_bf16: the bf16 decode loop's last-position logits against the
# prefill's at ssm_exact's width, depth, batch and prompt length, within 1.5
# times the largest gap of the JAX package's own decode loop against its
# forward there (tests/ssm_bf16_gap.py --no-excess-precision on the CPU,
# weight seeds 0-2 for rwkv6, 0-1 for zamba2: XLA then rounds each op to its
# dtype, as the port does).
SSM_BF16_LIMIT = {"rwkv6-1.6b": 1.5 * 0.01429, "zamba2-7b": 1.5 * 0.01474}
SSM_BATCH, SSM_PREFILL_TOKENS = 4, 2048
SSM_DECODE_PROMPT = {"rwkv6-1.6b": 256, "zamba2-7b": 128}   # multiples of K7's / K8's chunk
SSM_NEW_TOKENS = 32
SSM_PAGE = 64                      # zamba2's shared-attention KV pages
SSM_KERNELS = {"rwkv6-1.6b": ("rwkv6_scan",), "zamba2-7b": ("mamba2_scan", "flash_attention")}

# (B, H, T, N, chunk, dtype, w range): the JAX test shapes, rwkv6-1.6b's
# head shape, decays fast enough that the TPU kernel's k exp(-logd) form
# overflows, and T < chunk.
RWKV6_CHECKS = [
    (2, 2, 64, 32, 32, "float32", (0.75, 0.999)),
    (1, 4, 96, 16, 16, "float32", (0.75, 0.999)),
    (2, 32, 256, 64, 32, "bfloat16", (0.75, 0.999)),
    (2, 32, 256, 64, 32, "float32", (1e-3, 0.05)),
    (1, 4, 20, 64, 32, "float32", (0.75, 0.999)),
]
# (B, H, T, P, N, chunk, dtype, zamba2 decays): the JAX test shapes, then
# zamba2-7b's head shape at its decays (A = -linspace(1, 8, H), dt =
# softplus(N(0, 0.63^2))), where the TPU kernel gives NaN, and T < chunk.
MAMBA2_CHECKS = [
    (2, 2, 64, 32, 16, 32, "float32", False),
    (1, 4, 96, 16, 32, 16, "float32", False),
    (2, 112, 256, 64, 64, 64, "bfloat16", True),
    (2, 112, 256, 64, 64, 64, "float32", True),
    (1, 8, 40, 64, 64, 64, "float32", True),
    # The bf16 tensor-core kernel's edges: H not a multiple of the heads a
    # block, T < chunk, N and P below its 64-wide tiles; zamba2's P = N = 64
    # in float32 and bf16 at a batch of 1.
    (2, 7, 128, 64, 64, 64, "bfloat16", True),
    (1, 5, 40, 64, 64, 64, "bfloat16", True),
    (2, 3, 96, 16, 32, 32, "bfloat16", False),
    (1, 112, 128, 64, 64, 64, "float32", True),
    (1, 112, 128, 64, 64, 64, "bfloat16", True),
]


def _scan_compare(torch, op: str, kernel: str, got, want, dtype: str, **shape) -> float:
    """Outputs within the dtype's tolerance, states within float32's, all
    finite; one ``kernel_vs_plain`` line."""
    finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
    err_o, ok_o = _allclose_err(torch, [got[0].float()], [want[0].float()], SCAN_TOL[dtype])
    err_s, ok_s = _allclose_err(torch, [got[1]], [want[1]], SCAN_TOL["float32"])
    ok = finite and ok_o and ok_s
    emit("kernel_vs_plain", op=op, kernel=kernel, within=ok, finite=finite,
         max_abs_err=max(err_o, err_s), max_abs_err_out=err_o, max_abs_err_state=err_s,
         tolerance=SCAN_TOL[dtype], state_tolerance=SCAN_TOL["float32"], dtype=dtype, **shape)
    if not ok:
        fail(f"{op}: kernel differs from its plain version (finite {finite}, out err {err_o}, "
             f"state err {err_s})")
    return max(err_o, err_s)


def check_scans_against_plain(torch) -> dict:
    """Phase 11: K7 and K8 through their op entry points on the card against
    their plain versions on the same inputs, and the chunk rule."""
    import numpy as np

    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as r6

    dev = torch.device("cuda")
    errs = {"rwkv6_scan": 0.0, "mamba2_scan": 0.0}

    def t(a, dtype="float32"):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev, getattr(torch, dtype))

    for i, (B, H, T, N, chunk, dt, wr) in enumerate(RWKV6_CHECKS):
        rng = np.random.default_rng(300 + i)
        r, k, v = (t(rng.standard_normal((B, H, T, N)) * 0.5, dt) for _ in range(3))
        w, u = t(rng.uniform(*wr, (B, H, T, N))), t(rng.standard_normal((H, N)) * 0.5)
        got = r6.rwkv6_scan(r, k, v, w, u, chunk=chunk, kernel_mode="cuda")
        want = r6.rwkv6_scan(r, k, v, w, u, kernel_mode="reference")
        errs["rwkv6_scan"] = max(errs["rwkv6_scan"], _scan_compare(
            torch, "rwkv6_scan", "rwkv6_scan", got, want, dt, B=B, H=H, T=T, N=N, chunk=chunk,
            w_range=list(wr)))
    for i, (B, H, T, P, N, chunk, dt, zamba2) in enumerate(MAMBA2_CHECKS):
        rng = np.random.default_rng(400 + i)
        x = t(rng.standard_normal((B, H, T, P)) * 0.5, dt)
        if zamba2:
            dts = torch.nn.functional.softplus(t(rng.normal(0.0, 0.63, (B, H, T))))
            A = -torch.linspace(1.0, 8.0, H, device=dev)
        else:
            dts, A = t(rng.uniform(0.001, 0.1, (B, H, T))), t(-rng.uniform(0.5, 4.0, H))
        Bm, C = (t(rng.standard_normal((B, T, N)) * 0.5) for _ in range(2))
        D = t(rng.standard_normal(H))
        got = m2.mamba2_scan(x, dts, A, Bm, C, D, chunk=chunk, kernel_mode="cuda")
        want = m2.mamba2_scan(x, dts, A, Bm, C, D, kernel_mode="reference")
        errs["mamba2_scan"] = max(errs["mamba2_scan"], _scan_compare(
            torch, "mamba2_scan", "mamba2_scan", got, want, dt, B=B, H=H, T=T, P=P, N=N, chunk=chunk,
            zamba2_decays=zamba2))
    refused = []
    for name, call in (
            ("rwkv6_scan", lambda: r6.rwkv6_scan(*(torch.zeros((1, 2, 48, 16), device=dev),) * 3,
                                                 torch.full((1, 2, 48, 16), 0.5, device=dev),
                                                 torch.zeros((2, 16), device=dev), chunk=32,
                                                 kernel_mode="cuda")),
            ("mamba2_scan", lambda: m2.mamba2_scan(
                torch.zeros((1, 2, 96, 16), device=dev), torch.full((1, 2, 96), 0.1, device=dev),
                -torch.ones(2, device=dev), *(torch.zeros((1, 96, 16), device=dev),) * 2,
                torch.ones(2, device=dev), chunk=64, kernel_mode="cuda"))):
        try:
            call()
        except ValueError:
            refused.append(name)
    emit("scan_chunk_rule", refused_T_not_a_multiple_of_chunk=refused)
    if len(refused) != 2:
        fail(f"scan_chunk_rule: only {refused} refused T % chunk != 0")
    return errs


def _ssm_cfg(arch: str, **overrides):
    import dataclasses

    from repro_torch.configs import registry

    cfg = registry.get_config(arch)
    if cfg.family == "hybrid":
        overrides.setdefault("kv_page_size", SSM_PAGE)
    return dataclasses.replace(cfg, **overrides)


def _decode_loop(torch, cfg, params, prompts, new_tokens: int, *, keep_all: bool,
                 step_s=None):
    """Feed ``prompts`` [B, T] one token at a time through the family's
    ``decode_step`` from ``init_decode_state`` (zamba2: paged pools and a
    shuffled block table), then ``new_tokens`` greedy tokens.  Returns (the
    logits at every prompt position [B, T, V] when ``keep_all``, else at the
    last, float32; the greedy tokens [B, new_tokens]; the pools or None).
    ``step_s`` collects each step's host time, ending in a synchronise."""
    import numpy as np

    from repro_torch import models

    mod = models.get_family_module(cfg)
    dev = torch.device("cuda")
    B, T = prompts.shape
    state = mod.init_decode_state(cfg, B, device=dev)
    pools = None
    if cfg.family == "hybrid":
        G, _ = mod.group_dims(cfg)
        pages = -(-(T + new_tokens) // cfg.kv_page_size)
        shape = (G, B * pages, cfg.kv_page_size, cfg.num_kv_heads, cfg.head_dim)
        pools = (torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
        table = torch.from_numpy(np.random.default_rng(SSM_SEED).permutation(B * pages)
                                 .reshape(B, pages).astype(np.int32)).to(dev)
    logits, gen, tok = [], [], None
    for t in range(T + new_tokens):
        tok = prompts[:, t] if t < T else gen[-1]
        if step_s is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if pools is None:
            lg, state = mod.decode_step(params, tok, cfg, state)
        else:
            ctx = torch.full((B,), t + 1, dtype=torch.int32, device=dev)
            lg, state, _, _ = mod.decode_step(params, tok, cfg, state, *pools, table, ctx)
        if step_s is not None:
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        if keep_all and t < T or t == T - 1:
            logits.append(lg.float())
        if t >= T - 1:
            gen.append(lg.argmax(-1).to(torch.int32))
    out = torch.stack(logits, 1) if keep_all else logits[-1]
    return out, torch.stack(gen[:new_tokens], 1) if new_tokens else None, (pools, state)


def _family_launches(torch, before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()
            if k in ("rwkv6_scan", "mamba2_scan", "flash_attention", "paged_attention")}


def run_ssm_exact(torch) -> None:
    """Phase 12: both families at full width, cut in depth, float32:
    ``make_prefill_step`` through the kernels equals its run through the
    plain versions, and ``forward``'s logits at every position equal a
    decode loop from ``init_decode_state`` over the same tokens (JAX's own
    decode-consistency property), both within 1e-3 of the logits' scale
    with equal greedy tokens."""
    from repro_torch import models
    from repro_torch.train.train_step import make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    for arch in SSM_ARCHS:
        t0 = time.perf_counter()
        cfg = _ssm_cfg(arch, num_layers=SSM_EXACT_LAYERS[arch], dtype="float32")
        params = models.init(cfg, seed=SSM_SEED, device="cuda")
        prompts = torch.tensor(_prompts(cfg, [SSM_EXACT_TOKENS] * 2, SSM_SEED),
                               dtype=torch.int32, device="cuda")
        batch = {"tokens": prompts}
        before = _launches()
        kern = make_prefill_step(cfg)(params, batch)
        l_kern = _family_launches(torch, before)
        before = _launches()
        plain = make_prefill_step(cfg, kernel_mode="reference")(params, batch)
        l_plain = _family_launches(torch, before)
        full = models.forward(params, batch, cfg)[0].float()
        dec, _, _ = _decode_loop(torch, cfg, params, prompts, 0, keep_all=True)
        torch.cuda.synchronize()
        prefill_err = _rel_err(torch, kern, plain)
        decode_err = _rel_err(torch, dec, full)
        prefill_tokens_equal = torch.equal(kern.argmax(-1), plain.argmax(-1))
        decode_tokens_equal = torch.equal(dec.argmax(-1), full.argmax(-1))
        want = {k: 0 for k in l_kern}
        if cfg.family == "ssm":
            want["rwkv6_scan"] = cfg.num_layers
        else:
            G = cfg.num_layers // cfg.hybrid_period
            want.update(mamba2_scan=cfg.num_layers, flash_attention=G)
        emit("ssm_exact", arch=arch, layers=cfg.num_layers, d_model=cfg.d_model,
             dtype="float32", prompts=2, prompt_tokens=SSM_EXACT_TOKENS,
             prefill_max_rel_err=prefill_err, decode_vs_forward_max_rel_err=decode_err,
             tolerance=SSM_EXACT_TOL, prefill_tokens_equal=prefill_tokens_equal,
             decode_tokens_equal=decode_tokens_equal, launches_kernels=l_kern,
             launches_plain=l_plain, seconds=time.perf_counter() - t0,
             parameters=sum(p.numel() for p in params.parameters()))
        if not (prefill_err <= SSM_EXACT_TOL and decode_err <= SSM_EXACT_TOL
                and prefill_tokens_equal and decode_tokens_equal):
            fail(f"ssm_exact {arch}: prefill err {prefill_err}, decode err {decode_err}, "
                 f"tokens equal {prefill_tokens_equal}/{decode_tokens_equal}")
        if l_kern != want or any(l_plain.values()):
            fail(f"ssm_exact {arch}: launches {l_kern} (expected {want}), plain {l_plain}")
        del params, full, dec
        torch.cuda.empty_cache()


def run_ssm_full_depth(torch) -> None:
    """Phase 12b: both families at full width and full depth in float32: the
    decode loop's logits at the last prompt position equal
    ``make_prefill_step``'s (through the kernels) within 1e-3 of their scale,
    with the same greedy token.  This is where the decode path is held to
    the prefill at full depth.  In bf16 it is held to it at ``ssm_exact``'s
    depth (phase 12c), where the JAX package's own gap is read on the CPU
    (``tests/ssm_bf16_gap.py``); phase 13 reports the full-depth bf16 gap."""
    from repro_torch import models
    from repro_torch.train.train_step import make_prefill_step

    for arch in SSM_ARCHS:
        t0 = time.perf_counter()
        cfg = _ssm_cfg(arch, dtype="float32")
        params = models.init(cfg, seed=SSM_SEED, device="cuda")
        prompts = torch.tensor(_prompts(cfg, [SSM_EXACT_TOKENS] * 2, SSM_SEED + 2),
                               dtype=torch.int32, device="cuda")
        want = make_prefill_step(cfg)(params, {"tokens": prompts}).float()
        last, _, _ = _decode_loop(torch, cfg, params, prompts, 0, keep_all=False)
        torch.cuda.synchronize()
        rel = _rel_err(torch, last, want)
        equal = torch.equal(last.argmax(-1), want.argmax(-1))
        emit("ssm_full_depth", arch=arch, layers=cfg.num_layers, d_model=cfg.d_model,
             dtype="float32", prompts=2, prompt_tokens=SSM_EXACT_TOKENS,
             decode_vs_prefill_max_rel_err=rel, tolerance=SSM_EXACT_TOL,
             greedy_tokens_equal=equal, seconds=time.perf_counter() - t0,
             peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        if rel > SSM_EXACT_TOL or not equal:
            fail(f"ssm_full_depth {arch}: decode logits differ from the prefill's by {rel} "
                 f"of their scale (tolerance {SSM_EXACT_TOL}), tokens equal {equal}")
        del params
        torch.cuda.empty_cache()


def run_ssm_bf16(torch) -> None:
    """Phase 12c: both families at ``ssm_exact``'s width and depth in bf16,
    their serving dtype: the decode loop's logits at the last prompt
    position against ``make_prefill_step``'s (through the kernels), finite
    and within ``SSM_BF16_LIMIT`` of their scale, 1.5 times the JAX
    package's own gap at the same configuration."""
    from repro_torch import models
    from repro_torch.train.train_step import make_prefill_step

    for arch in SSM_ARCHS:
        t0 = time.perf_counter()
        cfg = _ssm_cfg(arch, num_layers=SSM_EXACT_LAYERS[arch])
        params = models.init(cfg, seed=SSM_SEED, device="cuda")
        prompts = torch.tensor(_prompts(cfg, [SSM_EXACT_TOKENS] * 2, SSM_SEED),
                               dtype=torch.int32, device="cuda")
        want = make_prefill_step(cfg)(params, {"tokens": prompts}).float()
        last, _, _ = _decode_loop(torch, cfg, params, prompts, 0, keep_all=False)
        torch.cuda.synchronize()
        rel = _rel_err(torch, last, want)
        finite = bool(torch.isfinite(last).all()) and bool(torch.isfinite(want).all())
        limit = SSM_BF16_LIMIT[arch]
        emit("ssm_bf16", arch=arch, layers=cfg.num_layers, d_model=cfg.d_model,
             dtype=cfg.dtype, prompts=2, prompt_tokens=SSM_EXACT_TOKENS,
             decode_vs_prefill_max_rel_err=rel, tolerance=limit, finite=finite,
             greedy_tokens_equal=torch.equal(last.argmax(-1), want.argmax(-1)),
             seconds=time.perf_counter() - t0)
        if not finite or rel > limit:
            fail(f"ssm_bf16 {arch}: decode logits differ from the prefill's by {rel} of "
                 f"their scale (limit {limit}), finite {finite}")
        del params
        torch.cuda.empty_cache()


def run_ssm_serve(torch, arch: str) -> dict:
    """Phase 13 for one family, the main path at full width in bf16 with
    every launch counter set to 0 just before and read just after:
    ``make_prefill_step`` on 4 numpy-seeded prompts of 2,048 tokens, on the
    first of them alone, then on the first 256 (rwkv6) / 128 (zamba2) tokens
    of each and
    a decode loop over those tokens from ``init_decode_state`` plus 32
    greedy tokens at batch 4.  The decode loop's logits at the last prompt
    position must be finite; their gap to the short prefill's is reported
    (phase 12b holds the two paths together at full depth in float32, phase
    12c in bf16 at the depth where the JAX package's gap is known).  The
    kernels' calls of the long prefill and the decode loop, and K7's of the
    one-prompt prefill, are recorded for the timing phase."""
    from repro_torch import models
    from repro_torch.kernels.flash_attention import ops as k5ops
    from repro_torch.kernels.mamba2_scan import ops as k8ops
    from repro_torch.kernels.paged_attention import ops as k6ops
    from repro_torch.kernels.rwkv6_scan import ops as k7ops
    from repro_torch.train.train_step import make_prefill_step

    cfg = _ssm_cfg(arch)
    t0 = time.perf_counter()
    params = models.init(cfg, seed=SSM_SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.tensor(_prompts(cfg, [SSM_PREFILL_TOKENS] * SSM_BATCH, SSM_SEED + 1),
                           dtype=torch.int32, device="cuda")
    T_dec = SSM_DECODE_PROMPT[arch]
    short = prompts[:, :T_dec].contiguous()
    step = make_prefill_step(cfg)
    calls = {"rwkv6_scan": [], "mamba2_scan": [], "flash_attention": [], "paged_attention": []}
    calls_one = []
    torch.cuda.reset_peak_memory_stats()

    for m in _counters().values():
        m.launches = 0
    undo = [_recording(k7ops, "rwkv6_scan_cuda", calls["rwkv6_scan"]),
            _recording(k8ops, "mamba2_scan_cuda", calls["mamba2_scan"]),
            _recording(k5ops, "flash_attention_cuda", calls["flash_attention"])]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, {"tokens": prompts})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    finally:
        for u in undo:
            u()
    l_prefill = _launches()
    # One prompt alone (batch 1), the narrow side of K7's column plan.
    undo = _recording(k7ops, "rwkv6_scan_cuda", calls_one)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, {"tokens": prompts[:1]})
        torch.cuda.synchronize()
        prefill_one_s = time.perf_counter() - t0
    finally:
        undo()
    l_one = _family_launches(torch, l_prefill)
    before = _launches()
    want_last = step(params, {"tokens": short})
    l_short = _family_launches(torch, before)
    before = _launches()
    step_s = []
    undo = _recording(k6ops, "paged_attention_cuda", calls["paged_attention"])
    try:
        last, gen, (pools, _) = _decode_loop(torch, cfg, params, short, SSM_NEW_TOKENS,
                                             keep_all=False, step_s=step_s)
    finally:
        undo()
    torch.cuda.synchronize()
    l_decode = _family_launches(torch, before)
    launches = _launches()
    # The long prefill again, warm (the first call also pays the shapes'
    # first launches), after the counters are read.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s_warm = time.perf_counter() - t0

    rel = _rel_err(torch, last, want_last)
    l_prefill = {k: v for k, v in l_prefill.items() if k in l_short}
    n_steps = len(step_s)
    G = cfg.num_layers // max(cfg.hybrid_period, 1)
    if cfg.family == "ssm":
        want_prefill = dict(rwkv6_scan=cfg.num_layers, mamba2_scan=0, flash_attention=0,
                            paged_attention=0)
        want_decode = {k: 0 for k in want_prefill}
    else:
        want_prefill = dict(rwkv6_scan=0, mamba2_scan=cfg.num_layers, flash_attention=G,
                            paged_attention=0)
        want_decode = dict(rwkv6_scan=0, mamba2_scan=0, flash_attention=0,
                           paged_attention=G * n_steps)
    mod = models.get_family_module(cfg)
    prof_tokens = gen[:, -1].contiguous()
    if pools is None:
        state = mod.init_decode_state(cfg, SSM_BATCH, device="cuda")
        prof = profile_line(torch, f"{arch} decode_step", PROFILE_STEPS,
                            lambda: mod.decode_step(params, prof_tokens, cfg, state),
                            batch=SSM_BATCH, tokens=SSM_BATCH)
    else:
        state = mod.init_decode_state(cfg, SSM_BATCH, device="cuda")
        table = torch.arange(pools[0].shape[1], dtype=torch.int32, device="cuda").reshape(
            SSM_BATCH, -1)
        ctx = torch.full((SSM_BATCH,), T_dec + SSM_NEW_TOKENS, dtype=torch.int32, device="cuda")
        prof = profile_line(torch, f"{arch} decode_step", PROFILE_STEPS,
                            lambda: mod.decode_step(params, prof_tokens, cfg, state, *pools,
                                                    table, ctx),
                            batch=SSM_BATCH, tokens=int(ctx.sum()))
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    emit("ssm_serve", arch=arch, family=cfg.family, layers=cfg.num_layers,
         d_model=cfg.d_model, dtype=cfg.dtype,
         parameters=sum(p.numel() for p in params.parameters()),
         weight_gb=weight_bytes / 1e9, init_s=init_s,
         prefill_batch=SSM_BATCH, prefill_tokens=SSM_PREFILL_TOKENS, prefill_s=prefill_s,
         prefill_tok_per_s=SSM_BATCH * SSM_PREFILL_TOKENS / prefill_s,
         prefill_s_warm=prefill_s_warm,
         prefill_tok_per_s_warm=SSM_BATCH * SSM_PREFILL_TOKENS / prefill_s_warm,
         prefill_one_prompt_s=prefill_one_s,
         prefill_one_prompt_tok_per_s=SSM_PREFILL_TOKENS / prefill_one_s,
         decode_batch=SSM_BATCH, decode_prompt_tokens=T_dec, new_tokens=SSM_NEW_TOKENS,
         decode_steps=n_steps, decode_s=sum(step_s),
         decode_step_ms_mean=sum(step_s) / n_steps * 1e3, decode_step_ms_min=min(step_s) * 1e3,
         decode_tok_per_s=SSM_BATCH * n_steps / sum(step_s),
         kv_page=cfg.kv_page_size if pools else None,
         kv_pool_gb=2 * pools[0].numel() * 4 / 1e9 if pools else None,
         kv_pool_shape=list(pools[0].shape) if pools else None,
         weights_read_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
         decode_vs_prefill_max_rel_err_bf16=rel,
         greedy_tokens=gen[0].tolist(),
         decode_step_device_idle_share=prof["device_idle_share"],
         decode_step_device_busy_ms=prof["device_busy_ms"],
         launches_prefill=l_prefill, launches_one_prompt_prefill=l_one,
         launches_short_prefill=l_short,
         launches_decode=l_decode, launches=launches,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not (bool(torch.isfinite(last).all()) and bool(torch.isfinite(want_last).all())):
        fail(f"ssm_serve {arch}: non-finite logits")
    for what, got, want in (("prefill", l_prefill, want_prefill),
                            ("one-prompt prefill", l_one, want_prefill),
                            ("short prefill", l_short, want_prefill),
                            ("decode", l_decode, want_decode)):
        if got != want:
            fail(f"ssm_serve {arch}: {what} launches {got}, expected {want}")
    for k in SSM_KERNELS[arch]:
        if launches[k] <= 0:
            fail(f"ssm_serve {arch}: the main path launched {k} {launches[k]} times")
    del params, pools
    return {"calls": calls, "calls_one_prompt": calls_one, "launches": launches, "cfg": cfg}


def _scan_work(kind: str, B: int, H: int, T: int, N: int, P: int, esize: int):
    """(bytes, operations) of one scan call: each input read once, the output
    and the final state written once; the operations the recurrence itself
    needs per token and head (``ref.py``), whatever form computes it.  K7:
    o = r S + (r . u k) v and S = diag(w) S + k v^T, 5 N^2 + 5 N (w is an
    input, no exponential).  K8: S = exp(A dt) S + (dt B) x^T and
    y = C S + D x, 5 N P + N + 2 P, plus A dt and its exponential."""
    if kind == "rwkv6_scan":       # r, k, v, o in esize; w f32; u; S [N, N]
        nbytes = 4 * B * H * T * N * esize + B * H * T * N * 4 + H * N * 4 + B * H * N * N * 4
        ops = B * H * T * (5 * N * N + 5 * N)
    else:                          # x, y in esize; dt; Bm, C; S [N, P]
        nbytes = (2 * B * H * T * P * esize + B * H * T * 4 + 2 * B * T * N * 4 + 2 * H * 4
                  + B * H * N * P * 4)
        ops = B * H * T * (5 * N * P + N + 2 * P + 2)
    return nbytes, ops


def _once_ms(torch, fn) -> float:
    """Milliseconds of one run of ``fn()``, CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _mamba2_design(torch, calls, t_bytes: float, t_ops_f32: float) -> dict:
    """K8's design and heads a block at the first of ``calls``, and its bound
    both at the rate of the unit the design uses (bf16 tensor cores,
    989 TFLOP/s, for the tensor-core kernel) and at the float32 rate."""
    from repro_torch.kernels.mamba2_scan import kernel as k8

    x = calls[0][0][0]
    d = k8.design(x.dtype)
    out = {"design": d, "bound_ms_f32_rate": max(t_bytes, t_ops_f32)}
    if d != "fma":
        plan = k8.heads_plan(x.shape[0], x.shape[1], k8.sm_count(0))
        out.update(heads_per_block=plan.heads_per_block, blocks=plan.blocks,
                   blocks_per_sm=plan.blocks_per_sm,
                   bound_ms_tensor_core=max(t_bytes, t_ops_f32 * F32_FLOPS_PER_S
                                            / BF16_FLOPS_PER_S))
    return out


def _rwkv6_design(torch, calls, t_bytes: float, t_ops_f32: float) -> dict:
    """K7's design and column plan at the first of ``calls`` (columns a
    block, slices a (b, h), blocks launched), and its bound both at the rate
    of the unit the design uses (bf16 tensor cores, 989 TFLOP/s, for the
    tensor-core kernel) and at the float32 rate."""
    from repro_torch.kernels.rwkv6_scan import kernel as k7

    (r, *_), kw = calls[0]
    d = k7.design(r.dtype)
    out = {"design": d, "bound_ms_f32_rate": max(t_bytes, t_ops_f32)}
    if d != "fma":
        B, H, T, N = r.shape
        plan = k7.cols_plan(B, H, N, k7.chunk_of(T, kw.get("chunk", 32)), k7.sm_count(0))
        out.update(cols_per_block=plan.cols_per_block, column_slices=plan.slices,
                   blocks=plan.blocks, blocks_per_sm=plan.blocks_per_sm,
                   bound_ms_tensor_core=max(t_bytes, t_ops_f32 * F32_FLOPS_PER_S
                                            / BF16_FLOPS_PER_S))
    return out


def _rwkv6_plans_ms(torch, kernel, calls) -> dict:
    """K7's time over ``calls`` (CUDA events) with each column width forced
    in turn, the reading behind ``cols_plan``'s cost model: the plan's own
    choice should be the fastest."""
    from repro_torch.kernels.rwkv6_scan import kernel as k7

    real, out = k7.cols_plan, {}
    try:
        for nc in k7.COLS_PER_BLOCK:
            def forced(B, H, N, C, sms, nc=nc):
                slices = -(-N // nc)
                return real(B, H, N, C, sms)._replace(
                    cols_per_block=nc, slices=slices, blocks=B * H * slices,
                    smem_bytes=k7.shared_bytes(C, nc))
            k7.cols_plan = forced
            out[str(nc)] = _event_ms(torch, lambda: [kernel(*a, **kw) for a, kw in calls],
                                     reps=1)
    finally:
        k7.cols_plan = real
    return out


def _scan_shape(calls) -> str:
    x, kw = calls[0][0][0], calls[0][1]
    return (f"{len(calls)} calls (one per layer), {list(x.shape)} {x.dtype}, "
            f"chunk {kw.get('chunk')}")


def _scan_timing(torch, name: str, kernel, plain, calls, err: float) -> dict:
    """K7 or K8 over ``calls`` (CUDA events, every call): the first and last
    call held against the plain version, the plain version's time over the
    same calls, the bound, the design's own fields and ``device_ms``; K7's
    tensor-core design adds ``cols_plan_ms``."""
    nbytes = ops = 0
    for args, kw in calls:
        x = args[0]
        B, H, T, P = x.shape
        N = args[3].shape[-1] if name == "mamba2_scan" else P
        b, o = _scan_work(name, B, H, T, N, P, x.element_size())
        nbytes, ops = nbytes + b, ops + o
    for args, kw in (calls[0], calls[-1]):
        dt = "bfloat16" if args[0].dtype == torch.bfloat16 else "float32"
        err = max(err, _scan_compare(torch, f"{name} (main-path call)", name,
                                     kernel(*args, **kw), plain(*args), dt,
                                     shape=list(args[0].shape)))
    ms = _event_ms(torch, lambda: [kernel(*a, **kw) for a, kw in calls], reps=1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3
    design = _mamba2_design if name == "mamba2_scan" else _rwkv6_design
    extra = design(torch, calls, t_bytes, t_ops)
    extra.update(_device_ms(torch, lambda: [kernel(*a, **kw) for a, kw in calls],
                            _expect_scan(torch, name, calls), [lambda a=a, kw=kw: kernel(*a, **kw)
                                                 for a, kw in calls]))
    if extra["design"] != "fma":         # the products run at the bf16 tensor-core rate
        t_ops = ops / BF16_FLOPS_PER_S * 1e3
    if name == "rwkv6_scan" and extra["design"] != "fma":
        extra["cols_plan_ms"] = _rwkv6_plans_ms(torch, kernel, calls)
    plain_ms = _once_ms(torch, lambda: [plain(*a) for a, kw in calls])
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "kernel_launches_timed": len(calls), "bytes": nbytes, "operations": ops,
            "ms_per_call": ms / len(calls), "gflops_per_s": ops / ms / 1e6, **extra}


def time_scans(torch, serve: dict, errs: dict) -> list:
    """Phase 14: K7 and K8 at the long prefill's calls (CUDA events, every
    call), their plain versions on the same calls, the bound; then, as
    ``timing_site`` lines, K7 at rwkv6's one-prompt prefill and K5 and K6 at
    zamba2's prefill and decode calls.  No single
    PyTorch call computes a scan, so the scans have no library time."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.mamba2_scan.kernel import mamba2_scan_cuda
    from repro_torch.kernels.mamba2_scan.ref import mamba2_scan_ref
    from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_cuda
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    rows = []
    specs = (("rwkv6_scan", "rwkv6-1.6b", rwkv6_scan_cuda, rwkv6_scan_ref,
              "src/repro/kernels/rwkv6_scan/kernel.py:112"),
             ("mamba2_scan", "zamba2-7b", mamba2_scan_cuda, mamba2_scan_ref,
              "src/repro/kernels/mamba2_scan/kernel.py:99"))
    for name, arch, kernel, plain, replaces in specs:
        calls = serve[arch]["calls"][name]
        m = _scan_timing(torch, name, kernel, plain, calls, errs[name])
        cfg = serve[arch]["cfg"]
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
               "replaces": replaces, "launches": serve[arch]["launches"][name],
               "max_abs_err": m.pop("max_abs_err"), "ms": m.pop("ms"),
               "plain_ms": m.pop("plain_ms"), "bound_ms": m.pop("bound_ms"),
               "bound_by": m.pop("bound_by"), "library_ms": None,
               "shape": f"{arch} prefill: {SSM_BATCH} prompts of {SSM_PREFILL_TOKENS} tokens, "
                        f"{_scan_shape(calls)}",
               "plain_shape": "the same calls in full", "layers": cfg.num_layers, **m}
        emit("timing", **row)
        rows.append(row)
        del calls
    # K7 at the one-prompt prefill, the plan's other side (16 columns a block).
    calls = serve["rwkv6-1.6b"]["calls_one_prompt"]
    emit("timing_site", site="K7 rwkv6 one-prompt prefill", kernel="rwkv6_scan",
         function="rwkv6_scan_pallas", replaces="src/repro/kernels/rwkv6_scan/kernel.py:112",
         shape=f"rwkv6-1.6b prefill: 1 prompt of {SSM_PREFILL_TOKENS} tokens, "
               f"{_scan_shape(calls)}", launches=len(calls), library_ms=None,
         **_scan_timing(torch, "rwkv6_scan", rwkv6_scan_cuda, rwkv6_scan_ref, calls,
                        errs["rwkv6_scan"]))
    del calls

    # K5 and K6 at zamba2's shared-attention calls.
    calls = serve["zamba2-7b"]["calls"]
    k5 = calls["flash_attention"]
    nbytes = flops = 0
    for (q, k, v), _ in k5:
        b, f = _flash_bytes_flops(q.shape[1], k.shape[1], q.shape[2], q.shape[3])
        nbytes, flops = nbytes + q.shape[0] * b, flops + q.shape[0] * f
    q, k, v = k5[0][0]
    err = _compare_tol(torch, "flash_attention (zamba2 prefill call)", "flash_attention",
                       [flash_attention_cuda(q, k, v, **k5[0][1]).float()],
                       [flash_attention_ref(q, k, v, **k5[0][1]).float()],
                       ATTN_TOL["bfloat16"], shape=list(q.shape))
    ms = _event_ms(torch, lambda: [flash_attention_cuda(*a, **kw) for a, kw in k5], reps=1)
    plain_ms = _once_ms(torch, lambda: [flash_attention_ref(*a, **kw) for a, kw in k5])
    lib_ms = _event_ms(torch, lambda: [F.scaled_dot_product_attention(
        *a, is_causal=True, enable_gqa=True) for a, _ in k5], reps=1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    emit("timing_site", site="K5 zamba2 prefill", kernel="flash_attention",
         function="flash_attention_pallas",
         replaces="src/repro/kernels/flash_attention/kernel.py:133",
         shape=f"zamba2-7b prefill: {len(k5)} calls {list(q.shape)} bf16, causal, group 1",
         launches=len(k5), max_abs_err=err, ms=ms, plain_ms=plain_ms,
         bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
         library_ms=lib_ms, bytes=nbytes, operations=flops, tflops=flops / ms / 1e9,
         **_k5_design(torch, q.shape[3]))
    k6 = calls["paged_attention"]
    nbytes = flops = 0
    for (q, kp, vp, table, ctx), _ in k6:
        B, Hq, D = q.shape
        Hkv, tokens = kp.shape[2], int(ctx.sum())
        nbytes += (2 * tokens * Hkv * D * 4 + B * Hq * D * q.element_size() + table.numel() * 4
                   + B * 4 + B * Hq * (D + 2) * 4)
        flops += 4 * tokens * Hq * D
    err = 0.0
    for a, kw in (k6[len(k6) // 2], k6[-1]):
        err = max(err, _paged_main_path_check(torch, "paged_attention_partial (zamba2 decode call)",
                                              a, kw, ctx=a[4].tolist()))
    ms = _event_ms(torch, lambda: [paged_attention_cuda(*a, **kw) for a, kw in k6], reps=1)
    dev_ms = _device_ms(torch, lambda: [paged_attention_cuda(*a, **kw) for a, kw in k6],
                        _expect_k6([a for a, _ in k6]), [lambda a=a, kw=kw: paged_attention_cuda(*a, **kw)
                                     for a, kw in k6])
    plain_ms = _once_ms(torch, lambda: [paged_attention_ref(*a, return_residuals=True, **kw)
                                        for a, kw in k6])
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    emit("timing_site", site="K6 zamba2 decode", kernel="paged_attention",
         function="paged_attention_pallas",
         replaces="src/repro/kernels/paged_attention/kernel.py:146",
         shape=f"zamba2-7b decode: {len(k6)} calls (27 per step), batch {SSM_BATCH}, "
               f"{SSM_PAGE}-token f32 pages, head_dim 112, group 1, bf16 queries",
         launches=len(k6), max_abs_err=err, ms=ms, plain_ms=plain_ms,
         bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
         library_ms=None, bytes=nbytes, operations=flops, **dev_ms,
         split_plans=_split_plans(torch, [a for a, _ in k6]))
    return rows


def run_ssm(torch) -> list:
    """Phases 11-14 (12b and 12c included); returns the K7 and K8 rows of the kernels
    line."""
    t0 = time.perf_counter()
    errs = check_scans_against_plain(torch)
    run_ssm_exact(torch)
    run_ssm_full_depth(torch)
    run_ssm_bf16(torch)
    serve = {}
    for arch in SSM_ARCHS:
        serve[arch] = run_ssm_serve(torch, arch)
        torch.cuda.empty_cache()
    rows = time_scans(torch, serve, errs)
    del serve
    torch.cuda.empty_cache()
    emit("ssm_phases", seconds=time.perf_counter() - t0)
    return rows

if __name__ == "__main__":
    sys.exit(main())
