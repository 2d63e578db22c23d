"""The port's benchmark entry point: every paper figure, the kernel benches and
the roofline table (the port of ``benchmarks/run.py``).

``python -m repro_torch.bench.run [--quick] [--only fig7,...] [--device cuda|cpu]``
runs Figs 2 and 4-11 through the ported figure modules and ``kernels``
(:mod:`repro_torch.bench.kernel_bench`, on the card only: the CPU's default
list leaves it out), prints each figure's CSV and ``[PASS]/[MISS]`` claim
lines, the claim summary and, where dry-run records exist
(``--dryrun-dir``), the roofline table (:mod:`repro_torch.bench.roofline`).
CSVs and claim lines go to stdout, narration to stderr through the
``repro_torch`` logger (``-v`` DEBUG, ``--quiet`` WARNING).

The trace-sweep figures (5, 8, 9, 10, 11) run through the crash-safe
orchestrator and, with ``--workers`` > 1, the shard scheduler, with their
checkpoints, calibration tables and run logs under ``--cache-dir``
(``build/repro_torch/cache/`` by default; each figure's run log is
``runlogs/<fig>.jsonl``).  ``--kernel-mode`` is the sweep engines' backend
(``auto``, ``reference``, ``cuda``, ``stackdist``); ``auto`` resolves
through the calibrated dispatch layer (:mod:`repro_torch.core.dispatch`),
which the kernel benches and every orchestrated chunk feed;
``--explain-dispatch`` prints its decision tables for the engines' quick
shapes without running a sweep, first seeding an empty table from the
kernel-bench history (``--history``) and the run logs.  ``--gc`` deletes
expired checkpoint blobs and stale calibration tables under the cache
directory and exits.  ``--profile DIR`` writes a ``torch.profiler`` trace
of the run, one ``record_function`` a figure.

Exit codes: 0; 1 when more than one claim is out of band (claim C2b reads
0/4 in both packages and is the one the rule allows); 75 (``EX_TEMPFAIL``)
when a sweep was preempted (rerun with ``--resume``); 79 (``EX_DEGRADED``)
when a scheduled sweep quarantined a shard.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import logging
import pathlib
import sys
import time

from repro_torch.bench import common
from repro_torch.bench.kernel_bench import _profiler, _section
from repro_torch.kernels.common import SWEEP_MODES
from repro_torch.runtime import telemetry

_LOG = logging.getLogger("repro_torch.bench.run")

FIGS = ("fig2", "fig4", "fig5", "fig6", "fig7", "fig8", "fig9", "fig10", "fig11", "kernels")


def _explain_dispatch(device, cache: pathlib.Path, history: pathlib.Path) -> None:
    """The dispatch decision tables for the three engines' quick shapes:
    candidates, calibrated rates, predicted seconds, the chosen mode and
    why.  An empty table is first seeded from what this checkout measured
    on this device (kernel-bench rows and run-log chunk spans)."""
    from repro_torch.bench import perfcheck
    from repro_torch.core import dispatch
    from repro_torch.core.sparta import TLBConfig
    from repro_torch.core.sweep import TLBSweepSpec
    from repro_torch.core.tlbsim import SystemSimConfig

    store = dispatch.store_for(cache / "calibration", device)
    if not store.exists():
        rows = (perfcheck.load_history(history).get("history", [])
                if history.exists() else [])
        n = dispatch.ingest_bench_entries(store, rows)
        runlogs = cache / "runlogs"
        n += dispatch.ingest_runlogs(store, sorted(runlogs.glob("*.jsonl"))
                                     if runlogs.exists() else [])
        _LOG.info("seeded %s from %d recorded rate(s)", store.path, n)
    print(f"# dispatch decisions ({store.describe()}, device={store.device_kind})")
    tlb_specs = [TLBSweepSpec(TLBConfig(entries=e, ways=4), num_partitions=p, page_shift=12)
                 for p in (1, 128) for e in (64, 128, 256, 512)]
    cache_cfg, mem = TLBConfig(entries=256, ways=4), TLBConfig(entries=128, ways=4)
    sys_cfgs = [SystemSimConfig(cache=cache_cfg, accel_tlb=None, mem_tlb=mem,
                                num_partitions=p, page_shift=12) for p in (1, 8, 32)]
    kw = dict(store=store, device=device)
    decisions = [
        ("fig4-style TLB sweep (8 specs x 120k accesses)",
         dispatch.decide_tlb("auto", tlb_specs, n_accesses=120_000, **kw)),
        ("fig9-style system sweep (3 configs x 10k accesses)",
         dispatch.decide_system("auto", sys_cfgs, n_accesses=10_000, **kw)),
        ("fig11-quick timeline matrix (batch=12 x 8k accesses)",
         dispatch.decide_timeline("auto", batch=12, n_accesses=8_000, **kw)),
        ("single timeline sim (batch=1 x 8k accesses)",
         dispatch.decide_timeline("auto", batch=1, n_accesses=8_000, **kw)),
    ]
    print("engine,candidate,rate_sim_acc_per_s,predicted_s,chosen")
    for label, d in decisions:
        print(f"# {label}")
        for m, c in d.candidates.items():
            rate, pred = c.get("rate"), c.get("predicted_s")
            print(f"{d.engine},{m},{rate if rate is not None else 'n/a'},"
                  f"{pred if pred is not None else 'n/a'},"
                  f"{'<-- chosen' if m == d.mode else ''}")
        print(f"#   -> {d.mode} [{d.calibration}]: {d.reason}")


def _gc(cache: pathlib.Path, age_s: float) -> None:
    from repro_torch.core.dispatch import gc_calibration
    from repro_torch.core.scheduler import gc_checkpoints

    summary = gc_checkpoints(cache / "ckpt", age_s=age_s)
    print(f"# gc {cache / 'ckpt'}")
    for k in ("deleted", "kept_in_progress", "kept_young", "skipped_foreign"):
        for p in summary[k]:
            print(f"{k},{p}")
    print(f"# {len(summary['deleted'])} deleted, {len(summary['kept_in_progress'])} "
          f"in-progress kept, {len(summary['kept_young'])} young kept, "
          f"{len(summary['skipped_foreign'])} foreign skipped")
    cal = gc_calibration(cache / "calibration", age_s=age_s)
    print(f"# gc {cache / 'calibration'}")
    for k in ("deleted", "kept_young", "skipped_foreign"):
        for p in cal[k]:
            print(f"{k},{p}")
    print(f"# {len(cal['deleted'])} calibration deleted, {len(cal['kept_young'])} young kept, "
          f"{len(cal['skipped_foreign'])} foreign skipped")


def _modules() -> dict:
    from repro_torch.bench import (fig2, fig4, fig5, fig6, fig7, fig8, fig9, fig10, fig11,
                                   kernel_bench)

    return {"fig2": fig2, "fig4": fig4, "fig5": fig5, "fig6": fig6, "fig7": fig7,
            "fig8": fig8, "fig9": fig9, "fig10": fig10, "fig11": fig11,
            "kernels": kernel_bench}


def _kwargs(name: str, fn, args, cache: pathlib.Path, sched) -> dict:
    """The figure's ``run`` arguments this invocation sets (each only where
    the figure takes it)."""
    params = inspect.signature(fn).parameters
    given = {"quick": args.quick, "device": args.device, "kernel_mode": args.kernel_mode,
             "run_cfg": common.run_config(name, resume=args.resume,
                                          chunk_accesses=args.chunk_accesses, root=cache),
             "sched": sched, "history": args.history,
             "calibration_dir": cache / "calibration", "profile": bool(args.profile)}
    return {k: v for k, v in given.items() if k in params and v is not None}


def _roofline(dryrun_dir: pathlib.Path) -> None:
    from repro_torch.bench import roofline

    rows = roofline.table("16x16", dryrun_dir)
    if not rows:
        _LOG.info("roofline table skipped: no ok 16x16 records under %s", dryrun_dir)
        return
    print(f"\n# Roofline (16x16, per-device seconds a step; H100: "
          f"{roofline.PEAK_FLOPS:.3g} FLOP/s, {roofline.HBM_BW:.3g} B/s HBM, "
          f"{roofline.LINK_BW:.3g} B/s NVLink)")
    roofline.print_table(rows)


def main(argv=None) -> int:
    from repro_torch.bench.kernel_bench import HISTORY_PATH
    from repro_torch.bench.roofline import CACHE as DRYRUN_DIR

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="small traces")
    ap.add_argument("--only", default=None, help="comma-separated figure list")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--kernel-mode", default="auto", choices=SWEEP_MODES,
                    help="sweep-engine backend of the trace-sweep figures")
    ap.add_argument("--resume", action="store_true",
                    help="re-enter interrupted sweeps from their last committed chunk")
    ap.add_argument("--chunk-accesses", type=int, default=None,
                    help="checkpoint-commit granularity (trace accesses a chunk)")
    ap.add_argument("--workers", type=int, default=1,
                    help="parallel sweep workers (sharded scheduler); 1 = unsharded")
    ap.add_argument("--shards", type=int, default=0,
                    help="shards per scheduled engine call (0 = auto, 2x workers)")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="per-shard straggler deadline in seconds")
    ap.add_argument("--executor", default="auto",
                    choices=("auto", "serial", "thread", "process"))
    ap.add_argument("--cache-dir", type=pathlib.Path, default=common.CACHE,
                    help="checkpoints, calibration tables and run logs")
    ap.add_argument("--history", type=pathlib.Path, default=HISTORY_PATH,
                    help="the kernel benches' history")
    ap.add_argument("--dryrun-dir", type=pathlib.Path, default=DRYRUN_DIR,
                    help="the dry run's records, for the roofline table")
    ap.add_argument("--gc", action="store_true",
                    help="delete expired checkpoint blobs and leases and stale calibration "
                         "tables under --cache-dir, then exit (fresh leases are kept)")
    ap.add_argument("--gc-age-s", type=float, default=7 * 86400.0, metavar="S",
                    help="age threshold for --gc (default: 7 days)")
    ap.add_argument("--explain-dispatch", action="store_true",
                    help="print the dispatch decision tables, then exit")
    ap.add_argument("-v", action="count", default=0, dest="verbose",
                    help="DEBUG narration on stderr (repeatable)")
    ap.add_argument("--quiet", action="store_true", help="narration at WARNING only")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run into DIR")
    args = ap.parse_args(argv)
    telemetry.setup_logging(-1 if args.quiet else args.verbose)
    cache = args.cache_dir

    if args.gc:
        _gc(cache, args.gc_age_s)
        return 0
    from repro_torch.kernels.common import as_device

    device = as_device(args.device)
    if args.explain_dispatch:
        _explain_dispatch(device, cache, args.history)
        return 0

    from repro_torch.core.orchestrator import Preempted
    from repro_torch.core.scheduler import EX_DEGRADED, fork_server

    modules = _modules()
    if args.only:
        chosen = args.only.split(",")
    else:
        chosen = [f for f in FIGS if f != "kernels" or device.type == "cuda"]
    unknown = [f for f in chosen if f not in modules]
    if unknown:
        ap.error(f"unknown figure(s) {unknown}; options: {', '.join(FIGS)}")
    sched = common.sched_config(workers=args.workers, shards=args.shards,
                                deadline=args.deadline, executor=args.executor, root=cache)
    forking = (sched is not None and sched.resolve_executor() == "process"
               and sched.mp_context == "forkserver")

    claims = []
    try:
        with fork_server() if forking else contextlib.nullcontext(), \
                _profiler(args.profile):
            for name in chosen:
                t0 = time.perf_counter()
                fn = modules[name].run
                with telemetry.run_scope(cache / "runlogs" / f"{name}.jsonl", run=name), \
                        _section(name, bool(args.profile)):
                    claims += fn(**_kwargs(name, fn, args, cache, sched))["claims"]
                _LOG.info("%s: %.1fs", name, time.perf_counter() - t0)
    except Preempted as exc:
        _LOG.warning("preempted: %s", exc)
        return 75   # EX_TEMPFAIL: rerun with --resume

    print("\n# Claim summary")
    n_ok = sum(c.ok for c in claims)
    for c in claims:
        print(str(c))
    print(f"\n{n_ok}/{len(claims)} claims in band")
    _roofline(args.dryrun_dir)
    if claims and n_ok < len(claims) - 1:
        return 1
    if common.degraded_runs():
        _LOG.error("degraded run(s) with quarantined shards: %s",
                   ", ".join(common.degraded_runs()))
        return EX_DEGRADED
    return 0


if __name__ == "__main__":
    sys.exit(main())
