"""Fault-injection smoke of the port's orchestrator: SIGTERM a Fig 11
timeline sweep mid-run, resume it, and fail if the resumed result differs
from an uninterrupted run.

The port-side counterpart of the JAX package's ``benchmarks/smoke_resume.py``.
Fig 11's specs (the first workload's interleaved stream, the conventional
and SPARTA-32 designs at each accelerator count) run through
:func:`repro_torch.core.orchestrator.run_sweep_timeline` in a child
process, with a small ``--chunk-accesses`` so the trace crosses many
checkpoint boundaries.  Three phases:

1. **Reference run**: start to finish; its digests (sha256 of each spec's
   latency / overhead / done bytes) are the ground truth.
2. **Interrupted run**: a fresh run is SIGTERMed as soon as its first chunk
   checkpoint is durably on disk; it must exit with code 75 (the
   orchestrator's ``Preempted``) and leave its checkpoint behind.
3. **Resumed run**: ``--resume`` re-enters at the last committed chunk and
   must give the reference's digests.

    python -m repro_torch.bench.smoke_resume [--device cpu] [--cap N] [--chunk-accesses N]

Exit 0 on success, 1 on any mismatch or unexpected exit code.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time

EX_TEMPFAIL = 75        # sysexits.h: temporary failure, rerun with --resume
NAME = "fig11_smoke"


def child(args) -> int:
    """One sweep: Fig 11's specs over the first workload, through the
    orchestrator, checkpointing into ``args.ckpt``; writes the digests to
    ``args.out``.  Exits 75 when preempted."""
    from repro_torch.bench import fig11
    from repro_torch.bench.common import W4, timeline_digests
    from repro_torch.core import timeline
    from repro_torch.core.orchestrator import Preempted, SweepRunConfig, run_sweep_timeline
    from repro_torch.core.sparta import SystemLatencies
    from repro_torch.core.sweep import sweep_system

    accels = (1, 4)
    inter = fig11.interleaved(W4[0], accels[-1], args.n_ops, args.cap)
    evs = sweep_system(inter, fig11.system_configs(), device=args.device)
    specs = []
    for A in accels:
        ids = timeline.round_robin_accel_ids(inter.shape[0], A)
        specs.append(timeline.TimelineSpec(inter, evs[0], "conventional", cfg=fig11.QUEUES,
                                           num_accelerators=A, accel_ids=ids))
        specs.append(timeline.TimelineSpec(inter, evs[1], "sparta", cfg=fig11.QUEUES,
                                           num_partitions=fig11.PARTITIONS,
                                           num_accelerators=A, accel_ids=ids))
    cfg = SweepRunConfig(checkpoint_dir=args.ckpt, resume=args.resume,
                         chunk_accesses=args.chunk_accesses)
    try:
        results, meta = run_sweep_timeline(specs, SystemLatencies(n_sockets=8), run=cfg,
                                           name=NAME, device=args.device)
    except Preempted as p:
        print(f"[smoke_resume] preempted: {p}", flush=True)
        return EX_TEMPFAIL
    pathlib.Path(args.out).write_text(json.dumps(
        {"digests": timeline_digests(results), "resumed_from": meta["resumed_from"],
         "events": [e["event"] for e in meta["events"]]}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n-ops", type=int, default=1_000)
    ap.add_argument("--cap", type=int, default=24_000, help="accesses of the stream")
    ap.add_argument("--chunk-accesses", type=int, default=2_048)
    ap.add_argument("--workdir", default=None,
                    help="directory for the checkpoints and results (default: a temporary one)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--resume", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args)

    work = pathlib.Path(args.workdir or tempfile.mkdtemp(prefix="smoke_resume-"))
    ckpt, out = work / "ckpt", work / "result.json"
    base = [sys.executable, "-m", "repro_torch.bench.smoke_resume", "--child",
            "--device", args.device, "--n-ops", str(args.n_ops), "--cap", str(args.cap),
            "--chunk-accesses", str(args.chunk_accesses), "--ckpt", str(ckpt),
            "--out", str(out)]
    try:
        print("[smoke_resume] phase 1: uninterrupted reference run", flush=True)
        shutil.rmtree(ckpt, ignore_errors=True)
        if subprocess.run(base).returncode != 0:
            print("[smoke_resume] reference run failed", file=sys.stderr)
            return 1
        reference = json.loads(out.read_text())
        out.unlink()

        print("[smoke_resume] phase 2: fresh run, SIGTERM at the first chunk checkpoint",
              flush=True)
        shutil.rmtree(ckpt, ignore_errors=True)
        proc = subprocess.Popen(base)
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline and proc.poll() is None:
            if ckpt.exists() and any(ckpt.glob("*.ckpt")):
                proc.send_signal(signal.SIGTERM)
                break
            time.sleep(0.02)
        rc = proc.wait(timeout=600)
        if rc != EX_TEMPFAIL:
            print(f"[smoke_resume] interrupted run exited {rc}, expected {EX_TEMPFAIL}",
                  file=sys.stderr)
            return 1
        if not (ckpt / f"{NAME}.ckpt").exists():
            print("[smoke_resume] the interrupted run left no checkpoint", file=sys.stderr)
            return 1
        print(f"[smoke_resume] interrupted cleanly (exit {EX_TEMPFAIL}), checkpoint on disk",
              flush=True)

        print("[smoke_resume] phase 3: rerun with --resume", flush=True)
        if subprocess.run(base + ["--resume"]).returncode != 0:
            print("[smoke_resume] resumed run failed", file=sys.stderr)
            return 1
        resumed = json.loads(out.read_text())
        if not resumed["resumed_from"]:
            print("[smoke_resume] the resumed run did not re-enter from the checkpoint",
                  file=sys.stderr)
            return 1
        if resumed["digests"] != reference["digests"]:
            bad = [i for i, (a, b) in enumerate(zip(resumed["digests"], reference["digests"]))
                   if a != b]
            print(f"[smoke_resume] FAIL: resumed specs {bad} differ from the reference",
                  file=sys.stderr)
            return 1
        print(f"[smoke_resume] PASS: resumed from access {resumed['resumed_from']}, "
              f"identical to the uninterrupted run", flush=True)
        return 0
    finally:
        if args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
