"""Fault-injection smoke of the port's shard scheduler: SIGKILL one worker
process mid-shard and fail unless the run survives it bit-identically.

The port-side counterpart of the JAX package's ``benchmarks/smoke_sched.py``.
Three phases over two ``python -m repro_torch.bench.fig11 --quick`` children
with a small ``--chunk-accesses``, the first two run at the same time:

1. **Serial reference** — Fig 11 unsharded, start to finish; its per-spec
   digests (sha256 of each spec's latency / overhead / done) are the ground
   truth.
2. **Sharded run + kill** — Fig 11 with ``--workers 2 --shards 2 --executor
   process``.  ``REPRO_SCHED_HOLD_S`` holds each shard's first attempt open
   after its lease lands, giving this parent a window to read a worker pid
   out of a lease file and SIGKILL it — a real worker death, not a
   simulated exception.  The run must still exit 0 or 1 (claims), *not* 79
   (nothing quarantined: the dead worker's shard is re-dispatched, it is
   not poisoned).
3. **Verification** — the sharded run's digests must equal the reference's,
   nothing may be quarantined, and the run logs (the figure's and each
   worker's) must record the recovery: ``worker_dead``, ``lease_expire``
   and ``redispatch``.

Each child writes its ``--out`` into a directory of its own under the
smoke's work directory, so its checkpoints, leases and run logs live there
(``<dir>/ckpt/fig11/``, ``<dir>/runlogs/``) and no other Fig 11 run's are
touched.

    python -m repro_torch.bench.smoke_sched [--device cpu] [--cap N] [--chunk-accesses N]

Exit 0 on success, 1 on any miss (a kill that never lands is a miss), with
a summary on stderr.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

from repro_torch.bench import obs_report

KILL_DEADLINE_S = 600
RECOVERY_EVENTS = ("worker_dead", "lease_expire", "redispatch")


def _kill_one_worker(parent: subprocess.Popen, ckpt: pathlib.Path):
    """Wait for the first shard lease under ``ckpt``, then SIGKILL the
    worker that holds it.  Returns the killed pid (None if the run finished
    first)."""
    deadline = time.monotonic() + KILL_DEADLINE_S
    while time.monotonic() < deadline:
        if parent.poll() is not None:
            return None
        for lp in sorted(ckpt.glob("*.lease")) if ckpt.exists() else []:
            try:
                lease = json.loads(lp.read_text())
            except (OSError, json.JSONDecodeError):
                continue
            pid = lease.get("pid")
            # Never kill the figure's own process: only its spawned workers
            # hold leases with a pid different from the figure's.
            if pid and pid != parent.pid:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    continue
                return pid
        time.sleep(0.05)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--cap", type=int, default=None,
                    help="accesses of each workload's stream (default: --quick's 24,000)")
    ap.add_argument("--chunk-accesses", type=int, default=4_096)
    ap.add_argument("--workdir", default=None,
                    help="directory for the two runs' results (default: a temporary one)")
    args = ap.parse_args(argv)

    work = pathlib.Path(args.workdir or tempfile.mkdtemp(prefix="smoke_sched-"))
    work.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.bench.fig11", "--quick", "--device", args.device,
           "--chunk-accesses", str(args.chunk_accesses)]
    if args.cap:
        cmd += ["--cap", str(args.cap)]
    env = dict(os.environ)
    ref_dir, shard_dir = work / "reference", work / "sharded"
    for d in (ref_dir, shard_dir):
        shutil.rmtree(d, ignore_errors=True)
    t_start = time.perf_counter()
    ref = child = None
    try:
        print("[smoke_sched] phase 1: serial reference run", flush=True)
        ref = subprocess.Popen(cmd + ["--out", str(ref_dir / "fig11.json")], env=env,
                               start_new_session=True)
        ref_end = {}
        waiter = threading.Thread(
            target=lambda: ref_end.update(rc=ref.wait(), s=time.perf_counter() - t_start),
            daemon=True)
        waiter.start()

        print("[smoke_sched] phase 2: --workers 2 (process executor), "
              "SIGKILL one worker mid-shard", flush=True)
        env_kill = dict(env)
        # Hold each shard's first attempt open so the kill lands mid-shard,
        # and shrink the lease TTL so recovery fits a smoke-test budget.
        env_kill["REPRO_SCHED_HOLD_S"] = "2.0"
        env_kill["REPRO_SCHED_LEASE_TTL_S"] = "1.5"
        env_kill["REPRO_SCHED_HEARTBEAT_S"] = "0.3"
        child = subprocess.Popen(
            cmd + ["--workers", "2", "--shards", "2", "--executor", "process",
                   "--out", str(shard_dir / "fig11.json")], env=env_kill,
            start_new_session=True)
        pid = _kill_one_worker(child, shard_dir / "ckpt" / "fig11")
        rc = child.wait(timeout=KILL_DEADLINE_S)
        sharded_s = time.perf_counter() - t_start
        waiter.join(timeout=KILL_DEADLINE_S)
        ref_rc, reference_s = ref_end.get("rc"), ref_end.get("s")
        if ref_rc not in (0, 1):   # 1 = a claim out of band, still a figure
            print(f"[smoke_sched] reference run failed (exit {ref_rc})", file=sys.stderr)
            return 1
        reference = json.loads((ref_dir / "fig11.json").read_text())
        if pid is None:
            print("[smoke_sched] FAIL: run finished before a worker lease "
                  "appeared — nothing was killed", file=sys.stderr)
            return 1
        print(f"[smoke_sched] killed worker pid {pid}; run exited {rc}", flush=True)
        if rc not in (0, 1):
            print(f"[smoke_sched] sharded run exited {rc} "
                  f"(79 would mean quarantined shards)", file=sys.stderr)
            return 1

        print("[smoke_sched] phase 3: verify recovery + bit-identity", flush=True)
        sharded = json.loads((shard_dir / "fig11.json").read_text())
        if sharded["crash_safety"]["quarantined_shards"]:
            print("[smoke_sched] FAIL: shards were quarantined — a killed worker "
                  "must be survived by re-dispatch, not quarantine", file=sys.stderr)
            return 1
        runlogs = shard_dir / "runlogs"
        logs = [runlogs / "fig11.jsonl"] + sorted(runlogs.glob("fig11-w*.jsonl"))
        merged = obs_report.merge_logs([obs_report.load_log(p) for p in logs if p.exists()])
        counts = obs_report.event_counts(merged)
        missing = [e for e in RECOVERY_EVENTS if not counts.get(e)]
        if missing:
            print(f"[smoke_sched] FAIL: merged run logs ({len(logs)} files) missing "
                  f"recovery events: {missing}; saw {counts}", file=sys.stderr)
            return 1
        print("[smoke_sched] recovery recorded: "
              + ", ".join(f"{e} x{counts[e]}" for e in RECOVERY_EVENTS), flush=True)
        if sharded["digests"] != reference["digests"]:
            bad = [i for i, (a, b) in enumerate(zip(sharded["digests"], reference["digests"]))
                   if a != b]
            print(f"[smoke_sched] FAIL: sharded specs {bad} differ from the serial "
                  f"reference", file=sys.stderr)
            return 1
        print(json.dumps({"smoke_sched": "pass", "specs": len(reference["digests"]),
                          "killed_pid": pid, "exit": rc, "worker_logs": len(logs) - 1,
                          "events": {e: counts[e] for e in RECOVERY_EVENTS},
                          "reference_s": reference_s, "sharded_s": sharded_s,
                          "seconds": time.perf_counter() - t_start}), flush=True)
        print("[smoke_sched] PASS: killed a worker mid-shard; the digests are "
              "bit-identical to the serial run", flush=True)
        return 0
    finally:
        # Each child leads a process group of its own: whatever of it is
        # still running (its fork server, its workers) goes with it.
        for proc in (ref, child):
            if proc is not None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        if args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
