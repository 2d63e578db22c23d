"""Shared plumbing of the port's figure drivers: trace cache, CSV output,
claim checks, the device clock, and the crash-safety plumbing of the mains
(checkpoint and schedule configs, the ``crash_safety`` stamp).

Checkpoints, calibration tables, run logs and figure outputs of the mains
live under :data:`CACHE` (``build/repro_torch/cache/``), never beside the
JAX package's.  Importing this module loads no torch, so a smoke's parent
process that only starts and watches figure runs starts in a fraction of a
second."""
from __future__ import annotations

import functools
import hashlib
import os
import pathlib
import time
from typing import Dict, List, Optional

from repro_torch.core import traces
from repro_torch.kernels._build import BUILD_DIR
from repro_torch.runtime import telemetry

CACHE = BUILD_DIR / "cache"
FIGS = CACHE / "figs"
GIB = 1 << 30

# Paper's four index workloads (Table 2).
W4 = ("bst_external", "bst_internal", "hash_table", "skip_list")


@functools.lru_cache(maxsize=16)
def trace(workload: str, *, n_ops: int = 40_000, seed: int = 0,
          footprint_bytes: int = 128 * GIB, max_accesses: int = 1_400_000):
    """One workload's trace, generated once per process for these arguments
    (the figure drivers' 128 GiB footprint and 1.4 M-access cap)."""
    return traces.generate(workload, n_ops=n_ops, seed=seed,
                           footprint_bytes=footprint_bytes,
                           max_accesses=max_accesses)


def synced_clock(device) -> float:
    """``time.perf_counter()`` after the card (if ``device`` is one) has
    finished all queued work."""
    import torch

    from repro_torch.kernels.common import as_device

    if as_device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


class Claim:
    """A checked reproduction claim (paper §7), printed and returned."""

    def __init__(self, name: str, desc: str, value: float, band: tuple, unit: str = ""):
        self.name, self.desc, self.value, self.band, self.unit = name, desc, value, band, unit
        self.ok = band[0] <= value <= band[1]

    def row(self) -> dict:
        return {
            "claim": self.name, "description": self.desc,
            "value": self.value, "band": list(self.band),
            "unit": self.unit, "ok": self.ok,
        }

    def __str__(self):
        mark = "PASS" if self.ok else "MISS"
        return (f"[{mark}] {self.name}: {self.value:.3g}{self.unit} "
                f"(band {self.band[0]:.3g}..{self.band[1]:.3g}) — {self.desc}")


def timeline_digests(results) -> List[Dict[str, str]]:
    """Per timeline result, the sha256 of its latency / overhead / done
    float32 bytes: what the smokes compare between two runs."""
    import numpy as np

    return [{k: hashlib.sha256(np.ascontiguousarray(getattr(r, k), np.float32)
                               .tobytes()).hexdigest()
             for k in ("latency", "overhead", "done")} for r in results]


def print_csv(title: str, header: List[str], rows: List[list]):
    print(f"\n# {title}")
    print(",".join(header))
    for r in rows:
        print(",".join(f"{x:.4g}" if isinstance(x, float) else str(x) for x in r))


def run_config(fig: str, *, resume: bool = False, chunk_accesses=None,
               root: pathlib.Path = CACHE):
    """The :class:`repro_torch.core.orchestrator.SweepRunConfig` of one
    figure main: checkpoints under ``root/ckpt/<fig>/`` (one blob per
    engine call or shard), ``resume`` re-enters them, ``chunk_accesses``
    overrides the commit granularity (the fault-injection smokes shrink it
    so a quick run still crosses several chunk boundaries), and
    ``calibration_dir`` points ``kernel_mode="auto"`` at the measured-rate
    tables under ``root/calibration/``.  ``root`` is :data:`CACHE` unless a
    main was given a directory of its own.  Library callers that pass no
    config get a ``SweepRunConfig()`` with no checkpoint directory."""
    from repro_torch.core.orchestrator import SweepRunConfig

    kw = {"checkpoint_dir": str(root / "ckpt" / fig), "resume": bool(resume),
          "calibration_dir": str(root / "calibration")}
    if chunk_accesses:
        kw["chunk_accesses"] = int(chunk_accesses)
    return SweepRunConfig(**kw)


def sched_config(*, workers: int = 1, shards: int = 0,
                 deadline: Optional[float] = None, executor: str = "auto",
                 root: pathlib.Path = CACHE):
    """The figure mains' :class:`repro_torch.core.scheduler.ScheduleConfig`,
    or ``None`` (pure unsharded passthrough) when nothing asks for
    scheduling.  Worker run logs land next to the figure's own
    (``root/runlogs/``); ``REPRO_SCHED_HOLD_S`` holds each shard's first
    attempt open long enough to SIGKILL a worker mid-shard, and
    ``REPRO_SCHED_LEASE_TTL_S`` / ``REPRO_SCHED_HEARTBEAT_S`` shrink the
    lease timing for the smoke.

    Process workers come from a fork server that imports torch once per
    figure (``mp_context="forkserver"``): a figure makes one scheduled call
    per sweep, and a spawned worker spends ~9 s importing torch on the H100's
    host before it reaches the card (PERF.md, the scheduler's findings)."""
    from repro_torch.core.scheduler import ScheduleConfig

    sched = ScheduleConfig(
        workers=int(workers), shards=int(shards), deadline_s=deadline,
        executor=executor, mp_context="forkserver",
        lease_ttl_s=float(os.environ.get("REPRO_SCHED_LEASE_TTL_S", 5.0)),
        heartbeat_s=float(os.environ.get("REPRO_SCHED_HEARTBEAT_S", 1.0)),
        hold_s=float(os.environ.get("REPRO_SCHED_HOLD_S", 0.0) or 0.0),
        runlog_dir=str(root / "runlogs"))
    return sched if sched.enabled else None


# Runs whose last figure completed degraded (quarantined shards): the
# figure mains exit with scheduler.EX_DEGRADED when this is non-empty.
_DEGRADED_RUNS: List[str] = []


def degraded_runs() -> List[str]:
    return list(_DEGRADED_RUNS)


def crash_safety(metas: Dict[str, dict]) -> dict:
    """The record of how each orchestrated engine call executed: its mode,
    every retry/halve event, where a resumed run re-entered, and, for
    scheduled (sharded) calls, the shard map and the quarantined-shard
    manifest.  A run with quarantined shards is registered in
    :func:`degraded_runs` under the active telemetry run's name."""
    out = {}
    quarantined = {}
    for name, m in metas.items():
        rec = {
            "start_mode": m["start_mode"], "final_mode": m["final_mode"],
            "resumable": m["resumable"], "resumed_from": m["resumed_from"],
            "completed_from_checkpoint": m["completed_from_checkpoint"],
            "events": m["events"],
        }
        s = m.get("scheduler")
        if s:
            rec["scheduler"] = {
                "shards": s["shards"], "workers": s["workers"],
                "executor": s["executor"], "shard_map": s["shard_map"],
                "events": [e["event"] for e in s["events"]],
            }
            if s.get("quarantined_shards"):
                quarantined[name] = s["quarantined_shards"]
        out[name] = rec
    out["quarantined_shards"] = quarantined
    if quarantined:
        run = telemetry.get_tracer().run or "?"
        if run not in _DEGRADED_RUNS:
            _DEGRADED_RUNS.append(run)
    return out
