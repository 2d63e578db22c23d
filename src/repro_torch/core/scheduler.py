"""Fault-tolerant shard scheduler: divide-and-conquer for the sweep axis.

The port of the JAX package's ``src/repro/core/scheduler.py``.  Any
:func:`run_sweep_tlb` / :func:`run_sweep_system` / :func:`run_sweep_timeline`
call is split into independent **shards** along the embarrassingly-parallel
config/sim axis, each shard executed as its own crash-safe orchestrator run
(:mod:`repro_torch.core.orchestrator`: per-chunk checkpoints, retry then
halve), and the partial results merged bit-identically to the unsharded
orchestrator (the engines are batch-mate invariant: a config's row does not
depend on which other configs share its batch).

Robustness machinery, in failure order:

* **Leases + heartbeats.**  A worker claims a shard by atomically writing a
  lease file (:func:`repro_torch.checkpoint.checkpoint.acquire_lease`) and
  heartbeats it on a background thread.  A SIGKILLed worker stops
  heartbeating; once the lease is stale (TTL exceeded) the parent declares
  it expired and re-dispatches the shard to a live worker, which *takes
  over* the dead worker's per-chunk checkpoint and resumes mid-shard.

* **Straggler re-dispatch.**  With ``ScheduleConfig.deadline_s`` set, a
  shard still running past its deadline is speculatively duplicated onto an
  idle worker (checkpoint-less, so the two attempts never contend on one
  blob).  First completion wins; when the loser eventually reports, its
  result is verified bit-identical (``duplicate_verified``) — a mismatch is
  a hard error, never a silent coin-flip.

* **Poison-shard quarantine.**  A shard whose *attempts keep failing* is
  quarantined after ``max_shard_attempts`` failures — the run **completes**
  with placeholder (all-zero) rows for the quarantined configs, a manifest
  in ``meta["scheduler"]["quarantined_shards"]`` (surfaced by
  :func:`repro_torch.bench.common.crash_safety`), and drivers exit with
  :data:`EX_DEGRADED` instead of dying.  A shard that keeps killing its
  workers hits the dispatch cap and is quarantined the same way.

Shard names (``{name}.s{i:02d}of{n:02d}``), lease and blob paths, event
names and the ``meta["scheduler"]`` layout are the reference's, so a shard
blob written by either package resumes in the other.  What differs, each
forced by the card:

* **One backend.**  The orchestrator has no downgrade ladder, so every
  shard runs the one concrete mode decided once over the whole sweep
  (``dispatch.decide_*`` on ``device``), and ``final_mode`` is that mode.
* **Nothing on the card crosses a process boundary.**  A worker's payload
  is host numpy (the trace, the specs, each timeline spec's events), the
  worker runs its shard on ``device`` (process workers each with their own
  CUDA context on the one card), its results come back as numpy, and the
  parent builds the result types on ``device``.
* **A dead context is not a poisoned config.**  An error after which no
  kernel runs in the process (:func:`repro_torch.runtime.fault_tolerance.
  is_fatal`: a failed build, a sticky CUDA error) aborts the scheduled run
  with that error; under the thread executor it would fail every shard.
  Any other exception counts toward the shard's quarantine, as in the
  reference.
* **Launch counts travel with the results.**  The kernels' ``launches``
  counters are module globals, which process workers never update in the
  parent; each attempt reports the launches its thread made
  (:func:`repro_torch.kernels.common.launch_tally`), summed in
  ``meta["scheduler"]["launches"]``.

Every lease/expiry/re-dispatch/quarantine event flows through the
:mod:`repro_torch.runtime.telemetry` run log (``kind="scheduler"`` attribute
on the event records, ``scheduler``/``shard`` spans) and is mirrored into
``meta["scheduler"]["events"]``.

Executors are pluggable: ``serial`` (inline, the default), ``thread``
(worker threads sharing the process's card), ``process``
(``multiprocessing`` spawn — survives SIGKILL of individual workers; each
worker writes its own ``runlogs/*.jsonl``).  With
``mp_context="forkserver"`` the process workers are forks of a server that
imported this module (and torch) once, so only a process's first executor
pays the import.  Results always travel back to the parent in-message;
per-chunk durability lives in the shard's own orchestrator checkpoint blob.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import pathlib
import pickle
import queue as queue_mod
import shutil
import socket
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (
    BLOB_MAGIC,
    LeaseHeld,
    acquire_lease,
    lease_is_stale,
    read_lease,
    refresh_lease,
    release_lease,
)
from repro_torch.core import dispatch
from repro_torch.core import orchestrator as orch
from repro_torch.core.orchestrator import (
    Preempted,
    SweepRunConfig,
    _host,
    _maybe_handler,
    merge_throughput,
)
from repro_torch.core.sweep import BatchedSystemEvents, BatchedTLBResult, TLBSweepSpec
from repro_torch.core.timeline import TimelineResult, TimelineSpec
from repro_torch.core.tlbsim import Device, SystemEvents, SystemSimConfig
from repro_torch.kernels.common import as_device, launch_tally
from repro_torch.runtime import telemetry
from repro_torch.runtime.fault_tolerance import PreemptionHandler, is_fatal

_LOG = logging.getLogger("repro_torch.core.scheduler")

__all__ = [
    "EX_DEGRADED",
    "ScheduleConfig",
    "SweepRunConfig",
    "Preempted",
    "run_sweep_tlb",
    "run_sweep_system",
    "run_sweep_timeline",
    "gc_checkpoints",
]

# Exit code for a run that *completed* but with quarantined shards (degraded
# data).  sysexits.h stops at 78; 75 (EX_TEMPFAIL) already means "preempted,
# rerun with --resume", so degraded gets the next free code.
EX_DEGRADED = 79

_EXECUTORS = ("auto", "serial", "thread", "process")


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """How a sweep call is sharded and scheduled.

    ``shards=0`` auto-sizes to ``2 * workers`` (over-decomposition keeps
    workers busy when shard runtimes are uneven).  ``executor="auto"``
    resolves to ``serial`` for one worker and ``thread`` otherwise.
    ``hold_s`` and ``on_shard_start`` are fault-injection seams: the hold
    sleeps each shard's *first* attempt after its lease is acquired (the
    smoke's window for SIGKILLing a worker mid-shard), and the hook fires
    with ``(shard, attempt, worker)`` before the engine runs (must be
    picklable for the process executor).
    """

    shards: int = 0
    workers: int = 1
    executor: str = "auto"
    lease_ttl_s: float = 5.0
    heartbeat_s: float = 1.0
    deadline_s: Optional[float] = None
    max_shard_attempts: int = 3
    poll_s: float = 0.05
    hold_s: float = 0.0
    on_shard_start: Optional[Callable] = None
    mp_context: str = "spawn"   # a forked child cannot use its parent's CUDA context
    runlog_dir: Optional[str] = None

    def __post_init__(self):
        if self.executor not in _EXECUTORS:
            raise ValueError(
                f"executor={self.executor!r} not in {_EXECUTORS}")

    @property
    def enabled(self) -> bool:
        """False = pure passthrough to the unsharded orchestrator."""
        return (self.workers > 1 or self.shards not in (0, 1)
                or self.executor in ("thread", "process"))

    def resolve_executor(self) -> str:
        if self.executor != "auto":
            return self.executor
        return "serial" if self.workers <= 1 else "thread"

    def resolve_shards(self, n_items: int) -> int:
        n = self.shards if self.shards > 0 else max(1, 2 * self.workers)
        return max(1, min(n, n_items))


# ---------------------------------------------------------------------------
# Worker side: claim lease -> heartbeat -> run one shard engine -> report.
# Module-level so the spawn-based process executor can pickle it by name.
# ---------------------------------------------------------------------------


class _Heartbeat:
    """Background lease refresher; a dead worker's silence is the failure
    detector.  Stops refreshing (without killing the work) if the lease was
    lost to another claimant — the parent's first-completion-wins merge
    dedups the results."""

    def __init__(self, path, owner: str, *, ttl_s: float, interval_s: float):
        self.path, self.owner = path, owner
        self.ttl_s, self.interval_s = ttl_s, interval_s
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True,
                                   name=f"lease-heartbeat-{pathlib.Path(path).stem}")

    def start(self) -> "_Heartbeat":
        self._t.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            if not refresh_lease(self.path, self.owner, ttl_s=self.ttl_s):
                return

    def stop(self) -> None:
        self._stop.set()
        self._t.join(timeout=5.0)


def _run_engine_shard(task: dict) -> Tuple[Dict[str, np.ndarray], dict, dict]:
    """Run one shard through the crash-safe orchestrator on the task's
    device.  Returns ``(arrays, extra, engine_meta)``, the arrays host numpy
    in the parent-mergeable layout.  ``resume=True`` whenever a checkpoint
    dir is set: that is how a re-dispatched shard takes over a dead worker's
    chunk checkpoint (and how a --resume rerun short-circuits completed
    shards)."""
    p = task["payload"]
    run_cfg = SweepRunConfig(
        checkpoint_dir=task.get("ckpt_dir"),
        resume=task.get("ckpt_dir") is not None,
        chunk_accesses=task["chunk_accesses"],
        max_retries=task["max_retries"],
        backoff_base_s=task["backoff_base_s"],
        backoff_cap_s=task["backoff_cap_s"],
        keep_checkpoint=True,
        # install=False: workers may be threads (signal.signal is
        # main-thread-only); the parent owns preemption and simply stops
        # dispatching.
        preemption=PreemptionHandler(install=False),
        fault_hook=task.get("fault_hook"),
        rng_seed=task.get("rng_seed"),
    )
    engine, device = task["engine"], task["device"]
    if engine == "sweep_tlb":
        res, meta = orch.run_sweep_tlb(
            p["addrs"], p["specs"], warmup_frac=p["warmup_frac"],
            kernel_mode=p["mode"], block=p["block"], run=run_cfg,
            name=task["name"], device=device)
        return {"hits": _host(res.hits)}, {}, meta
    if engine == "sweep_system":
        evs, meta = orch.run_sweep_system(
            p["lines"], p["cfgs"], warmup_frac=p["warmup_frac"],
            kernel_mode=p["mode"], block=p["block"], run=run_cfg,
            name=task["name"], device=device)
        return {"cache_hit": _host(evs.cache_hit),
                "accel_tlb_hit": _host(evs.accel_tlb_hit),
                "mem_tlb_hit": _host(evs.mem_tlb_hit)}, {}, meta
    if engine == "sweep_timeline":
        res_list, meta = orch.run_sweep_timeline(
            p["specs"], p["lat"], kernel_mode=p["mode"], block=p["block"],
            run=run_cfg, name=task["name"], device=device)
        lens = [int(r.latency.shape[0]) for r in res_list]
        n = max(lens) if lens else 0
        arrays = {nm: np.zeros((len(res_list), n), np.float32)
                  for nm in ("latency", "overhead", "done")}
        for i, r in enumerate(res_list):
            arrays["latency"][i, :lens[i]] = r.latency
            arrays["overhead"][i, :lens[i]] = r.overhead
            arrays["done"][i, :lens[i]] = r.done
        return arrays, {"lens": lens}, meta
    raise ValueError(f"unknown shard engine {engine!r}")


def _portable(exc: BaseException) -> BaseException:
    """``exc`` if it survives pickling (a process worker's message to its
    parent is pickled), else a RuntimeError with its type and text."""
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:
        return RuntimeError(f"{type(exc).__name__}: {exc}")


def _execute_shard(worker_id: int, task: dict, boot: Optional[dict] = None) -> dict:
    """One shard attempt, end to end: lease, heartbeat, injection seams,
    engine, release.  Always *returns* a message (never raises) for normal
    failures; only BaseExceptions (simulated kills) tear through.  A fatal
    error (:func:`is_fatal`) returns ``kind="fatal"`` with the exception.
    Every message carries the kernel launches this attempt's thread made.
    ``boot`` (a process worker's first task): the seconds its first touch of
    the device takes are added to it, and it rides on the message."""
    out = {"shard": task["idx"], "attempt": task["attempt"],
           "worker": worker_id, "name": task["name"]}
    tracer = telemetry.get_tracer()
    owner = f"{socket.gethostname()}:{os.getpid()}:w{worker_id}"
    lease_path = task.get("lease_path")
    hb = None
    t0 = time.perf_counter()
    with launch_tally() as launches:
        try:
            try:
                if boot is not None:
                    out["boot"] = boot
                    t_ctx = time.perf_counter()
                    dev = torch.device(task["device"])
                    torch.zeros((), device=dev)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    boot["context_s"] = round(time.perf_counter() - t_ctx, 6)
                if lease_path:
                    try:
                        acquire_lease(lease_path, owner, ttl_s=task["lease_ttl_s"],
                                      shard=task["idx"], attempt=task["attempt"],
                                      name=task["name"], pid=os.getpid())
                    except LeaseHeld as exc:
                        return {**out, "kind": "lease_held", "error": str(exc),
                                "launches": dict(launches)}
                    tracer.event("lease_acquire", kind="scheduler",
                                 engine=task["engine"], name=task["name"],
                                 shard=task["idx"], attempt=task["attempt"],
                                 owner=owner)
                    hb = _Heartbeat(lease_path, owner, ttl_s=task["lease_ttl_s"],
                                    interval_s=task["heartbeat_s"]).start()
                if task.get("hold_s"):
                    time.sleep(task["hold_s"])
                hook = task.get("on_shard_start")
                if hook is not None:
                    hook(task["idx"], task["attempt"], worker_id)
                with tracer.span("shard", engine=task["engine"], name=task["name"],
                                 shard=task["idx"], attempt=task["attempt"],
                                 worker=worker_id):
                    arrays, extra, engine_meta = _run_engine_shard(task)
                return {**out, "kind": "done", "arrays": arrays,
                        "engine_meta": engine_meta, "launches": dict(launches),
                        "elapsed_s": round(time.perf_counter() - t0, 6), **extra}
            except Exception as exc:
                msg = {**out, "kind": "failed",
                       "error": f"{type(exc).__name__}: {exc}",
                       "launches": dict(launches),
                       "elapsed_s": round(time.perf_counter() - t0, 6)}
                if is_fatal(exc):
                    msg.update(kind="fatal", exc=_portable(exc))
                return msg
        finally:
            if hb is not None:
                hb.stop()
            if lease_path:
                release_lease(lease_path, owner)


def _worker_loop(worker_id: int, inbox, outbox, init: dict) -> None:
    """Executor worker main: drain tasks until the ``None`` sentinel.  A
    process worker opens its own telemetry run log (the parent's file handle
    does not cross the process boundary) and reports its boot (pid, the
    seconds from its spawn to this loop, then its first device touch) on its
    first message; thread workers share the parent's tracer, which is
    thread-safe."""
    boot = None
    if "spawned_ts" in init:
        boot = {"worker": worker_id, "pid": os.getpid(),
                "spawn_s": round(time.time() - init["spawned_ts"], 6)}
    own_log = init.get("runlog_dir") is not None
    if own_log:
        run = init.get("run") or "scheduler"
        path = (pathlib.Path(init["runlog_dir"])
                / f"{run}-w{worker_id}-{os.getpid()}.jsonl")
        telemetry.start_run(path, run=f"{run}-w{worker_id}",
                            worker=worker_id, pid=os.getpid())
    try:
        while True:
            task = inbox.get()
            if task is None:
                return
            outbox.put(_execute_shard(worker_id, task, boot))
            boot = None
    finally:
        if own_log:
            telemetry.end_run()


# ---------------------------------------------------------------------------
# Executors: a uniform slot model — `workers` slots, one in-flight task per
# slot, messages drain through poll(), dead slots are respawnable.
# ---------------------------------------------------------------------------


class _SerialExecutor:
    kind = "serial"
    workers = 1

    def __init__(self):
        self._msgs: List[dict] = []

    def submit(self, worker_id: int, task: dict) -> None:
        self._msgs.append(_execute_shard(worker_id, task))

    def poll(self, timeout: float) -> List[dict]:
        msgs, self._msgs = self._msgs, []
        return msgs

    def alive(self, worker_id: int) -> bool:
        return True

    def respawn(self, worker_id: int) -> None:  # pragma: no cover - unused
        pass

    def shutdown(self) -> None:
        pass


def _drain(outbox, timeout: float) -> List[dict]:
    msgs = []
    try:
        msgs.append(outbox.get(timeout=timeout))
    except queue_mod.Empty:
        return msgs
    while True:
        try:
            msgs.append(outbox.get_nowait())
        except queue_mod.Empty:
            return msgs


class _ThreadExecutor:
    kind = "thread"

    def __init__(self, workers: int):
        self.workers = workers
        self._outbox: "queue_mod.Queue" = queue_mod.Queue()
        self._inboxes: List["queue_mod.Queue"] = [queue_mod.Queue()
                                                  for _ in range(workers)]
        self._threads: List[threading.Thread] = [None] * workers
        for wid in range(workers):
            self.respawn(wid)

    def respawn(self, worker_id: int) -> None:
        t = threading.Thread(
            target=_worker_loop,
            args=(worker_id, self._inboxes[worker_id], self._outbox, {}),
            daemon=True, name=f"sweep-worker-{worker_id}")
        self._threads[worker_id] = t
        t.start()

    def submit(self, worker_id: int, task: dict) -> None:
        self._inboxes[worker_id].put(task)

    def poll(self, timeout: float) -> List[dict]:
        return _drain(self._outbox, timeout)

    def alive(self, worker_id: int) -> bool:
        return self._threads[worker_id].is_alive()

    def shutdown(self) -> None:
        for inbox in self._inboxes:
            inbox.put(None)
        for t in self._threads:
            t.join(timeout=5.0)


def _mp_context(name: str):
    """The multiprocessing context ``name``.  A fork server imports torch and
    this module once, before any worker exists; each worker is then a fork
    of it that has not touched the card and opens its own CUDA context.
    torch comes first: a preload that fails to import is skipped silently,
    and a server whose interpreter does not pass it the parent's sys.path
    cannot find this package."""
    import multiprocessing

    ctx = multiprocessing.get_context(name)
    if name == "forkserver":
        ctx.set_forkserver_preload(["torch", __name__])
    return ctx


def start_fork_server() -> None:
    """Start the fork server that ``mp_context="forkserver"`` executors fork
    their workers from, now, so that its import of torch overlaps the
    caller's own work instead of delaying the first scheduled sweep."""
    from multiprocessing import forkserver

    _mp_context("forkserver")
    forkserver.ensure_running()


def stop_helper_processes() -> None:
    """Stop the fork server and the resource tracker that this process's
    executors started, and wait for both to exit.  Left alone, each notices
    its parent's exit only by reading EOF and outlives it by a second or
    more (the fork server tears down the torch it preloaded)."""
    from multiprocessing import forkserver, resource_tracker

    for helper in (forkserver._forkserver, resource_tracker._resource_tracker):
        helper._stop()


@contextlib.contextmanager
def fork_server():
    """The fork server, started on entry (:func:`start_fork_server`) and
    stopped with the resource tracker on exit, however the body ends."""
    start_fork_server()
    try:
        yield
    finally:
        stop_helper_processes()


class _ProcessExecutor:
    kind = "process"

    def __init__(self, workers: int, *, mp_context: str, init: dict):
        self.workers = workers
        self._ctx = _mp_context(mp_context)
        self._init = dict(init)
        self._outbox = self._ctx.Queue()
        self._inboxes = [self._ctx.Queue() for _ in range(workers)]
        self._procs: List = [None] * workers
        for wid in range(workers):
            self.respawn(wid)

    def respawn(self, worker_id: int) -> None:
        p = self._ctx.Process(
            target=_worker_loop,
            args=(worker_id, self._inboxes[worker_id], self._outbox,
                  dict(self._init, spawned_ts=time.time())),
            daemon=True, name=f"sweep-worker-{worker_id}")
        self._procs[worker_id] = p
        p.start()

    def submit(self, worker_id: int, task: dict) -> None:
        self._inboxes[worker_id].put(task)

    def poll(self, timeout: float) -> List[dict]:
        return _drain(self._outbox, timeout)

    def alive(self, worker_id: int) -> bool:
        return self._procs[worker_id].is_alive()

    def shutdown(self) -> None:
        for inbox, p in zip(self._inboxes, self._procs):
            if p.is_alive():
                with contextlib.suppress(Exception):
                    inbox.put_nowait(None)
        for p in self._procs:
            p.join(timeout=10.0)
            if p.is_alive():  # pragma: no cover - stuck worker
                p.terminate()
                p.join(timeout=5.0)


def _make_executor(kind: str, workers: int, sched: ScheduleConfig, init: dict):
    if kind == "serial":
        return _SerialExecutor()
    if kind == "thread":
        return _ThreadExecutor(workers)
    if kind == "process":
        return _ProcessExecutor(workers, mp_context=sched.mp_context, init=init)
    raise ValueError(f"unknown executor {kind!r}")


# ---------------------------------------------------------------------------
# Parent side: the shard state machine.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Shard:
    idx: int
    lo: int
    hi: int
    name: str
    state: str = "pending"          # pending | running | done | quarantined
    dispatches: int = 0
    failures: int = 0
    dup_queued: bool = False
    t_first: Optional[float] = None
    errors: List[str] = dataclasses.field(default_factory=list)
    running: Dict[int, dict] = dataclasses.field(default_factory=dict)
    arrays: Optional[Dict[str, np.ndarray]] = None
    engine_meta: Optional[dict] = None
    lens: Optional[List[int]] = None


def _shard_ranges(n_items: int, n_shards: int) -> List[Tuple[int, int]]:
    base, rem = divmod(n_items, n_shards)
    out, lo = [], 0
    for i in range(n_shards):
        hi = lo + base + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _arrays_equal(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> bool:
    return (set(a) == set(b)
            and all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
                    for k in a))


def _merge_engine_meta(engine: str, mode: str, shards: Sequence[_Shard],
                       ckpt_root, sched_meta: dict) -> dict:
    metas = [sh.engine_meta for sh in shards if sh.engine_meta]
    events = [dict(e, shard=sh.idx) for sh in shards
              for e in (sh.engine_meta or {}).get("events", [])]
    return {
        "engine": engine,
        "resumable": bool(metas) and all(m.get("resumable") for m in metas),
        "start_mode": mode,
        "final_mode": mode,   # no downgrade: every shard ran the decided mode
        "events": events,
        "chunks_committed": sum(m.get("chunks_committed", 0) for m in metas),
        "resumed_from": None,
        "completed_from_checkpoint": (
            bool(metas) and all(m.get("completed_from_checkpoint")
                                for m in metas)),
        "checkpoint": str(ckpt_root) if ckpt_root else None,
        "throughput": merge_throughput(metas),
        "scheduler": sched_meta,
    }


def _schedule(*, engine: str, payload: Callable[[int, int], dict],
              n_items: int, mode: str, run_cfg: SweepRunConfig,
              sched: ScheduleConfig, name: str,
              device: torch.device) -> Tuple[List[_Shard], dict]:
    """The scheduler loop: dispatch shards to executor slots, watch leases,
    duplicate stragglers, quarantine poison, merge metadata."""
    tracer = telemetry.get_tracer()
    n_shards = sched.resolve_shards(n_items)
    kind = sched.resolve_executor()
    workers = 1 if kind == "serial" else max(1, sched.workers)
    ckpt_root = (pathlib.Path(run_cfg.checkpoint_dir)
                 if run_cfg.checkpoint_dir else None)
    tmp_lease_dir = ckpt_root is None
    lease_dir = (ckpt_root if ckpt_root is not None
                 else pathlib.Path(tempfile.mkdtemp(prefix="repro-sched-")))
    lease_dir.mkdir(parents=True, exist_ok=True)

    shards = [_Shard(idx=i, lo=lo, hi=hi,
                     name=f"{name}.s{i:02d}of{n_shards:02d}")
              for i, (lo, hi) in enumerate(_shard_ranges(n_items, n_shards))]
    if ckpt_root is not None and not run_cfg.resume:
        # Fresh run: stale shard blobs from a previous identical run must
        # not short-circuit this one (workers always run with resume=True so
        # re-dispatches can take over mid-shard state from *this* run).
        for sh in shards:
            with contextlib.suppress(OSError):
                os.remove(ckpt_root / f"{sh.name}.ckpt")

    run_cfg, handler = _maybe_handler(run_cfg)
    events: List[dict] = []
    launches: Dict[str, int] = {}
    boots: List[dict] = []

    def sev(event: str, level: int = logging.INFO, **kw) -> None:
        events.append({"event": event, "ts": time.time(),
                       "t_mono": time.perf_counter(), **kw})
        tracer.event(event, kind="scheduler", engine=engine, name=name, **kw)
        _LOG.log(level, "scheduler[%s] %s%s", name, event,
                 "".join(f" {k}={v}" for k, v in kw.items()))

    init = {"runlog_dir": sched.runlog_dir if kind == "process" else None,
            "run": tracer.run or name}
    executor = _make_executor(kind, workers, sched, init)
    busy: Dict[int, Tuple[int, int]] = {}
    pending = deque(range(n_shards))
    dead_waiting: List[Tuple[int, int, Optional[str]]] = []
    dispatch_cap = sched.max_shard_attempts + 3
    preempt_stop = False

    def make_task(sh: _Shard, attempt: int, duplicate: bool) -> dict:
        lease_name = (f"{sh.name}.dup{attempt}.lease" if duplicate
                      else f"{sh.name}.lease")
        return {
            "engine": engine, "name": sh.name, "idx": sh.idx,
            "attempt": attempt, "payload": payload(sh.lo, sh.hi),
            "device": str(device),
            # Duplicates run checkpoint-less so two live attempts never race
            # on one shard's chunk blob.
            "ckpt_dir": (None if duplicate else
                         (str(ckpt_root) if ckpt_root else None)),
            "lease_path": str(lease_dir / lease_name),
            "lease_ttl_s": sched.lease_ttl_s,
            "heartbeat_s": sched.heartbeat_s,
            "hold_s": sched.hold_s if attempt == 0 else 0.0,
            "on_shard_start": sched.on_shard_start,
            "chunk_accesses": run_cfg.chunk_accesses,
            "max_retries": run_cfg.max_retries,
            "backoff_base_s": run_cfg.backoff_base_s,
            "backoff_cap_s": run_cfg.backoff_cap_s,
            "rng_seed": run_cfg.rng_seed,
            "fault_hook": run_cfg.fault_hook,
        }

    def maybe_requeue(sh: _Shard, reason: str) -> None:
        """Back to the queue — or quarantine if the shard is out of
        budget."""
        if sh.state in ("done", "quarantined") or sh.running:
            return
        if (sh.failures >= sched.max_shard_attempts
                or sh.dispatches >= dispatch_cap):
            sh.state = "quarantined"
            sev("quarantine", logging.ERROR, shard=sh.idx,
                failures=sh.failures, dispatches=sh.dispatches,
                error=(sh.errors[-1] if sh.errors else None))
            return
        if sh.idx not in pending:
            sh.state = "pending"
            pending.append(sh.idx)
            sev("redispatch", logging.WARNING, shard=sh.idx, reason=reason)

    try:
        with tracer.span("scheduler", engine=engine, name=name,
                         shards=n_shards, workers=workers, executor=kind):
            while True:
                pre = run_cfg.preemption
                if pre is not None and pre.requested and not preempt_stop:
                    preempt_stop = True
                    sev("preempt_stop", logging.WARNING,
                        done=sum(1 for s in shards if s.state == "done"))
                if not preempt_stop:
                    # Dispatch pending shards onto idle live slots.
                    for w in range(executor.workers):
                        if not pending:
                            break
                        if w in busy or not executor.alive(w):
                            continue
                        i = pending.popleft()
                        sh = shards[i]
                        if sh.state in ("done", "quarantined"):
                            continue
                        duplicate = sh.state == "running"
                        attempt = sh.dispatches
                        sh.dispatches += 1
                        task = make_task(sh, attempt, duplicate)
                        sh.running[attempt] = {
                            "worker": w, "t0": time.monotonic(),
                            "lease_path": task["lease_path"],
                            "duplicate": duplicate}
                        if sh.state == "pending":
                            sh.state = "running"
                            sh.t_first = time.monotonic()
                        busy[w] = (i, attempt)
                        sev("dispatch", shard=i, attempt=attempt, worker=w,
                            duplicate=duplicate)
                        executor.submit(w, task)
                    # Straggler duplication: only once everything else is
                    # dispatched and only one duplicate per shard.
                    if sched.deadline_s and not pending and len(busy) < executor.workers:
                        now_m = time.monotonic()
                        for sh in shards:
                            if (sh.state == "running" and not sh.dup_queued
                                    and len(sh.running) == 1
                                    and sh.t_first is not None
                                    and now_m - sh.t_first > sched.deadline_s):
                                sh.dup_queued = True
                                pending.append(sh.idx)
                                sev("redispatch", logging.WARNING,
                                    shard=sh.idx, reason="straggler",
                                    elapsed_s=round(now_m - sh.t_first, 3))

                for msg in executor.poll(sched.poll_s):
                    i, attempt = msg["shard"], msg["attempt"]
                    w = msg.get("worker")
                    if busy.get(w) == (i, attempt):
                        busy.pop(w)
                    for k, v in (msg.get("launches") or {}).items():
                        launches[k] = launches.get(k, 0) + v
                    if msg.get("boot"):
                        boots.append(msg["boot"])
                    sh = shards[i]
                    sh.running.pop(attempt, None)
                    if msg["kind"] == "done":
                        if sh.state == "done":
                            identical = _arrays_equal(sh.arrays, msg["arrays"])
                            sev("duplicate_verified", shard=i, attempt=attempt,
                                identical=identical)
                            if not identical:
                                raise RuntimeError(
                                    f"shard {sh.name} attempt {attempt} "
                                    f"produced a result differing from the "
                                    f"first completion — nondeterministic "
                                    f"engine or corrupted worker; refusing "
                                    f"to merge")
                        else:
                            sh.state = "done"
                            sh.arrays = msg["arrays"]
                            sh.engine_meta = msg["engine_meta"]
                            sh.lens = msg.get("lens")
                            sev("shard_done", shard=i, attempt=attempt,
                                worker=w, elapsed_s=msg.get("elapsed_s"))
                    elif msg["kind"] == "lease_held":
                        sev("lease_held", logging.WARNING, shard=i,
                            attempt=attempt, error=msg.get("error"))
                        maybe_requeue(sh, "lease_held")
                    elif msg["kind"] == "fatal":
                        # No kernel runs in that worker any more (a failed
                        # build, a dead context): abort, never quarantine.
                        sev("shard_failed", logging.ERROR, shard=i,
                            attempt=attempt, worker=w, error=msg.get("error"),
                            fatal=True)
                        raise msg["exc"]
                    else:
                        sh.failures += 1
                        sh.errors.append(msg.get("error", "unknown"))
                        sev("shard_failed", logging.WARNING, shard=i,
                            attempt=attempt, worker=w,
                            error=msg.get("error"))
                        maybe_requeue(sh, "failure")

                # Liveness: a busy slot whose worker died stops heartbeating;
                # once the lease is stale the shard is re-dispatched.
                for w in list(busy):
                    if not executor.alive(w):
                        i, attempt = busy.pop(w)
                        sh = shards[i]
                        info = sh.running.get(attempt)
                        sev("worker_dead", logging.WARNING, worker=w,
                            shard=i, attempt=attempt)
                        dead_waiting.append(
                            (i, attempt,
                             info["lease_path"] if info else None))
                        executor.respawn(w)
                        sev("worker_respawn", worker=w)
                still = []
                for (i, attempt, lease_path) in dead_waiting:
                    lease = read_lease(lease_path) if lease_path else None
                    if lease is not None and lease.get("shard") != i:
                        lease = None   # foreign/reused file, not this claim
                    if lease_path is not None and not lease_is_stale(lease):
                        still.append((i, attempt, lease_path))
                        continue
                    sh = shards[i]
                    sh.running.pop(attempt, None)
                    sev("lease_expire", logging.WARNING, shard=i,
                        attempt=attempt)
                    maybe_requeue(sh, "lease_expired")
                dead_waiting = still

                if all(sh.state in ("done", "quarantined") for sh in shards) \
                        and not any(sh.running for sh in shards) \
                        and not dead_waiting:
                    break
                if preempt_stop and not any(sh.running for sh in shards) \
                        and not dead_waiting:
                    done_items = sum(sh.hi - sh.lo for sh in shards
                                     if sh.state == "done")
                    raise Preempted(ckpt_root, done_items, n_items)
    finally:
        executor.shutdown()
        if handler is not None:
            handler.uninstall()
        # Leases are per-run claims, never results: sweep them regardless.
        for lp in list(lease_dir.glob(f"{name}.s*.lease")) + \
                list(lease_dir.glob(f"{name}.s*.lease.lck")):
            with contextlib.suppress(OSError):
                lp.unlink()
        if tmp_lease_dir:
            shutil.rmtree(lease_dir, ignore_errors=True)

    quarantined = [sh for sh in shards if sh.state == "quarantined"]
    if ckpt_root is not None and not run_cfg.keep_checkpoint \
            and not run_cfg.resume and not quarantined:
        # Mirror the orchestrator's fresh-run policy: a clean non-resume run
        # leaves no blobs behind.  Quarantined runs keep theirs so the
        # poisoned shard can be retried with --resume.
        for sh in shards:
            with contextlib.suppress(OSError):
                os.remove(ckpt_root / f"{sh.name}.ckpt")

    sched_meta = {
        "shards": n_shards,
        "workers": workers,
        "executor": kind,
        "deadline_s": sched.deadline_s,
        "events": events,
        "quarantined_shards": [
            {"shard": sh.idx, "name": sh.name, "items": [sh.lo, sh.hi],
             "failures": sh.failures, "dispatches": sh.dispatches,
             "errors": sh.errors[-3:]}
            for sh in quarantined],
        "shard_map": [
            {"shard": sh.idx, "name": sh.name, "items": [sh.lo, sh.hi],
             "state": sh.state, "dispatches": sh.dispatches,
             "failures": sh.failures,
             "resumed_from": (sh.engine_meta or {}).get("resumed_from"),
             "completed_from_checkpoint": bool(
                 (sh.engine_meta or {}).get("completed_from_checkpoint"))}
            for sh in shards],
        # The port's own: the kernel launches every reporting attempt made
        # (duplicates included), and each process worker's boot.
        "launches": launches,
        "worker_boots": boots,
    }
    if quarantined:
        _LOG.error(
            "scheduler[%s]: run completed DEGRADED — %d/%d shards "
            "quarantined (%s); their rows are zero placeholders",
            name, len(quarantined), n_shards,
            ", ".join(sh.name for sh in quarantined))
    meta = _merge_engine_meta(engine, mode, shards, ckpt_root, sched_meta)
    return shards, meta


# ---------------------------------------------------------------------------
# Public entry points: drop-in supersets of the orchestrator's.
# ---------------------------------------------------------------------------


def _host_events(ev: SystemEvents, memo: dict) -> SystemEvents:
    """``ev`` with host numpy arrays; ``memo`` maps each tensor's storage
    view to one array, so specs that share events pickle them once."""
    def host(x):
        if not isinstance(x, torch.Tensor):
            return np.asarray(x)
        key = (x.device, x.data_ptr(), tuple(x.shape), x.stride(), x.dtype)
        if key not in memo:
            memo[key] = _host(x)
        return memo[key]

    return SystemEvents(host(ev.cache_hit), host(ev.accel_tlb_hit), host(ev.mem_tlb_hit),
                        ev.n_warm)


def run_sweep_tlb(
    addrs,
    specs: Sequence[TLBSweepSpec],
    *,
    warmup_frac: float = 0.25,
    kernel_mode: str = "auto",
    block: int = 512,
    run: SweepRunConfig = SweepRunConfig(),
    sched: Optional[ScheduleConfig] = None,
    name: str = "sweep_tlb",
    device: Device = "cuda",
) -> Tuple[BatchedTLBResult, dict]:
    """Sharded, fault-tolerant :func:`repro_torch.core.orchestrator.run_sweep_tlb`.
    ``sched=None`` (or a disabled config) is a pure passthrough.  Sharded,
    the hits are a bool tensor on ``device``."""
    if sched is None or not sched.enabled or len(specs) <= 1:
        return orch.run_sweep_tlb(
            addrs, specs, warmup_frac=warmup_frac, kernel_mode=kernel_mode,
            block=block, run=run, name=name, device=device)
    dev = as_device(device)
    addrs = _host(addrs)
    specs = list(specs)
    # The dispatch decision is made ONCE over the full spec set (stackdist
    # eligibility and calibration lookups are properties of the whole sweep)
    # and passed concrete to every shard, so sharding can never flip the
    # backend choice.
    decision = dispatch.decide_tlb(
        kernel_mode, specs, n_accesses=int(addrs.shape[0]),
        store=dispatch.store_for(run.calibration_dir, dev), device=dev)
    dispatch.record_decision(decision, name=name)
    mode = decision.mode
    n = int(addrs.shape[0])
    shards, meta = _schedule(
        engine="sweep_tlb",
        payload=lambda lo, hi: {"addrs": addrs, "specs": specs[lo:hi],
                                "warmup_frac": warmup_frac, "block": block,
                                "mode": mode},
        n_items=len(specs), mode=mode, run_cfg=run, sched=sched, name=name,
        device=dev)
    meta["dispatch"] = decision.to_json()
    rows = [np.zeros((sh.hi - sh.lo, n), bool) if sh.arrays is None
            else np.asarray(sh.arrays["hits"], bool)
            for sh in shards]
    hits = torch.from_numpy(np.concatenate(rows, axis=0)).to(dev)
    return BatchedTLBResult(hits=hits, n_warm=n - int(n * warmup_frac)), meta


def run_sweep_system(
    lines,
    cfgs: Sequence[SystemSimConfig],
    *,
    warmup_frac: float = 0.25,
    kernel_mode: str = "auto",
    block: int = 512,
    run: SweepRunConfig = SweepRunConfig(),
    sched: Optional[ScheduleConfig] = None,
    name: str = "sweep_system",
    device: Device = "cuda",
) -> Tuple[BatchedSystemEvents, dict]:
    """Sharded, fault-tolerant
    :func:`repro_torch.core.orchestrator.run_sweep_system`.  Sharded, the hit
    bits are bool tensors on ``device``."""
    if sched is None or not sched.enabled or len(cfgs) <= 1:
        return orch.run_sweep_system(
            lines, cfgs, warmup_frac=warmup_frac, kernel_mode=kernel_mode,
            block=block, run=run, name=name, device=device)
    dev = as_device(device)
    lines = _host(lines)
    cfgs = list(cfgs)
    # Decided once globally (see run_sweep_tlb): shards get a concrete mode.
    decision = dispatch.decide_system(
        kernel_mode, cfgs, n_accesses=int(lines.shape[0]),
        store=dispatch.store_for(run.calibration_dir, dev), device=dev)
    dispatch.record_decision(decision, name=name)
    mode = decision.mode
    n = int(lines.shape[0])
    shards, meta = _schedule(
        engine="sweep_system",
        payload=lambda lo, hi: {"lines": lines, "cfgs": cfgs[lo:hi],
                                "warmup_frac": warmup_frac, "block": block,
                                "mode": mode},
        n_items=len(cfgs), mode=mode, run_cfg=run, sched=sched, name=name,
        device=dev)
    meta["dispatch"] = decision.to_json()
    cols = {}
    for nm in ("cache_hit", "accel_tlb_hit", "mem_tlb_hit"):
        cols[nm] = torch.from_numpy(np.concatenate(
            [np.zeros((sh.hi - sh.lo, n), bool) if sh.arrays is None
             else np.asarray(sh.arrays[nm], bool) for sh in shards], axis=0)).to(dev)
    return BatchedSystemEvents(cols["cache_hit"], cols["accel_tlb_hit"],
                               cols["mem_tlb_hit"],
                               n_warm=n - int(n * warmup_frac)), meta


def run_sweep_timeline(
    specs: Sequence[TimelineSpec],
    lat=None,
    *,
    kernel_mode: str = "auto",
    block: int = 512,
    run: SweepRunConfig = SweepRunConfig(),
    sched: Optional[ScheduleConfig] = None,
    name: str = "sweep_timeline",
    device: Device = "cuda",
) -> Tuple[List[TimelineResult], dict]:
    """Sharded, fault-tolerant
    :func:`repro_torch.core.orchestrator.run_sweep_timeline`."""
    if sched is None or not sched.enabled or len(specs) <= 1:
        return orch.run_sweep_timeline(
            specs, lat, kernel_mode=kernel_mode, block=block, run=run,
            name=name, device=device)
    dev = as_device(device)
    memo: dict = {}
    specs = [dataclasses.replace(sp, lines=_host(sp.lines),
                                 events=_host_events(sp.events, memo))
             for sp in specs]
    # The batch-aware decision must see the GLOBAL batch size, not a
    # shard's — otherwise a single-spec shard could take another backend
    # and the merged run would not be bit-identical to the unsharded one.
    decision = dispatch.decide_timeline(
        kernel_mode, batch=len(specs),
        n_accesses=max((int(sp.lines.shape[0]) for sp in specs), default=0),
        store=dispatch.store_for(run.calibration_dir, dev), device=dev)
    dispatch.record_decision(decision, name=name)
    mode = decision.mode
    shards, meta = _schedule(
        engine="sweep_timeline",
        payload=lambda lo, hi: {"specs": specs[lo:hi], "lat": lat,
                                "block": block, "mode": mode},
        n_items=len(specs), mode=mode, run_cfg=run, sched=sched, name=name,
        device=dev)
    meta["dispatch"] = decision.to_json()
    results: List[TimelineResult] = []
    for sh in shards:
        for j, g in enumerate(range(sh.lo, sh.hi)):
            sp = specs[g]
            cache_hit = np.asarray(sp.events.cache_hit).astype(bool)
            if sh.arrays is None:   # quarantined placeholder rows
                n_g = int(cache_hit.shape[0])
                results.append(TimelineResult(
                    latency=np.zeros(n_g, np.float32),
                    overhead=np.zeros(n_g, np.float32),
                    done=np.zeros(n_g, np.float32),
                    cache_hit=cache_hit, n_warm=sp.events.n_warm))
            else:
                n_g = int(sh.lens[j])
                results.append(TimelineResult(
                    latency=np.asarray(sh.arrays["latency"][j, :n_g]),
                    overhead=np.asarray(sh.arrays["overhead"][j, :n_g]),
                    done=np.asarray(sh.arrays["done"][j, :n_g]),
                    cache_hit=cache_hit, n_warm=sp.events.n_warm))
    return results, meta


# ---------------------------------------------------------------------------
# Garbage collection for the checkpoint/lease tree.
# ---------------------------------------------------------------------------


def gc_checkpoints(root, *, age_s: float = 7 * 86400.0,
                   now: Optional[float] = None,
                   dry_run: bool = False) -> dict:
    """Sweep stale shard blobs, expired leases and orphaned temp files under
    ``root`` (``build/repro_torch/cache/ckpt``).

    Policy:

    * an *expired* lease (TTL exceeded) is deleted; a fresh lease marks its
      directory as **in-progress** and every blob there is kept regardless
      of age (never delete under a live run);
    * a ``.ckpt`` blob older than ``age_s`` is deleted only if its header
      identifies it as a repro checkpoint blob — unrecognized files are
      reported in ``skipped_foreign`` and never touched (never delete data
      you did not write);
    * ``.tmp-*`` leftovers from crashed writers are deleted once old.

    Returns a summary dict; ``dry_run=True`` reports without deleting.
    """
    root = pathlib.Path(root)
    now = time.time() if now is None else now
    summary = {"deleted": [], "kept_in_progress": [], "kept_young": [],
               "skipped_foreign": [], "dry_run": dry_run}
    if not root.exists():
        return summary

    def delete(p: pathlib.Path) -> None:
        summary["deleted"].append(str(p))
        if not dry_run:
            with contextlib.suppress(OSError):
                p.unlink()

    fresh_dirs = set()
    lease_paths = [p for p in sorted(root.rglob("*.lease")) if p.is_file()]
    for lp in lease_paths:
        if not lease_is_stale(read_lease(lp), now=now):
            fresh_dirs.add(lp.parent)
    for lp in lease_paths:
        if lease_is_stale(read_lease(lp), now=now):
            delete(lp)
            lck = lp.with_name(lp.name + ".lck")
            if lck.exists():
                delete(lck)
        else:
            summary["kept_in_progress"].append(str(lp))

    for p in sorted(root.rglob("*")):
        if not p.is_file() or p.suffix == ".lease" \
                or p.name.endswith(".lease.lck"):
            continue
        try:
            age = now - p.stat().st_mtime
        except OSError:
            continue
        if ".tmp-" in p.name:
            if age > age_s:
                delete(p)
            else:
                summary["kept_young"].append(str(p))
            continue
        if p.suffix == ".ckpt":
            if p.parent in fresh_dirs:
                summary["kept_in_progress"].append(str(p))
                continue
            if age <= age_s:
                summary["kept_young"].append(str(p))
                continue
            try:
                head = p.open("rb").read(len(BLOB_MAGIC))
            except OSError:
                continue
            if head == BLOB_MAGIC.encode():
                delete(p)
            else:
                summary["skipped_foreign"].append(str(p))
            continue
        summary["skipped_foreign"].append(str(p))
    return summary
