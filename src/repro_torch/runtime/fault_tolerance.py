"""Fault-tolerance runtime: heartbeats, straggler detection, preemption,
bounded retry, and the classification of transient faults.

The port of the JAX package's ``src/repro/runtime/fault_tolerance.py``.
:class:`HostStats`, :class:`HeartbeatTracker`, :class:`PreemptionHandler`,
:func:`backoff_delays` and :func:`retry_step` are the reference's.
:func:`is_transient` classifies by the exception's type, never by its text:
the reference keys on XLA status strings (``"INTERNAL"``, ``"out of
memory"``, ...), which a CUDA runtime does not produce and which text such
as an ``nvcc`` log can contain by accident; :func:`is_fatal` names the
errors after which no kernel runs in the process.  :func:`run_training_loop`
(with :class:`LoopConfig`) is the reference's fault-tolerant training
driver, and the caller of the retry, heartbeat and preemption pieces.
"""
from __future__ import annotations

import dataclasses
import errno
import logging
import random
import signal
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.kernels._build import CUDA_ERROR_MEMORY_ALLOCATION, CudaError, KernelBuildError

_LOG = logging.getLogger("repro_torch.runtime.fault_tolerance")

__all__ = ["HostStats", "HeartbeatTracker", "PreemptionHandler", "is_transient",
           "is_fatal", "backoff_delays", "retry_step", "LoopConfig", "run_training_loop"]


@dataclasses.dataclass
class HostStats:
    ewma: float = 0.0
    count: int = 0
    last_seen: float = 0.0


class HeartbeatTracker:
    """Tracks per-host step durations; flags stragglers and dead hosts."""

    def __init__(self, *, alpha: float = 0.2, straggler_factor: float = 1.5,
                 dead_after_s: float = 60.0):
        self.alpha = alpha
        self.straggler_factor = straggler_factor
        self.dead_after_s = dead_after_s
        self.hosts: Dict[int, HostStats] = {}

    def record(self, host: int, step_time_s: float, now: Optional[float] = None):
        st = self.hosts.setdefault(host, HostStats())
        st.ewma = step_time_s if st.count == 0 else (
            self.alpha * step_time_s + (1 - self.alpha) * st.ewma
        )
        st.count += 1
        st.last_seen = time.time() if now is None else now

    def _median_ewma(self) -> float:
        vals = sorted(s.ewma for s in self.hosts.values() if s.count > 0)
        return vals[len(vals) // 2] if vals else 0.0

    def stragglers(self) -> List[int]:
        med = self._median_ewma()
        if med <= 0:
            return []
        return [h for h, s in self.hosts.items() if s.ewma > self.straggler_factor * med]

    def dead(self, now: Optional[float] = None) -> List[int]:
        t = time.time() if now is None else now
        return [h for h, s in self.hosts.items() if t - s.last_seen > self.dead_after_s]


class PreemptionHandler:
    """SIGTERM/SIGINT => checkpoint-and-exit at the next step boundary.

    Any *user-installed* handler that was registered before us is chained
    (called after ``requested`` is set) instead of silently replaced; the
    interpreter defaults (``SIG_DFL`` / ``SIG_IGN`` / Python's
    ``default_int_handler``, which would raise ``KeyboardInterrupt`` straight
    through the graceful shutdown) are replaced, which is the point of
    installing a preemption handler at all.  ``uninstall()`` restores
    whatever was there before.

    Off the main thread ``signal.signal`` raises ``ValueError`` by CPython
    design — exactly where scheduler worker threads construct orchestrators.
    Construction there is a *documented no-op with a warning*: ``requested``
    stays drivable (the parent forwards preemption by constructing workers
    with ``install=False`` and setting ``requested`` itself), and
    ``uninstall()`` is safe to call.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, install: bool = True,
                 signals: Optional[Tuple[int, ...]] = None):
        self.requested = False
        self.installed = False
        self._previous: Dict[int, object] = {}
        if install:
            if threading.current_thread() is not threading.main_thread():
                _LOG.warning(
                    "PreemptionHandler constructed off the main thread "
                    "(%s): signal handlers cannot be installed there "
                    "(signal.signal raises ValueError); continuing as a "
                    "no-op — forward preemption from the main thread via "
                    "an injected handler (install=False).",
                    threading.current_thread().name)
                return
            for sig in (signals if signals is not None else self.SIGNALS):
                self._previous[sig] = signal.signal(sig, self._on_signal)
            self.installed = True

    def _on_signal(self, signum, frame):
        self.requested = True
        prev = self._previous.get(signum)
        if callable(prev) and prev is not signal.default_int_handler:
            prev(signum, frame)

    def uninstall(self):
        """Restore the handlers that were installed before us."""
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._previous = {}


# OSError is mostly deterministic (missing file, bad permissions, dir-vs-file,
# full disk): retrying those just replays the failure.  Only the classic
# "try again" errnos are worth a retry (the reference's list).
_TRANSIENT_ERRNOS = frozenset(
    getattr(errno, nm) for nm in (
        "EINTR", "EAGAIN", "EWOULDBLOCK", "EBUSY", "EIO", "ETIMEDOUT",
        "ESTALE", "ENOBUFS", "ECONNRESET", "ECONNABORTED", "ENETRESET",
        "ENETDOWN", "ENETUNREACH", "EHOSTUNREACH",
    ) if hasattr(errno, nm))


def is_transient(exc: BaseException) -> bool:
    """Is this exception a transient runtime fault worth retrying?

    Transient: the card ran out of memory (``torch.cuda.OutOfMemoryError``,
    or a kernel's launch returning ``cudaErrorMemoryAllocation``), and the
    OS cases the reference keeps: ``MemoryError``, ``TimeoutError``,
    ``ConnectionError`` and the "try again" errnos of
    :data:`_TRANSIENT_ERRNOS`.

    Never transient: a failed kernel build (:class:`KernelBuildError`); any
    other CUDA error, sticky ones (700 illegal address, 716 misaligned
    address, 719 launch failure: ``torch.AcceleratorError`` in general) leave
    the context dead, so neither a retry nor the plain version on the same
    card can run, and 701 (too many resources requested) is deterministic;
    program bugs (``ValueError``, ``TypeError``, a bare ``RuntimeError``,
    ...); deterministic filesystem failures (``FileNotFoundError``,
    ``PermissionError``, ``ENOSPC``, ...).
    """
    if isinstance(exc, KernelBuildError):
        return False
    if isinstance(exc, CudaError):
        return exc.code == CUDA_ERROR_MEMORY_ALLOCATION
    torch = sys.modules.get("torch")   # an exception of torch's implies torch is loaded
    if torch is not None:
        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
        accelerator_error = getattr(torch, "AcceleratorError", None)
        if accelerator_error is not None and isinstance(exc, accelerator_error):
            return False
    if isinstance(exc, (MemoryError, TimeoutError, ConnectionError)):
        return True
    if isinstance(exc, OSError):
        return exc.errno in _TRANSIENT_ERRNOS
    return False


# cudaError_t codes that leave the context dead: 700 illegal address, 716
# misaligned address, 719 launch failure.
STICKY_CUDA_ERRORS = frozenset({700, 716, 719})


def is_fatal(exc: BaseException) -> bool:
    """Does this exception leave the process without a kernel to run?

    Fatal: a failed kernel build (:class:`KernelBuildError`) and a sticky
    CUDA error (:data:`STICKY_CUDA_ERRORS`, ``torch.AcceleratorError``):
    every later launch in the process fails the same way, whatever it runs.
    The shard scheduler aborts its run on one instead of counting it against
    the shard (``repro_torch.core.scheduler``); a fatal error is never
    :func:`is_transient` either.
    """
    if isinstance(exc, KernelBuildError):
        return True
    if isinstance(exc, CudaError):
        return exc.code in STICKY_CUDA_ERRORS
    torch = sys.modules.get("torch")
    accelerator_error = getattr(torch, "AcceleratorError", None) if torch is not None else None
    return accelerator_error is not None and isinstance(exc, accelerator_error)


def backoff_delays(retries: int, *, base_s: float = 0.05, cap_s: float = 2.0,
                   jitter: float = 0.25,
                   rng: Optional[random.Random] = None) -> List[float]:
    """Bounded exponential backoff schedule with multiplicative jitter."""
    rng = rng or random.Random()
    out = []
    for attempt in range(retries):
        d = min(base_s * (2.0 ** attempt), cap_s)
        out.append(d * (1.0 + jitter * rng.random()))
    return out


def retry_step(fn: Callable, *args, retries: int = 2,
               on_retry: Optional[Callable[[int, BaseException], None]] = None,
               base_delay_s: float = 0.05, max_delay_s: float = 2.0,
               rng: Optional[random.Random] = None):
    """Run one step with bounded retry of *transient* runtime faults.

    Only exceptions classified by :func:`is_transient` are retried —
    deterministic bugs (ValueError/TypeError/...) surface immediately instead
    of burning every retry first.  Retries sleep a bounded exponential
    backoff with jitter (``base_delay_s`` doubling up to ``max_delay_s``);
    pass ``base_delay_s=0`` to disable sleeping (tests).
    """
    delays = backoff_delays(retries, base_s=base_delay_s, cap_s=max_delay_s,
                            rng=rng)
    for attempt in range(retries + 1):
        try:
            return fn(*args)
        except Exception as e:
            if attempt == retries or not is_transient(e):
                raise
            if on_retry:
                on_retry(attempt, e)
            if delays[attempt] > 0:
                time.sleep(delays[attempt])


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    checkpoint_every: int = 100
    keep: int = 3
    retries: int = 2


def run_training_loop(
    step_fn: Callable,
    state: tuple,
    batch_fn: Callable[[int], dict],
    ckpt_root,
    loop: LoopConfig,
    *,
    start_step: int = 0,
    tracker: Optional[HeartbeatTracker] = None,
    preemption: Optional[PreemptionHandler] = None,
    host_id: int = 0,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
):
    """The fault-tolerant driver: retries transient step faults, records
    heartbeats, checkpoints asynchronously every ``checkpoint_every`` steps
    and checkpoints-and-exits on preemption.  ``state`` is ``(params,
    opt_state)`` and ``step_fn(params, opt_state, batch)`` returns
    ``(params, opt_state, metrics)``.  Returns ``(state, step)``."""
    from repro_torch.checkpoint.checkpoint import AsyncCheckpointer

    tracker = tracker or HeartbeatTracker()
    ckpt = AsyncCheckpointer(ckpt_root, keep=loop.keep)
    step = start_step
    try:
        while step < loop.total_steps:
            t0 = time.time()
            batch = batch_fn(step)
            params, opt_state, metrics = retry_step(
                step_fn, *state, batch, retries=loop.retries
            )
            state = (params, opt_state)
            tracker.record(host_id, time.time() - t0)
            if on_metrics:
                on_metrics(step, metrics)
            step += 1
            if step % loop.checkpoint_every == 0:
                ckpt.submit(step, {"params": params, "opt_state": opt_state})
            if preemption is not None and preemption.requested:
                ckpt.submit(step, {"params": params, "opt_state": opt_state})
                break
    finally:
        ckpt.close()
    return state, step
