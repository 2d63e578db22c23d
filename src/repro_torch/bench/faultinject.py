"""Fault-injection seams of the shard scheduler (``ScheduleConfig.
on_shard_start``), for the smokes, the tests and ``chip_smoke.py``.

The port-side copies of the classes the JAX package keeps in
``tests/_faultinject.py``.  Module-level classes, not closures, so the
spawn-based process executor can pickle them by name: each is called with
``(shard, attempt, worker)`` after the worker holds the shard's lease and
before the engine runs.

* :class:`KillWorkerOnShard` — the worker SIGKILLs *itself* (process
  executor only: from a thread it would take down the whole process);
* :class:`PoisonShard` — the shard fails deterministically on every attempt
  (the quarantine path);
* :class:`HoldShard` — the shard's first attempt sleeps (a straggler);
* :class:`RaiseOnShard` — the shard raises a given exception on every
  attempt (a fatal one, :func:`repro_torch.runtime.fault_tolerance.
  is_fatal`, must abort the run).
"""
from __future__ import annotations


class KillWorkerOnShard:
    """A worker that picks up the matching ``(shard, attempt)`` SIGKILLs
    itself — "SIGKILL one worker mid-shard" with no timing race."""

    def __init__(self, shard: int, attempts=(0,)):
        self.shard = int(shard)
        self.attempts = tuple(attempts)

    def __call__(self, shard: int, attempt: int, worker: int) -> None:
        if shard == self.shard and attempt in self.attempts:
            import os
            import signal

            os.kill(os.getpid(), signal.SIGKILL)


class PoisonShard:
    """The matching shard fails with a ``ValueError`` on every attempt (a
    poison config), while all other shards run normally."""

    def __init__(self, shard: int):
        self.shard = int(shard)

    def __call__(self, shard: int, attempt: int, worker: int) -> None:
        if shard == self.shard:
            raise ValueError(
                f"poisoned shard {shard} (attempt {attempt}, worker {worker})")


class HoldShard:
    """Sleep the matching shard's first attempt ``hold_s`` seconds — an
    injected straggler for deadline/duplicate runs."""

    def __init__(self, shard: int, hold_s: float, attempts=(0,)):
        self.shard = int(shard)
        self.hold_s = float(hold_s)
        self.attempts = tuple(attempts)

    def __call__(self, shard: int, attempt: int, worker: int) -> None:
        if shard == self.shard and attempt in self.attempts:
            import time

            time.sleep(self.hold_s)


class RaiseOnShard:
    """The matching shard raises ``exc`` (a picklable exception instance)
    on every attempt."""

    def __init__(self, shard: int, exc: BaseException):
        self.shard = int(shard)
        self.exc = exc

    def __call__(self, shard: int, attempt: int, worker: int) -> None:
        if shard == self.shard:
            raise self.exc
