"""Run telemetry: spans, counters/gauges and per-run append-only JSONL logs.

The port of the JAX package's ``src/repro/runtime/telemetry.py``, record for
record: the run-log schema is the same (:data:`SCHEMA_VERSION` 1), so the
port's reader ``python -m repro_torch.bench.obs_report`` (and the JAX
package's own) renders the logs of either package.

* :class:`RunLog` — an append-only JSONL sink, one file per figure/bench
  run, one self-describing record per line (``kind`` = ``run_start`` /
  ``span`` / ``event`` / ``run_end``; every record carries ``ts`` wall-clock
  seconds and ``t_mono`` = ``time.perf_counter()``).  The first record
  stamps ``schema_version``.
* :class:`Span` — a context manager recording wall duration (and optionally
  device-blocked time via :meth:`Span.block`, which routes through
  :func:`repro_torch.core.benchtime.block`); spans nest, with ``span_id`` /
  ``parent_id`` linking the records.  :meth:`Tracer.record_span` logs a
  span whose duration was measured externally (``benchtime.measure``).
* :class:`Counter` / :class:`Gauge` — a per-run registry (simulated-access
  counts, carried-state footprints, ...), aggregated into the ``run_end``
  summary.
* :class:`Tracer` — the global instance (:func:`get_tracer`).  When no run
  is active every call is a no-op returning shared null objects, so hot
  loops can be instrumented unconditionally.

Lifecycle: :func:`run_scope` (or :func:`start_run`/:func:`end_run`) brackets
one run; ``run_scope`` catches ``BaseException`` so a ``Preempted`` exit
still closes the log with an ``error`` on the ``run_end`` record.
:meth:`Tracer.summary` is the in-memory aggregate of the last run.

Stdlib only: ``benchtime`` (which imports torch) is pulled in lazily inside
:meth:`Span.block`, so importing telemetry never costs a torch import.
"""
from __future__ import annotations

import contextlib
import json
import logging
import pathlib
import sys
import threading
import time
from typing import IO, Any, Dict, List, Optional, Union

# Version of the JSONL record schema below; bump on any incompatible change
# (the BENCH_sweep.json `schema_version` discipline).
SCHEMA_VERSION = 1

_LOG = logging.getLogger("repro_torch.runtime.telemetry")


def _stamp() -> Dict[str, float]:
    """Wall-clock + monotonic timestamps carried by every record."""
    return {"ts": time.time(), "t_mono": time.perf_counter()}


def _jsonable(x: Any):
    """json.dumps default: numpy scalars/arrays degrade to Python values."""
    item = getattr(x, "item", None)
    if callable(item):
        try:
            return x.item()
        except (TypeError, ValueError):
            pass
    tolist = getattr(x, "tolist", None)
    if callable(tolist):
        return x.tolist()
    return str(x)


class _NullSpan:
    """The disabled-tracer span: every method is a do-nothing returning
    something sensible, so instrumented code needs no ``if enabled`` guard.
    ``block`` returns its argument *without* blocking — the disabled path
    must not add device synchronization the uninstrumented code lacked."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def block(self, x):
        return x


class _NullInstrument:
    """Disabled-tracer counter/gauge."""

    __slots__ = ()

    def add(self, n=1):
        return self

    def set(self, value):
        return self


_NULL_SPAN = _NullSpan()
_NULL_INSTRUMENT = _NullInstrument()

# One lock for all counter/gauge mutation: scheduler worker threads update
# shared instruments concurrently, and `+=` on a float is not atomic.  The
# disabled-tracer path never reaches these (it returns _NULL_INSTRUMENT), so
# the <2% no-op overhead guard is unaffected.
_AGG_LOCK = threading.Lock()


class Counter:
    """Monotonically accumulated value (e.g. simulated accesses)."""

    __slots__ = ("name", "value", "updates")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.updates = 0

    def add(self, n=1):
        with _AGG_LOCK:
            self.value += n
            self.updates += 1
        return self

    def summary(self) -> dict:
        return {"value": self.value, "updates": self.updates}


class Gauge:
    """Last-set value with min/max tracking (e.g. carried-state bytes)."""

    __slots__ = ("name", "value", "min", "max", "updates")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.updates = 0

    def set(self, value):
        value = float(value)
        with _AGG_LOCK:
            self.value = value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            self.updates += 1
        return self

    def summary(self) -> dict:
        return {"value": self.value, "min": self.min, "max": self.max,
                "updates": self.updates}


class RunLog:
    """Append-only JSONL sink for one run: one json record per line,
    flushed per write so a crashed/preempted run keeps every completed
    record (at worst the final line is torn, which readers tolerate)."""

    def __init__(self, path: Union[str, pathlib.Path]):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f: Optional[IO[str]] = open(self.path, "w", encoding="utf-8")

    def write(self, rec: dict) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps(rec, default=_jsonable) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class Span:
    """An in-progress span; obtained from :meth:`Tracer.span` and used as a
    context manager.  ``set(**attrs)`` attaches attributes discovered while
    the span runs (e.g. achieved accesses/s); ``block(x)`` waits for the card
    via ``benchtime.block`` and accumulates the wait into the span's
    ``blocked_s`` attribute."""

    __slots__ = ("_tracer", "name", "attrs", "span_id", "parent_id", "ts",
                 "_t0", "_blocked_s")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id: Optional[int] = None
        self.parent_id: Optional[int] = None
        self._blocked_s = 0.0

    def __enter__(self) -> "Span":
        tr = self._tracer
        self.parent_id = tr._stack[-1].span_id if tr._stack else None
        self.span_id = tr._next_id()
        tr._stack.append(self)
        self.ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def block(self, x):
        from repro_torch.core.benchtime import block

        t0 = time.perf_counter()
        block(x)
        self._blocked_s += time.perf_counter() - t0
        return x

    def __exit__(self, et, ev, tb) -> bool:
        dur_s = time.perf_counter() - self._t0
        tr = self._tracer
        if tr._stack and tr._stack[-1] is self:
            tr._stack.pop()
        if et is not None:
            self.attrs.setdefault("error", f"{et.__name__}: {ev}")
        if self._blocked_s:
            self.attrs.setdefault("blocked_s", round(self._blocked_s, 6))
        tr._finish_span(self.name, dur_s, self.span_id, self.parent_id,
                        self.ts, self.attrs)
        return False


class Tracer:
    """The global spans/counters/events registry for one run.

    ``active`` is the no-op gate: with no run started (the default), every
    instrument call returns a shared null object and records nothing.  The
    per-name aggregates (``summary()``) survive :meth:`end_run`, so a driver
    can stamp the finished run's summary into its figure JSON.

    Thread-safety: scheduler worker *threads* share this tracer, so the
    span stack is thread-local (each thread nests its own spans; a worker
    span never claims another thread's span as parent) while the shared
    registries (span stats, event counts, counters/gauges, id allocation)
    and the JSONL sink are guarded by one re-entrant lock.  The disabled
    path stays lock-free — the <2% no-op overhead guard still holds."""

    def __init__(self):
        self._lock = threading.RLock()
        self._tls = threading.local()
        self._reset()

    def _reset(self) -> None:
        self.active = False
        self.run: Optional[str] = None
        self._log: Optional[RunLog] = None
        self._tls.stack = []
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._span_stats: Dict[str, dict] = {}
        self._event_counts: Dict[str, int] = {}
        self._id = 0

    @property
    def _stack(self) -> List[Span]:
        """This thread's open-span stack (created lazily per thread)."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    # -- lifecycle ----------------------------------------------------------

    def start_run(self, path: Union[str, pathlib.Path, None] = None, *,
                  run: Optional[str] = None, **meta) -> "Tracer":
        """Begin a run, resetting all registries.  ``path=None`` keeps the
        run in-memory only (aggregates, no JSONL)."""
        with self._lock:
            if self.active:
                _LOG.warning("telemetry run %r still active; closing it to start %r",
                             self.run, run)
                self.end_run(error=f"superseded by run {run!r}")
            self._reset()
            self.run = run
            self.active = True
            if path is not None:
                self._log = RunLog(path)
            rec = {"kind": "run_start", "schema_version": SCHEMA_VERSION,
                   "run": run, **_stamp()}
            if meta:
                rec["meta"] = meta
            self._emit(rec)
            return self

    def end_run(self, error: Optional[str] = None) -> dict:
        """Close the run (writing the ``run_end`` summary record) and return
        the summary.  No-op returning ``{}`` when no run is active."""
        with self._lock:
            if not self.active:
                return {}
            s = self.summary()
            rec = {"kind": "run_end", "run": self.run, **_stamp(), "summary": s}
            if error is not None:
                rec["error"] = str(error)
            self._emit(rec)
            if self._log is not None:
                self._log.close()
                self._log = None
            self.active = False
            del self._stack[:]
            return s

    # -- instruments --------------------------------------------------------

    # `name` is positional-only so callers can attach a `name=...` attribute
    # (e.g. the orchestrator labels chunk spans with the figure name).
    def span(self, name: str, /, **attrs):
        """Open a span context manager (a shared no-op when disabled)."""
        if not self.active:
            return _NULL_SPAN
        return Span(self, name, attrs)

    def record_span(self, name: str, dur_s: float, /, **attrs) -> None:
        """Record an already-measured span (duration timed externally)."""
        if not self.active:
            return
        parent = self._stack[-1].span_id if self._stack else None
        self._finish_span(name, float(dur_s), self._next_id(), parent,
                          time.time(), attrs)

    def event(self, name: str, /, **attrs) -> None:
        """Record a point-in-time structured event (retry, halve, ...)."""
        if not self.active:
            return
        with self._lock:
            self._event_counts[name] = self._event_counts.get(name, 0) + 1
            rec = {"kind": "event", "name": name, **_stamp()}
            if attrs:
                rec["attrs"] = attrs
            self._emit(rec)

    def counter(self, name: str):
        if not self.active:
            return _NULL_INSTRUMENT
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str):
        if not self.active:
            return _NULL_INSTRUMENT
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def summary(self) -> dict:
        """Aggregate view of the (last) run: per-name span stats, event
        counts, counter/gauge values — the figure-JSON ``_telemetry`` base."""
        with self._lock:
            return self._summary_locked()

    def _summary_locked(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "run": self.run,
            "n_spans": sum(s["count"] for s in self._span_stats.values()),
            "spans": {k: {"count": v["count"],
                          "total_s": round(v["total_s"], 6)}
                      for k, v in sorted(self._span_stats.items())},
            "events": dict(sorted(self._event_counts.items())),
            "counters": {k: c.summary()
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.summary()
                       for k, g in sorted(self._gauges.items())},
        }

    # -- internals ----------------------------------------------------------

    def _next_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def _emit(self, rec: dict) -> None:
        with self._lock:
            if self._log is not None:
                self._log.write(rec)

    def _finish_span(self, name: str, dur_s: float, span_id: Optional[int],
                     parent_id: Optional[int], ts: float, attrs: dict) -> None:
        with self._lock:
            st = self._span_stats.setdefault(name, {"count": 0, "total_s": 0.0})
            st["count"] += 1
            st["total_s"] += dur_s
            rec = {"kind": "span", "name": name, "span_id": span_id,
                   "parent_id": parent_id, "ts": ts,
                   "t_mono": time.perf_counter(), "dur_s": round(dur_s, 6)}
            if attrs:
                rec["attrs"] = dict(attrs)
            self._emit(rec)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def start_run(path=None, *, run=None, **meta) -> Tracer:
    return _TRACER.start_run(path, run=run, **meta)


def end_run(error: Optional[str] = None) -> dict:
    return _TRACER.end_run(error=error)


@contextlib.contextmanager
def run_scope(path=None, *, run=None, **meta):
    """Bracket one run.  Catches ``BaseException`` deliberately: a
    :class:`repro_torch.core.orchestrator.Preempted` (or KeyboardInterrupt) must
    still close the JSONL log, with the error recorded on ``run_end``."""
    _TRACER.start_run(path, run=run, **meta)
    try:
        yield _TRACER
    except BaseException as exc:
        _TRACER.end_run(error=f"{type(exc).__name__}: {exc}")
        raise
    else:
        _TRACER.end_run()


def setup_logging(verbosity: int = 0,
                  stream: Optional[IO[str]] = None) -> logging.Logger:
    """Configure the ``repro_torch`` logger hierarchy for driver narration.

    The handler writes to **stderr** so stdout stays machine output (CSV
    rows, claim lines, figure paths).  ``verbosity < 0`` -> WARNING
    (``--quiet``), ``0`` -> INFO (default), ``>= 1`` -> DEBUG (``-v``).
    Idempotent: repeated calls adjust the level instead of stacking
    handlers."""
    level = (logging.WARNING if verbosity < 0
             else logging.INFO if verbosity == 0 else logging.DEBUG)
    root = logging.getLogger("repro_torch")
    root.setLevel(level)
    if not any(getattr(h, "_repro_narration", False) for h in root.handlers):
        h = logging.StreamHandler(stream if stream is not None else sys.stderr)
        h.setFormatter(logging.Formatter("%(levelname).1s %(name)s: %(message)s"))
        h._repro_narration = True
        root.addHandler(h)
    root.propagate = False
    return root
