"""Crash-safe streaming sweep orchestrator: chunked engines + checkpoint/
resume + a retry-and-halve ladder.

The port of the JAX package's ``src/repro/core/orchestrator.py``.  Its three
entry points — :func:`run_sweep_tlb`, :func:`run_sweep_system`,
:func:`run_sweep_timeline` — wrap the resumable streams
(:class:`repro_torch.core.sweep.TLBSweepStream`,
:class:`repro_torch.core.sweep.SystemSweepStream`,
:class:`repro_torch.core.timeline.TimelineSweepStream`) in one shared chunk
loop, and return results bit-identical to the monolithic engines:

* **Bounded-memory streaming.**  The trace is consumed in
  ``chunk_accesses``-sized slices (whole blocks); the carried per-config
  state lives in the stream on the data's device.  Each chunk's outputs are
  copied to host result buffers (numpy [B, total]): a checkpoint is host
  bytes.

* **Checkpoint/resume.**  With ``SweepRunConfig.checkpoint_dir`` set, every
  committed chunk atomically replaces one checkpoint blob
  (:func:`repro_torch.checkpoint.checkpoint.write_checkpoint_blob`: write a
  temporary file, fsync, rename, content checksum) holding the carried
  state, the partial results and a JSON meta record.  The blob format
  (``repro-sweep-ckpt-v1``), the array names and the fingerprint (the
  stream's layout, the sha256 of the host trace arrays, the trace length)
  are the reference's, so a sweep checkpointed by either package resumes
  in the other.  On restart with ``resume=True`` the blob is validated and
  the run re-enters at the first uncommitted chunk; a corrupt, truncated,
  foreign-engine or fingerprint-mismatched blob is **refused** with
  :class:`~repro_torch.checkpoint.checkpoint.CheckpointCorruptError`.

* **The ladder.**  A run executes one backend from start to end: the
  decided mode (the kernel on the card, the plain version on the CPU).  On
  a transient fault (:func:`repro_torch.runtime.fault_tolerance.
  is_transient`: the card out of memory, ...) a chunk is retried with
  bounded exponential backoff, then split in half (block-aligned); a
  one-block span that still fails raises its last error.  There is no
  downgrade to the plain version: on the card the kernel runs or the run
  raises.  Every retry and halve is recorded in ``meta["events"]`` and
  logged as a warning.  A build failure, a sticky CUDA error and every
  other non-transient error raise at once.

* **Preemption.**  A :class:`~repro_torch.runtime.fault_tolerance.
  PreemptionHandler` (installed automatically when checkpointing is on)
  turns SIGTERM/SIGINT into a clean checkpoint-and-exit at the next chunk
  boundary, raising :class:`Preempted` (drivers exit with code 75, the
  sysexits.h "temporary failure; rerun with --resume" convention).

The TLB sweep's ``"stackdist"`` backend needs the whole trace and cannot
carry state across chunk boundaries; ``run_sweep_tlb`` runs it
monolithically (``meta["resumable"] = False``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import pathlib
import random
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (
    CheckpointCorruptError,
    read_checkpoint_blob,
    write_checkpoint_blob,
)
from repro_torch.core import benchtime, dispatch
from repro_torch.core.sweep import (
    BatchedSystemEvents,
    BatchedTLBResult,
    SystemSweepStream,
    TLBSweepSpec,
    TLBSweepStream,
    sweep_tlb,
)
from repro_torch.core.timeline import TimelineResult, TimelineSpec, TimelineSweepStream
from repro_torch.core.tlbsim import Device, SystemSimConfig, as_tensor
from repro_torch.runtime import telemetry
from repro_torch.runtime.fault_tolerance import (
    PreemptionHandler,
    backoff_delays,
    is_transient,
)

_LOG = logging.getLogger("repro_torch.core.orchestrator")

# Narration level per ladder event: anything that changes how the run
# executes (retried, split, preempted) is a warning; resuming is the
# expected path of --resume.
_EVENT_LEVELS = {"retry": logging.WARNING, "halve": logging.WARNING,
                 "preempt": logging.WARNING, "resume": logging.INFO}

__all__ = [
    "SweepRunConfig",
    "Preempted",
    "CKPT_FORMAT",
    "run_sweep_tlb",
    "run_sweep_system",
    "run_sweep_timeline",
    "merge_throughput",
]

CKPT_FORMAT = "repro-sweep-ckpt-v1"


class Preempted(BaseException):
    """SIGTERM/SIGINT arrived; state was checkpointed at a chunk boundary.

    A BaseException (like KeyboardInterrupt): the ladder catches transient
    ``Exception``s only, so a preemption can never be mistaken for a
    recoverable fault.
    """

    def __init__(self, checkpoint: Optional[pathlib.Path], now: int, total: int):
        self.checkpoint = checkpoint
        self.now, self.total = now, total
        super().__init__(
            f"preempted at chunk boundary {now}/{total}; "
            + (f"state checkpointed to {checkpoint} — rerun with --resume"
               if checkpoint else "no checkpoint_dir, state discarded"))


@dataclasses.dataclass(frozen=True)
class SweepRunConfig:
    """How a streamed sweep executes (checkpointing, chunking, the ladder).

    ``chunk_accesses`` is the macro-chunk: the trace-slice granularity of
    checkpoint commits (rounded up to a whole number of blocks).
    ``fault_hook(engine, lo, hi, mode, attempt)`` is a test seam invoked
    before every chunk attempt (a fault-injection harness raises simulated
    faults there); ``on_chunk_committed(chunk_idx)`` fires after a chunk's
    checkpoint is durably on disk (a harness raises a simulated hard kill
    there).

    ``calibration_dir`` points ``kernel_mode="auto"`` at a measured-rate
    calibration table directory (:mod:`repro_torch.core.dispatch`) and feeds
    achieved rates back into it after every run.  ``None`` (the default)
    keeps decisions on the cold-start rules.
    """

    checkpoint_dir: Optional[str] = None
    calibration_dir: Optional[str] = None
    resume: bool = False
    chunk_accesses: int = 65_536
    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    keep_checkpoint: bool = False
    preemption: Optional[PreemptionHandler] = None
    fault_hook: Optional[Callable] = None
    on_chunk_committed: Optional[Callable] = None
    rng_seed: Optional[int] = 0   # backoff jitter; None -> wall-clock seeded


def _fingerprint_json(fp: dict) -> str:
    return json.dumps(fp, sort_keys=True)


def _host(x) -> np.ndarray:
    """A chunk output (tensor on any device, or numpy) as a host array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _ChunkRunner:
    """The shared chunk loop: ladder + checkpointing around one stream."""

    def __init__(self, stream, total: int, out_names: Sequence[str],
                 out_dtypes: Sequence, run_chunk: Callable, start_mode: str,
                 cfg: SweepRunConfig, *, name: str, trace_sha: str,
                 decision: Optional[dispatch.DispatchDecision] = None):
        self.stream = stream
        self.decision = decision
        self.total = int(total)
        self.out_names = tuple(out_names)
        self.run_chunk = run_chunk     # (lo, hi, mode) -> tuple of [B, hi - lo]
        self.cfg = cfg
        self.name = name
        self.batch = stream.batch_size
        self.bufs = [np.zeros((self.batch, self.total), dt) for dt in out_dtypes]
        # mode -> {chunks, accesses, sim_accesses, elapsed_s}: achieved
        # throughput per backend actually executed (meta()["throughput"]).
        self.throughput: dict = {}
        self.mode = start_mode
        self.events: List[dict] = []
        self.chunks_committed = 0
        self.resumed_from: Optional[int] = None
        self._rng = random.Random(cfg.rng_seed)
        fp = dict(stream.fingerprint())
        fp["trace_sha256"] = trace_sha
        fp["total"] = self.total
        self._fp = _fingerprint_json(fp)
        self.path = (pathlib.Path(cfg.checkpoint_dir) / f"{name}.ckpt"
                     if cfg.checkpoint_dir else None)

    # -- checkpointing ------------------------------------------------------

    def _meta(self, completed: bool, *, chunks_committed: Optional[int] = None) -> dict:
        return {
            "format": CKPT_FORMAT,
            "engine": self.stream.engine,
            "name": self.name,
            "fingerprint": self._fp,
            "now": int(self.stream.now),
            "total": self.total,
            "completed": completed,
            "mode": self.mode,
            "events": self.events,
            "chunks_committed": (self.chunks_committed if chunks_committed is None
                                 else chunks_committed),
            "dispatch": self.decision.to_json() if self.decision is not None else None,
        }

    def _write_checkpoint(self, completed: bool, *,
                          chunks_committed: Optional[int] = None) -> None:
        if self.path is None:
            return
        arrays = {f"s_{k}": v for k, v in self.stream.export_state().items()}
        now = int(self.stream.now)
        for nm, buf in zip(self.out_names, self.bufs):
            arrays[f"r_{nm}"] = buf[:, :now]
        write_checkpoint_blob(self.path, arrays,
                              self._meta(completed, chunks_committed=chunks_committed))

    def try_resume(self) -> Optional[dict]:
        """Load the checkpoint if resuming.  Returns the blob meta when the
        checkpointed run had already completed (results restored), else
        None; raises :class:`CheckpointCorruptError` on a corrupt or
        mismatched blob."""
        if not (self.cfg.resume and self.path is not None and self.path.exists()):
            return None
        arrays, meta = read_checkpoint_blob(self.path)
        if meta.get("format") != CKPT_FORMAT or meta.get("engine") != self.stream.engine:
            raise CheckpointCorruptError(
                f"checkpoint {self.path} was written by "
                f"{meta.get('engine')!r}/{meta.get('format')!r}, not "
                f"{self.stream.engine!r}/{CKPT_FORMAT!r}; refusing to resume "
                f"from it — delete it deliberately (or start without "
                f"--resume) to begin a fresh run")
        if meta.get("fingerprint") != self._fp:
            raise CheckpointCorruptError(
                f"checkpoint {self.path} was taken on a different sweep "
                f"layout or trace (fingerprint mismatch); refusing to resume "
                f"from it — delete it deliberately (or start without "
                f"--resume) to begin a fresh run")
        self.stream.import_state({k[2:]: v for k, v in arrays.items() if k.startswith("s_")})
        now = int(self.stream.now)
        for nm, buf in zip(self.out_names, self.bufs):
            buf[:, :now] = arrays[f"r_{nm}"]
        self.events = list(meta.get("events", []))
        # The carried state is the same for every backend, so the blob never
        # chooses this run's: this run goes on with its own decided mode (the
        # kernel on the card, even from a blob the plain version wrote on the
        # CPU).  Where the blob ran that same mode, its decision is kept as
        # the record.
        blob_mode = meta.get("mode")
        dd = meta.get("dispatch")
        if dd:
            blob_dec = dispatch.DispatchDecision.from_json(dd)
            if blob_dec.mode == self.mode:
                self.decision = dataclasses.replace(
                    blob_dec, reason=blob_dec.reason + " (reused from checkpoint)",
                    calibration=f"checkpoint:{blob_dec.calibration}")
        self.chunks_committed = int(meta.get("chunks_committed", 0))
        self.resumed_from = now
        self._log("resume", now, self.total, chunks_committed=self.chunks_committed,
                  completed=bool(meta.get("completed")), blob_mode=blob_mode)
        return meta if meta.get("completed") else None

    # -- the ladder ---------------------------------------------------------

    def _commit(self, lo: int, hi: int, outs) -> None:
        for buf, out in zip(self.bufs, outs):
            buf[:, lo:hi] = out
        # The blob (written with the incremented count) is the commit point:
        # the in-memory counter moves only once the write has succeeded.
        t0 = time.perf_counter()
        self._write_checkpoint(completed=False, chunks_committed=self.chunks_committed + 1)
        self.chunks_committed += 1
        if self.path is not None:
            telemetry.get_tracer().event(
                "checkpoint_write", engine=self.stream.engine, name=self.name,
                chunk=self.chunks_committed, dur_s=round(time.perf_counter() - t0, 6))
        if self.cfg.on_chunk_committed is not None:
            self.cfg.on_chunk_committed(self.chunks_committed - 1)
        pre = self.cfg.preemption
        if pre is not None and pre.requested:
            self._log("preempt", int(self.stream.now), self.total,
                      chunks_committed=self.chunks_committed)
            raise Preempted(self.path, int(self.stream.now), self.total)

    def _log(self, event: str, lo: int, hi: int, **kw) -> None:
        """Record one ladder event into meta["events"], the telemetry run
        log, and the narration logger, with a wall-clock (``ts``) and a
        monotonic (``t_mono``) stamp."""
        rec = {"event": event, "lo": int(lo), "hi": int(hi),
               "mode": self.mode,
               "ts": time.time(), "t_mono": time.perf_counter(), **kw}
        self.events.append(rec)
        telemetry.get_tracer().event(
            event, engine=self.stream.engine, name=self.name,
            **{k: v for k, v in rec.items() if k not in ("event", "ts", "t_mono")})
        _LOG.log(_EVENT_LEVELS.get(event, logging.INFO), "%s[%s] %s [%d, %d) mode=%s%s",
                 self.stream.engine, self.name, event, rec["lo"], rec["hi"], rec["mode"],
                 "".join(f" {k}={v}" for k, v in kw.items()))

    def _note_chunk(self, lo: int, hi: int, mode: str, attempt: int, dur_s: float) -> None:
        """Account a successful chunk attempt: per-mode throughput (always)
        plus a telemetry chunk span (when a run is active)."""
        n = int(hi - lo)
        agg = self.throughput.setdefault(
            mode, {"chunks": 0, "accesses": 0, "sim_accesses": 0, "elapsed_s": 0.0})
        agg["chunks"] += 1
        agg["accesses"] += n
        agg["sim_accesses"] += n * self.batch
        agg["elapsed_s"] += dur_s
        telemetry.get_tracer().record_span(
            "chunk", dur_s, engine=self.stream.engine, name=self.name,
            lo=int(lo), hi=int(hi), mode=mode, attempt=attempt,
            accesses=n, configs=self.batch,
            accesses_per_s=round(n / dur_s, 1) if dur_s > 0 else None,
            sim_accesses_per_s=round(n * self.batch / dur_s, 1) if dur_s > 0 else None)

    def _exec(self, lo: int, hi: int) -> None:
        """Run span [lo, hi) through retries, then halving; a one-block span
        whose retries all fail raises its last error."""
        delays = backoff_delays(self.cfg.max_retries, base_s=self.cfg.backoff_base_s,
                                cap_s=self.cfg.backoff_cap_s, rng=self._rng)
        last_exc: Optional[Exception] = None
        for attempt in range(self.cfg.max_retries + 1):
            mode = self.mode
            # Only the chunk attempt itself may be retried, and only while
            # the stream still stands at `lo`: once it has advanced, a retry
            # would apply the chunk twice.  _commit stays outside the try: a
            # failed checkpoint write propagates, leaving the previous blob
            # as the resume point.  The copy of the outputs to the host is
            # inside, so the chunk's time includes its kernels.
            t0 = time.perf_counter()
            try:
                if self.cfg.fault_hook is not None:
                    self.cfg.fault_hook(self.stream.engine, lo, hi, mode, attempt)
                outs = tuple(_host(o) for o in self.run_chunk(lo, hi, mode))
            except Exception as exc:
                if not is_transient(exc) or int(self.stream.now) != lo:
                    raise
                last_exc = exc
                self._log("retry", lo, hi, attempt=attempt,
                          elapsed_s=round(time.perf_counter() - t0, 6),
                          error=f"{type(exc).__name__}: {exc}")
                if attempt < self.cfg.max_retries:
                    time.sleep(delays[attempt])
                continue
            self._note_chunk(lo, hi, mode, attempt, time.perf_counter() - t0)
            self._commit(lo, hi, outs)
            return
        # Retries exhausted.  Halve if the span is more than one block, else
        # raise.
        block = self.stream.block
        if hi - lo > block:
            half = ((hi - lo) // 2 // block) * block
            mid = lo + max(half, block)
            self._log("halve", lo, hi, mid=int(mid))
            self._exec(lo, mid)
            self._exec(mid, hi)
            return
        raise last_exc

    # -- the loop -----------------------------------------------------------

    def run(self) -> dict:
        block = self.stream.block
        chunk = max(int(self.cfg.chunk_accesses), 1)
        chunk += (-chunk) % block   # whole blocks per macro-chunk
        while self.stream.now < self.total:
            lo = int(self.stream.now)
            self._exec(lo, min(lo + chunk, self.total))
        if self.path is not None and not self.cfg.keep_checkpoint and not self.cfg.resume:
            # A fresh run that finished cleanly leaves no blob behind unless
            # asked to.
            try:
                os.remove(self.path)
            except OSError:
                pass
        else:
            # keep_checkpoint or --resume: the completed blob stays, so an
            # identical rerun is a pure checkpoint read.
            self._write_checkpoint(completed=True)
        return self.meta()

    def meta(self, *, completed_from_checkpoint: bool = False) -> dict:
        return {
            "engine": self.stream.engine,
            "resumable": True,
            "start_mode": self.mode,
            "final_mode": self.mode,
            "events": self.events,
            "chunks_committed": self.chunks_committed,
            "resumed_from": self.resumed_from,
            "completed_from_checkpoint": completed_from_checkpoint,
            "checkpoint": str(self.path) if self.path else None,
            "throughput": _throughput_meta(self.throughput),
            "dispatch": self.decision.to_json() if self.decision is not None else None,
        }


def _throughput_meta(agg_by_mode: dict) -> dict:
    """Finish the per-mode accumulators into achieved accesses/s (trace
    accesses and simulated config x access pairs per second of engine wall
    time)."""
    out = {}
    for mode, a in agg_by_mode.items():
        dt = a["elapsed_s"]
        out[mode] = {
            "chunks": a["chunks"], "accesses": a["accesses"],
            "sim_accesses": a["sim_accesses"], "elapsed_s": round(dt, 6),
            "accesses_per_s": round(a["accesses"] / dt, 1) if dt > 0 else None,
            "sim_accesses_per_s": round(a["sim_accesses"] / dt, 1) if dt > 0 else None,
        }
    return out


def merge_throughput(metas: Sequence[dict]) -> dict:
    """Merge the ``meta["throughput"]`` stamps of several runs into one
    per-mode aggregate with recomputed achieved rates."""
    agg: dict = {}
    for m in metas:
        for mode, d in (m.get("throughput") or {}).items():
            a = agg.setdefault(mode, {"chunks": 0, "accesses": 0,
                                      "sim_accesses": 0, "elapsed_s": 0.0})
            for k in a:
                a[k] += d[k]
    return _throughput_meta(agg)


def _sha256_arrays(*arrays: np.ndarray) -> str:
    """The reference's trace digest: dtype, shape and bytes of each host
    array in turn."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _maybe_handler(cfg: SweepRunConfig) -> Tuple[SweepRunConfig, Optional[PreemptionHandler]]:
    """Install a PreemptionHandler for the duration of a checkpointing run
    when the caller did not supply one."""
    if cfg.checkpoint_dir is None or cfg.preemption is not None:
        return cfg, None
    handler = PreemptionHandler()
    return dataclasses.replace(cfg, preemption=handler), handler


def _run_streamed(runner: _ChunkRunner, store, name: str) -> dict:
    done = runner.try_resume()
    meta = runner.meta(completed_from_checkpoint=True) if done else runner.run()
    dispatch.observe(runner.decision, meta.get("throughput") or {}, store=store, name=name)
    return meta


def run_sweep_tlb(
    addrs,
    specs: Sequence[TLBSweepSpec],
    *,
    warmup_frac: float = 0.25,
    kernel_mode: str = "auto",
    block: int = 512,
    run: SweepRunConfig = SweepRunConfig(),
    name: str = "sweep_tlb",
    device: Device = "cuda",
) -> Tuple[BatchedTLBResult, dict]:
    """Crash-safe :func:`repro_torch.core.sweep.sweep_tlb`.

    Returns ``(BatchedTLBResult, meta)``, the hits bit-identical to the
    monolithic engine's (streamed: a host tensor, the result buffer).
    ``"stackdist"`` (and ``"auto"`` resolving to it) runs monolithically:
    the stack-distance engine needs the whole trace, so it is not resumable
    (``meta["resumable"] = False``) and its hits stay on ``device``.
    """
    host = _host(addrs)
    n = int(host.shape[0])
    store = dispatch.store_for(run.calibration_dir, device)
    decision = dispatch.decide_tlb(kernel_mode, specs, n_accesses=n, store=store,
                                   device=device)
    dispatch.record_decision(decision, name=name)
    mode = decision.mode
    if mode == "stackdist":
        # Monolithic, but still measured: its achieved rate lands in
        # meta["throughput"] and one whole-trace "chunk" span.
        t0 = time.perf_counter()
        res = sweep_tlb(addrs, specs, warmup_frac=warmup_frac, kernel_mode=mode,
                        device=device)
        benchtime.block(res)
        dur = time.perf_counter() - t0
        telemetry.get_tracer().record_span(
            "chunk", dur, engine="sweep_tlb", name=name, lo=0, hi=n, mode=mode,
            attempt=0, accesses=n, configs=len(specs),
            accesses_per_s=round(n / dur, 1) if dur > 0 else None,
            sim_accesses_per_s=round(n * len(specs) / dur, 1) if dur > 0 else None)
        throughput = _throughput_meta({mode: {"chunks": 1, "accesses": n,
                                              "sim_accesses": n * len(specs),
                                              "elapsed_s": dur}})
        dispatch.observe(decision, throughput, store=store, name=name)
        return res, {"engine": "sweep_tlb", "resumable": False, "start_mode": mode,
                     "final_mode": mode, "events": [], "chunks_committed": 0,
                     "resumed_from": None, "completed_from_checkpoint": False,
                     "checkpoint": None, "throughput": throughput,
                     "dispatch": decision.to_json()}

    run, handler = _maybe_handler(run)
    try:
        stream = TLBSweepStream(specs, block=block, device=device)
        trace = as_tensor(addrs, stream.device)
        runner = _ChunkRunner(
            stream, n, ("hits",), (bool,),
            lambda lo, hi, m: (stream.run_chunk(trace[lo:hi], kernel_mode=m),),
            mode, run, name=name, trace_sha=_sha256_arrays(host), decision=decision)
        meta = _run_streamed(runner, store, name)
        n0 = int(n * warmup_frac)
        return BatchedTLBResult(hits=torch.from_numpy(runner.bufs[0]), n_warm=n - n0), meta
    finally:
        if handler is not None:
            handler.uninstall()


def run_sweep_system(
    lines,
    cfgs: Sequence[SystemSimConfig],
    *,
    warmup_frac: float = 0.25,
    kernel_mode: str = "auto",
    block: int = 512,
    run: SweepRunConfig = SweepRunConfig(),
    name: str = "sweep_system",
    device: Device = "cuda",
) -> Tuple[BatchedSystemEvents, dict]:
    """Crash-safe :func:`repro_torch.core.sweep.sweep_system`; returns
    ``(BatchedSystemEvents, meta)``, bit-identical to the monolithic engine
    (host tensors, the result buffers)."""
    host = _host(lines)
    n = int(host.shape[0])
    store = dispatch.store_for(run.calibration_dir, device)
    decision = dispatch.decide_system(kernel_mode, cfgs, n_accesses=n, store=store,
                                      device=device)
    dispatch.record_decision(decision, name=name)
    run, handler = _maybe_handler(run)
    try:
        stream = SystemSweepStream(cfgs, block=block, device=device)
        trace = as_tensor(lines, stream.device)
        runner = _ChunkRunner(
            stream, n, ("cache_hit", "accel_tlb_hit", "mem_tlb_hit"), (bool, bool, bool),
            lambda lo, hi, m: stream.run_chunk(trace[lo:hi], kernel_mode=m),
            decision.mode, run, name=name, trace_sha=_sha256_arrays(host),
            decision=decision)
        meta = _run_streamed(runner, store, name)
        n0 = int(n * warmup_frac)
        return BatchedSystemEvents(*(torch.from_numpy(b) for b in runner.bufs),
                                   n_warm=n - n0), meta
    finally:
        if handler is not None:
            handler.uninstall()


def run_sweep_timeline(
    specs: Sequence[TimelineSpec],
    lat=None,
    *,
    kernel_mode: str = "auto",
    block: int = 512,
    run: SweepRunConfig = SweepRunConfig(),
    name: str = "sweep_timeline",
    device: Device = "cuda",
) -> Tuple[List[TimelineResult], dict]:
    """Crash-safe :func:`repro_torch.core.timeline.sweep_timeline`; returns
    ``(results, meta)``, bit-identical to the monolithic engine."""
    store = dispatch.store_for(run.calibration_dir, device)
    n_acc = max((len(sp.lines) for sp in specs), default=0) if specs else None
    decision = dispatch.decide_timeline(kernel_mode, batch=len(specs), n_accesses=n_acc,
                                        store=store, device=device)
    dispatch.record_decision(decision, name=name)
    run, handler = _maybe_handler(run)
    try:
        stream = TimelineSweepStream(specs, lat, block=block, device=device)
        runner = _ChunkRunner(
            stream, stream.n, ("latency", "overhead", "done"),
            (np.float32, np.float32, np.float32),
            lambda lo, hi, m: stream.run_chunk(lo, hi, kernel_mode=m),
            decision.mode, run, name=name,
            trace_sha=_sha256_arrays(*stream.host_columns), decision=decision)
        meta = _run_streamed(runner, store, name)
        return stream.finalize(*runner.bufs), meta
    finally:
        if handler is not None:
            handler.uninstall()
