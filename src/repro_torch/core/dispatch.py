"""Cost-model backend dispatch: one calibrated selection layer for the sweeps.

The port of the JAX package's ``src/repro/core/dispatch.py``.  Every engine
resolves ``kernel_mode="auto"`` here, and the orchestrator feeds back what
each backend achieved:

* :class:`DispatchDecision` — the one decision object: requested mode,
  chosen mode, per-candidate predicted rates, calibration provenance and a
  human-readable reason.  It is JSON-able end to end (the reference's
  fields), so the orchestrator records it as a telemetry event and stamps it
  into checkpoint blob meta (resume reuses it: a calibration table that
  changed between runs can never flip the backend mid-stream).

* **Analytic cost model.**  Per engine the work is ``sim_accesses = batch x
  trace length`` and the predicted runtime of a backend is ``sim_accesses /
  rate``, where ``rate`` is a calibrated per-(device kind, engine, mode,
  batch bucket) constant in simulated accesses per second.  Buckets are
  ``"b1"`` (batch <= 1) and ``"bN"``.

* :class:`CalibrationStore` — per-device JSON tables under a caller-chosen
  directory, keyed by ``torch.cuda.get_device_name`` (through
  :func:`repro_torch.core.benchtime.device_metadata`) and written with the
  checkpoint-blob header discipline (one ASCII header line
  ``repro-dispatch-calib-v1 sha256:<hex>`` pinning the payload digest).  A
  corrupt or foreign file is **refused** with
  :class:`CalibrationCorruptError`, never silently regenerated.  The table is
  seeded only from the port's own measurements: its run logs
  (:func:`ingest_runlogs`), its own benchmark rows
  (:func:`ingest_bench_entries`) and the orchestrator's runs
  (:func:`observe`), never from the reference's TPU/CPU rows.

* **Cold start.**  With no calibration (or no measurement for the would-be
  default) ``decide_*`` takes :func:`cold_start_mode`: the stack-distance
  engine for a TLB sweep whose specs all have at most
  :data:`repro_torch.core.stackdist.AUTO_MAX_WAYS` ways, otherwise the
  kernel (``"cuda"``) for data on the card and the plain version
  (``"reference"``) on the CPU.  The reference's single-sim timeline rule
  (batch <= 1 takes its scan, because a TPU ran its kernel at 0.87x there)
  is not copied: on the H100 the timeline kernel at one sim is ~1,800x its
  plain version, so the timeline takes the kernel at every batch size.  A
  calibrated choice is only taken when the cold-start default itself has a
  measured rate and at least one rival does too.

The candidates are the modes ``"auto"`` may take on the data's device:
``"cuda"`` on the card and ``"reference"`` on the CPU, and ``"stackdist"``
for an eligible TLB sweep on either.  The plain version is no candidate on
the card, whatever a table says of it: there ``"auto"`` launches a kernel,
so the one calibrated choice on the card is a TLB sweep's stack-distance
engine against the LRU kernel.  The reference's ``"pallas"`` reads as
``"cuda"``; it has no interpret mode to offer.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import pathlib
import re
import time
import uuid
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import stackdist
from repro_torch.core.tlbsim import Device, _geom
from repro_torch.kernels.common import SWEEP_MODES, VALID_MODES
from repro_torch.kernels.system_sim import resolve_system_mode
from repro_torch.kernels.timeline import resolve_timeline_mode
from repro_torch.runtime import telemetry

_LOG = logging.getLogger("repro_torch.core.dispatch")

__all__ = [
    "CALIB_FORMAT",
    "DispatchDecision",
    "CalibrationStore",
    "CalibrationCorruptError",
    "default_mode",
    "cold_start_mode",
    "stackdist_eligible",
    "decide_tlb",
    "decide_system",
    "decide_timeline",
    "observe",
    "record_decision",
    "store_for",
    "gc_calibration",
    "ingest_bench_entries",
    "ingest_runlogs",
]

# Header magic of a calibration table file (the checkpoint-blob discipline:
# `<magic> sha256:<hex>\n` + payload; bump on incompatible payload changes).
CALIB_FORMAT = "repro-dispatch-calib-v1"
SCHEMA_VERSION = 1

# The three orchestrated engines this layer dispatches for.
ENGINES = ("sweep_tlb", "sweep_system", "sweep_timeline")

# A calibrated rate is trusted for prediction only above this much measured
# work: a single tiny smoke chunk should not steer real sweeps.
MIN_CALIB_WEIGHT = 1_000.0

# When merging a new measurement into a stored rate, the stored weight is
# capped at this multiple of the new one so the table keeps adapting.
_MAX_OLD_WEIGHT_RATIO = 10.0

# The device stamp of a table measured on the host CPU.
CPU_DEVICE = {"platform": "cpu", "device_kind": "cpu"}


class CalibrationCorruptError(RuntimeError):
    """A calibration table failed validation (truncated, bit-flipped, or not
    a calibration file at all).  Deliberately raised, never silently
    regenerated: delete the file deliberately to start cold."""


def _on_card(device: Device) -> bool:
    return torch.device(device).type == "cuda"


def default_mode(device: Device = "cuda") -> str:
    """The generic cold-start rule: the kernel for data on the card, the
    plain version on the CPU."""
    return "cuda" if _on_card(device) else "reference"


def stackdist_eligible(specs: Sequence) -> bool:
    """May ``"auto"`` consider the exact stack-distance backend for this TLB
    sweep?  Every spec is a pure-LRU TLB, so eligibility is the associativity
    staying within the capped-stack state (:data:`stackdist.AUTO_MAX_WAYS`).
    A hard shape constraint, which calibration never overrides."""
    return max(sp.cfg.effective_ways for sp in specs) <= stackdist.AUTO_MAX_WAYS


def cold_start_mode(engine: str, *, batch: int = 1, eligible_stackdist: bool = False,
                    device: Device = "cuda") -> str:
    """The ``"auto"`` heuristics with no measurement: ``"stackdist"`` for an
    eligible TLB sweep, else :func:`default_mode` for every engine and
    batch size (``batch`` is accepted for the reference's signature; no rule
    here depends on it)."""
    del batch
    if engine == "sweep_tlb" and eligible_stackdist:
        return "stackdist"
    return default_mode(device)


def _bucket(batch: int) -> str:
    return "b1" if batch <= 1 else "bN"


def _concrete(kernel_mode: str, device: Device, valid: Sequence[str],
              engine_check=None) -> Optional[str]:
    """Validate ``kernel_mode`` for an engine on ``device`` without touching
    the card; ``None`` for ``"auto"``, else the mode.  ``engine_check`` is
    the engine's own validator, which raises its own error for a sweep-only
    mode."""
    if engine_check is not None and kernel_mode in SWEEP_MODES \
            and kernel_mode not in VALID_MODES:
        engine_check(kernel_mode, device)
    if kernel_mode not in valid:
        raise ValueError(f"kernel_mode={kernel_mode!r}; expected one of {tuple(valid)}")
    if kernel_mode == "cuda" and not _on_card(device):
        raise ValueError(f"kernel_mode='cuda' needs data on a CUDA device, "
                         f"got device={str(device)!r}")
    return None if kernel_mode == "auto" else kernel_mode


# ---------------------------------------------------------------------------
# The decision object.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DispatchDecision:
    """One resolved backend choice: what was asked, what was chosen, what
    every candidate was predicted to achieve, and why.

    ``candidates`` maps each considered mode to ``{"rate": sim_accesses/s |
    None, "predicted_s": float | None}`` (rate from the calibration table;
    ``None`` = no trusted measurement).  ``calibration`` is the provenance:
    ``"explicit"`` (mode was not ``"auto"``), ``"cold_start"`` or
    ``"measured:<table path>"``.
    """

    engine: str
    requested: str
    mode: str
    candidates: Dict[str, dict]
    calibration: str
    reason: str
    features: Dict[str, object]

    def to_json(self) -> dict:
        return {
            "engine": self.engine, "requested": self.requested,
            "mode": self.mode, "candidates": self.candidates,
            "calibration": self.calibration, "reason": self.reason,
            "features": self.features,
        }

    @classmethod
    def from_json(cls, d: dict) -> "DispatchDecision":
        return cls(
            engine=str(d.get("engine")), requested=str(d.get("requested")),
            mode=str(d.get("mode")), candidates=dict(d.get("candidates") or {}),
            calibration=str(d.get("calibration", "?")),
            reason=str(d.get("reason", "")),
            features=dict(d.get("features") or {}))


# ---------------------------------------------------------------------------
# Calibration store: per-device rate tables with blob-header integrity.
# ---------------------------------------------------------------------------


def _slug(s: str) -> str:
    return re.sub(r"[^a-z0-9]+", "-", str(s).lower()).strip("-") or "unknown"


def _write_table(path: pathlib.Path, payload: dict) -> None:
    body = json.dumps(payload, sort_keys=True, indent=1).encode()
    header = f"{CALIB_FORMAT} sha256:{hashlib.sha256(body).hexdigest()}\n".encode()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp-{uuid.uuid4().hex[:8]}")
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(body)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_table(path: pathlib.Path) -> dict:
    data = path.read_bytes()
    nl = data.find(b"\n")
    refusal = ("refusing to use it — delete the file deliberately to start "
               "from a cold (heuristic) table")
    if nl < 0:
        raise CalibrationCorruptError(
            f"calibration table {path} has no header line (truncated?); {refusal}")
    try:
        magic, digest_field = data[:nl].decode("ascii").split(" ", 1)
    except (UnicodeDecodeError, ValueError):
        raise CalibrationCorruptError(
            f"calibration table {path} header is unparseable; {refusal}") from None
    if magic != CALIB_FORMAT or not digest_field.startswith("sha256:"):
        raise CalibrationCorruptError(
            f"calibration table {path} is not a {CALIB_FORMAT} file "
            f"(header {data[:nl][:64]!r}); {refusal}")
    body = data[nl + 1:]
    if hashlib.sha256(body).hexdigest() != digest_field[len("sha256:"):]:
        raise CalibrationCorruptError(
            f"calibration table {path} failed its content checksum "
            f"(truncated or bit-flipped); {refusal}")
    try:
        payload = json.loads(body.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CalibrationCorruptError(
            f"calibration table {path} payload is undecodable ({e}); {refusal}") from e
    if not isinstance(payload, dict):
        raise CalibrationCorruptError(
            f"calibration table {path} payload is not an object; {refusal}")
    return payload


class CalibrationStore:
    """One device's measured-rate table: ``calib-<device slug>.json`` under
    a calibration directory, read lazily with an mtime cache and updated by
    locked read-modify-write (concurrent runs serialize instead of losing
    appends)."""

    def __init__(self, path, *, device: Optional[dict] = None):
        self.path = pathlib.Path(path)
        self.device = dict(device or {})
        self._cache: Optional[Tuple[float, dict]] = None

    @classmethod
    def for_dir(cls, root, *, device: Optional[dict] = None) -> "CalibrationStore":
        """The per-device table under ``root`` for the card
        (``benchtime.device_metadata()``, which raises without one) or an
        explicit ``device`` stamp."""
        if device is None:
            from repro_torch.core.benchtime import device_metadata

            device = device_metadata()
        kind = device.get("device_kind", "unknown")
        return cls(pathlib.Path(root) / f"calib-{_slug(kind)}.json", device=device)

    @property
    def device_kind(self) -> str:
        return str(self.device.get("device_kind", "unknown"))

    def load(self) -> dict:
        """The table payload (an empty skeleton when the file does not
        exist).  Raises :class:`CalibrationCorruptError` on a corrupt or
        foreign file; never silently regenerates."""
        try:
            mtime = self.path.stat().st_mtime
        except OSError:
            return {"format": CALIB_FORMAT, "schema_version": SCHEMA_VERSION,
                    "device": self.device, "rates": {}}
        if self._cache is not None and self._cache[0] == mtime:
            return self._cache[1]
        payload = _read_table(self.path)
        self._cache = (mtime, payload)
        return payload

    def exists(self) -> bool:
        return self.path.exists()

    def describe(self) -> str:
        """Provenance string for decisions made against this table."""
        return f"measured:{self.path}" if self.exists() else "cold_start"

    def rate(self, engine: str, mode: str, batch: int) -> Optional[float]:
        """Trusted calibrated rate (sim accesses/s) or ``None``."""
        rec = (self.load().get("rates", {}).get(engine, {})
               .get(mode, {}).get(_bucket(batch)))
        if not rec or float(rec.get("weight", 0.0)) < MIN_CALIB_WEIGHT:
            return None
        r = rec.get("rate")
        return float(r) if r and r > 0 else None

    def record(self, engine: str, mode: str, batch: int, rate: float,
               *, weight: float) -> None:
        self.record_many([(engine, mode, batch, rate, weight)])

    def record_many(self, rows: Iterable[Tuple[str, str, int, float, float]]) -> None:
        """Merge measured ``(engine, mode, batch, rate, weight)`` rows into
        the table in one locked read-modify-write.  Weights are simulated
        accesses; the stored weight is capped at ``_MAX_OLD_WEIGHT_RATIO x``
        the incoming one so the table adapts."""
        rows = [r for r in rows if r[3] and r[3] > 0 and r[4] > 0]
        if not rows:
            return
        from repro_torch.checkpoint.checkpoint import file_lock

        with file_lock(self.path.with_name(self.path.name + ".lock")):
            self._cache = None
            payload = self.load()
            payload.setdefault("format", CALIB_FORMAT)
            payload.setdefault("schema_version", SCHEMA_VERSION)
            payload.setdefault("device", self.device)
            rates = payload.setdefault("rates", {})
            for engine, mode, batch, rate, weight in rows:
                rec = (rates.setdefault(engine, {}).setdefault(mode, {})
                       .setdefault(_bucket(batch), {}))
                w_old = min(float(rec.get("weight", 0.0)),
                            _MAX_OLD_WEIGHT_RATIO * float(weight))
                r_old = float(rec.get("rate", 0.0))
                w_new = float(weight)
                rec["rate"] = (r_old * w_old + float(rate) * w_new) / (w_old + w_new)
                rec["weight"] = float(rec.get("weight", 0.0)) + w_new
                rec["n"] = int(rec.get("n", 0)) + 1
                rec["updated_at"] = time.strftime("%Y-%m-%d %H:%M:%S")
            _write_table(self.path, payload)
        self._cache = None


def store_for(calibration_dir, device: Device = "cuda") -> Optional[CalibrationStore]:
    """A :class:`CalibrationStore` for ``calibration_dir`` and the device the
    data lies on (the card's own table, or :data:`CPU_DEVICE`'s), or
    ``None`` when no directory is configured (cold-start decisions only)."""
    if not calibration_dir:
        return None
    return CalibrationStore.for_dir(
        calibration_dir, device=None if _on_card(device) else CPU_DEVICE)


# ---------------------------------------------------------------------------
# The decision core.
# ---------------------------------------------------------------------------


def _candidates(device: Device, eligible_stackdist: bool = False) -> List[str]:
    out = [] if _on_card(device) else ["reference"]
    if eligible_stackdist:
        out.append("stackdist")
    if _on_card(device):
        out.append("cuda")
    return out


def _decide(engine: str, requested: str, concrete: Optional[str], *,
            candidates: Sequence[str], cold: str, batch: int,
            n_accesses: Optional[int], features: Dict[str, object],
            store: Optional[CalibrationStore]) -> DispatchDecision:
    feats = {"batch": int(batch), "n_accesses": n_accesses,
             "sim_accesses": int(batch) * int(n_accesses) if n_accesses else None,
             **features}
    if store is not None:
        feats.setdefault("device_kind", store.device_kind)
    sim = feats["sim_accesses"]

    cand: Dict[str, dict] = {}
    for m in candidates:
        r = store.rate(engine, m, batch) if store is not None else None
        cand[m] = {"rate": round(r, 1) if r else None,
                   "predicted_s": round(sim / r, 6) if r and sim else None}

    if concrete is not None:   # explicit mode: honoured as given
        cand.setdefault(concrete, {"rate": None, "predicted_s": None})
        return DispatchDecision(
            engine=engine, requested=requested, mode=concrete, candidates=cand,
            calibration="explicit", reason=f"kernel_mode={requested!r} given explicitly",
            features=feats)

    measured = {m: c["rate"] for m, c in cand.items() if c["rate"]}
    if cold in measured and len(measured) >= 2:
        chosen = max(measured, key=measured.get)
        ordered = ", ".join(f"{m}={measured[m]:.3g}/s"
                            for m in sorted(measured, key=measured.get, reverse=True))
        return DispatchDecision(
            engine=engine, requested=requested, mode=chosen, candidates=cand,
            calibration=store.describe(),
            reason=(f"calibrated: fastest measured backend ({ordered}); "
                    f"cold-start default was {cold!r}"),
            features=feats)
    why = ("no calibration table" if store is None or not store.exists()
           else f"default {cold!r} not measured yet"
           if cold not in measured else "no measured rival to compare")
    return DispatchDecision(
        engine=engine, requested=requested, mode=cold, candidates=cand,
        calibration="cold_start" if store is None or not store.exists()
        else store.describe(),
        reason=f"cold-start heuristic ({why})", features=feats)


def decide_tlb(kernel_mode: str, specs: Sequence, *, n_accesses: Optional[int] = None,
               store: Optional[CalibrationStore] = None,
               device: Device = "cuda") -> DispatchDecision:
    """Backend decision for the TLB sweep (``SWEEP_MODES``, including the
    sweep-only exact stack-distance engine when every spec is eligible)."""
    concrete = _concrete(kernel_mode, device, SWEEP_MODES)
    eligible = stackdist_eligible(specs)
    geoms = [sp.geometry for sp in specs]
    features = {
        "words_per_access": 3,
        "state_bytes": 4 * sum(2 * (g[0] + 1) * g[1] for g in geoms),
        "stackdist_eligible": eligible,
    }
    return _decide(
        "sweep_tlb", kernel_mode, concrete,
        candidates=_candidates(device, eligible),
        cold=cold_start_mode("sweep_tlb", batch=len(specs),
                             eligible_stackdist=eligible, device=device),
        batch=len(specs), n_accesses=n_accesses, features=features, store=store)


def decide_system(kernel_mode: str, cfgs: Sequence, *, n_accesses: Optional[int] = None,
                  store: Optional[CalibrationStore] = None,
                  device: Device = "cuda") -> DispatchDecision:
    """Backend decision for the joint system sweep.  Sweep-only modes raise
    the engine's own error (stack inclusion does not hold for
    cache-hit-conditional probes)."""
    concrete = _concrete(kernel_mode, device, VALID_MODES, resolve_system_mode)
    state = 0
    for c in cfgs:
        cs, cw = _geom(c.cache)
        asets, aw = _geom(c.accel_tlb)
        ms, mw = _geom(c.mem_tlb)
        state += 2 * ((cs + 1) * cw + (asets + 1) * aw + (ms * c.num_partitions + 1) * mw)
    return _decide(
        "sweep_system", kernel_mode, concrete, candidates=_candidates(device),
        cold=cold_start_mode("sweep_system", batch=len(cfgs), device=device),
        batch=len(cfgs), n_accesses=n_accesses,
        features={"words_per_access": 7, "state_bytes": 4 * state}, store=store)


def decide_timeline(kernel_mode: str, *, batch: int, n_accesses: Optional[int] = None,
                    state_bytes: Optional[int] = None,
                    store: Optional[CalibrationStore] = None,
                    device: Device = "cuda") -> DispatchDecision:
    """Backend decision for the batched timeline engine.  Sweep-only modes
    raise the engine's own error."""
    concrete = _concrete(kernel_mode, device, VALID_MODES, resolve_timeline_mode)
    features: Dict[str, object] = {"words_per_access": 11}
    if state_bytes is not None:
        features["state_bytes"] = int(state_bytes)
    return _decide(
        "sweep_timeline", kernel_mode, concrete, candidates=_candidates(device),
        cold=cold_start_mode("sweep_timeline", batch=batch, device=device),
        batch=batch, n_accesses=n_accesses, features=features, store=store)


# ---------------------------------------------------------------------------
# Feedback: telemetry events + achieved-rate recording.
# ---------------------------------------------------------------------------


def record_decision(decision: DispatchDecision, *, name: str) -> None:
    """Emit the decision as a structured telemetry event (run-log record +
    event count) and a narration line."""
    telemetry.get_tracer().event(
        "dispatch", engine=decision.engine, name=name, mode=decision.mode,
        requested=decision.requested, calibration=decision.calibration,
        reason=decision.reason,
        candidates={m: c.get("rate") for m, c in decision.candidates.items()},
        predicted_s={m: c.get("predicted_s") for m, c in decision.candidates.items()
                     if c.get("predicted_s") is not None})
    _LOG.info("%s[%s] dispatch %r -> %r (%s)", decision.engine, name,
              decision.requested, decision.mode, decision.reason)


def observe(decision: DispatchDecision, throughput: Dict[str, dict], *,
            store: Optional[CalibrationStore] = None, name: str = "?") -> None:
    """Close the loop after a run: record each executed backend's achieved
    rate into the calibration table and emit ``dispatch_residual`` events
    comparing achieved against predicted."""
    batch = int(decision.features.get("batch") or 1)
    rows = []
    tracer = telemetry.get_tracer()
    for mode, d in (throughput or {}).items():
        achieved = d.get("sim_accesses_per_s")
        if not achieved:
            continue
        predicted = (decision.candidates.get(mode) or {}).get("rate")
        tracer.event(
            "dispatch_residual", engine=decision.engine, name=name, mode=mode,
            chosen=(mode == decision.mode), predicted_rate=predicted,
            achieved_rate=achieved,
            ratio=round(achieved / predicted, 3) if predicted else None)
        rows.append((decision.engine, mode, batch, float(achieved),
                     float(d.get("sim_accesses", 0))))
    if store is not None and rows:
        try:
            store.record_many(rows)
        except CalibrationCorruptError:
            raise
        except OSError as e:  # calibration is best-effort; the sweep is not
            _LOG.warning("calibration update failed (%s): %s", store.path, e)


# ---------------------------------------------------------------------------
# Bootstrap ingesters + garbage collection.
# ---------------------------------------------------------------------------


def ingest_bench_entries(store: CalibrationStore, entries: Iterable[dict]) -> int:
    """Record the per-backend rates implied by the port's own benchmark
    rows: the reference's row shapes (``bench`` = ``sweep``, ``timeline``,
    ``timeline_batched`` or ``system_batched``) with the kernel's time in
    ``t_cuda_s`` where the reference reads ``t_pallas_s``.  Rows whose
    ``device_kind`` differs from the store's are skipped.  Returns the
    number of rates ingested."""
    rows: List[Tuple[str, str, int, float, float]] = []
    for e in entries:
        if e.get("device_kind") != store.device_kind:
            continue
        bench = e.get("bench", "sweep")
        n_acc = float(e.get("n_accesses", 0) or 0)
        if bench == "sweep":
            batch = int(e.get("n_configs", 1) or 1)
            sim, engine = n_acc * batch, "sweep_tlb"
            pairs = [("reference", e.get("t_reference_s")),
                     ("stackdist", e.get("t_stackdist_s")),
                     ("cuda", e.get("t_cuda_s"))]
        elif bench == "timeline":
            batch, sim, engine = 1, n_acc, "sweep_timeline"
            pairs = [("reference", e.get("t_reference_s")), ("cuda", e.get("t_cuda_s"))]
        elif bench in ("timeline_batched", "system_batched"):
            batch = int(e.get("n_sims" if bench == "timeline_batched" else "n_configs",
                              1) or 1)
            sim = n_acc * batch
            engine = "sweep_timeline" if bench == "timeline_batched" else "sweep_system"
            pairs = [("reference", e.get("t_batched_s")), ("cuda", e.get("t_cuda_s"))]
        else:
            continue
        for mode, secs in pairs:
            if secs and sim > 0:
                rows.append((engine, mode, batch, sim / float(secs), sim))
    store.record_many(rows)
    return len(rows)


def ingest_runlogs(store: CalibrationStore, paths: Iterable) -> int:
    """Seed the table from orchestrator ``chunk`` spans in telemetry run
    logs (only logs whose ``run_start`` device matches the store's device
    kind).  Returns the number of rates ingested."""
    rows: List[Tuple[str, str, int, float, float]] = []
    for p in paths:
        p = pathlib.Path(p)
        if not p.exists():
            continue
        device_ok = False
        for line in p.read_text(encoding="utf-8").splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail from a crashed writer
            if rec.get("kind") == "run_start":
                dev = (rec.get("meta") or {}).get("device") or {}
                device_ok = dev.get("device_kind") == store.device_kind
            if not device_ok or rec.get("kind") != "span" or rec.get("name") != "chunk":
                continue
            a = rec.get("attrs") or {}
            rate = a.get("sim_accesses_per_s")
            engine, mode = a.get("engine"), a.get("mode")
            batch = int(a.get("configs", 1) or 1)
            sim = float(a.get("accesses", 0) or 0) * batch
            if engine in ENGINES and mode in SWEEP_MODES and mode != "auto" \
                    and rate and sim > 0:
                rows.append((engine, mode, batch, float(rate), sim))
    store.record_many(rows)
    return len(rows)


def gc_calibration(root, *, age_s: float = 7 * 86400.0, now: Optional[float] = None,
                   dry_run: bool = False) -> dict:
    """Sweep stale calibration tables (and orphaned temp files) under
    ``root``.  A file is deleted only when it is older than ``age_s`` AND
    its header identifies it as a :data:`CALIB_FORMAT` table; unrecognized
    files are reported in ``skipped_foreign`` and never touched."""
    root = pathlib.Path(root)
    now = time.time() if now is None else now
    summary = {"deleted": [], "kept_young": [], "skipped_foreign": [], "dry_run": dry_run}
    if not root.exists():
        return summary

    def delete(p: pathlib.Path) -> None:
        summary["deleted"].append(str(p))
        if not dry_run:
            try:
                p.unlink()
            except OSError:
                pass

    for p in sorted(root.iterdir()):
        if not p.is_file():
            continue
        try:
            age = now - p.stat().st_mtime
        except OSError:
            continue
        if ".tmp-" in p.name or p.suffix == ".lock":
            if age > age_s:
                delete(p)
            else:
                summary["kept_young"].append(str(p))
            continue
        if age <= age_s:
            summary["kept_young"].append(str(p))
            continue
        try:
            with p.open("rb") as f:
                head = f.read(len(CALIB_FORMAT))
        except OSError:
            continue
        if head == CALIB_FORMAT.encode():
            delete(p)
        else:
            summary["skipped_foreign"].append(str(p))
    return summary
