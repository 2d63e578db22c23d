"""Tolerance-band gate over the port's kernel-bench history (the port of
``benchmarks/perfcheck.py``).

Every ``python -m repro_torch.bench.kernel_bench`` run on the card appends
one row per engine bench to the port's history
(``build/repro_torch/bench_history.json`` by default; never the JAX
package's ``BENCH_sweep.json``): min-of-N synchronised wall times and the
card's stamp (:func:`repro_torch.core.benchtime.device_metadata`).
:data:`REFS_PATH` (``src/repro_torch/bench/references.json``) holds one
expected value per (bench, backend, mode, quick|full) key and metric, with a
band ``{"ref": seconds, "tol": [lower, upper], "abs_slack_s": s}`` that
passes iff

    ref * (1 + lower)  <=  recorded  <=  ref * (1 + upper) + abs_slack_s.

Gate semantics (:func:`check_perf_history`, run by ``kernel_bench --check``):

* a recorded metric outside its band **fails**, a slowdown and a speedup too
  good to be true (a broken timer or a skipped workload) alike;
* a row whose key has **no reference**, or whose ``device_kind`` differs
  from the reference's, **warns and passes**;
* **legacy rows** (no ``schema_version``) are skipped;
* a missing metric field on a schema'd row fails;
* a corrupt or unparseable history file fails loudly.

Re-baselining is deliberate: ``python -m repro_torch.bench.perfcheck
--update-refs --history PATH`` (or ``kernel_bench --update-refs``) rewrites
each reference from the latest matching row, keeping any hand-edited band.

    PYTHONPATH=src python -m repro_torch.bench.perfcheck [--history PATH] [--update-refs]
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List, Optional, Tuple

REFS_PATH = pathlib.Path(__file__).resolve().parent / "references.json"

# The band --update-refs gives a new reference: wide, since one card's wall
# times move with its host's load; the lower bound mostly catches a broken
# timer.  Tighten an entry by hand as the spread is learned.
DEFAULT_TOLERANCE = (-0.95, 3.0)

# Absolute seconds added to the upper bound by --update-refs, so that a
# reference of a few milliseconds does not fail on the host's jitter.
DEFAULT_ABS_SLACK_S = 1.0

REFS_SCHEMA_VERSION = 2


class WarnPass(str):
    """A warn-and-pass message (a plain string) that also carries the row's
    ``key`` and the ``reason`` (``"unreferenced"`` / ``"device_mismatch"``)
    that :func:`summarize` counts."""

    __slots__ = ("key", "reason")

    def __new__(cls, key: str, reason: str, msg: str):
        self = super().__new__(cls, msg)
        self.key = key
        self.reason = reason
        return self


def row_key(row: dict) -> str:
    """(bench, backend, mode, quick|full) identity of a recorded row."""
    return "|".join((row.get("bench", "sweep"), row.get("backend", "?"), row.get("mode", "-"),
                     "quick" if row.get("quick") else "full"))


def metric_fields(row: dict) -> List[str]:
    """The gated wall-time fields of a row (``t_*_s``)."""
    return sorted(k for k in row if k.startswith("t_") and k.endswith("_s"))


def load_history(path: pathlib.Path) -> dict:
    """Parse a history file, failing loudly on corruption."""
    try:
        doc = json.loads(pathlib.Path(path).read_text())
    except json.JSONDecodeError as e:
        raise SystemExit(f"{path} is corrupt ({e}); refusing to gate on an unreadable "
                         f"perf history") from e
    if not isinstance(doc, dict) or not isinstance(doc.get("history", []), list):
        raise SystemExit(f"{path} is not a {{'history': [...]}} document")
    return doc


def load_references(path: pathlib.Path = REFS_PATH) -> dict:
    path = pathlib.Path(path)
    if not path.exists():
        return {"schema_version": REFS_SCHEMA_VERSION, "references": {}}
    try:
        return json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise SystemExit(f"{path} is corrupt ({e}); fix or regenerate it with "
                         f"--update-refs") from e


def check_rows(history: List[dict], refs_doc: dict) -> Tuple[List[str], List[str], int, int]:
    """Gate every schema'd row against its reference bands: ``(failures,
    warnings, n_checked, n_legacy)``; the caller decides what fails."""
    refs: Dict[str, dict] = refs_doc.get("references", {})
    failures: List[str] = []
    warnings: List[str] = []
    n_checked = n_legacy = 0
    for i, row in enumerate(history):
        if "schema_version" not in row:
            n_legacy += 1
            continue
        key = row_key(row)
        where = f"history[{i}] ({key}, written_at={row.get('written_at')!r})"
        entry = refs.get(key)
        if entry is None:
            warnings.append(WarnPass(
                key, "unreferenced",
                f"{where}: no reference for this (bench, backend, mode, quick) key — "
                f"passing; baseline it with --update-refs"))
            continue
        ref_kind, row_kind = entry.get("device_kind"), row.get("device_kind")
        if ref_kind is not None and row_kind != ref_kind:
            warnings.append(WarnPass(
                key, "device_mismatch",
                f"{where}: recorded on device_kind={row_kind!r} but the reference was "
                f"baselined on {ref_kind!r} — passing; --update-refs on that device to "
                f"start gating it"))
            continue
        n_checked += 1
        for metric, spec in entry.get("metrics", {}).items():
            val = row.get(metric)
            if not isinstance(val, (int, float)):
                failures.append(f"{where}: metric {metric!r} missing from the recorded row "
                                f"(schema violation)")
                continue
            ref = float(spec["ref"])
            lower, upper = spec.get("tol", DEFAULT_TOLERANCE)
            lo = ref * (1.0 + lower)
            hi = ref * (1.0 + upper) + spec.get("abs_slack_s", 0.0)
            if not lo <= val <= hi:
                direction = ("slower — perf regression" if val > hi else
                             "faster — suspiciously good, check the timer/workload")
                failures.append(f"{where}: {metric}={val:.4g}s outside [{lo:.4g}, {hi:.4g}] "
                                f"(ref {ref:.4g}s, tol [{lower:+.0%}, {upper:+.0%}]) — "
                                f"{direction}")
    return failures, warnings, n_checked, n_legacy


def update_references(history: List[dict], refs_path: pathlib.Path = REFS_PATH) -> dict:
    """Re-baseline: the latest schema'd row of each key becomes its
    reference; existing bands are kept, values overwritten."""
    refs_path = pathlib.Path(refs_path)
    doc = load_references(refs_path)
    refs: Dict[str, dict] = doc.setdefault("references", {})
    doc["schema_version"] = REFS_SCHEMA_VERSION
    latest: Dict[str, dict] = {}
    for row in history:
        if "schema_version" in row:
            latest[row_key(row)] = row            # later rows win
    for key, row in latest.items():
        old = refs.get(key, {}).get("metrics", {})
        refs[key] = {
            "device_kind": row.get("device_kind"),
            "nvidia_smi": row.get("nvidia_smi"),
            "baselined_at": row.get("written_at"),
            "metrics": {m: {"ref": row[m],
                            "tol": list(old.get(m, {}).get("tol", DEFAULT_TOLERANCE)),
                            "abs_slack_s": old.get(m, {}).get("abs_slack_s",
                                                              DEFAULT_ABS_SLACK_S)}
                        for m in metric_fields(row)},
        }
    refs_path.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"  {refs_path.name}: baselined {len(latest)} key(s) from {len(history)} "
          f"recorded row(s)")
    return doc


def summarize(failures: List[str], warnings: List[str], n_checked: int,
              n_legacy: int) -> dict:
    """The gate's outcome as one dict, warn-passes counted by key and reason."""
    reasons: Dict[str, int] = {}
    for w in warnings:
        r = getattr(w, "reason", "other")
        reasons[r] = reasons.get(r, 0) + 1
    return {"n_checked": n_checked, "n_legacy": n_legacy, "n_failures": len(failures),
            "warn_pass": {"count": len(warnings),
                          "keys": sorted({w.key for w in warnings if hasattr(w, "key")}),
                          "reasons": reasons}}


def check_perf_history(history_path: pathlib.Path, refs_path: pathlib.Path = REFS_PATH,
                       history: Optional[List[dict]] = None) -> dict:
    """``SystemExit`` on any out-of-band metric; else :func:`summarize`'s
    dict (``{}`` when there is no history file), also printed as one
    ``perfcheck summary:`` JSON line."""
    if history is None:
        if not pathlib.Path(history_path).exists():
            return {}
        history = load_history(history_path).get("history", [])
    failures, warnings, n_checked, n_legacy = check_rows(history, load_references(refs_path))
    for w in warnings:
        print(f"  [perfcheck warn] {w}")
    summary = summarize(failures, warnings, n_checked, n_legacy)
    if failures:
        lines = "\n".join(f"  {f}" for f in failures)
        raise SystemExit(f"perf-regression gate: {len(failures)} metric(s) outside their "
                         f"reference band:\n{lines}\n(re-baseline deliberately with "
                         f"`python -m repro_torch.bench.kernel_bench --update-refs`)")
    print(f"  perfcheck: {n_checked} row(s) within reference bands ({len(warnings)} "
          f"unbaselined pass(es) with warning, {n_legacy} legacy row(s) skipped)")
    print(f"  perfcheck summary: {json.dumps(summary, sort_keys=True)}")
    from repro_torch.runtime import telemetry

    telemetry.get_tracer().event("perfcheck", **summary)
    return summary


def main(argv=None) -> int:
    from repro_torch.bench.kernel_bench import HISTORY_PATH

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--history", type=pathlib.Path, default=HISTORY_PATH)
    ap.add_argument("--refs", type=pathlib.Path, default=REFS_PATH)
    ap.add_argument("--update-refs", action="store_true",
                    help="re-baseline the references from the latest recorded row per "
                         "(bench, backend, mode, quick) key")
    args = ap.parse_args(argv)
    history = load_history(args.history).get("history", [])
    if args.update_refs:
        update_references(history, args.refs)
    check_perf_history(args.history, args.refs, history=history)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
