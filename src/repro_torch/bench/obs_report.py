"""Render per-run telemetry JSONL logs (``build/repro_torch/cache/runlogs/``).

The port's own copy of the JAX package's ``benchmarks/obs_report.py``,
function for function: the same names, the same command line, the same
output byte for byte and the same exit codes on the same logs.  The run-log
schema is shared (:data:`repro_torch.runtime.telemetry.SCHEMA_VERSION`), so
it reads logs either package wrote.

``python -m repro_torch.bench.obs_report LOG [LOG...]`` prints, per log: the
run header (name, device, clean/errored end), the per-phase wall-clock
breakdown (span name -> count / total seconds, sorted by where the time
went), the achieved per-(engine, backend) throughput from the
orchestrator's ``chunk`` spans, a predicted-vs-achieved backend-dispatch
table (each ``dispatch`` event's calibrated per-candidate rate predictions
against what the run's chunk spans actually achieved), a throughput
timeline (chunk-by-chunk accesses/s against the run's monotonic clock),
and the structured-event table (retries, halves, resumes, preemptions,
checkpoint writes).

Sharded scheduler runs write one log per *worker process*
(``<run>-wN-<pid>.jsonl``) beside the parent's: a positional argument may be
a **comma-joined group** (``fig11.jsonl,fig11-w0-123.jsonl,...``) and the
group is merged into one record stream ordered by ``t_mono`` before
rendering — the interleaved cross-process view of a run.  ``--merge``
instead merges *all* positional logs into a single set.  A merged run with
scheduler activity additionally prints the shard table (per-shard attempts,
workers, wall time) and the scheduler event sequence (lease acquisitions
and expiries, re-dispatches, duplicates, quarantines).

``--diff A B`` compares two logs — or two comma-joined merged groups —
phase-by-phase and engine-by-engine: the before/after view for a perf
change or a 1-worker vs N-worker run.

``--fail-on-event NAMES`` (comma-separated) exits 1 if any named event
occurs in any log or merged group (``--fail-on-event downgrade`` turns a
backend downgrade into a failure; the port never downgrades, so on its logs
that check passes).  The fault-injection smoke asserts
``lease_expire``/``redispatch`` *are* present the same way, via
:func:`event_counts`.

Deliberately stdlib-only (it reads what
:mod:`repro_torch.runtime.telemetry` wrote and imports nothing of the
package, nor torch) so it runs anywhere the logs land.  Torn final
lines — a crashed or preempted writer — are tolerated: every complete
record still renders.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict, List, Tuple


def load_log(path: pathlib.Path) -> List[dict]:
    """Parse one JSONL run log, skipping a torn (incomplete) final line."""
    recs: List[dict] = []
    lines = path.read_text(encoding="utf-8").splitlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            recs.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break  # torn tail from a crashed writer — expected
            raise SystemExit(
                f"{path}:{i + 1}: corrupt record mid-log (only the final "
                f"line may be torn)")
    return recs


def merge_logs(rec_sets: List[List[dict]]) -> List[dict]:
    """Merge several run logs into one record stream ordered by ``t_mono``.

    Worker processes share the parent's monotonic clock domain (same host,
    ``time.perf_counter``), so a global sort reconstructs the interleaved
    timeline.  Records without ``t_mono`` sort first, keeping their original
    relative order (stable sort).
    """
    merged = [r for recs in rec_sets for r in recs]
    merged.sort(key=lambda r: r.get("t_mono", float("-inf")))
    return merged


def phase_breakdown(recs: List[dict]) -> Dict[str, dict]:
    """span name -> {count, total_s}, sorted by descending total."""
    agg: Dict[str, dict] = {}
    for r in recs:
        if r.get("kind") != "span":
            continue
        st = agg.setdefault(r["name"], {"count": 0, "total_s": 0.0})
        st["count"] += 1
        st["total_s"] += float(r.get("dur_s", 0.0))
    return dict(sorted(agg.items(), key=lambda kv: -kv[1]["total_s"]))


def engine_throughput(recs: List[dict]) -> Dict[Tuple[str, str], dict]:
    """(engine, mode) -> aggregate chunk throughput from ``chunk`` spans."""
    agg: Dict[Tuple[str, str], dict] = {}
    for r in recs:
        if r.get("kind") != "span" or r.get("name") != "chunk":
            continue
        a = r.get("attrs", {})
        key = (str(a.get("engine", "?")), str(a.get("mode", "?")))
        st = agg.setdefault(key, {"chunks": 0, "accesses": 0, "elapsed_s": 0.0})
        st["chunks"] += 1
        st["accesses"] += int(a.get("accesses", 0))
        st["elapsed_s"] += float(r.get("dur_s", 0.0))
    for st in agg.values():
        st["accesses_per_s"] = (
            st["accesses"] / st["elapsed_s"] if st["elapsed_s"] > 0 else None)
    return agg


def throughput_timeline(recs: List[dict]) -> List[dict]:
    """chunk-by-chunk rows, t_rel measured from the run_start record."""
    t0 = next((r["t_mono"] for r in recs if r.get("kind") == "run_start"), None)
    rows = []
    for r in recs:
        if r.get("kind") != "span" or r.get("name") != "chunk":
            continue
        a = r.get("attrs", {})
        rows.append({
            "t_rel_s": (round(r["t_mono"] - t0, 3)
                        if t0 is not None and "t_mono" in r else None),
            "engine": a.get("engine"), "name": a.get("name"),
            "mode": a.get("mode"), "lo": a.get("lo"), "hi": a.get("hi"),
            "accesses_per_s": a.get("accesses_per_s"),
        })
    return rows


def shard_table(recs: List[dict]) -> Dict[Tuple[str, int], dict]:
    """(engine-call name, shard) -> attempts / workers / total busy seconds,
    from the scheduler's ``shard`` spans (one per attempt, any worker)."""
    agg: Dict[Tuple[str, int], dict] = {}
    for r in recs:
        if r.get("kind") != "span" or r.get("name") != "shard":
            continue
        a = r.get("attrs", {})
        key = (str(a.get("name", "?")), int(a.get("shard", -1)))
        st = agg.setdefault(key, {"attempts": 0, "workers": set(),
                                  "total_s": 0.0})
        st["attempts"] += 1
        st["workers"].add(a.get("worker"))
        st["total_s"] += float(r.get("dur_s", 0.0))
    return dict(sorted(agg.items()))


def scheduler_events(recs: List[dict]) -> List[dict]:
    """The scheduler's own event records (dispatch, lease_expire, redispatch,
    straggler duplicates, quarantine, worker death/respawn), in stream
    order."""
    return [r for r in recs
            if r.get("kind") == "event"
            and r.get("attrs", {}).get("kind") == "scheduler"]


def dispatch_table(recs: List[dict]) -> List[dict]:
    """Predicted-vs-achieved backend dispatch rows: one per (engine call,
    candidate mode), pairing each ``dispatch`` event's calibrated rate
    predictions with the rates the run actually achieved (from its ``chunk``
    spans, simulated accesses per second)."""
    achieved: Dict[Tuple[str, str, str], dict] = {}
    for r in recs:
        if r.get("kind") != "span" or r.get("name") != "chunk":
            continue
        a = r.get("attrs", {})
        key = (str(a.get("engine", "?")), str(a.get("name", "?")),
               str(a.get("mode", "?")))
        st = achieved.setdefault(key, {"sim_accesses": 0, "elapsed_s": 0.0})
        st["sim_accesses"] += (int(a.get("accesses", 0) or 0)
                               * int(a.get("configs", 1) or 1))
        st["elapsed_s"] += float(r.get("dur_s", 0.0))
    rows = []
    for r in recs:
        if r.get("kind") != "event" or r.get("name") != "dispatch":
            continue
        a = r.get("attrs", {})
        eng, name, chosen = a.get("engine"), a.get("name"), a.get("mode")
        for mode, rate in (a.get("candidates") or {}).items():
            st = achieved.get((str(eng), str(name), str(mode)))
            ach = (st["sim_accesses"] / st["elapsed_s"]
                   if st and st["elapsed_s"] > 0 else None)
            rows.append({
                "engine": eng, "name": name, "mode": mode,
                "chosen": mode == chosen, "predicted_rate": rate,
                "achieved_rate": ach, "calibration": a.get("calibration"),
            })
    return rows


def event_counts(recs: List[dict]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for r in recs:
        if r.get("kind") == "event":
            counts[r["name"]] = counts.get(r["name"], 0) + 1
    return dict(sorted(counts.items()))


def _fmt_rate(x) -> str:
    if x is None:
        return "-"
    return f"{x / 1e6:.2f}M/s" if x >= 1e6 else f"{x / 1e3:.1f}k/s"


def render(path: pathlib.Path, recs: List[dict]) -> None:
    start = next((r for r in recs if r.get("kind") == "run_start"), None)
    end = next((r for r in recs if r.get("kind") == "run_end"), None)
    run = start.get("run") if start else "?"
    dev = (start or {}).get("meta", {}).get("device", {})
    dur = (end["t_mono"] - start["t_mono"]
           if start and end and "t_mono" in start and "t_mono" in end else None)
    print(f"\n# run {run!r} ({path})")
    status = ("no run_end (crashed/torn)" if end is None
              else f"error: {end['error']}" if "error" in end else "clean")
    print(f"  records={len(recs)}  wall={dur:.2f}s" if dur is not None
          else f"  records={len(recs)}  wall=?", end="")
    print(f"  end={status}"
          + (f"  device={dev.get('platform')}/{dev.get('device_kind')}"
             if dev else ""))

    phases = phase_breakdown(recs)
    if phases:
        print("  ## phase breakdown (span name, count, total seconds)")
        for name, st in phases.items():
            print(f"    {name:<16} x{st['count']:<5} {st['total_s']:9.3f}s")

    tput = engine_throughput(recs)
    if tput:
        print("  ## engine throughput (from chunk spans)")
        for (eng, mode), st in sorted(tput.items()):
            print(f"    {eng:<16} {mode:<18} chunks={st['chunks']:<4} "
                  f"accesses={st['accesses']:<9} "
                  f"rate={_fmt_rate(st['accesses_per_s'])}")

    shards = shard_table(recs)
    if shards:
        print("  ## shards (scheduler attempts per shard)")
        for (call, idx), st in shards.items():
            workers = ",".join(str(w) for w in sorted(
                st["workers"], key=lambda x: (x is None, x)))
            print(f"    {call:<24} shard={idx:<3} attempts={st['attempts']:<2} "
                  f"workers=[{workers}] busy={st['total_s']:.3f}s")
    sev = scheduler_events(recs)
    if sev:
        print(f"  ## scheduler events ({len(sev)})")
        t0s = next((r["t_mono"] for r in recs if r.get("kind") == "run_start"),
                   None)
        for r in sev:
            a = r.get("attrs", {})
            t = (f"{r['t_mono'] - t0s:8.2f}s"
                 if t0s is not None and "t_mono" in r else "       ?")
            detail = " ".join(
                f"{k}={a[k]}" for k in ("name", "shard", "attempt", "worker",
                                        "duplicate", "owner")
                if k in a and a[k] is not None)
            print(f"    {t}  {r['name']:<20} {detail}")

    disp = dispatch_table(recs)
    if disp:
        print("  ## dispatch (predicted vs achieved, sim accesses/s)")
        for row in disp:
            mark = "*" if row["chosen"] else " "
            print(f"   {mark} {str(row['name']):<16} {str(row['mode']):<18} "
                  f"predicted={_fmt_rate(row['predicted_rate'])} "
                  f"achieved={_fmt_rate(row['achieved_rate'])}  "
                  f"[{row['calibration']}]")

    timeline = throughput_timeline(recs)
    if timeline:
        print(f"  ## throughput timeline ({len(timeline)} chunks)")
        for row in timeline:
            t = f"{row['t_rel_s']:8.2f}s" if row["t_rel_s"] is not None else "       ?"
            print(f"    {t}  {str(row['name']):<16} {str(row['mode']):<18} "
                  f"[{row['lo']}, {row['hi']})  {_fmt_rate(row['accesses_per_s'])}")

    events = event_counts(recs)
    if events:
        print("  ## events")
        for name, n in events.items():
            print(f"    {name:<20} x{n}")


def diff(a_path: pathlib.Path, a: List[dict],
         b_path: pathlib.Path, b: List[dict]) -> None:
    print(f"\n# diff {a_path} -> {b_path}")
    pa, pb = phase_breakdown(a), phase_breakdown(b)
    print("  ## phase totals (seconds, A -> B)")
    for name in sorted(set(pa) | set(pb)):
        ta = pa.get(name, {}).get("total_s", 0.0)
        tb = pb.get(name, {}).get("total_s", 0.0)
        delta = f"{(tb - ta) / ta:+.0%}" if ta > 0 else "new" if tb else "-"
        print(f"    {name:<16} {ta:9.3f}s -> {tb:9.3f}s  ({delta})")
    ea, eb = engine_throughput(a), engine_throughput(b)
    if ea or eb:
        print("  ## engine throughput (accesses/s, A -> B)")
        for key in sorted(set(ea) | set(eb)):
            ra = (ea.get(key) or {}).get("accesses_per_s")
            rb = (eb.get(key) or {}).get("accesses_per_s")
            delta = (f"{(rb - ra) / ra:+.0%}" if ra and rb else "-")
            print(f"    {key[0]:<16} {key[1]:<18} "
                  f"{_fmt_rate(ra)} -> {_fmt_rate(rb)}  ({delta})")
    ca, cb = event_counts(a), event_counts(b)
    if ca or cb:
        print("  ## event counts (A -> B)")
        for name in sorted(set(ca) | set(cb)):
            print(f"    {name:<20} {ca.get(name, 0)} -> {cb.get(name, 0)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("logs", nargs="+",
                    help="run-log JSONL files (build/repro_torch/cache/runlogs/); "
                         "a comma-joined argument is one merged group "
                         "(parent + worker logs of a sharded run)")
    ap.add_argument("--diff", action="store_true",
                    help="compare exactly two logs (or merged groups) "
                         "phase-by-phase")
    ap.add_argument("--merge", action="store_true",
                    help="merge ALL given logs into one t_mono-ordered set")
    ap.add_argument("--fail-on-event", default=None, metavar="NAMES",
                    help="comma-separated event names; exit 1 if any occurs "
                         "(CI: --fail-on-event downgrade)")
    args = ap.parse_args(argv)

    # Each positional arg is a group: one file, or comma-joined files merged
    # by t_mono into a single record stream.
    loaded = []
    for spec in args.logs:
        paths = [pathlib.Path(s) for s in spec.split(",") if s]
        recs = merge_logs([load_log(p) for p in paths])
        label = paths[0] if len(paths) == 1 else pathlib.Path(
            f"{paths[0]}(+{len(paths) - 1})")
        loaded.append((label, recs))
    if args.merge and len(loaded) > 1:
        label = pathlib.Path(f"{loaded[0][0]}(+{len(loaded) - 1})")
        loaded = [(label, merge_logs([recs for _, recs in loaded]))]

    if args.diff:
        if len(loaded) != 2:
            ap.error("--diff needs exactly two logs or merged groups")
        diff(*loaded[0], *loaded[1])
    else:
        for p, recs in loaded:
            render(p, recs)

    if args.fail_on_event:
        banned = {s.strip() for s in args.fail_on_event.split(",") if s.strip()}
        offenders = [
            f"{p}: {name} x{n}"
            for p, recs in loaded
            for name, n in event_counts(recs).items() if name in banned
        ]
        if offenders:
            print("\nbanned event(s) present:", file=sys.stderr)
            for line in offenders:
                print(f"  {line}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
