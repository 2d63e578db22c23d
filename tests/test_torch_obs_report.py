"""The port's run-log reader (``repro_torch.bench.obs_report``) held to the
JAX package's ``benchmarks/obs_report.py``: on the same logs, the same
standard output and standard error byte for byte, the same exit code (or
``SystemExit``), and equal return values from every public function.

The logs (made once, on the CPU):

* a port orchestrator run (``run_sweep_system`` in ``reference`` mode, in
  chunks, with an injected out-of-memory error: chunk spans, dispatch events,
  a retry);
* a port scheduler run's merged group (the parent's log and each process
  worker's, comma-joined), under the thread and the process executor;
* a log the JAX package wrote (its orchestrator under its own telemetry);
* a torn last line (a crashed writer), and a log corrupt mid-file;
* ``--diff`` of two logs, ``--merge``, ``--fail-on-event`` for both
  outcomes, and ``--diff`` with one log (an argparse error).
"""
import numpy as np
import pytest
import torch
from test_torch_scheduler import _cfg, _engine, _sched

from benchmarks import obs_report as jreport
from repro.core.orchestrator import SweepRunConfig as JSweepRunConfig
from repro.core.orchestrator import run_sweep_system as jrun_sweep_system
from repro.core.tlbsim import SystemSimConfig as JSystemSimConfig
from repro.runtime import telemetry as jtelemetry
from repro_torch.bench import obs_report as report
from repro_torch.core.orchestrator import SweepRunConfig, run_sweep_system
from repro_torch.core.tlbsim import SystemSimConfig
from repro_torch.runtime import telemetry

FUNCTIONS = ("load_log", "merge_logs", "phase_breakdown", "engine_throughput",
             "throughput_timeline", "shard_table", "scheduler_events", "dispatch_table",
             "event_counts")
LOGS = ("orchestrator", "scheduler_thread", "scheduler_process", "jax", "torn")


def _oom_once(engine, lo, hi, mode, attempt):
    if (lo, attempt) == (1024, 0):
        raise torch.cuda.OutOfMemoryError("injected")


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runlogs")
    lines = np.random.default_rng(5).integers(0, 1 << 22, 4096).astype(np.int64)
    cfgs = [SystemSimConfig(num_partitions=p) for p in (1, 8)]
    out = {}

    path = root / "orchestrator.jsonl"
    with telemetry.run_scope(path, run="orchestrator", device={"device_kind": "cpu"}):
        run_sweep_system(lines, cfgs, kernel_mode="reference", name="sys", device="cpu",
                         run=SweepRunConfig(chunk_accesses=1024, fault_hook=_oom_once,
                                            backoff_base_s=0.0))
    out["orchestrator"] = [path]

    run, _, _ = _engine("system")
    for executor in ("thread", "process"):
        d = root / executor
        parent = d / "sched.jsonl"
        with telemetry.run_scope(parent, run="sched"):
            run(_cfg(d / "ckpt"), _sched(executor=executor, runlog_dir=str(d)))
        workers = sorted(d.glob("sched-w*.jsonl"))
        assert bool(workers) == (executor == "process")
        out[f"scheduler_{executor}"] = [parent] + workers

    path = root / "jax.jsonl"
    with jtelemetry.run_scope(path, run="jax", device={"device_kind": "cpu"}):
        jrun_sweep_system(lines, [JSystemSimConfig(num_partitions=p) for p in (1, 8)],
                          kernel_mode="reference", name="sys",
                          run=JSweepRunConfig(chunk_accesses=1024, backoff_base_s=0.0))
    out["jax"] = [path]

    text = (root / "orchestrator.jsonl").read_text()
    torn = root / "torn.jsonl"
    torn.write_text(text[:text.rstrip("\n").rfind("\n") + 1] + '{"kind": "span", "na')
    out["torn"] = [torn]
    corrupt = root / "corrupt.jsonl"
    first, rest = text.split("\n", 1)
    corrupt.write_text(first + "\n{not json\n" + rest)
    out["corrupt"] = [corrupt]
    return out


def _group(paths) -> str:
    return ",".join(str(p) for p in paths)


def _both(capsys, args):
    """Each reader's (exit code or SystemExit code, stdout, stderr) on
    ``args``; they must be equal."""
    res = []
    for mod in (jreport, report):
        try:
            rc = mod.main(list(args))
        except SystemExit as e:
            rc = ("SystemExit", str(e.code))
        cap = capsys.readouterr()
        res.append((rc, cap.out, cap.err))
    assert res[0] == res[1]
    return res[1]


def _records(mod, paths):
    return mod.merge_logs([mod.load_log(p) for p in paths])


@pytest.mark.parametrize("log", LOGS)
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_functions_equal_jax(logs, log, fn):
    if fn == "load_log":
        got = [report.load_log(p) for p in logs[log]]
        want = [jreport.load_log(p) for p in logs[log]]
    elif fn == "merge_logs":
        got, want = _records(report, logs[log]), _records(jreport, logs[log])
    else:
        recs = _records(jreport, logs[log])
        got, want = getattr(report, fn)(recs), getattr(jreport, fn)(recs)
    assert got == want


@pytest.mark.parametrize("log", LOGS)
def test_render_equals_jax(logs, log, capsys):
    rc, out, _ = _both(capsys, [_group(logs[log])])
    assert rc == 0 and f"# run " in out


def test_the_logs_hold_what_the_reader_renders(logs, capsys):
    recs = _records(report, logs["orchestrator"])
    assert report.event_counts(recs)["retry"] == 1
    assert {m for _, m in report.engine_throughput(recs)} == {"reference"}
    assert report.dispatch_table(recs)
    merged = _records(report, logs["scheduler_process"])
    assert report.shard_table(merged) and report.scheduler_events(merged)
    _, out, _ = _both(capsys, [_group(logs["scheduler_process"])])
    assert "## shards" in out and "## scheduler events" in out
    torn = report.load_log(logs["torn"][0])
    assert len(torn) == len(report.load_log(logs["orchestrator"][0])) - 1


def test_every_log_at_once_equals_jax(logs, capsys):
    args = [_group(logs[k]) for k in LOGS]
    rc, out, _ = _both(capsys, args)
    assert rc == 0 and out.count("# run ") == len(LOGS)


def test_merge_equals_jax(logs, capsys):
    rc, out, _ = _both(capsys, [str(p) for k in LOGS for p in logs[k]] + ["--merge"])
    assert rc == 0 and out.count("# run ") == 1


@pytest.mark.parametrize("pair", [("orchestrator", "jax"), ("scheduler_thread",
                                                           "scheduler_process")])
def test_diff_equals_jax(logs, capsys, pair):
    rc, out, _ = _both(capsys, [_group(logs[pair[0]]), _group(logs[pair[1]]), "--diff"])
    assert rc == 0 and "# diff " in out and "## phase totals" in out


@pytest.mark.parametrize("banned,want", [("downgrade", 0), ("retry", 1),
                                         ("downgrade,retry", 1), ("lease_acquire", 1)])
def test_fail_on_event_equals_jax(logs, capsys, banned, want):
    args = [_group(logs[k]) for k in ("orchestrator", "scheduler_thread")]
    rc, _, err = _both(capsys, args + ["--fail-on-event", banned])
    assert rc == want and ("banned event(s) present" in err) == bool(want)


def test_diff_needs_two_logs_as_in_jax(logs, capsys):
    rc, _, err = _both(capsys, [str(logs["jax"][0]), "--diff"])
    assert rc == ("SystemExit", "2") and "--diff needs exactly two" in err


def test_corrupt_mid_log_raises_as_in_jax(logs, capsys):
    rc, _, _ = _both(capsys, [str(logs["corrupt"][0])])
    assert rc[0] == "SystemExit" and "corrupt record mid-log" in rc[1]
