"""The port's run telemetry (``repro_torch.runtime.telemetry``), its threading
through the orchestrator and the streams, held to the JAX package's
(``tests/test_telemetry.py``): the JSONL schema, nesting, the no-op fast
path, chunk spans and achieved rates — and the same records as the JAX
package for the same sweep, read by the port's reader
``repro_torch.bench.obs_report`` (held to the JAX package's
``benchmarks/obs_report.py`` in ``tests/test_torch_obs_report.py``)."""
import json
import logging

import numpy as np
import pytest
import torch

from repro.core.orchestrator import SweepRunConfig as JSweepRunConfig
from repro.core.orchestrator import run_sweep_tlb as jrun_sweep_tlb
from repro.core.sparta import TLBConfig as JTLBConfig
from repro.core.sweep import TLBSweepSpec as JTLBSweepSpec
from repro.runtime import telemetry as jtelemetry
from repro_torch.bench import obs_report
from repro_torch.core import benchtime
from repro_torch.core.orchestrator import (SweepRunConfig, run_sweep_system,
                                           run_sweep_timeline, run_sweep_tlb)
from repro_torch.core.sparta import SystemLatencies, TLBConfig
from repro_torch.core.sweep import TLBSweepSpec, sweep_system, sweep_tlb
from repro_torch.core.timeline import TimelineConfig, TimelineSpec
from repro_torch.core.tlbsim import SystemSimConfig
from repro_torch.runtime import telemetry

BLOCK = 128


@pytest.fixture(autouse=True)
def _clean_tracer():
    for tr in (telemetry.get_tracer(), jtelemetry.get_tracer()):
        if tr.active:
            tr.end_run(error="leaked from a previous test")
    yield
    for tr in (telemetry.get_tracer(), jtelemetry.get_tracer()):
        if tr.active:
            tr.end_run(error="leaked by test")


def _sweep_inputs(ways=4):
    rng = np.random.default_rng(7)
    addrs = rng.integers(0, 1 << 22, 4096).astype(np.int64)
    specs = [TLBSweepSpec(TLBConfig(entries=64, ways=ways), num_partitions=p) for p in (1, 8)]
    return addrs, specs


def _read(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


# ------------------------------------------------------------ schema/lifecycle

def test_jsonl_schema_roundtrip(tmp_path):
    path = tmp_path / "run.jsonl"
    with telemetry.run_scope(path, run="t", device={"platform": "cpu"}):
        tr = telemetry.get_tracer()
        with tr.span("phase", k=1):
            tr.event("retry", lo=0, hi=10)
        tr.counter("c").add(3)
        tr.gauge("g").set(2.0)
    recs = _read(path)
    assert [r["kind"] for r in recs] == ["run_start", "event", "span", "run_end"]
    for r in recs:
        assert isinstance(r["ts"], float) and r["ts"] > 1e9 and isinstance(r["t_mono"], float)
    start, event, span, end = recs
    assert start["schema_version"] == telemetry.SCHEMA_VERSION == jtelemetry.SCHEMA_VERSION
    assert start["run"] == "t" and start["meta"]["device"]["platform"] == "cpu"
    assert event["name"] == "retry" and event["attrs"] == {"lo": 0, "hi": 10}
    assert span["name"] == "phase" and span["dur_s"] >= 0 and span["attrs"]["k"] == 1
    s = end["summary"]
    assert s["n_spans"] == 1 and s["events"] == {"retry": 1}
    assert s["counters"]["c"] == {"value": 3, "updates": 1}
    assert s["gauges"]["g"]["value"] == 2.0


def test_run_scope_closes_log_on_error(tmp_path):
    path = tmp_path / "crash.jsonl"
    with pytest.raises(KeyboardInterrupt):
        with telemetry.run_scope(path, run="t"):
            raise KeyboardInterrupt
    end = _read(path)[-1]
    assert end["kind"] == "run_end" and "KeyboardInterrupt" in end["error"]
    assert not telemetry.get_tracer().active


def test_span_nesting_parent_ids(tmp_path):
    path = tmp_path / "nest.jsonl"
    with telemetry.run_scope(path, run="t"):
        tr = telemetry.get_tracer()
        with tr.span("outer") as outer:
            with tr.span("inner") as inner:
                assert inner.parent_id == outer.span_id
            tr.record_span("measured", 0.01)
    spans = {r["name"]: r for r in _read(path) if r["kind"] == "span"}
    assert spans["outer"]["parent_id"] is None
    assert spans["inner"]["parent_id"] == spans["outer"]["span_id"]
    assert spans["measured"]["parent_id"] == spans["outer"]["span_id"]


def test_span_block_goes_through_the_ports_benchtime(tmp_path, monkeypatch):
    path = tmp_path / "blk.jsonl"
    seen = []
    monkeypatch.setattr(benchtime, "block", lambda x: seen.append(x) or x)
    x = torch.arange(8)
    with telemetry.run_scope(path, run="t"):
        with telemetry.get_tracer().span("s") as sp:
            assert sp.block(x) is x
    assert seen == [x]
    rec = [r for r in _read(path) if r["kind"] == "span"][0]
    assert rec["attrs"]["blocked_s"] > 0


def test_counter_gauge_aggregation_and_superseded_runs(tmp_path):
    tr = telemetry.get_tracer()
    tr.start_run(None, run="mem")
    c = tr.counter("hits")
    assert tr.counter("hits") is c
    c.add().add(5)
    tr.gauge("bytes").set(5).set(3)
    s = tr.end_run()
    assert s["counters"]["hits"] == {"value": 6, "updates": 2}
    assert s["gauges"]["bytes"] == {"value": 3.0, "min": 3.0, "max": 5.0, "updates": 2}
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    telemetry.start_run(a, run="a")
    telemetry.start_run(b, run="b")
    telemetry.end_run()
    assert "superseded" in _read(a)[-1]["error"]
    assert _read(b)[-1]["kind"] == "run_end"


def test_disabled_tracer_is_noop():
    tr = telemetry.get_tracer()
    assert not tr.active
    assert tr.span("x", a=1) is telemetry._NULL_SPAN
    assert tr.counter("c") is telemetry._NULL_INSTRUMENT
    assert tr.gauge("g") is telemetry._NULL_INSTRUMENT
    tr.event("e")
    tr.record_span("s", 0.5)
    assert tr.end_run() == {}
    obj = object()
    assert telemetry._NULL_SPAN.block(obj) is obj
    with tr.span("x") as sp:
        sp.set(k=1).block(obj)


def test_disabled_tracer_overhead_under_2_percent():
    """The instrument ops one sweep performs, costed at the disabled-tracer
    per-op price, stay under 2% of the sweep's own wall time."""
    addrs, specs = _sweep_inputs(ways=32)
    cfg = SweepRunConfig(chunk_accesses=1024)
    tr = telemetry.get_tracer()
    tr.start_run(None, run="probe")
    run_sweep_tlb(addrs, specs, kernel_mode="reference", block=BLOCK, run=cfg, device="cpu")
    s = tr.end_run()
    n_ops = (s["n_spans"] + sum(s["events"].values())
             + sum(c["updates"] for c in s["counters"].values())
             + sum(g["updates"] for g in s["gauges"].values()))
    assert n_ops >= 4

    def ops(k=1000):
        for _ in range(k):
            with tr.span("x"):
                pass
            tr.record_span("y", 0.0)
            tr.event("e")
            tr.counter("c").add()

    per_op = benchtime.measure(ops, reps=3).best_s / (1000 * 4)
    m_sweep = benchtime.measure(run_sweep_tlb, addrs, specs, kernel_mode="reference",
                                block=BLOCK, run=cfg, device="cpu", reps=2)
    assert n_ops * per_op < 0.02 * m_sweep.best_s


def test_setup_logging_levels_and_idempotent():
    root = logging.getLogger("repro_torch")
    saved = (root.level, list(root.handlers), root.propagate)
    try:
        log = telemetry.setup_logging(0)
        n = len(log.handlers)
        assert log.name == "repro_torch" and log.level == logging.INFO
        assert telemetry.setup_logging(1).level == logging.DEBUG
        assert telemetry.setup_logging(-1).level == logging.WARNING
        assert len(log.handlers) == n
    finally:
        # The narration handler stops propagation; later tests in this
        # process read the port's records with caplog, through the root.
        root.setLevel(saved[0])
        root.handlers[:] = saved[1]
        root.propagate = saved[2]


# ------------------------------------------------------- orchestrator threading

def test_ladder_events_carry_timestamps_and_elapsed():
    addrs, specs = _sweep_inputs(ways=32)
    left = {"n": 1}

    def hook(engine, lo, hi, mode, attempt):
        if left["n"]:
            left["n"] -= 1
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    res, meta = run_sweep_tlb(addrs, specs, kernel_mode="reference", block=BLOCK,
                              device="cpu", run=SweepRunConfig(
                                  fault_hook=hook, backoff_base_s=0.0, backoff_cap_s=0.0,
                                  chunk_accesses=1024))
    (e,) = [e for e in meta["events"] if e["event"] == "retry"]
    assert e["ts"] > 1e9 and isinstance(e["t_mono"], float)
    assert e["elapsed_s"] >= 0 and e["attempt"] == 0 and "OutOfMemoryError" in e["error"]
    oracle = sweep_tlb(addrs, specs, kernel_mode="reference", device="cpu")
    np.testing.assert_array_equal(res.hits.numpy(), oracle.hits.numpy())


def test_runlog_chunks_counters_and_throughput_meta(tmp_path):
    addrs, specs = _sweep_inputs(ways=32)
    path = tmp_path / "fig.jsonl"
    with telemetry.run_scope(path, run="fig"):
        _, meta = run_sweep_tlb(addrs, specs, kernel_mode="reference", block=BLOCK,
                                run=SweepRunConfig(chunk_accesses=1024), name="tlb",
                                device="cpu")
    tp = meta["throughput"]["reference"]
    assert tp["chunks"] == 4 and tp["accesses"] == 4096
    assert tp["sim_accesses"] == 4096 * len(specs) and tp["sim_accesses_per_s"] > 0
    recs = _read(path)
    chunks = [r for r in recs if r["kind"] == "span" and r["name"] == "chunk"]
    assert len(chunks) == 4
    a = chunks[0]["attrs"]
    assert (a["engine"], a["name"], a["mode"], a["configs"]) == ("sweep_tlb", "tlb",
                                                                 "reference", len(specs))
    assert (a["lo"], a["hi"]) == (0, 1024) and a["accesses_per_s"] > 0
    env = [r for r in recs if r["kind"] == "event" and r["name"] == "vmem_envelope"]
    assert env and env[0]["attrs"]["configs"] == len(specs)
    assert env[0]["attrs"]["state_bytes"] > 0
    summary = recs[-1]["summary"]
    assert summary["counters"]["sweep_tlb.sim_accesses"]["value"] == 4096 * len(specs)
    assert summary["gauges"]["sweep_tlb.state_bytes"]["value"] > 0


def test_stackdist_monolithic_path_records_throughput(tmp_path):
    addrs, specs = _sweep_inputs()
    path = tmp_path / "sd.jsonl"
    with telemetry.run_scope(path, run="sd"):
        _, meta = run_sweep_tlb(addrs, specs, kernel_mode="stackdist", block=BLOCK,
                                name="tlb", device="cpu")
    assert meta["resumable"] is False
    tp = meta["throughput"]["stackdist"]
    assert tp["chunks"] == 1 and tp["accesses"] == 4096 and tp["accesses_per_s"] > 0
    chunks = [r for r in _read(path) if r["kind"] == "span" and r["name"] == "chunk"]
    assert len(chunks) == 1 and chunks[0]["attrs"]["mode"] == "stackdist"


def test_system_and_timeline_streams_count_their_sim_accesses(tmp_path):
    rng = np.random.default_rng(2)
    lines = rng.integers(0, 1 << 24, 1500).astype(np.int64)
    cfgs = [SystemSimConfig(num_partitions=8), SystemSimConfig(accel_tlb=None)]
    ev = sweep_system(lines, cfgs, device="cpu")
    specs = [TimelineSpec(lines, ev[i], d, cfg=TimelineConfig(mshrs=2, dram_banks=4),
                          num_partitions=p, num_accelerators=2)
             for i, (d, p) in enumerate((("conventional", 1), ("sparta", 8)))]
    path = tmp_path / "st.jsonl"
    with telemetry.run_scope(path, run="st"):
        run_sweep_system(lines, cfgs, block=BLOCK, device="cpu",
                         run=SweepRunConfig(chunk_accesses=512))
        run_sweep_timeline(specs, SystemLatencies(), block=BLOCK, device="cpu",
                           run=SweepRunConfig(chunk_accesses=512))
    c = _read(path)[-1]["summary"]["counters"]
    assert c["sweep_system.sim_accesses"] == {"value": 3000, "updates": 3}
    assert c["sweep_timeline.sim_accesses"] == {"value": 3000, "updates": 3}
    assert c["sweep_timeline.trace_accesses"]["value"] == 1500


def _records(path):
    """(kind, name, attribute names) of every record but the run's own."""
    return [(r["kind"], r.get("name"), sorted((r.get("attrs") or {})))
            for r in _read(path) if r["kind"] in ("span", "event")]


def test_the_same_sweep_writes_the_jax_packages_records(tmp_path):
    addrs, specs = _sweep_inputs(ways=32)
    jspecs = [JTLBSweepSpec(JTLBConfig(entries=64, ways=32), num_partitions=p)
              for p in (1, 8)]
    t, j = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    with telemetry.run_scope(t, run="fig"):
        run_sweep_tlb(addrs, specs, kernel_mode="reference", block=BLOCK, name="tlb",
                      run=SweepRunConfig(chunk_accesses=1024), device="cpu")
    with jtelemetry.run_scope(j, run="fig"):
        jrun_sweep_tlb(addrs, jspecs, kernel_mode="reference", block=BLOCK, name="tlb",
                       run=JSweepRunConfig(chunk_accesses=1024))
    assert _records(t) == _records(j)
    ts, js = _read(t)[-1]["summary"], _read(j)[-1]["summary"]
    assert ts["counters"] == js["counters"] and ts["gauges"] == js["gauges"]
    assert ts["events"] == js["events"] and ts["n_spans"] == js["n_spans"]


# ------------------------------------------------------------------ obs_report

def test_obs_report_reads_a_port_run_log(tmp_path, capsys):
    addrs, specs = _sweep_inputs(ways=32)
    path = tmp_path / "fig.jsonl"

    def hook(engine, lo, hi, mode, attempt):
        if (lo, attempt) == (1024, 0):
            raise torch.cuda.OutOfMemoryError("injected")

    with telemetry.run_scope(path, run="fig", device={"device_kind": "cpu"}):
        run_sweep_tlb(addrs, specs, kernel_mode="reference", block=BLOCK, name="tlb",
                      device="cpu", run=SweepRunConfig(chunk_accesses=1024, fault_hook=hook,
                                                       backoff_base_s=0.0))
    assert obs_report.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "phase breakdown" in out and "engine throughput" in out and "sweep_tlb" in out
    assert "retry" in out and "end=clean" in out
    recs = obs_report.load_log(path)
    st = obs_report.engine_throughput(recs)[("sweep_tlb", "reference")]
    assert st["chunks"] == 4 and st["accesses"] == 4096
    assert obs_report.event_counts(recs)["retry"] == 1
    assert obs_report.main([str(path), "--fail-on-event", "downgrade"]) == 0
    assert obs_report.main([str(path), "--fail-on-event", "retry"]) == 1
