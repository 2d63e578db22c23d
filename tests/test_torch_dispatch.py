"""The port's dispatch layer (``repro_torch.core.dispatch``), held to the JAX
package's (``tests/test_dispatch.py``): the calibration store's integrity
and merge rule, the cold start, the calibrated argmax, resume stickiness,
the ingesters and GC — and the same ``DispatchDecision`` as the JAX
package for the same inputs, with its ``pallas`` read as ``cuda`` (the
card) and its ``pallas_interpret`` left out (the port has no interpret
mode).  Two deliberate differences: a single-sim timeline takes the kernel
on the card (the JAX cold start sends it to its scan), and on the card the
plain version is no candidate of ``auto``, so a JAX decision is compared
as the JAX package makes it over the port's candidates (its ``reference``
unmeasured and left out)."""
import json
import os

import numpy as np
import pytest
from _faultinject import SimulatedKill, kill_after

from repro.core import dispatch as jdispatch
from repro.core.sparta import TLBConfig as JTLBConfig
from repro.core.sweep import TLBSweepSpec as JTLBSweepSpec
from repro.core.tlbsim import SystemSimConfig as JSystemSimConfig
from repro_torch.core import dispatch
from repro_torch.core.dispatch import CalibrationCorruptError, CalibrationStore, DispatchDecision
from repro_torch.core.orchestrator import SweepRunConfig, run_sweep_tlb
from repro_torch.core.sparta import TLBConfig
from repro_torch.core.sweep import TLBSweepSpec, sweep_tlb
from repro_torch.core.tlbsim import SystemSimConfig
from repro_torch.runtime import telemetry
from repro_torch.runtime.fault_tolerance import PreemptionHandler

BLOCK = 128
W = dispatch.MIN_CALIB_WEIGHT
DEV = {"device_kind": "TestCPU"}


def _store(path, engine="sweep_timeline", batch=8, **rates):
    st = CalibrationStore(path / "calib-test.json", device=DEV)
    st.record_many([(engine, mode, batch, r, 10 * W) for mode, r in rates.items()])
    return st


def _specs(ways, cls=TLBSweepSpec, cfg=TLBConfig):
    return [cls(cfg(entries=64, ways=ways), num_partitions=p) for p in (1, 8)]


# ---------------------------------------------------------------------------
# Store round trip + integrity refusal.
# ---------------------------------------------------------------------------

def test_store_round_trip_and_weighted_merge(tmp_path):
    st = _store(tmp_path)
    st.record("sweep_tlb", "reference", 4, 1e6, weight=2 * W)
    st.record("sweep_tlb", "reference", 4, 2e6, weight=2 * W)
    st2 = CalibrationStore(st.path, device=DEV)
    assert st2.rate("sweep_tlb", "reference", 4) == pytest.approx(1.5e6)
    assert st2.rate("sweep_tlb", "reference", 1) is None
    assert st2.rate("sweep_system", "reference", 4) is None


def test_store_trust_threshold_and_old_weight_cap(tmp_path):
    st = _store(tmp_path)
    st.record("sweep_tlb", "cuda", 4, 1e6, weight=W / 10)
    assert st.rate("sweep_tlb", "cuda", 4) is None   # one tiny smoke chunk
    st.record("sweep_tlb", "reference", 4, 1.0, weight=1e9)
    st.record("sweep_tlb", "reference", 4, 101.0, weight=W)
    assert st.rate("sweep_tlb", "reference", 4) == pytest.approx((1.0 * 10 + 101.0) / 11)


def test_store_merge_equals_jax(tmp_path):
    rows = [("sweep_system", "reference", 9, 3e5, 4 * W), ("sweep_system", "reference", 9,
                                                            5e5, 2 * W),
            ("sweep_timeline", "reference", 1, 7e4, 1e9), ("sweep_timeline", "reference", 1,
                                                           9e4, W)]
    t = CalibrationStore(tmp_path / "t" / "c.json", device=DEV)
    j = jdispatch.CalibrationStore(tmp_path / "j" / "c.json", device=DEV)
    t.record_many(rows)
    j.record_many(rows)
    for eng, mode, b, _, _ in rows:
        assert t.rate(eng, mode, b) == j.rate(eng, mode, b)


def test_tables_are_read_by_either_package(tmp_path):
    st = _store(tmp_path, reference=2e6)
    assert jdispatch.CalibrationStore(st.path, device=DEV).rate(
        "sweep_timeline", "reference", 8) == pytest.approx(2e6)


def test_corrupt_table_is_refused_not_regenerated(tmp_path):
    st = _store(tmp_path, reference=1e6)
    data = bytearray(st.path.read_bytes())
    data[-10] ^= 0x40
    st.path.write_bytes(bytes(data))
    fresh = CalibrationStore(st.path, device=DEV)
    with pytest.raises(CalibrationCorruptError, match="checksum"):
        fresh.load()
    with pytest.raises(CalibrationCorruptError):
        fresh.record("sweep_tlb", "reference", 4, 1e6, weight=W)
    assert st.path.read_bytes() == bytes(data)   # left in place, untouched


def test_truncated_and_foreign_tables_are_refused(tmp_path):
    p = tmp_path / "calib-test.json"
    p.write_text('{"rates": {}}\n')
    st = CalibrationStore(p, device=DEV)
    with pytest.raises(CalibrationCorruptError, match="not a repro-dispatch-calib"):
        st.load()
    p.write_bytes(b"no newline header at all")
    with pytest.raises(CalibrationCorruptError, match="no header"):
        st.load()


def test_decision_json_round_trip(tmp_path):
    st = _store(tmp_path, reference=2e6, cuda=1e8)
    d = dispatch.decide_timeline("auto", batch=8, n_accesses=4096, store=st, device="cuda")
    assert d.mode == "cuda"
    assert DispatchDecision.from_json(d.to_json()) == d
    assert DispatchDecision.from_json(json.loads(json.dumps(d.to_json()))) == d


def test_store_for_keys_the_table_by_device(tmp_path):
    assert dispatch.store_for(None) is None
    st = dispatch.store_for(tmp_path, "cpu")
    assert st.path.name == "calib-cpu.json" and st.device_kind == "cpu"
    st = CalibrationStore.for_dir(tmp_path, device={"device_kind": "NVIDIA H100 80GB HBM3"})
    assert st.path.name == "calib-nvidia-h100-80gb-hbm3.json"


# ---------------------------------------------------------------------------
# Cold start.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,generic", [("cpu", "reference"), ("cuda", "cuda")])
def test_cold_start_rules(device, generic):
    d = dispatch.decide_tlb("auto", _specs(4), device=device)
    assert (d.mode, d.calibration) == ("stackdist", "cold_start")
    d = dispatch.decide_tlb("auto", _specs(32), device=device)
    assert d.mode == generic and "stackdist" not in d.candidates
    assert dispatch.decide_system("auto", [SystemSimConfig(num_partitions=8)],
                                  device=device).mode == generic
    for batch in (1, 8, 40):
        assert dispatch.decide_timeline("auto", batch=batch, device=device).mode == generic


def test_single_sim_timeline_takes_the_kernel_on_the_card():
    """The JAX cold start sends a batch-1 timeline to its scan (a TPU ran
    its kernel at 0.87x there); on the H100 the kernel is ~1,800x its plain
    version, so the port's does not."""
    assert dispatch.cold_start_mode("sweep_timeline", batch=1, device="cuda") == "cuda"
    assert dispatch.cold_start_mode("sweep_timeline", batch=1, device="cpu") == "reference"
    assert jdispatch.cold_start_mode("sweep_timeline", batch=1) == "reference"


def test_explicit_mode_is_honoured_verbatim(tmp_path):
    st = _store(tmp_path, reference=1e7, cuda=1e5)
    d = dispatch.decide_timeline("cuda", batch=8, store=st, device="cuda")
    assert (d.mode, d.calibration) == ("cuda", "explicit")
    d = dispatch.decide_tlb("stackdist", _specs(32), device="cpu")
    assert (d.mode, d.calibration) == ("stackdist", "explicit")


def test_invalid_and_sweep_only_modes_raise():
    with pytest.raises(ValueError, match="timeline"):
        dispatch.decide_timeline("stackdist", batch=8)
    with pytest.raises(ValueError, match="stack"):
        dispatch.decide_system("stackdist", [SystemSimConfig()])
    with pytest.raises(ValueError, match="bogus"):
        dispatch.decide_tlb("bogus", _specs(4))
    with pytest.raises(ValueError, match="pallas_interpret"):
        dispatch.decide_tlb("pallas_interpret", _specs(4))
    with pytest.raises(ValueError, match="needs data on a CUDA device"):
        dispatch.decide_system("cuda", [SystemSimConfig()], device="cpu")


# ---------------------------------------------------------------------------
# Calibrated choice.
# ---------------------------------------------------------------------------

def test_calibrated_choice_is_argmax_measured_rate(tmp_path):
    """The card's one calibrated choice, a TLB sweep's stack-distance engine
    against the LRU kernel; on the CPU the same choice against the plain
    version."""
    st = _store(tmp_path, engine="sweep_tlb", batch=2, stackdist=1.8e6, cuda=2.7e5)
    d = dispatch.decide_tlb("auto", _specs(4), n_accesses=4096, store=st, device="cuda")
    assert d.mode == "stackdist" and d.calibration.startswith("measured:")
    st2 = _store(tmp_path / "other", engine="sweep_tlb", batch=2, stackdist=1e5, cuda=9e8)
    d = dispatch.decide_tlb("auto", _specs(4), n_accesses=4096, store=st2, device="cuda")
    assert d.mode == "cuda"
    preds = {m: c["predicted_s"] for m, c in d.candidates.items() if c["predicted_s"]}
    assert min(preds, key=preds.get) == d.mode
    st3 = _store(tmp_path / "cpu", engine="sweep_tlb", batch=2, stackdist=1e5, reference=9e5)
    d = dispatch.decide_tlb("auto", _specs(4), n_accesses=4096, store=st3, device="cpu")
    assert d.mode == "reference" and d.calibration.startswith("measured:")


@pytest.mark.parametrize("engine", ["sweep_tlb", "sweep_system", "sweep_timeline"])
def test_the_card_never_offers_the_plain_version(tmp_path, engine):
    """A table that rates the plain version far above the kernel does not
    send ``auto`` to it on the card: it is no candidate there."""
    st = _store(tmp_path, engine=engine, batch=2, reference=9e12, cuda=1.0)
    if engine == "sweep_tlb":
        d = dispatch.decide_tlb("auto", _specs(32), n_accesses=4096, store=st, device="cuda")
    elif engine == "sweep_system":
        d = dispatch.decide_system("auto", [SystemSimConfig(), SystemSimConfig()],
                                   n_accesses=4096, store=st, device="cuda")
    else:
        d = dispatch.decide_timeline("auto", batch=2, n_accesses=4096, store=st, device="cuda")
    assert d.mode == "cuda" and "reference" not in d.candidates


def test_half_measured_table_stays_on_cold_start(tmp_path):
    st = _store(tmp_path, reference=9e9)
    d = dispatch.decide_timeline("auto", batch=8, n_accesses=4096, store=st, device="cuda")
    assert d.mode == "cuda" and "not measured" in d.reason
    st2 = _store(tmp_path / "other", cuda=1e6)
    d = dispatch.decide_timeline("auto", batch=8, n_accesses=4096, store=st2, device="cuda")
    assert d.mode == "cuda" and "rival" in d.reason


def _norm(d: dict, path_map=(), *, on_card=False) -> dict:
    """A JAX decision in the port's vocabulary: ``pallas`` read as ``cuda``,
    ``pallas_interpret`` dropped (and on the card ``reference`` too, unless
    asked for explicitly), table paths replaced."""
    def mode(m):
        return "cuda" if m == "pallas" else m

    d = json.loads(json.dumps(d))
    d["mode"] = mode(d["mode"])
    d["requested"] = mode(d["requested"])
    drop = {"pallas_interpret"} | ({"reference"} if on_card and d["mode"] != "reference"
                                   else set())
    d["candidates"] = {mode(m): c for m, c in d["candidates"].items() if m not in drop}
    for a, b in path_map:
        d["calibration"] = d["calibration"].replace(a, b)
    d["reason"] = d["reason"].replace("pallas=", "cuda=").replace("'pallas'", "'cuda'")
    d["reason"] = d["reason"].replace("kernel_mode='pallas'", "kernel_mode='cuda'")
    return d


PARITY = [
    # (engine, mode, backend, rates {port mode: rate} or None)
    ("tlb4", "auto", "cpu", None), ("tlb4", "auto", "tpu", None),
    ("tlb32", "auto", "cpu", None), ("tlb32", "auto", "tpu", None),
    ("system", "auto", "cpu", None), ("system", "auto", "tpu", None),
    ("timeline", "auto", "tpu", None), ("timeline", "reference", "tpu", None),
    ("timeline", "auto", "tpu", {"reference": 2e5, "cuda": 9e7}),
    ("timeline", "auto", "tpu", {"reference": 9e7, "cuda": 2e5}),
    ("timeline", "auto", "tpu", {"cuda": 9e7}),
    ("system", "auto", "tpu", {"reference": 3e5, "cuda": 4e8}),
    ("tlb32", "auto", "tpu", {"reference": 3e5}),
    ("tlb4", "auto", "tpu", {"stackdist": 3e7, "reference": 3e5, "cuda": 1e9}),
]


@pytest.mark.parametrize("case", PARITY, ids=[f"{e}-{m}-{b}-{'cal' if r else 'cold'}"
                                              for e, m, b, r in PARITY])
def test_decisions_equal_jax(tmp_path, monkeypatch, case):
    import repro.kernels.common as kc

    engine, mode, backend, rates = case
    monkeypatch.setattr(kc.jax, "default_backend", lambda: backend)
    device = "cuda" if backend == "tpu" else "cpu"
    batch = {"tlb4": 2, "tlb32": 2, "system": 2, "timeline": 8}[engine]
    eng = {"tlb4": "sweep_tlb", "tlb32": "sweep_tlb", "system": "sweep_system",
           "timeline": "sweep_timeline"}[engine]
    stores = (None, None)
    if rates:
        t = CalibrationStore(tmp_path / "t" / "calib.json", device=DEV)
        j = jdispatch.CalibrationStore(tmp_path / "j" / "calib.json", device=DEV)
        t.record_many([(eng, m, batch, r, 10 * W) for m, r in rates.items()])
        # On the card the JAX package decides over the port's candidates: its
        # plain version left unmeasured at this batch (its rate goes to the
        # one-sim bucket, which no case here reads, so the table exists as
        # the port's does).
        j.record_many([(eng, "pallas" if m == "cuda" else m,
                        1 if device == "cuda" and m == "reference" else batch, r, 10 * W)
                       for m, r in rates.items()])
        stores = (t, j)
    jmode = "pallas" if mode == "cuda" else mode
    kw = {"n_accesses": 4096}
    if engine.startswith("tlb"):
        ways = 4 if engine == "tlb4" else 32
        got = dispatch.decide_tlb(mode, _specs(ways), store=stores[0], device=device, **kw)
        want = jdispatch.decide_tlb(jmode, _specs(ways, JTLBSweepSpec, JTLBConfig),
                                    store=stores[1], **kw)
    elif engine == "system":
        got = dispatch.decide_system(mode, [SystemSimConfig(num_partitions=8),
                                            SystemSimConfig(accel_tlb=None)],
                                     store=stores[0], device=device, **kw)
        want = jdispatch.decide_system(jmode, [JSystemSimConfig(num_partitions=8),
                                               JSystemSimConfig(accel_tlb=None)],
                                       store=stores[1], **kw)
    else:
        got = dispatch.decide_timeline(mode, batch=batch, store=stores[0], device=device, **kw)
        want = jdispatch.decide_timeline(jmode, batch=batch, store=stores[1], **kw)
    paths = ((str(tmp_path / "j"), str(tmp_path / "t")),)
    assert got.to_json() == _norm(want.to_json(), paths, on_card=device == "cuda")


# ---------------------------------------------------------------------------
# Feedback, resume stickiness, ingesters, GC.
# ---------------------------------------------------------------------------

def test_observe_records_achieved_rates_and_residual_events(tmp_path):
    st = _store(tmp_path)
    d = dispatch.decide_timeline("auto", batch=8, n_accesses=4096, store=st, device="cpu")
    log = tmp_path / "run.jsonl"
    with telemetry.run_scope(log, run="t"):
        dispatch.record_decision(d, name="fig")
        dispatch.observe(d, {"reference": {"sim_accesses_per_s": 5e5, "sim_accesses": 4e6}},
                         store=st, name="fig")
    assert st.rate("sweep_timeline", "reference", 8) == pytest.approx(5e5)
    kinds = [(r.get("kind"), r.get("name"))
             for r in map(json.loads, log.read_text().splitlines())]
    assert ("event", "dispatch") in kinds and ("event", "dispatch_residual") in kinds


def test_resume_reuses_the_checkpointed_decision(tmp_path):
    calib = tmp_path / "calibration"
    store = dispatch.store_for(calib, "cpu")
    store.record_many([("sweep_tlb", "reference", 2, 2e6, 10 * W)])
    rng = np.random.default_rng(7)
    addrs = rng.integers(0, 1 << 22, 4096).astype(np.int64)
    specs = _specs(32)
    oracle = sweep_tlb(addrs, specs, kernel_mode="reference", device="cpu").hits

    def cfg(**kw):
        return SweepRunConfig(checkpoint_dir=str(tmp_path / "ckpt"),
                              calibration_dir=str(calib), chunk_accesses=1024,
                              backoff_base_s=0.0, backoff_cap_s=0.0,
                              preemption=PreemptionHandler(install=False), **kw)

    with pytest.raises(SimulatedKill):
        run_sweep_tlb(addrs, specs, block=BLOCK, device="cpu",
                      run=cfg(on_chunk_committed=kill_after(2)), name="tlb")
    res, meta = run_sweep_tlb(addrs, specs, block=BLOCK, device="cpu", run=cfg(resume=True),
                              name="tlb")
    assert meta["final_mode"] == "reference" and meta["dispatch"]["mode"] == "reference"
    assert meta["dispatch"]["calibration"].startswith("checkpoint:measured:")
    assert "reused from checkpoint" in meta["dispatch"]["reason"]
    np.testing.assert_array_equal(res.hits.numpy(), oracle.numpy())
    # The runs fed their achieved rates back: 4 chunks x 4096 accesses x 2 configs.
    assert store.load()["rates"]["sweep_tlb"]["reference"]["bN"]["weight"] > 10 * W


def test_run_meta_carries_decision_cold_and_explicit():
    rng = np.random.default_rng(9)
    addrs = rng.integers(0, 1 << 22, 1024).astype(np.int64)
    run = SweepRunConfig(preemption=PreemptionHandler(install=False))
    _, meta = run_sweep_tlb(addrs, _specs(32), kernel_mode="reference", block=BLOCK, run=run,
                            name="t", device="cpu")
    assert (meta["dispatch"]["calibration"], meta["dispatch"]["mode"]) == ("explicit",
                                                                          "reference")
    _, meta = run_sweep_tlb(addrs, _specs(4), block=BLOCK, run=run, name="t", device="cpu")
    assert (meta["dispatch"]["mode"], meta["dispatch"]["calibration"]) == ("stackdist",
                                                                          "cold_start")
    assert meta["final_mode"] == "stackdist" and "throughput" in meta


def test_ingest_bench_entries_reads_the_ports_rows_only(tmp_path):
    st = _store(tmp_path)
    n = dispatch.ingest_bench_entries(st, [
        {"device_kind": "TestCPU", "bench": "sweep", "n_accesses": 1e5, "n_configs": 8,
         "t_reference_s": 0.5, "t_stackdist_s": 0.1, "t_cuda_s": 0.01},
        {"device_kind": "SomeTPU", "bench": "sweep", "n_accesses": 1e5, "n_configs": 8,
         "t_reference_s": 0.01},
        {"device_kind": "TestCPU", "bench": "timeline_batched", "n_accesses": 1e4,
         "n_sims": 12, "t_batched_s": 0.2, "t_cuda_s": 0.002},
        {"device_kind": "TestCPU", "bench": "system_batched", "n_accesses": 1e4,
         "n_configs": 9, "t_batched_s": 0.3, "t_pallas_s": 0.001},   # a reference row
    ])
    assert n == 6
    assert st.rate("sweep_tlb", "cuda", 8) == pytest.approx(8e5 / 0.01)
    assert st.rate("sweep_tlb", "stackdist", 8) == pytest.approx(8e5 / 0.1)
    assert st.rate("sweep_timeline", "cuda", 12) == pytest.approx(1.2e5 / 0.002)
    assert st.rate("sweep_system", "reference", 9) == pytest.approx(9e4 / 0.3)
    assert st.rate("sweep_system", "cuda", 9) is None and st.rate("sweep_system", "pallas",
                                                                  9) is None


def test_ingest_runlogs_reads_chunk_spans(tmp_path):
    st = _store(tmp_path)
    log = tmp_path / "fig.jsonl"
    recs = [
        {"kind": "run_start", "meta": {"device": {"device_kind": "TestCPU"}}},
        {"kind": "span", "name": "chunk",
         "attrs": {"engine": "sweep_system", "mode": "cuda", "configs": 3,
                   "accesses": 2048, "sim_accesses_per_s": 7e5}},
        {"kind": "span", "name": "chunk",
         "attrs": {"engine": "sweep_system", "mode": "auto", "configs": 3,
                   "accesses": 2048, "sim_accesses_per_s": 1e9}},
    ]
    log.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    foreign = tmp_path / "foreign.jsonl"
    foreign.write_text(json.dumps({"kind": "run_start",
                                   "meta": {"device": {"device_kind": "SomeTPU"}}}) + "\n"
                       + json.dumps(recs[1]) + "\n")
    assert dispatch.ingest_runlogs(st, [log, foreign, tmp_path / "nope"]) == 1
    assert st.rate("sweep_system", "cuda", 3) == pytest.approx(7e5)


def test_gc_sweeps_stale_tables_but_never_fresh_or_foreign(tmp_path):
    stale = _store(tmp_path, reference=1e6)
    fresh = CalibrationStore(tmp_path / "calib-fresh.json", device={"device_kind": "Fresh"})
    fresh.record("sweep_tlb", "reference", 1, 1e6, weight=W)
    foreign = tmp_path / "notes.json"
    foreign.write_text("{}")
    tmpfile = tmp_path / "calib-x.json.tmp-deadbeef"
    tmpfile.write_text("torn")
    old = 30 * 86400.0
    for p in (stale.path, foreign, tmpfile):
        os.utime(p, (p.stat().st_mtime - old, p.stat().st_mtime - old))
    dry = dispatch.gc_calibration(tmp_path, age_s=7 * 86400.0, dry_run=True)
    assert dry["dry_run"] and stale.path.exists()
    out = dispatch.gc_calibration(tmp_path, age_s=7 * 86400.0)
    assert sorted(out["deleted"]) == sorted([str(stale.path), str(tmpfile)])
    assert str(foreign) in out["skipped_foreign"]
    assert fresh.path.exists() and foreign.exists() and str(fresh.path) in out["kept_young"]
