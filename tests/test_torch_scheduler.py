"""The port's shard scheduler (``repro_torch.core.scheduler``), held to the
JAX package's (``tests/test_scheduler.py``) on its inputs: the TLB, system
and timeline engines, 4 sweep items each, ``BLOCK`` 128, the JAX scheduler
with ``kernel_mode="reference"`` and the port's with ``device="cpu"``,
tolerance 0.  The serial and thread executors here; the process executor
(spawned workers, a real SIGKILL, the ``smoke_sched`` subprocess) in
``tests/test_torch_scheduler_process.py``.

* sharded arrays bit-identical to the JAX package's monolithic engines;
* the serial event-name sequence, ``shard_map`` and ``quarantined_shards``
  equal to the JAX scheduler's given the same poisoned shard;
* a straggler duplicated and verified identical; a resume from shard
  checkpoints, and shard blobs written by one package resumed by the other;
* ``gc_checkpoints`` giving the JAX package's summary on the same tree;
* ``crash_safety`` and ``EX_DEGRADED`` as the JAX drivers have them;
* a fatal error in a shard (a failed build, a sticky CUDA error) aborting
  the run instead of counting toward quarantine.

The routed figure drivers: ``tests/test_torch_scheduler_figs.py``.
"""
import os
import time

import numpy as np
import pytest
import torch
from _faultinject import HoldShard as JHoldShard
from _faultinject import PoisonShard as JPoisonShard

from benchmarks import common as jcommon
from repro.checkpoint.checkpoint import BLOB_MAGIC as JBLOB_MAGIC
from repro.core import scheduler as jsched
from repro.core.orchestrator import SweepRunConfig as JSweepRunConfig
from repro.core.sparta import SystemLatencies as JLat
from repro.core.sparta import TLBConfig as JTLBConfig
from repro.core.sweep import TLBSweepSpec as JTLBSweepSpec
from repro.core.sweep import sweep_system as jsweep_system
from repro.core.sweep import sweep_tlb as jsweep_tlb
from repro.core.timeline import TimelineConfig as JTimelineConfig
from repro.core.timeline import TimelineSpec as JTimelineSpec
from repro.core.timeline import sweep_timeline as jsweep_timeline
from repro.core.tlbsim import SystemSimConfig as JSystemSimConfig
from repro.runtime import telemetry as jtelemetry
from repro.runtime.fault_tolerance import PreemptionHandler as JPreemptionHandler
from repro_torch.bench import common
from repro_torch.bench.faultinject import HoldShard, PoisonShard, RaiseOnShard
from repro_torch.checkpoint.checkpoint import BLOB_MAGIC, acquire_lease
from repro_torch.core import scheduler as sched_mod
from repro_torch.core.orchestrator import SweepRunConfig
from repro_torch.core.scheduler import (EX_DEGRADED, ScheduleConfig, gc_checkpoints,
                                        run_sweep_system, run_sweep_timeline, run_sweep_tlb)
from repro_torch.core.sparta import SystemLatencies, TLBConfig
from repro_torch.core.sweep import TLBSweepSpec, sweep_system
from repro_torch.core.timeline import TimelineConfig, TimelineSpec, sweep_timeline
from repro_torch.core.tlbsim import SystemSimConfig
from repro_torch.kernels._build import CudaError, KernelBuildError
from repro_torch.runtime import telemetry
from repro_torch.runtime.fault_tolerance import PreemptionHandler

BLOCK = 128
ENGINES = ("tlb", "system", "timeline")


def _cfg(tmp_path, **kw):
    kw.setdefault("backoff_base_s", 0.0)
    kw.setdefault("backoff_cap_s", 0.0)
    kw.setdefault("keep_checkpoint", True)
    kw.setdefault("preemption", PreemptionHandler(install=False))
    return SweepRunConfig(checkpoint_dir=str(tmp_path), **kw)


def _jcfg(tmp_path, **kw):
    kw.setdefault("backoff_base_s", 0.0)
    kw.setdefault("backoff_cap_s", 0.0)
    kw.setdefault("keep_checkpoint", True)
    kw.setdefault("preemption", JPreemptionHandler(install=False))
    return JSweepRunConfig(checkpoint_dir=str(tmp_path), **kw)


def _sched_kw(**kw):
    kw.setdefault("shards", 2)
    kw.setdefault("workers", 2)
    kw.setdefault("executor", "thread")
    kw.setdefault("poll_s", 0.01)
    kw.setdefault("lease_ttl_s", 5.0)
    kw.setdefault("heartbeat_s", 0.2)
    return kw


def _sched(**kw):
    return ScheduleConfig(**_sched_kw(**kw))


def _jsched(**kw):
    return jsched.ScheduleConfig(**_sched_kw(**kw))


# ---------------------------------------------------------------------------
# One harness per engine, the JAX test's inputs: run(cfg, sched) and
# jrun(jcfg, jsched) -> (list of arrays, meta); the oracle is the JAX
# package's monolithic engine.
# ---------------------------------------------------------------------------

def _tlb_engine():
    rng = np.random.default_rng(7)
    addrs = rng.integers(0, 1 << 22, 4096).astype(np.int64)
    parts = (1, 4, 8, 16)
    specs = [TLBSweepSpec(TLBConfig(entries=64, ways=4), num_partitions=p) for p in parts]
    jspecs = [JTLBSweepSpec(JTLBConfig(entries=64, ways=4), num_partitions=p) for p in parts]

    def run(cfg, sched, **kw):
        res, meta = run_sweep_tlb(addrs, specs, kernel_mode="reference", block=BLOCK, run=cfg,
                                  sched=sched, name="tlb", device="cpu", **kw)
        return [res.hits.numpy()], meta

    def jrun(cfg, sched):
        res, meta = jsched.run_sweep_tlb(addrs, jspecs, kernel_mode="reference", block=BLOCK,
                                         run=cfg, sched=sched, name="tlb")
        return [np.asarray(res.hits)], meta

    oracle = [np.asarray(jsweep_tlb(addrs, jspecs, kernel_mode="reference", block=BLOCK).hits)]
    return run, jrun, oracle


_SYSTEM_KW = [dict(num_partitions=8), dict(accel=(16, 4), num_partitions=4),
              dict(cache=None, page_shift=21, num_partitions=32), dict(num_partitions=2)]


def _system_cfgs(cls, tlb):
    out = []
    for k in _SYSTEM_KW:
        k = dict(k)
        if "accel" in k:
            e, w = k.pop("accel")
            k["accel_tlb"] = tlb(entries=e, ways=w)
        out.append(cls(**k))
    return out


def _system_engine():
    rng = np.random.default_rng(11)
    lines = rng.integers(0, 1 << 26, 4096).astype(np.int64)
    cfgs = _system_cfgs(SystemSimConfig, TLBConfig)
    jcfgs = _system_cfgs(JSystemSimConfig, JTLBConfig)

    def run(cfg, sched, **kw):
        bev, meta = run_sweep_system(lines, cfgs, kernel_mode="reference", block=BLOCK,
                                     run=cfg, sched=sched, name="system", device="cpu", **kw)
        return [bev.cache_hit.numpy(), bev.accel_tlb_hit.numpy(), bev.mem_tlb_hit.numpy()], meta

    def jrun(cfg, sched):
        bev, meta = jsched.run_sweep_system(lines, jcfgs, kernel_mode="reference", block=BLOCK,
                                            run=cfg, sched=sched, name="system")
        return [np.asarray(x) for x in (bev.cache_hit, bev.accel_tlb_hit, bev.mem_tlb_hit)], meta

    o = jsweep_system(lines, jcfgs, kernel_mode="reference", block=BLOCK)
    return run, jrun, [np.asarray(x) for x in (o.cache_hit, o.accel_tlb_hit, o.mem_tlb_hit)]


_TIMELINE_SPECS = [  # (trace, design, (mshrs, ports, banks), partitions, accelerators)
    ("a", "sparta", (4, 1, 8), 8, 2),
    ("b", "ideal", (2, 1, 4), 1, 4),
    ("a", "conventional", (4, 1, 8), 1, 1),
    ("b", "sparta", (2, 1, 4), 2, 2),
]


def _timeline_engine():
    rng = np.random.default_rng(3)
    lines = {"a": rng.integers(0, 1 << 24, 2048).astype(np.int64),
             "b": rng.integers(0, 1 << 24, 1200).astype(np.int64)}
    parts = {"a": 8, "b": 2}
    ev = {k: sweep_system(v, [SystemSimConfig(num_partitions=parts[k])],
                          device="cpu")[0] for k, v in lines.items()}
    jev = {k: jsweep_system(v, [JSystemSimConfig(num_partitions=parts[k])])[0]
           for k, v in lines.items()}

    def specs(spec_cls, cfg_cls, events):
        return [spec_cls(lines[t], events[t], d, cfg=cfg_cls(mshrs=m, tlb_ports=p, dram_banks=b),
                         num_partitions=P, num_accelerators=A)
                for t, d, (m, p, b), P, A in _TIMELINE_SPECS]

    tspecs = specs(TimelineSpec, TimelineConfig, ev)
    jspecs = specs(JTimelineSpec, JTimelineConfig, jev)

    def run(cfg, sched, **kw):
        res, meta = run_sweep_timeline(tspecs, SystemLatencies(), kernel_mode="reference",
                                       block=BLOCK, run=cfg, sched=sched, name="timeline",
                                       device="cpu", **kw)
        return [a for r in res for a in (r.latency, r.overhead, r.done)], meta

    def jrun(cfg, sched):
        res, meta = jsched.run_sweep_timeline(jspecs, JLat(), kernel_mode="reference",
                                              block=BLOCK, run=cfg, sched=sched, name="timeline")
        return [np.asarray(a) for r in res for a in (r.latency, r.overhead, r.done)], meta

    oracle = [np.asarray(a)
              for r in jsweep_timeline(jspecs, JLat(), kernel_mode="reference", block=BLOCK)
              for a in (r.latency, r.overhead, r.done)]
    # The port's own monolithic engine agrees with the JAX package's.
    mono = [a for r in sweep_timeline(tspecs, SystemLatencies(), kernel_mode="reference",
                                      device="cpu")
            for a in (r.latency, r.overhead, r.done)]
    _assert_bits(mono, oracle, "timeline/monolithic")
    return run, jrun, oracle


_BUILDERS = {"tlb": _tlb_engine, "system": _system_engine, "timeline": _timeline_engine}
_CASES = {}


def _engine(name):
    if name not in _CASES:   # traces + oracle built once per engine
        _CASES[name] = _BUILDERS[name]()
    return _CASES[name]


def _assert_bits(got, want, ctx=""):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} output {i}")


def _event_names(meta):
    return [e["event"] for e in meta["scheduler"]["events"]]


# ---------------------------------------------------------------------------
# Bit-identity of the happy path, serial and threaded.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("executor,workers", [("serial", 1), ("thread", 2)])
def test_sharded_bit_identity_equals_jax(tmp_path, engine, executor, workers):
    run, _, oracle = _engine(engine)
    got, meta = run(_cfg(tmp_path), _sched(executor=executor, workers=workers))
    _assert_bits(got, oracle, f"{engine}/{executor}")
    s = meta["scheduler"]
    assert s["shards"] == 2 and s["executor"] == executor
    assert not s["quarantined_shards"]
    assert all(sm["state"] == "done" for sm in s["shard_map"])
    assert [sm["name"] for sm in s["shard_map"]] == [f"{engine}.s00of02", f"{engine}.s01of02"]
    assert meta["final_mode"] == meta["start_mode"] == "reference"
    assert meta["dispatch"]["mode"] == "reference"
    assert s["launches"] == {}   # the plain version launches no kernel


def test_no_or_a_disabled_schedule_is_the_orchestrator(tmp_path):
    run, _, oracle = _engine("tlb")
    got, meta = run(_cfg(tmp_path), None)
    _assert_bits(got, oracle, "tlb/passthrough")
    assert "scheduler" not in meta
    got, meta = run(_cfg(tmp_path), _sched(shards=1, workers=1, executor="auto"))
    _assert_bits(got, oracle, "tlb/disabled")
    assert "scheduler" not in meta


def test_without_a_card_the_sharded_entry_points_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        run_sweep_tlb(np.arange(64, dtype=np.int64),
                      [TLBSweepSpec(TLBConfig(entries=64, ways=4), num_partitions=p)
                       for p in (1, 2)], sched=_sched())


@pytest.mark.parametrize("engine", ENGINES)
def test_resume_completes_from_shard_checkpoints(tmp_path, engine):
    run, _, oracle = _engine(engine)
    run(_cfg(tmp_path), _sched(executor="serial", workers=1))
    assert sorted(p.name for p in tmp_path.glob("*.ckpt")) == \
        [f"{engine}.s00of02.ckpt", f"{engine}.s01of02.ckpt"]
    assert not list(tmp_path.glob("*.lease"))
    got, meta = run(_cfg(tmp_path, resume=True), _sched(executor="serial", workers=1))
    _assert_bits(got, oracle, f"{engine}/resume")
    assert meta["completed_from_checkpoint"] is True


# ---------------------------------------------------------------------------
# Cross-package: a shard blob written by either package resumes in the other.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shard_checkpoints_resume_across_packages(tmp_path, engine, writer):
    run, jrun, oracle = _engine(engine)
    if writer == "jax":
        jrun(_jcfg(tmp_path), _jsched(executor="serial", workers=1))
        got, meta = run(_cfg(tmp_path, resume=True), _sched(executor="serial", workers=1))
    else:
        run(_cfg(tmp_path), _sched(executor="serial", workers=1))
        got, meta = jrun(_jcfg(tmp_path, resume=True), _jsched(executor="serial", workers=1))
    _assert_bits(got, oracle, f"{engine}/{writer}-written")
    assert meta["completed_from_checkpoint"] is True
    assert all(sm["completed_from_checkpoint"] for sm in meta["scheduler"]["shard_map"])


# ---------------------------------------------------------------------------
# Poison shard: quarantine, zero placeholders, the JAX scheduler's record.
# ---------------------------------------------------------------------------

def _strip_stamps(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "t_mono", "elapsed_s")}
            for e in events]


@pytest.mark.parametrize("engine", ENGINES)
def test_poison_shard_quarantine_equals_jax(tmp_path, engine):
    run, jrun, oracle = _engine(engine)
    got, meta = run(_cfg(tmp_path / "port"),
                    _sched(executor="serial", workers=1, max_shard_attempts=2,
                           on_shard_start=PoisonShard(0)))
    jgot, jmeta = jrun(_jcfg(tmp_path / "jax"),
                       _jsched(executor="serial", workers=1, max_shard_attempts=2,
                               on_shard_start=JPoisonShard(0)))
    s, js = meta["scheduler"], jmeta["scheduler"]
    assert _event_names(meta) == _event_names(jmeta)
    assert _strip_stamps(s["events"]) == _strip_stamps(js["events"])
    assert s["shard_map"] == js["shard_map"]
    assert s["quarantined_shards"] == js["quarantined_shards"]
    q = s["quarantined_shards"]
    assert len(q) == 1 and q[0]["shard"] == 0 and q[0]["failures"] == 2
    assert "poisoned shard 0" in q[0]["errors"][-1]
    _assert_bits(got, jgot, f"{engine}/poisoned, against JAX's")
    lo, hi = q[0]["items"]
    assert (lo, hi) == (0, 2)
    if engine == "timeline":
        _assert_bits(got[3 * hi:], oracle[3 * hi:], "timeline/healthy")
        assert not any(np.any(a) for a in got[:3 * hi])
    else:
        for a, b in zip(got, oracle):
            np.testing.assert_array_equal(a[hi:], b[hi:])
            assert not np.any(a[:hi])


def test_clean_serial_run_records_jax_event_sequence(tmp_path):
    run, jrun, _ = _engine("system")
    _, meta = run(_cfg(tmp_path / "port"), _sched(executor="serial", workers=1))
    _, jmeta = jrun(_jcfg(tmp_path / "jax"), _jsched(executor="serial", workers=1))
    assert _event_names(meta) == _event_names(jmeta) == \
        ["dispatch", "shard_done", "dispatch", "shard_done"]
    assert meta["scheduler"]["shard_map"] == jmeta["scheduler"]["shard_map"]
    assert meta["chunks_committed"] == jmeta["chunks_committed"]


def test_quarantine_hoisted_into_crash_safety_as_in_jax(tmp_path):
    run, _, _ = _engine("tlb")
    _, meta = run(_cfg(tmp_path), _sched(executor="serial", workers=1, max_shard_attempts=1,
                                         on_shard_start=PoisonShard(1)))
    before, jbefore = list(common._DEGRADED_RUNS), list(jcommon._DEGRADED_RUNS)
    try:
        common._DEGRADED_RUNS.clear()
        jcommon._DEGRADED_RUNS.clear()
        cs = common.crash_safety({"tlb": meta})
        assert cs == jcommon.crash_safety({"tlb": meta})
        assert cs["quarantined_shards"]["tlb"][0]["shard"] == 1
        assert cs["tlb"]["scheduler"]["shards"] == 2
        assert "quarantine" in cs["tlb"]["scheduler"]["events"]
        # Registered under the telemetry run's name (the last run's, when an
        # earlier test in this process left one), "?" without any.
        assert common.degraded_runs() == [telemetry.get_tracer().run or "?"]
        assert jcommon.degraded_runs() == [jtelemetry.get_tracer().run or "?"]
    finally:
        common._DEGRADED_RUNS[:] = before
        jcommon._DEGRADED_RUNS[:] = jbefore
    assert EX_DEGRADED == jsched.EX_DEGRADED == 79


def test_clean_run_has_empty_quarantine_manifest(tmp_path):
    run, _, _ = _engine("tlb")
    _, meta = run(_cfg(tmp_path), _sched(executor="serial", workers=1))
    before = list(common._DEGRADED_RUNS)
    assert common.crash_safety({"tlb": meta})["quarantined_shards"] == {}
    assert common._DEGRADED_RUNS == before


# ---------------------------------------------------------------------------
# Fatal errors abort; a program bug is a poisoned config.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exc", [
    lambda: KernelBuildError("nvcc failed (1): ..."),
    lambda: CudaError("system_sim_launch", 700, "an illegal memory access was encountered"),
    lambda: torch.AcceleratorError("CUDA error: unspecified launch failure"),
], ids=["build_error", "sticky_cuda_error", "accelerator_error"])
@pytest.mark.parametrize("executor,workers", [("serial", 1), ("thread", 2)])
def test_a_fatal_error_in_a_shard_aborts_the_run(tmp_path, exc, executor, workers):
    run, _, _ = _engine("system")
    seen = []

    class Hook(RaiseOnShard):
        def __call__(self, shard, attempt, worker):
            seen.append((shard, attempt))
            super().__call__(shard, attempt, worker)

    with pytest.raises(type(exc())):
        run(_cfg(tmp_path), _sched(executor=executor, workers=workers, max_shard_attempts=3,
                                   on_shard_start=Hook(0, exc())))
    assert seen.count((0, 0)) == 1 and (0, 1) not in seen   # no second attempt
    assert not list(tmp_path.glob("*.lease"))


def test_a_transient_cuda_error_is_not_fatal():
    from repro_torch.runtime.fault_tolerance import is_fatal, is_transient

    oom = CudaError("tlb_sim_launch", 2, "out of memory")
    assert not is_fatal(oom) and is_transient(oom)
    assert not is_fatal(CudaError("tlb_sim_launch", 701, "too many resources requested"))
    assert not is_fatal(ValueError("poisoned shard"))
    for code in (700, 716, 719):
        e = CudaError("x", code, "sticky")
        assert is_fatal(e) and not is_transient(e)
        assert sched_mod._portable(e).code == code     # survives a worker's pickling


# ---------------------------------------------------------------------------
# Straggler duplication: first completion wins, loser verified identical.
# ---------------------------------------------------------------------------

def test_straggler_duplicate_first_wins(tmp_path):
    run, _, oracle = _engine("tlb")
    sched = _sched(deadline_s=0.2, on_shard_start=HoldShard(0, 1.5, attempts=(0,)))
    t0 = time.monotonic()
    got, meta = run(_cfg(tmp_path), sched)
    _assert_bits(got, oracle, "tlb/straggler")
    dup = [e for e in meta["scheduler"]["events"] if e["event"] == "duplicate_verified"]
    assert dup and all(e["identical"] for e in dup)
    straggled = [e for e in meta["scheduler"]["events"]
                 if e["event"] == "redispatch" and e.get("reason") == "straggler"]
    assert straggled
    assert "quarantine" not in _event_names(meta)
    assert time.monotonic() - t0 >= 1.5


def test_straggler_duplicate_in_jax_has_the_same_shape(tmp_path):
    """The JAX scheduler, given the same hold, records the same kinds of
    event: a straggler re-dispatch and a verified duplicate."""
    _, jrun, _ = _engine("tlb")
    _, jmeta = jrun(_jcfg(tmp_path), _jsched(deadline_s=0.2,
                                             on_shard_start=JHoldShard(0, 1.5, attempts=(0,))))
    names = set(_event_names(jmeta))
    assert {"redispatch", "duplicate_verified", "shard_done", "dispatch"} <= names


# ---------------------------------------------------------------------------
# Checkpoint/lease GC: the JAX package's summary on the same tree.
# ---------------------------------------------------------------------------

def _age(p, age_s, now):
    t = now - age_s
    os.utime(p, (t, t))


def test_gc_checkpoints_equals_jax(tmp_path):
    from repro.core.scheduler import gc_checkpoints as jgc

    assert BLOB_MAGIC == JBLOB_MAGIC
    now = time.time()
    done, live = tmp_path / "done", tmp_path / "live"
    done.mkdir()
    live.mkdir()
    files = {"old": done / "old.ckpt", "young": done / "young.ckpt",
             "foreign": done / "foreign.ckpt", "tmp": done / "x.ckpt.tmp-123",
             "live": live / "shard.ckpt"}
    for k, p in files.items():
        p.write_bytes(b"not-a-repro-blob" if k == "foreign" else
                      b"partial" if k == "tmp" else BLOB_MAGIC.encode() + b"\n{}")
        _age(p, 0 if k == "young" else 3600, now)
    acquire_lease(live / "shard.lease", "w0", ttl_s=300.0)
    acquire_lease(done / "dead.lease", "w1", ttl_s=0.01)
    time.sleep(0.05)
    now = time.time()

    dry = gc_checkpoints(tmp_path, age_s=600.0, now=now, dry_run=True)
    assert dry == jgc(tmp_path, age_s=600.0, now=now, dry_run=True)
    assert str(files["old"]) in dry["deleted"] and files["old"].exists()
    summary = gc_checkpoints(tmp_path, age_s=600.0, now=now)
    assert summary == dict(dry, dry_run=False)
    assert not files["old"].exists() and not files["tmp"].exists()
    assert files["young"].exists() and str(files["young"]) in summary["kept_young"]
    assert files["foreign"].exists() and str(files["foreign"]) in summary["skipped_foreign"]
    assert files["live"].exists() and str(files["live"]) in summary["kept_in_progress"]
    assert not (done / "dead.lease").exists() and (live / "shard.lease").exists()


# ---------------------------------------------------------------------------
# Launch counts travel with the results.
# ---------------------------------------------------------------------------

class _NoteLaunches:
    """``on_shard_start``: the worker's thread counts ``n`` launches of
    ``name``, as a kernel wrapper does."""

    def __init__(self, name, n):
        self.name, self.n = name, n

    def __call__(self, shard, attempt, worker):
        from repro_torch.kernels.common import note_launch

        for _ in range(self.n):
            note_launch(self.name)


@pytest.mark.parametrize("executor,workers", [("serial", 1), ("thread", 2)])
def test_worker_launches_are_summed_in_the_scheduler_meta(tmp_path, executor, workers):
    from repro_torch.kernels.common import launch_tally

    run, _, _ = _engine("tlb")
    with launch_tally() as outer:
        _, meta = run(_cfg(tmp_path), _sched(executor=executor, workers=workers, shards=4,
                                             on_shard_start=_NoteLaunches("tlb_sim", 3)))
    assert meta["scheduler"]["launches"] == {"tlb_sim": 12}
    assert outer == {}    # each attempt counted in its own tally, not the caller's
