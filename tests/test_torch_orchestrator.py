"""The port's crash-safe sweep orchestrator (``repro_torch.core.orchestrator``),
held to the JAX package's (``tests/test_orchestrator.py``), for all three
engines on the CPU at 4 chunks:

* kill at every chunk boundary, then resume: bit-identical to the
  monolithic engine and to the JAX package's;
* corrupt, truncated, foreign-engine and fingerprint-mismatched blobs are
  refused;
* the ladder: retry, then halve, on transient faults only, and a one-block
  span that still fails raises: there is no downgrade to the plain version,
  and a blob the plain version wrote resumes on the kernel; a build error, a
  sticky CUDA error and a program bug raise at once; a failed blob write
  propagates without applying the chunk twice;
* preemption, by the handler's flag and by a real SIGTERM;
* the stack-distance engine runs monolithically;
* cross-package: a sweep the JAX package checkpointed resumes in the port
  (and the other way) to the uninterrupted result, and the port-side
  ``smoke_resume`` SIGTERMs a subprocess sweep and resumes it.

There is no card here, so the kernel is a seam of the tests: ``_as_cuda``
makes the dispatch layer take ``cuda`` for data on the CPU and the stream
run the plain version when asked for ``cuda``."""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
from _faultinject import SimulatedKill, corrupt_file, kill_after

from repro.core import orchestrator as jorch
from repro.core.sparta import SystemLatencies as JLat
from repro.core.sparta import TLBConfig as JTLBConfig
from repro.core.sweep import TLBSweepSpec as JTLBSweepSpec
from repro.core.sweep import sweep_system as jsweep_system
from repro.core.timeline import TimelineConfig as JTimelineConfig
from repro.core.timeline import TimelineSpec as JTimelineSpec
from repro.core.tlbsim import SystemSimConfig as JSystemSimConfig
from repro.runtime.fault_tolerance import PreemptionHandler as JPreemptionHandler
from repro_torch.checkpoint.checkpoint import CheckpointCorruptError
from repro_torch.core import dispatch
from repro_torch.core import orchestrator as orch
from repro_torch.core.orchestrator import (Preempted, SweepRunConfig, merge_throughput,
                                           run_sweep_system, run_sweep_timeline,
                                           run_sweep_tlb)
from repro_torch.core.sparta import SystemLatencies, TLBConfig
from repro_torch.core.sweep import (SystemSweepStream, TLBSweepSpec, TLBSweepStream,
                                    sweep_system, sweep_tlb)
from repro_torch.core.timeline import (TimelineConfig, TimelineSpec, TimelineSweepStream,
                                       sweep_timeline)
from repro_torch.core.tlbsim import SystemSimConfig
from repro_torch.kernels._build import CudaError, KernelBuildError
from repro_torch.runtime.fault_tolerance import PreemptionHandler

LAT = SystemLatencies()
BLOCK = 128
OOM = torch.cuda.OutOfMemoryError


def _cfg(tmp_path, **kw):
    kw.setdefault("backoff_base_s", 0.0)
    kw.setdefault("backoff_cap_s", 0.0)
    kw.setdefault("preemption", PreemptionHandler(install=False))
    return SweepRunConfig(checkpoint_dir=str(tmp_path), **kw)


def _jcfg(tmp_path, **kw):
    return jorch.SweepRunConfig(checkpoint_dir=str(tmp_path), backoff_base_s=0.0,
                                backoff_cap_s=0.0, preemption=JPreemptionHandler(install=False),
                                **kw)


# ---------------------------------------------------------------------------
# One harness per engine: run(cfg, kernel_mode) -> (outputs, meta), the
# monolithic oracle, the JAX package's run, the total, the chunk, the blob.
# Every case is exactly 4 chunks.
# ---------------------------------------------------------------------------

def _tlb_engine():
    rng = np.random.default_rng(7)
    addrs = rng.integers(0, 1 << 22, 4096).astype(np.int64)
    specs = [TLBSweepSpec(TLBConfig(entries=64, ways=4), num_partitions=p) for p in (1, 8)]
    jspecs = [JTLBSweepSpec(JTLBConfig(entries=64, ways=4), num_partitions=p) for p in (1, 8)]

    def run(cfg, kernel_mode="reference"):
        res, meta = run_sweep_tlb(addrs, specs, kernel_mode=kernel_mode, block=BLOCK, run=cfg,
                                  name="tlb", device="cpu")
        return [res.hits.numpy()], meta

    def jrun(cfg):
        res, meta = jorch.run_sweep_tlb(addrs, jspecs, kernel_mode="reference", block=BLOCK,
                                        run=cfg, name="tlb")
        return [np.asarray(res.hits)], meta

    oracle = [sweep_tlb(addrs, specs, kernel_mode="reference", device="cpu").hits.numpy()]
    return run, jrun, oracle, 4096, 1024, "tlb.ckpt"


def _system_engine():
    rng = np.random.default_rng(11)
    lines = rng.integers(0, 1 << 26, 4096).astype(np.int64)
    kw = [dict(num_partitions=8), dict(accel=(16, 4), num_partitions=4),
          dict(cache=None, page_shift=21, num_partitions=32)]

    def cfgs(cls, tlb):
        out = []
        for k in kw:
            k = dict(k)
            if "accel" in k:
                e, w = k.pop("accel")
                k["accel_tlb"] = tlb(entries=e, ways=w)
            out.append(cls(**k))
        return out

    tcfgs, jcfgs = cfgs(SystemSimConfig, TLBConfig), cfgs(JSystemSimConfig, JTLBConfig)

    def run(cfg, kernel_mode="reference"):
        bev, meta = run_sweep_system(lines, tcfgs, kernel_mode=kernel_mode, block=BLOCK,
                                     run=cfg, name="system", device="cpu")
        return [x.numpy() for x in (bev.cache_hit, bev.accel_tlb_hit, bev.mem_tlb_hit)], meta

    def jrun(cfg):
        bev, meta = jorch.run_sweep_system(lines, jcfgs, kernel_mode="reference", block=BLOCK,
                                           run=cfg, name="system")
        return [np.asarray(x) for x in (bev.cache_hit, bev.accel_tlb_hit,
                                        bev.mem_tlb_hit)], meta

    o = sweep_system(lines, tcfgs, kernel_mode="reference", device="cpu")
    oracle = [x.numpy() for x in (o.cache_hit, o.accel_tlb_hit, o.mem_tlb_hit)]
    return run, jrun, oracle, 4096, 1024, "system.ckpt"


def _timeline_specs(mod_spec, mod_cfg, events):
    rng = np.random.default_rng(3)
    lines_a = rng.integers(0, 1 << 24, 2048).astype(np.int64)
    lines_b = rng.integers(0, 1 << 24, 1200).astype(np.int64)
    ev_a, ev_b = events(lines_a, 8), events(lines_b, 2)
    return [
        mod_spec(lines_a, ev_a, "sparta", cfg=mod_cfg(mshrs=4, tlb_ports=1, dram_banks=8),
                 num_partitions=8, num_accelerators=2),
        mod_spec(lines_b, ev_b, "ideal", cfg=mod_cfg(mshrs=2, tlb_ports=1, dram_banks=4),
                 num_accelerators=4),
    ]


def _timeline_engine():
    specs = _timeline_specs(
        TimelineSpec, TimelineConfig,
        lambda x, p: sweep_system(x, [SystemSimConfig(num_partitions=p)], device="cpu")[0])
    jspecs = _timeline_specs(
        JTimelineSpec, JTimelineConfig,
        lambda x, p: jsweep_system(x, [JSystemSimConfig(num_partitions=p)])[0])

    def flat(res):
        return [np.asarray(a) for r in res for a in (r.latency, r.overhead, r.done)]

    def run(cfg, kernel_mode="reference"):
        res, meta = run_sweep_timeline(specs, LAT, kernel_mode=kernel_mode, block=BLOCK,
                                       run=cfg, name="timeline", device="cpu")
        return flat(res), meta

    def jrun(cfg):
        res, meta = jorch.run_sweep_timeline(jspecs, JLat(), kernel_mode="reference",
                                             block=BLOCK, run=cfg, name="timeline")
        return flat(res), meta

    oracle = flat(sweep_timeline(specs, LAT, kernel_mode="reference", device="cpu"))
    return run, jrun, oracle, 2048, 512, "timeline.ckpt"


_BUILDERS = {"tlb": _tlb_engine, "system": _system_engine, "timeline": _timeline_engine}
_CASES = {}
ENGINES = list(_BUILDERS)


def _engine(name):
    if name not in _CASES:
        _CASES[name] = _BUILDERS[name]()
    return _CASES[name]


def _assert_bits(got, want, ctx=""):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} output {i}")


@pytest.fixture
def _as_cuda(monkeypatch):
    """The kernel on the CPU: the dispatch layer takes ``cuda`` for data on
    the CPU, and the streams run the plain version when asked for ``cuda``.
    Returns the modes the streams were asked for."""
    asked = []
    monkeypatch.setattr(dispatch, "_on_card", lambda device: True)
    for cls in (TLBSweepStream, SystemSweepStream, TimelineSweepStream):
        real = cls.run_chunk

        def run_chunk(self, *args, _real=real, kernel_mode="auto"):
            asked.append(kernel_mode)
            return _real(self, *args, kernel_mode="reference")

        monkeypatch.setattr(cls, "run_chunk", run_chunk)
    return asked


# ---------------------------------------------------------------------------
# Kill at every chunk boundary + resume == uninterrupted run.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kill", [1, 2, 3])
def test_kill_and_resume_bit_identical(tmp_path, engine, kill):
    run, _, oracle, total, chunk, blob = _engine(engine)
    with pytest.raises(SimulatedKill):
        run(_cfg(tmp_path, chunk_accesses=chunk, on_chunk_committed=kill_after(kill)))
    assert (tmp_path / blob).exists()
    outs, meta = run(_cfg(tmp_path, chunk_accesses=chunk, resume=True))
    assert meta["resumed_from"] == kill * chunk
    assert meta["chunks_committed"] == 4
    assert meta["events"][0]["event"] == "resume"
    _assert_bits(outs, oracle, ctx=f"{engine} kill@{kill}")


@pytest.mark.parametrize("engine", ENGINES)
def test_kill_after_final_chunk_then_resume(tmp_path, engine):
    run, _, oracle, total, chunk, _ = _engine(engine)
    with pytest.raises(SimulatedKill):
        run(_cfg(tmp_path, chunk_accesses=chunk, on_chunk_committed=kill_after(4)))
    outs, meta = run(_cfg(tmp_path, chunk_accesses=chunk, resume=True))
    assert meta["resumed_from"] == total
    _assert_bits(outs, oracle, ctx=f"{engine} kill@final")


@pytest.mark.parametrize("engine", ENGINES)
def test_a_jax_checkpoint_resumes_in_the_port(tmp_path, engine):
    """The JAX package's run, killed after chunk 2 on the CPU, resumed by the
    port's orchestrator: equal to the JAX package's uninterrupted run."""
    run, jrun, oracle, total, chunk, blob = _engine(engine)
    want, _ = jrun(jorch.SweepRunConfig(chunk_accesses=chunk))
    _assert_bits(want, oracle, ctx=f"{engine} jax vs port oracle")
    with pytest.raises(SimulatedKill):
        jrun(_jcfg(tmp_path, chunk_accesses=chunk, on_chunk_committed=kill_after(2)))
    outs, meta = run(_cfg(tmp_path, chunk_accesses=chunk, resume=True))
    assert meta["resumed_from"] == 2 * chunk and meta["chunks_committed"] == 4
    assert meta["dispatch"]["calibration"] == "checkpoint:explicit"
    _assert_bits(outs, want, ctx=f"{engine} jax-checkpointed, port-resumed")


def test_a_port_checkpoint_resumes_in_jax(tmp_path):
    run, jrun, oracle, total, chunk, blob = _engine("timeline")
    with pytest.raises(SimulatedKill):
        run(_cfg(tmp_path, chunk_accesses=chunk, on_chunk_committed=kill_after(3)))
    outs, meta = jrun(_jcfg(tmp_path, chunk_accesses=chunk, resume=True))
    assert meta["resumed_from"] == 3 * chunk
    _assert_bits(outs, oracle, ctx="port-checkpointed, jax-resumed")


def test_clean_run_leaves_no_blob_and_matches_oracle(tmp_path):
    run, _, oracle, _, chunk, blob = _engine("tlb")
    outs, meta = run(_cfg(tmp_path, chunk_accesses=chunk))
    _assert_bits(outs, oracle)
    assert meta["chunks_committed"] == 4 and meta["resumable"] and meta["events"] == []
    assert not (tmp_path / blob).exists()
    outs2, _ = run(_cfg(tmp_path, chunk_accesses=chunk, keep_checkpoint=True))
    _assert_bits(outs2, oracle)
    assert (tmp_path / blob).exists()


@pytest.mark.parametrize("engine", ENGINES)
def test_a_run_with_no_checkpoint_keeps_its_results_on_the_device(tmp_path, engine,
                                                                   monkeypatch):
    """With no checkpoint directory the chunks' outputs stay where the
    stream put them (tensors on the data's device for the TLB and system
    sweeps, numpy for the timeline's) and the trace is never digested; the
    result is the oracle's."""
    run, _, oracle, _, chunk, _ = _engine(engine)
    digested = []
    real = orch._sha256_arrays
    monkeypatch.setattr(orch, "_sha256_arrays", lambda *a: digested.append(1) or real(*a))
    outs, meta = run(SweepRunConfig(chunk_accesses=chunk))
    _assert_bits(outs, oracle)
    assert meta["chunks_committed"] == 4 and meta["checkpoint"] is None
    assert not digested and not list(tmp_path.iterdir())
    _, _ = run(_cfg(tmp_path, chunk_accesses=chunk))
    assert digested    # a checkpointed run fingerprints its trace


def test_unchecked_results_are_tensors_on_the_device():
    addrs = np.random.default_rng(5).integers(0, 1 << 22, 2048).astype(np.int64)
    specs = [TLBSweepSpec(TLBConfig(entries=64, ways=4), num_partitions=p) for p in (1, 8)]
    res, _ = run_sweep_tlb(addrs, specs, kernel_mode="reference", block=BLOCK,
                           run=SweepRunConfig(chunk_accesses=512), device="cpu")
    assert isinstance(res.hits, torch.Tensor) and res.hits.device == torch.device("cpu")
    assert res.hits.dtype == torch.bool


def test_completed_checkpoint_short_circuits_rerun(tmp_path):
    run, _, oracle, total, chunk, _ = _engine("system")
    with pytest.raises(SimulatedKill):
        run(_cfg(tmp_path, chunk_accesses=chunk, on_chunk_committed=kill_after(2)))
    outs1, meta1 = run(_cfg(tmp_path, chunk_accesses=chunk, resume=True))
    outs2, meta2 = run(_cfg(tmp_path, chunk_accesses=chunk, resume=True))
    assert meta1["resumed_from"] == 2 * chunk
    assert meta2["completed_from_checkpoint"] and meta2["resumed_from"] == total
    _assert_bits(outs1, oracle)
    _assert_bits(outs2, oracle)


# ---------------------------------------------------------------------------
# Refusal.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_corrupt_checkpoint_refused(tmp_path, damage):
    run, _, _, _, chunk, blob = _engine("tlb")
    with pytest.raises(SimulatedKill):
        run(_cfg(tmp_path, chunk_accesses=chunk, on_chunk_committed=kill_after(1)))
    corrupt_file(tmp_path / blob, mode=damage)
    with pytest.raises(CheckpointCorruptError, match="refusing to resume"):
        run(_cfg(tmp_path, chunk_accesses=chunk, resume=True))


def test_fingerprint_mismatch_refused(tmp_path):
    rng = np.random.default_rng(0)
    specs = [TLBSweepSpec(TLBConfig(entries=64, ways=32))]
    a = rng.integers(0, 1 << 20, 2048).astype(np.int64)
    with pytest.raises(SimulatedKill):
        run_sweep_tlb(a, specs, block=BLOCK, name="fp", device="cpu",
                      run=_cfg(tmp_path, chunk_accesses=512, on_chunk_committed=kill_after(1)))
    with pytest.raises(CheckpointCorruptError, match="fingerprint mismatch"):
        run_sweep_tlb(a + 1, specs, block=BLOCK, name="fp", device="cpu",
                      run=_cfg(tmp_path, chunk_accesses=512, resume=True))


def test_wrong_engine_checkpoint_refused(tmp_path):
    run, _, _, _, chunk, _ = _engine("tlb")
    with pytest.raises(SimulatedKill):
        run(_cfg(tmp_path, chunk_accesses=chunk, on_chunk_committed=kill_after(1)))
    lines = np.arange(1024, dtype=np.int64) * 64
    with pytest.raises(CheckpointCorruptError, match="was written by"):
        run_sweep_system(lines, [SystemSimConfig()], block=BLOCK, name="tlb", device="cpu",
                         run=_cfg(tmp_path, resume=True))


# ---------------------------------------------------------------------------
# The ladder.
# ---------------------------------------------------------------------------

def _faults(modes=("cuda",), log=None, exc=OOM, limit=None):
    state = {"n": 0}

    def hook(engine, lo, hi, mode, attempt):
        if log is not None:
            log.append((engine, lo, hi, mode, attempt))
        if mode in modes and (limit is None or state["n"] < limit):
            state["n"] += 1
            raise exc(f"injected fault #{state['n']} ({engine} [{lo}:{hi}) {mode})")

    return hook


@pytest.mark.parametrize("engine", ENGINES)
def test_ladder_retry_halve_downgrade_order_and_bit_identity(tmp_path, engine, _as_cuda):
    """Every kernel attempt on more than one block fails: each span is
    retried, then halved, down to single blocks, which run on the kernel.
    No event downgrades the run and no chunk runs the plain version."""
    run, _, oracle, total, chunk, _ = _engine(engine)
    seen = []

    def hook(eng, lo, hi, mode, attempt):
        seen.append((lo, hi, mode, attempt))
        if hi - lo > BLOCK:
            raise OOM(f"injected fault ({eng} [{lo}:{hi}) {mode})")

    outs, meta = run(_cfg(tmp_path, chunk_accesses=chunk, max_retries=1, fault_hook=hook),
                     kernel_mode="cuda")
    _assert_bits(outs, oracle, ctx="ladder")
    assert (meta["start_mode"], meta["final_mode"]) == ("cuda", "cuda")
    names = [e["event"] for e in meta["events"]]
    assert names[:6] == ["retry", "retry", "halve", "retry", "retry", "halve"]
    assert set(names) == {"retry", "halve"}
    for h in (e for e in meta["events"] if e["event"] == "halve"):
        assert (h["mid"] - h["lo"]) % BLOCK == 0
    assert {s[2] for s in seen} == {"cuda"}
    assert _as_cuda == ["cuda"] * (total // BLOCK)   # every block ran on the kernel


@pytest.mark.parametrize("engine", ENGINES)
def test_a_block_that_keeps_failing_raises_and_never_runs_the_plain_version(
        tmp_path, engine, _as_cuda):
    """From the second chunk on every kernel attempt fails: once the span is
    one block the error is raised, with no downgrade; the blob keeps the
    first chunk, and a resume finishes on the kernel, bit-identical."""
    run, _, oracle, _, chunk, blob = _engine(engine)

    def hook(eng, lo, hi, mode, attempt):
        if lo >= chunk:
            raise OOM(f"injected fault ({eng} [{lo}:{hi}) {mode})")

    with pytest.raises(OOM):
        run(_cfg(tmp_path, chunk_accesses=chunk, max_retries=1, fault_hook=hook),
            kernel_mode="cuda")
    assert set(_as_cuda) == {"cuda"} and len(_as_cuda) == 1
    outs, meta = run(_cfg(tmp_path, chunk_accesses=chunk, resume=True), kernel_mode="cuda")
    assert meta["resumed_from"] == chunk and meta["final_mode"] == "cuda"
    assert "downgrade" not in [e["event"] for e in meta["events"]]
    assert set(_as_cuda) == {"cuda"}
    _assert_bits(outs, oracle, ctx=f"{engine} resumed after a raise")


@pytest.mark.parametrize("writer", ["port_cpu", "jax"])
@pytest.mark.parametrize("engine", ["system", "timeline"])
def test_a_plain_version_blob_resumes_on_the_kernel(tmp_path, engine, writer, _as_cuda):
    """A blob the plain version wrote (the port on the CPU, or the JAX
    package's reference run) does not choose the resumed run's backend: on
    the card ``auto`` resumes it on the kernel, bit-identical."""
    run, jrun, oracle, _, chunk, _ = _engine(engine)
    with pytest.raises(SimulatedKill):
        if writer == "jax":
            jrun(_jcfg(tmp_path, chunk_accesses=chunk, on_chunk_committed=kill_after(2)))
        else:
            run(_cfg(tmp_path, chunk_accesses=chunk, on_chunk_committed=kill_after(2)))
    del _as_cuda[:]
    outs, meta = run(_cfg(tmp_path, chunk_accesses=chunk, resume=True), kernel_mode="auto")
    assert meta["resumed_from"] == 2 * chunk
    assert (meta["start_mode"], meta["final_mode"], meta["dispatch"]["mode"]) == (
        "cuda", "cuda", "cuda")
    assert not meta["dispatch"]["calibration"].startswith("checkpoint:")
    resume = next(e for e in meta["events"] if e["event"] == "resume")
    assert resume["blob_mode"] == "reference" and resume["mode"] == "cuda"
    assert _as_cuda == ["cuda", "cuda"]
    _assert_bits(outs, oracle, ctx=f"{engine} {writer} blob resumed on the kernel")


def test_clean_cuda_run_has_no_ladder_events(tmp_path, _as_cuda):
    run, _, oracle, _, chunk, _ = _engine("tlb")
    outs, meta = run(_cfg(tmp_path, chunk_accesses=chunk), kernel_mode="cuda")
    _assert_bits(outs, oracle)
    assert meta["events"] == [] and meta["final_mode"] == "cuda"
    assert _as_cuda == ["cuda"] * 4


def test_two_faults_with_one_retry_halve_the_chunk(tmp_path, _as_cuda):
    """Two injected OOMs at one retry exhaust the retries and halve the
    chunk; the halves then run on the kernel: exactly retry, retry, halve
    (what ``chip_smoke.py`` injects on the card)."""
    run, _, oracle, _, chunk, _ = _engine("system")
    outs, meta = run(_cfg(tmp_path, chunk_accesses=chunk, max_retries=1,
                          fault_hook=_faults(limit=2)), kernel_mode="cuda")
    _assert_bits(outs, oracle)
    assert [e["event"] for e in meta["events"]] == ["retry", "retry", "halve"]
    assert meta["final_mode"] == "cuda"
    assert meta["throughput"]["cuda"]["chunks"] == 5


def test_ladder_events_survive_resume(tmp_path, _as_cuda):
    run, _, oracle, _, chunk, _ = _engine("tlb")
    with pytest.raises(SimulatedKill):
        run(_cfg(tmp_path, chunk_accesses=chunk, max_retries=0, fault_hook=_faults(limit=1),
                 on_chunk_committed=kill_after(2)), kernel_mode="cuda")
    outs, meta = run(_cfg(tmp_path, chunk_accesses=chunk, resume=True), kernel_mode="cuda")
    _assert_bits(outs, oracle, ctx="resume-after-halve")
    assert meta["final_mode"] == "cuda"
    assert [e["event"] for e in meta["events"]] == ["retry", "halve", "resume"]
    assert meta["resumed_from"] == chunk   # the chunk's two halves were committed


@pytest.mark.parametrize("exc", [
    lambda: ValueError("config bug"),
    lambda: KernelBuildError("nvcc failed (1): ... out of memory ..."),
    lambda: CudaError("tlb_sim_launch", 700, "an illegal memory access was encountered"),
    lambda: torch.AcceleratorError("CUDA error: unspecified launch failure"),
], ids=["program_bug", "build_error", "sticky_cuda_error", "accelerator_error"])
def test_non_transient_error_raises_immediately(tmp_path, exc, _as_cuda):
    run, _, _, _, chunk, blob = _engine("tlb")
    seen = []

    def hook(engine, lo, hi, mode, attempt):
        seen.append((mode, attempt))
        raise exc()

    with pytest.raises(type(exc())):
        run(_cfg(tmp_path, chunk_accesses=chunk, fault_hook=hook), kernel_mode="cuda")
    assert seen == [("cuda", 0)]            # no retry, and never the plain version
    assert not (tmp_path / blob).exists()


def test_checkpoint_write_failure_propagates_without_double_apply(tmp_path, monkeypatch):
    import errno

    run, _, oracle, _, chunk, blob = _engine("tlb")
    real_write = orch.write_checkpoint_blob
    writes = {"n": 0}

    def flaky_write(path, arrays, meta):
        writes["n"] += 1
        if writes["n"] == 3:
            raise OSError(errno.EIO, "injected EIO on checkpoint write")
        return real_write(path, arrays, meta)

    attempts = []
    monkeypatch.setattr(orch, "write_checkpoint_blob", flaky_write)
    with pytest.raises(OSError, match="injected EIO"):
        run(_cfg(tmp_path, chunk_accesses=chunk,
                 fault_hook=lambda eng, lo, hi, mode, att: attempts.append((lo, att))))
    assert [a for _, a in attempts] == [0, 0, 0] and len({lo for lo, _ in attempts}) == 3
    assert (tmp_path / blob).exists()
    monkeypatch.setattr(orch, "write_checkpoint_blob", real_write)
    outs, meta = run(_cfg(tmp_path, chunk_accesses=chunk, resume=True))
    assert meta["resumed_from"] == 2 * chunk and meta["chunks_committed"] == 4
    _assert_bits(outs, oracle, ctx="resume-after-ckpt-write-failure")


def test_a_fault_after_the_stream_advanced_is_not_retried(tmp_path, monkeypatch):
    """A transient fault that surfaces once the stream has moved past the
    chunk (the copy of its outputs to the host) must not be retried: the
    retry would apply the chunk twice."""
    run, _, _, _, chunk, _ = _engine("tlb")
    calls = {"n": 0}
    real = orch._host

    def host(x):
        calls["n"] += 1
        if calls["n"] == 2:
            raise MemoryError("injected host allocation failure")
        return real(x)

    monkeypatch.setattr(orch, "_host", host)
    with pytest.raises(MemoryError):
        run(_cfg(tmp_path, chunk_accesses=chunk))


# ---------------------------------------------------------------------------
# Preemption, the monolithic stack-distance path, throughput.
# ---------------------------------------------------------------------------

def test_preemption_checkpoints_at_chunk_boundary_then_resumes(tmp_path):
    run, _, oracle, _, chunk, blob = _engine("tlb")
    handler = PreemptionHandler(install=False)

    def sigterm_mid_run(i):
        if i >= 1:
            handler.requested = True

    with pytest.raises(Preempted) as exc:
        run(_cfg(tmp_path, chunk_accesses=chunk, preemption=handler,
                 on_chunk_committed=sigterm_mid_run))
    assert exc.value.now == 2 * chunk and "--resume" in str(exc.value)
    outs, meta = run(_cfg(tmp_path, chunk_accesses=chunk, resume=True))
    assert meta["resumed_from"] == 2 * chunk
    # The preempt event follows the blob's commit, so the blob's events end
    # before it, as in the reference.
    assert [e["event"] for e in meta["events"]] == ["resume"]
    _assert_bits(outs, oracle, ctx="preempted")


def test_a_real_sigterm_preempts_through_the_installed_handler(tmp_path):
    run, _, oracle, _, chunk, blob = _engine("timeline")
    before = signal.getsignal(signal.SIGTERM)
    cfg = SweepRunConfig(checkpoint_dir=str(tmp_path), chunk_accesses=chunk,
                         on_chunk_committed=lambda i: i == 1 and os.kill(os.getpid(),
                                                                          signal.SIGTERM))
    with pytest.raises(Preempted) as exc:
        run(cfg)
    assert exc.value.now == 2 * chunk
    assert signal.getsignal(signal.SIGTERM) is before   # the handler was uninstalled
    outs, meta = run(_cfg(tmp_path, chunk_accesses=chunk, resume=True))
    _assert_bits(outs, oracle, ctx="sigterm")


def test_stackdist_path_is_monolithic_and_not_resumable(tmp_path):
    rng = np.random.default_rng(5)
    addrs = rng.integers(0, 1 << 20, 2048).astype(np.int64)
    specs = [TLBSweepSpec(TLBConfig(entries=64, ways=4), num_partitions=p) for p in (1, 4)]
    res, meta = run_sweep_tlb(addrs, specs, block=BLOCK, name="sd", device="cpu",
                              run=_cfg(tmp_path, chunk_accesses=512))
    assert meta["resumable"] is False and meta["start_mode"] == "stackdist"
    assert meta["throughput"]["stackdist"]["chunks"] == 1
    assert not list(tmp_path.glob("*.ckpt"))
    ref = sweep_tlb(addrs, specs, kernel_mode="reference", device="cpu")
    np.testing.assert_array_equal(res.hits.numpy(), ref.hits.numpy())


def test_merge_throughput_equals_jax():
    metas = [{"throughput": {"reference": {"chunks": 2, "accesses": 100, "sim_accesses": 300,
                                           "elapsed_s": 0.5}}},
             {"throughput": {"reference": {"chunks": 1, "accesses": 50, "sim_accesses": 150,
                                           "elapsed_s": 0.25},
                             "cuda": {"chunks": 3, "accesses": 90, "sim_accesses": 270,
                                      "elapsed_s": 0.01}}}]
    assert merge_throughput(metas) == jorch.merge_throughput(metas)
    assert merge_throughput(metas)["reference"]["accesses_per_s"] == 200.0


def test_smoke_resume_sigterms_a_subprocess_sweep_and_resumes_it(tmp_path):
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.smoke_resume", "--device", "cpu",
         "--n-ops", "200", "--cap", "2048", "--chunk-accesses", "256",
         "--workdir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "interrupted cleanly (exit 75)" in proc.stdout
    assert "PASS: resumed from access" in proc.stdout
