"""The port's shard scheduler under the process executor, on the CPU: spawned
workers (``mp_context="spawn"``, the default, and the fork server the
figure mains use), each running its shard on the device it is given and
sending its results back as numpy.

* arrays bit-identical to the JAX package's monolithic engines (the inputs
  of ``tests/test_torch_scheduler.py``, tolerance 0);
* a worker that SIGKILLs itself mid-shard is survived: the parent sees it
  dead, respawns the slot, waits out the lease and re-dispatches the shard,
  which ends bit-identical with nothing quarantined;
* a fatal error raised in a worker process (a failed build) aborts the run
  with that error;
* ``fork_server()`` stops the fork server and the resource tracker, reaped,
  when its scope ends;
* ``python -m repro_torch.bench.smoke_sched --device cpu``: a Fig 11 run
  whose worker process is SIGKILLed from outside ends with the serial run's
  digests and the recovery events in its run logs.  A kill that never lands
  fails the test.
"""
import os
import subprocess
import sys

import pytest
from test_torch_scheduler import _assert_bits, _cfg, _engine, _event_names, _sched

from repro_torch.bench.faultinject import KillWorkerOnShard, RaiseOnShard
from repro_torch.core.scheduler import fork_server
from repro_torch.kernels._build import KernelBuildError

ENGINES = ("tlb", "system", "timeline")


@pytest.mark.parametrize("engine", ENGINES)
def test_process_executor_bit_identity(tmp_path, engine):
    run, _, oracle = _engine(engine)
    got, meta = run(_cfg(tmp_path), _sched(executor="process"))
    _assert_bits(got, oracle, f"{engine}/process")
    s = meta["scheduler"]
    assert s["executor"] == "process" and s["workers"] == 2
    assert not s["quarantined_shards"]
    boots = s["worker_boots"]
    assert sorted(b["worker"] for b in boots) == [0, 1]
    assert all(b["pid"] != os.getpid() and b["spawn_s"] > 0 and b["context_s"] >= 0
               for b in boots)


def test_fork_server_workers_are_bit_identical(tmp_path):
    run, _, oracle = _engine("system")
    for sub in ("a", "b"):   # the second executor forks from the running server
        got, meta = run(_cfg(tmp_path / sub), _sched(executor="process", mp_context="forkserver"))
        _assert_bits(got, oracle, f"system/forkserver {sub}")
        assert len(meta["scheduler"]["worker_boots"]) == 2


def test_fork_server_scope_stops_its_helpers(tmp_path):
    """The fork server and the resource tracker are gone when the scope ends,
    not a second or more after this process exits."""
    from multiprocessing import forkserver, resource_tracker

    run, _, oracle = _engine("system")
    with fork_server():
        got, _ = run(_cfg(tmp_path), _sched(executor="process", mp_context="forkserver"))
        pids = [forkserver._forkserver._forkserver_pid, resource_tracker._resource_tracker._pid]
        assert all(pids), pids
    _assert_bits(got, oracle, "system/fork_server scope")
    assert forkserver._forkserver._forkserver_pid is None
    assert resource_tracker._resource_tracker._pid is None
    for pid in pids:   # reaped, so no such process remains
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


@pytest.mark.parametrize("engine", ENGINES)
def test_kill_worker_redispatch(tmp_path, engine):
    run, _, oracle = _engine(engine)
    sched = _sched(executor="process", lease_ttl_s=1.0, heartbeat_s=0.2,
                   on_shard_start=KillWorkerOnShard(0, attempts=(0,)))
    got, meta = run(_cfg(tmp_path), sched)
    _assert_bits(got, oracle, f"{engine}/kill")
    names = _event_names(meta)
    for event in ("worker_dead", "worker_respawn", "lease_expire", "redispatch"):
        assert event in names, (event, names)
    assert not meta["scheduler"]["quarantined_shards"]
    sm0 = meta["scheduler"]["shard_map"][0]
    assert sm0["state"] == "done" and sm0["dispatches"] >= 2
    # A boot rides on a worker's first message: the killed worker sent none.
    boots = meta["scheduler"]["worker_boots"]
    assert 1 <= len(boots) <= 2 and all(b["pid"] != os.getpid() for b in boots)


def test_a_fatal_error_in_a_worker_process_aborts_the_run(tmp_path):
    run, _, _ = _engine("tlb")
    with pytest.raises(KernelBuildError, match="nvcc failed"):
        run(_cfg(tmp_path), _sched(executor="process", max_shard_attempts=3,
                                   on_shard_start=RaiseOnShard(1, KernelBuildError(
                                       "nvcc failed (1): injected"))))
    assert not list(tmp_path.glob("*.lease"))


def test_smoke_sched_kills_a_worker_and_matches_the_serial_run(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.smoke_sched", "--device", "cpu",
         "--cap", "2048", "--chunk-accesses", "512", "--workdir", str(tmp_path)],
        env=dict(os.environ), capture_output=True, text=True, timeout=600)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    assert "[smoke_sched] killed worker pid" in proc.stdout
    assert "recovery recorded: worker_dead x" in proc.stdout
    assert "PASS: killed a worker mid-shard" in proc.stdout
    # Each child kept its run logs beside its --out, under the work directory.
    for run in ("reference", "sharded"):
        assert (tmp_path / run / "fig11.json").exists()
        assert (tmp_path / run / "runlogs" / "fig11.jsonl").exists()
    assert list((tmp_path / "sharded" / "runlogs").glob("fig11-w*.jsonl"))
