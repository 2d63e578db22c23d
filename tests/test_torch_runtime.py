"""The port's checkpoint blobs and leases (``repro_torch.checkpoint``) and its
fault-tolerance runtime (``repro_torch.runtime.fault_tolerance``), held to
the JAX package's (``tests/test_runtime.py``'s blob, lease and
fault-tolerance parts): a blob written by either package is read by the
other with equal arrays and meta; damaged blobs are refused; leases
serialise claimants; ``is_transient`` classifies by type."""
import errno
import os
import pathlib
import random
import signal
import threading
import time

import numpy as np
import pytest
import torch
from _faultinject import corrupt_file

from repro.checkpoint import checkpoint as jckpt
from repro.runtime import fault_tolerance as jft
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.kernels._build import CudaError, KernelBuildError
from repro_torch.runtime import fault_tolerance as tft

WRITERS = {"jax": jckpt.write_checkpoint_blob, "torch": tckpt.write_checkpoint_blob}
READERS = {"jax": jckpt.read_checkpoint_blob, "torch": tckpt.read_checkpoint_blob}


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"s_now": np.array([4096], np.int64),
            "s_g0_tags": rng.integers(-1, 1 << 20, (2, 9, 4)).astype(np.int32),
            "r_latency": rng.standard_normal((3, 17)).astype(np.float32),
            "r_hits": rng.random((2, 33)) < 0.5}


META = {"format": "repro-sweep-ckpt-v1", "engine": "sweep_tlb", "now": 4096,
        "events": [{"event": "retry", "lo": 0, "hi": 512}], "dispatch": None}


# ---------------------------------------------------------------------------
# Blobs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax"),
                                           ("torch", "torch")])
def test_blob_read_by_either_package(tmp_path, writer, reader):
    arrays = _arrays()
    path = WRITERS[writer](tmp_path / "x.ckpt", arrays, META)
    assert path.read_bytes().startswith(b"repro-ckpt-v1 sha256:")
    got, meta = READERS[reader](path)
    assert meta == META
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert got[k].tobytes() == v.tobytes(), k


def test_blob_header_and_payload_equal_jax_layout(tmp_path):
    """The digest in the header pins the payload, and both packages put the
    same arrays and meta in it: the npz members are equal."""
    import io
    import zipfile

    a = tckpt.write_checkpoint_blob(tmp_path / "t.ckpt", _arrays(1), META).read_bytes()
    b = jckpt.write_checkpoint_blob(tmp_path / "j.ckpt", _arrays(1), META).read_bytes()
    members = []
    for data in (a, b):
        head, body = data.split(b"\n", 1)
        assert head.split(b" ")[0] == b"repro-ckpt-v1"
        with zipfile.ZipFile(io.BytesIO(body)) as z:
            members.append({n: z.read(n) for n in z.namelist()})
    assert members[0] == members[1]


@pytest.mark.parametrize("damage", ["flip", "truncate"])
@pytest.mark.parametrize("reader", ["jax", "torch"])
def test_damaged_blob_refused(tmp_path, damage, reader):
    path = tckpt.write_checkpoint_blob(tmp_path / "x.ckpt", _arrays(), META)
    corrupt_file(path, mode=damage)
    err = tckpt.CheckpointCorruptError if reader == "torch" else jckpt.CheckpointCorruptError
    with pytest.raises(err, match="refusing to resume"):
        READERS[reader](path)


def test_foreign_and_headerless_files_refused(tmp_path):
    p = tmp_path / "x.ckpt"
    p.write_bytes(b"not a blob at all")
    with pytest.raises(tckpt.CheckpointCorruptError, match="no header"):
        tckpt.read_checkpoint_blob(p)
    p.write_bytes(b"other-format sha256:00\npayload")
    with pytest.raises(tckpt.CheckpointCorruptError, match="is not a repro-ckpt-v1 blob"):
        tckpt.read_checkpoint_blob(p)


def test_blob_reserves_the_meta_key_and_leaves_no_temp_files(tmp_path):
    with pytest.raises(ValueError, match="reserved"):
        tckpt.write_checkpoint_blob(tmp_path / "x.ckpt", {"__meta__": np.zeros(1)}, {})
    tckpt.write_checkpoint_blob(tmp_path / "x.ckpt", _arrays(), META)
    tckpt.write_checkpoint_blob(tmp_path / "x.ckpt", _arrays(2), META)   # replaces
    assert [p.name for p in tmp_path.iterdir()] == ["x.ckpt"]
    got, _ = tckpt.read_checkpoint_blob(tmp_path / "x.ckpt")
    assert np.array_equal(got["r_latency"], _arrays(2)["r_latency"])


# ---------------------------------------------------------------------------
# Leases.
# ---------------------------------------------------------------------------

def test_lease_acquire_refresh_release(tmp_path):
    path = tmp_path / "shard_0003.lease"
    rec = tckpt.acquire_lease(path, "w0", ttl_s=30.0, shard=3)
    assert rec["owner"] == "w0" and rec["shard"] == 3
    assert tckpt.acquire_lease(path, "w0", ttl_s=30.0)["owner"] == "w0"   # re-entrant
    with pytest.raises(tckpt.LeaseHeld, match="held by 'w0'"):
        tckpt.acquire_lease(path, "w1", ttl_s=30.0)
    assert tckpt.refresh_lease(path, "w0", ttl_s=30.0)
    assert not tckpt.refresh_lease(path, "w1", ttl_s=30.0)
    assert not tckpt.release_lease(path, "w1")
    assert tckpt.release_lease(path, "w0") and tckpt.read_lease(path) is None


def test_stale_lease_is_broken_and_lost_owner_cannot_refresh(tmp_path):
    path = tmp_path / "s.lease"
    tckpt.acquire_lease(path, "dead", ttl_s=0.01)
    cur = tckpt.read_lease(path)
    assert tckpt.lease_is_stale(cur, now=cur["ts"] + 1.0)
    assert not tckpt.lease_is_stale(cur, now=cur["ts"])
    time.sleep(0.05)   # past the dead owner's TTL
    assert tckpt.acquire_lease(path, "new", ttl_s=30.0)["owner"] == "new"
    assert not tckpt.refresh_lease(path, "dead", ttl_s=30.0)


def test_lease_files_are_shared_with_the_jax_package(tmp_path):
    path = tmp_path / "s.lease"
    jckpt.acquire_lease(path, "jax-worker", ttl_s=30.0)
    assert tckpt.read_lease(path)["owner"] == "jax-worker"
    with pytest.raises(tckpt.LeaseHeld):
        tckpt.acquire_lease(path, "torch-worker", ttl_s=30.0)
    path.write_text('{"format": "repro-lease-v1", "own')   # torn lease
    assert tckpt.read_lease(path) is None and tckpt.lease_is_stale(None)
    assert tckpt.acquire_lease(path, "torch-worker", ttl_s=30.0)["owner"] == "torch-worker"


def test_file_lock_serialises_threads(tmp_path):
    lock, order = tmp_path / "x.lck", []

    def worker(i):
        with tckpt.file_lock(lock):
            order.append(("in", i))
            order.append(("out", i))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(order[k][0] == "in" and order[k + 1] == ("out", order[k][1])
               for k in range(0, len(order), 2))


# ---------------------------------------------------------------------------
# Fault tolerance.
# ---------------------------------------------------------------------------

def test_heartbeat_straggler_and_dead_detection_equal_jax():
    trackers = [tft.HeartbeatTracker(straggler_factor=1.5),
                jft.HeartbeatTracker(straggler_factor=1.5)]
    for tr in trackers:
        for host in range(8):
            for _ in range(5):
                tr.record(host, 1.0 if host != 3 else 2.5, now=100.0 + host)
    assert [tr.stragglers() for tr in trackers] == [[3], [3]]
    assert [tr.dead(now=165.0) for tr in trackers] == [[0, 1, 2, 3, 4], [0, 1, 2, 3, 4]]
    assert trackers[0].hosts[3].ewma == trackers[1].hosts[3].ewma


def test_backoff_schedule_equals_jax():
    for kw in ({}, {"base_s": 0.5, "cap_s": 1.0, "jitter": 0.0}):
        assert tft.backoff_delays(6, rng=random.Random(3), **kw) == \
            jft.backoff_delays(6, rng=random.Random(3), **kw)


def test_retry_step_retries_only_transient_faults():
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        if calls["n"] < 3:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return x + 1

    seen = []
    assert tft.retry_step(flaky, 41, retries=3, base_delay_s=0,
                          on_retry=lambda a, e: seen.append(a)) == 42
    assert seen == [0, 1]
    calls["n"] = 0

    def bug():
        calls["n"] += 1
        raise RuntimeError("RESOURCE_EXHAUSTED: a status string is not a type")

    with pytest.raises(RuntimeError):
        tft.retry_step(bug, retries=3, base_delay_s=0)
    assert calls["n"] == 1


TRANSIENT = [
    ("oom", lambda: torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    ("cuda_error_2", lambda: CudaError("timeline_launch", 2, "out of memory"), True),
    ("memory_error", MemoryError, True),
    ("timeout", TimeoutError, True),
    ("conn_reset", lambda: ConnectionResetError(errno.ECONNRESET, "reset"), True),
    ("eintr", lambda: InterruptedError(errno.EINTR, "interrupted"), True),
    ("eio", lambda: OSError(errno.EIO, "flaky disk"), True),
    ("illegal_address_700", lambda: CudaError("stack_scan_launch", 700,
                                              "an illegal memory access was encountered"),
     False),
    ("misaligned_716", lambda: CudaError("flash_attention_launch", 716,
                                         "misaligned address"), False),
    ("launch_failure_719", lambda: CudaError("tlb_sim_launch", 719,
                                             "unspecified launch failure"), False),
    ("out_of_resources_701", lambda: CudaError("paged_attention_launch", 701,
                                               "too many resources requested for launch"),
     False),
    ("accelerator_error", lambda: torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"), False),
    ("build_log_says_oom", lambda: KernelBuildError(
        "nvcc failed (1): ptxas error: out of memory; RESOURCE_EXHAUSTED UNKNOWN"), False),
    ("xla_status_text", lambda: RuntimeError("RESOURCE_EXHAUSTED: out of memory"), False),
    ("not_found", lambda: FileNotFoundError(errno.ENOENT, "gone"), False),
    ("permission", lambda: PermissionError(errno.EACCES, "denied"), False),
    ("disk_full", lambda: OSError(errno.ENOSPC, "disk full"), False),
    ("value_error", lambda: ValueError("bad config"), False),
    ("not_implemented", NotImplementedError, False),
]


@pytest.mark.parametrize("make,want", [(m, w) for _, m, w in TRANSIENT],
                         ids=[n for n, _, _ in TRANSIENT])
def test_is_transient_classifies_by_type(make, want):
    assert tft.is_transient(make()) is want


def test_is_transient_agrees_with_jax_on_the_os_cases():
    for exc in (MemoryError(), TimeoutError(), OSError(errno.EIO, "x"),
                OSError(errno.ENOSPC, "x"), FileNotFoundError(errno.ENOENT, "x"),
                ValueError("x"), ConnectionResetError(errno.ECONNRESET, "x")):
        assert tft.is_transient(exc) == jft.is_transient(exc), exc


def test_preemption_handler_sets_requested_chains_and_uninstalls():
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        h = tft.PreemptionHandler(signals=(signal.SIGUSR1,))
        assert h.installed and not h.requested
        os.kill(os.getpid(), signal.SIGUSR1)
        assert h.requested and seen == [signal.SIGUSR1]   # the earlier handler chained
        h.uninstall()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert seen == [signal.SIGUSR1] * 2               # restored
    finally:
        signal.signal(signal.SIGUSR1, prev)
    off = tft.PreemptionHandler(install=False)
    assert not off.installed and not off.requested


def test_preemption_handler_off_the_main_thread_is_a_noop():
    out = {}

    def build():
        out["h"] = tft.PreemptionHandler()

    t = threading.Thread(target=build)
    t.start()
    t.join()
    assert not out["h"].installed
    out["h"].uninstall()


def test_port_runtime_modules_keep_the_reference_names():
    for name in ("HostStats", "HeartbeatTracker", "PreemptionHandler", "backoff_delays",
                 "retry_step", "is_transient"):
        assert hasattr(tft, name) and hasattr(jft, name)
    for name in ("write_checkpoint_blob", "read_checkpoint_blob", "file_lock", "acquire_lease",
                 "refresh_lease", "release_lease", "read_lease", "lease_is_stale",
                 "LeaseHeld", "CheckpointCorruptError", "BLOB_MAGIC", "LEASE_FORMAT"):
        assert getattr(tckpt, name, None) is not None, name
    assert (tckpt.BLOB_MAGIC, tckpt.LEASE_FORMAT) == (jckpt.BLOB_MAGIC, jckpt.LEASE_FORMAT)
    assert pathlib.Path(tckpt.__file__).parent.name == "checkpoint"
