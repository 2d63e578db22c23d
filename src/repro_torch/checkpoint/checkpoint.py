"""Checksummed single-file checkpoint blobs and advisory shard leases.

The port of the blob and lease primitives of the JAX package's
``src/repro/checkpoint/checkpoint.py`` (its lines 157-383), byte for byte:
a blob is one ASCII header line ``repro-ckpt-v1 sha256:<hex>`` followed by
an ``np.savez`` payload whose digest the header pins, arrays plus a JSON
meta dict in one file, so a sweep chunk's checkpoint commits (or does not)
as a unit, and a blob written by either package is read by the other.  A
lease is a small JSON file that marks a scheduler shard as claimed by one
worker, serialised by an ``flock`` on a sibling ``.lck`` file.

The training state's pytree checkpoints (``save``, ``restore``,
``restore_resharded``, ``AsyncCheckpointer``) are not ported yet: they come
with the training step.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import pathlib
import time
import uuid
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

try:  # POSIX advisory locks; absent on some platforms (file_lock degrades)
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None

__all__ = [
    "BLOB_MAGIC",
    "LEASE_FORMAT",
    "CheckpointCorruptError",
    "LeaseHeld",
    "write_checkpoint_blob",
    "read_checkpoint_blob",
    "file_lock",
    "read_lease",
    "lease_is_stale",
    "acquire_lease",
    "refresh_lease",
    "release_lease",
]

BLOB_MAGIC = "repro-ckpt-v1"
_META_KEY = "__meta__"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint blob failed validation (truncated, bit-flipped, or not a
    checkpoint at all).  Deliberately NOT silently ignored by resume paths."""


def write_checkpoint_blob(path, arrays: Dict[str, np.ndarray], meta: dict) -> pathlib.Path:
    """Atomically write a checksummed single-file checkpoint.

    Durability contract: the payload is serialised fully in memory,
    sha256-pinned in the header, written to a ``.tmp-<nonce>`` sibling,
    fsync'd, then ``os.replace``d into place (the commit point), and the
    parent directory is fsync'd so the rename itself survives power loss.
    Readers therefore only ever see a complete blob or no blob.
    """
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if _META_KEY in arrays:
        raise ValueError(f"array key {_META_KEY!r} is reserved for metadata")
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    payload[_META_KEY] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8
    ).copy()
    buf = io.BytesIO()
    np.savez(buf, **payload)
    body = buf.getvalue()
    header = f"{BLOB_MAGIC} sha256:{hashlib.sha256(body).hexdigest()}\n".encode()

    tmp = path.with_name(f"{path.name}.tmp-{uuid.uuid4().hex[:8]}")
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(body)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # commit
    try:
        dfd = os.open(str(path.parent), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # pragma: no cover - e.g. directories on exotic fs
        pass
    return path


def read_checkpoint_blob(path) -> Tuple[Dict[str, np.ndarray], dict]:
    """Load and validate a blob written by :func:`write_checkpoint_blob`.

    Raises :class:`CheckpointCorruptError` (with a clear, actionable message)
    if the header is missing/foreign or the payload digest does not match —
    a truncated or bit-flipped checkpoint is *refused*, never resumed.
    """
    path = pathlib.Path(path)
    data = path.read_bytes()
    nl = data.find(b"\n")
    refusal = (
        "refusing to resume from it — delete it deliberately (or start "
        "without --resume) to begin a fresh run"
    )
    if nl < 0:
        raise CheckpointCorruptError(
            f"checkpoint {path} has no header line (truncated?); {refusal}")
    try:
        magic, digest_field = data[:nl].decode("ascii").split(" ", 1)
    except (UnicodeDecodeError, ValueError):
        raise CheckpointCorruptError(
            f"checkpoint {path} header is unparseable; {refusal}") from None
    if magic != BLOB_MAGIC or not digest_field.startswith("sha256:"):
        raise CheckpointCorruptError(
            f"checkpoint {path} is not a {BLOB_MAGIC} blob "
            f"(header {data[:nl][:64]!r}); {refusal}")
    body = data[nl + 1:]
    actual = hashlib.sha256(body).hexdigest()
    expected = digest_field[len("sha256:"):]
    if actual != expected:
        raise CheckpointCorruptError(
            f"checkpoint {path} failed its content checksum "
            f"(expected sha256:{expected[:12]}…, got sha256:{actual[:12]}… — "
            f"truncated or bit-flipped); {refusal}")
    try:
        with np.load(io.BytesIO(body), allow_pickle=False) as npz:
            meta = json.loads(bytes(npz[_META_KEY]).decode())
            arrays = {k: npz[k] for k in npz.files if k != _META_KEY}
    except CheckpointCorruptError:
        raise
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} payload is undecodable ({e}); {refusal}") from e
    return arrays, meta


# ---------------------------------------------------------------------------
# Advisory file locks + shard lease files (scheduler work-queue primitives).
#
# A lease is a tiny JSON file that marks a shard as claimed by one worker.
# Ownership is advisory but race-free: every acquire/refresh/release takes an
# flock on a sibling `.lck` file, so two workers racing for the same shard
# serialise and exactly one wins.  A lease with no heartbeat for longer than
# its TTL is *stale* and may be broken by a new claimant — that is how work
# owned by a SIGKILLed worker gets re-dispatched.
# ---------------------------------------------------------------------------

LEASE_FORMAT = "repro-lease-v1"


class LeaseHeld(RuntimeError):
    """The shard is already claimed under a fresh (non-stale) lease."""


@contextlib.contextmanager
def file_lock(path, *, timeout_s: float = 30.0, poll_s: float = 0.02) -> Iterator[None]:
    """Advisory exclusive lock on ``path`` (created if absent).

    Blocks up to ``timeout_s`` then raises ``TimeoutError``.  Uses
    ``fcntl.flock`` where available; degrades to a no-op on platforms
    without it (single-writer environments).
    """
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if fcntl is None:  # pragma: no cover - non-POSIX
        yield
        return
    fd = os.open(str(path), os.O_RDWR | os.O_CREAT, 0o644)
    try:
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"could not lock {path} within {timeout_s}s")
                time.sleep(poll_s)
        yield
    finally:
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)


def _lease_lock_path(path) -> pathlib.Path:
    path = pathlib.Path(path)
    return path.with_name(path.name + ".lck")


def read_lease(path) -> Optional[dict]:
    """Return the lease dict, or None if absent/unreadable (a torn lease is
    treated as stale-able junk, not an error)."""
    try:
        rec = json.loads(pathlib.Path(path).read_text())
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) and rec.get("format") == LEASE_FORMAT else None


def lease_is_stale(lease: Optional[dict], *, now: Optional[float] = None) -> bool:
    """A lease is stale once its last heartbeat is older than its TTL.
    Unreadable/foreign leases are stale by definition."""
    if lease is None:
        return True
    now = time.time() if now is None else now
    try:
        return (now - float(lease["ts"])) > float(lease["ttl_s"])
    except (KeyError, TypeError, ValueError):
        return True


def _write_lease_locked(path, owner: str, *, ttl_s: float, **extra) -> dict:
    rec = {
        "format": LEASE_FORMAT,
        "owner": owner,
        "ts": time.time(),
        "ttl_s": float(ttl_s),
        **extra,
    }
    path = pathlib.Path(path)
    tmp = path.with_name(f"{path.name}.tmp-{uuid.uuid4().hex[:8]}")
    tmp.write_text(json.dumps(rec, sort_keys=True))
    os.replace(tmp, path)
    return rec


def acquire_lease(path, owner: str, *, ttl_s: float, **extra) -> dict:
    """Claim the shard lease at ``path`` for ``owner``.

    Succeeds if no lease exists, the existing lease is stale (broken and
    taken over — the dead worker's claim), or ``owner`` already holds it
    (re-entrant refresh).  Raises :class:`LeaseHeld` otherwise.
    """
    path = pathlib.Path(path)
    with file_lock(_lease_lock_path(path)):
        cur = read_lease(path)
        if cur is not None and cur.get("owner") != owner and not lease_is_stale(cur):
            raise LeaseHeld(
                f"shard lease {path.name} is held by {cur.get('owner')!r} "
                f"(heartbeat {time.time() - float(cur.get('ts', 0)):.1f}s ago, "
                f"ttl {cur.get('ttl_s')}s)")
        return _write_lease_locked(path, owner, ttl_s=ttl_s, **extra)


def refresh_lease(path, owner: str, *, ttl_s: float, **extra) -> bool:
    """Heartbeat: re-stamp ``ts`` if ``owner`` still holds the lease.
    Returns False (without writing) if the lease was lost — broken by
    another claimant after this owner stalled past the TTL."""
    path = pathlib.Path(path)
    with file_lock(_lease_lock_path(path)):
        cur = read_lease(path)
        if cur is None or cur.get("owner") != owner:
            return False
        _write_lease_locked(path, owner, ttl_s=ttl_s, **extra)
        return True


def release_lease(path, owner: str) -> bool:
    """Delete the lease if ``owner`` holds it (and sweep the lock sibling).
    Returns True if a lease was removed."""
    path = pathlib.Path(path)
    with file_lock(_lease_lock_path(path)):
        cur = read_lease(path)
        if cur is not None and cur.get("owner") == owner:
            with contextlib.suppress(OSError):
                path.unlink()
            return True
        return False
