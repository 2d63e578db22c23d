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
``AsyncCheckpointer``; the port of the JAX module's lines 47-131 and
385-423) keep the JAX package's directory layout, so either package
restores the other's float32 checkpoints::

    <root>/step_00000123.tmp-<nonce>/   (written, then renamed: the commit)
        manifest.json                   {"step", "leaves": {key: {file, shape, dtype}}}
        <leaf>.npy ...
    <root>/step_00000123/

Keys join the tree's path with ``::``.  A port parameter module, and a dict
keyed by its dotted parameter names (the AdamW moments), are written in the
JAX package's stacked layout (:func:`repro_torch.convert.jax_layout`:
``layers::...`` on a leading [L] axis).  A bfloat16 leaf is written as the
JAX package writes it, 2-byte records (``<V2``) with manifest dtype
``"bfloat16"``, and read back by that dtype through a ``uint16`` view, with
no ml_dtypes; the JAX package's own ``restore(template=...)`` cannot cast
such a leaf (ROADMAP.md, section 3).

A sharded training state (DTensor leaves) is saved as the same directory:
every rank gathers every leaf (``full_tensor()``, a collective, in one
fixed order), rank 0 writes and commits, and the other ranks wait at a
barrier.  ``restore_resharded`` reads a checkpoint written on any mesh (or
none) and places each leaf on a new mesh by its spec.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import pathlib
import queue
import re
import shutil
import threading
import time
import uuid
import warnings
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.distributed.sharding import is_dtensor

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
    "step_dir",
    "latest_step",
    "save",
    "restore",
    "restore_resharded",
    "AsyncCheckpointer",
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


# ---------------------------------------------------------------------------
# Pytree checkpoints of the training state.
# ---------------------------------------------------------------------------

_SEP = "::"
_STEP_RE = re.compile(r"step_(\d+)")


def _port_named(tree) -> bool:
    """A dict keyed by a module's dotted parameter names (the moments)."""
    return (isinstance(tree, dict) and bool(tree) and any("." in k for k in tree)
            and all(isinstance(v, torch.Tensor) for v in tree.values()))


def _has_dtensor(tree) -> bool:
    """Whether any leaf of ``tree`` (a module's parameters included) is a
    DTensor, i.e. the tree is a sharded training state."""
    if isinstance(tree, nn.Module):
        return any(is_dtensor(p) for p in tree.parameters())
    if isinstance(tree, dict):
        return any(_has_dtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_dtensor(v) for v in tree)
    return is_dtensor(tree)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole tensor on the host (an all-gather every rank joins);
    a plain tensor as it is."""
    if is_dtensor(t):
        return t.detach().full_tensor().cpu()
    return t


def _host_tree(tree, *, copy: bool = True):
    """``tree`` on the host in the JAX package's layout: a parameter
    module or a dict keyed by its dotted names is stacked
    (:func:`repro_torch.convert.jax_layout`), other dicts, lists and tuples
    keep their structure, tensors become CPU tensors (DTensors gathered
    whole, leaf by leaf in the tree's order) and anything else a numpy
    array.  With ``copy`` every leaf owns its memory, so the caller may
    update the originals in place afterwards."""
    from repro_torch.convert import jax_layout

    if isinstance(tree, nn.Module):
        return jax_layout({n: _whole(p) for n, p in tree.named_parameters()})
    if _port_named(tree):
        return jax_layout({n: _whole(t) for n, t in tree.items()})
    if isinstance(tree, dict):
        return {k: _host_tree(v, copy=copy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v, copy=copy) for v in tree)
    if isinstance(tree, torch.Tensor):
        return _whole(tree).detach().to("cpu", copy=copy)
    return np.array(tree) if copy else np.asarray(tree)


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{``::``-joined path: leaf} of a host tree (dict keys, list indices)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    return flat


def _leaf_array(leaf) -> Tuple[np.ndarray, str]:
    """(C-ordered array to write, manifest dtype); a bfloat16 leaf as its
    ``uint16`` bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(leaf) if np.ndim(leaf) else np.asarray(leaf)
    if arr.dtype.name == "bfloat16":      # ml_dtypes' bfloat16 from a numpy tree
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _write_leaf(path: pathlib.Path, arr: np.ndarray, dtype: str) -> None:
    """``np.save``; a bfloat16 leaf gets the header ``np.save`` writes for
    ml_dtypes' bfloat16 (``'descr': '<V2'``), so the file is the JAX
    package's byte for byte."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes() if arr.ndim == 0 else memoryview(arr).cast("B"))


def _read_leaf(d: pathlib.Path, meta: dict, *, mmap: bool):
    """One leaf as the manifest describes it: a numpy array, or for a
    bfloat16 leaf a CPU ``torch.bfloat16`` tensor (numpy has no bf16)."""
    arr = np.load(d / meta["file"], mmap_mode="r" if mmap else None, allow_pickle=False)
    if meta["dtype"] != "bfloat16":
        return arr
    raw = arr.view(np.uint16)
    with warnings.catch_warnings():   # a read-only memmap; it is only read
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(raw).view(torch.bfloat16)


def step_dir(root, step: int) -> pathlib.Path:
    return pathlib.Path(root) / f"step_{step:08d}"


def _steps(root: pathlib.Path) -> List[int]:
    return sorted(int(m.group(1)) for p in root.iterdir() if (m := _STEP_RE.fullmatch(p.name)))


def latest_step(root) -> Optional[int]:
    root = pathlib.Path(root)
    if not root.exists():
        return None
    steps = _steps(root)
    return steps[-1] if steps else None


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def save(root, step: int, tree, *, keep: int = 3) -> pathlib.Path:
    """Write ``tree`` atomically as step ``step``; prune to the newest
    ``keep`` steps.  Stale ``.tmp-*`` directories of interrupted writes are
    swept first.  A tree with DTensor leaves is a collective: every rank
    gathers, rank 0 writes, every rank returns after the commit."""
    if not _has_dtensor(tree):
        return _write(root, step, _host_tree(tree, copy=False), keep=keep)
    host = _host_tree(tree, copy=False)
    try:
        if _rank() == 0:
            _write(root, step, host, keep=keep)
    finally:
        _barrier()
    return step_dir(root, step)


def _write(root, step: int, host, *, keep: int) -> pathlib.Path:
    """Write a host tree (:func:`_host_tree`) as step ``step`` and commit."""
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    for junk in root.glob("*.tmp-*"):
        shutil.rmtree(junk, ignore_errors=True)

    final = step_dir(root, step)
    tmp = root / f"{final.name}.tmp-{uuid.uuid4().hex[:8]}"
    tmp.mkdir()
    manifest = {}
    for key, leaf in _flatten(host).items():
        arr, dtype = _leaf_array(leaf)
        fname = f"{abs(hash(key)) & 0xFFFFFFFF:08x}_{len(manifest)}.npy"
        _write_leaf(tmp / fname, arr, dtype)
        manifest[key] = {"file": fname, "shape": list(arr.shape), "dtype": dtype}
    (tmp / "manifest.json").write_text(json.dumps({"step": step, "leaves": manifest}))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # commit

    for s in _steps(root)[:-keep] if keep else []:
        shutil.rmtree(step_dir(root, s), ignore_errors=True)
    return final


def _fill_tensor(dst: torch.Tensor, src) -> None:
    if not isinstance(src, torch.Tensor):
        with warnings.catch_warnings():   # a read-only memmap; it is only read
            warnings.simplefilter("ignore", UserWarning)
            src = torch.from_numpy(np.asarray(src, order="C"))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"checkpoint leaf {tuple(src.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(src)


def _fill_named(named: Dict[str, torch.Tensor], flat: dict, prefix: str) -> None:
    """Copy the stacked leaves under ``prefix`` into port-named tensors."""
    from repro_torch.convert import stack_index

    for name, dst in named.items():
        leaf, idx = stack_index(name)
        key = prefix + leaf.replace(".", _SEP)
        if key not in flat:
            raise KeyError(f"checkpoint has no leaf {key!r} (for {name})")
        _fill_tensor(dst, flat[key][idx] if idx else flat[key])


@torch.no_grad()
def _fill(template, flat: dict, prefix: str = ""):
    if isinstance(template, nn.Module):
        _fill_named(dict(template.named_parameters()), flat, prefix)
        return template
    if _port_named(template):
        _fill_named(template, flat, prefix)
        return template
    if isinstance(template, dict):
        return {k: _fill(v, flat, f"{prefix}{k}{_SEP}") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(v, flat, f"{prefix}{i}{_SEP}")
                              for i, v in enumerate(template))
    key = prefix[:-len(_SEP)]
    if isinstance(template, torch.Tensor):
        _fill_tensor(template, flat[key])
        return template
    arr = flat[key]
    if isinstance(arr, torch.Tensor):
        arr = arr.float().numpy()
    return np.array(arr).astype(np.asarray(template).dtype)


def restore(root, step: Optional[int] = None, template: Any = None):
    """Load step ``step`` (default: the latest) of the checkpoints under
    ``root``.  Without a template: ``({key: leaf}, step)``, numpy arrays
    keyed by ``::`` paths, a bfloat16 leaf as a CPU ``torch.bfloat16``
    tensor.  With a template (a tree of port modules, moment dicts, tensors
    or arrays): ``(template filled, step)``; every tensor and module of the
    template is overwritten in place, on its own device and in its own
    dtype, from the file's bytes."""
    root = pathlib.Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = step_dir(root, step)
    manifest = json.loads((d / "manifest.json").read_text())["leaves"]
    flat = {k: _read_leaf(d, meta, mmap=template is not None) for k, meta in manifest.items()}
    if template is None:
        return flat, step
    return _fill(template, flat), step


def _place(tree, specs, mesh):
    """``tree`` (filled by :func:`restore`) with every tensor leaf a DTensor
    on ``mesh`` placed by the spec at the same place in ``specs``; a
    module's parameters are replaced in place."""
    from repro_torch.distributed import sharding as shd

    if isinstance(tree, nn.Module):
        return shd.place_params(tree, mesh, specs)
    if isinstance(tree, dict):
        return {k: _place(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, sp, mesh) for v, sp in zip(tree, specs))
    return shd.distribute(torch.as_tensor(tree), mesh, specs)


def restore_resharded(root, template, mesh, specs, step: Optional[int] = None):
    """Elastic restore: :func:`restore` into ``template`` (plain tensors on
    any device), then place every leaf on ``mesh`` with ``specs`` (a tree
    like the template's: a spec a tensor, ``{name: spec}`` for a module or
    a moment dict; :mod:`repro_torch.distributed.sharding`) — the mesh may
    differ arbitrarily from the one that saved.  Every rank reads the
    files and keeps its own shards; nothing is sent.  Returns (tree,
    step)."""
    tree, step = restore(root, step, template)
    return _place(tree, specs, mesh), step


class AsyncCheckpointer:
    """Background-thread writer: ``submit`` copies the tree to the host and
    returns, the thread writes it; ``wait`` joins outstanding writes (call
    before exit / preemption).  ``records`` holds, per submitted step, the
    host copy's and the write's seconds and the bytes written.  A sharded
    tree (DTensor leaves) is gathered in ``submit`` on the caller's thread,
    on every rank; only rank 0's thread writes, and ``wait`` ends at a
    barrier of every rank."""

    def __init__(self, root, *, keep: int = 3):
        self.root = root
        self.keep = keep
        self.records: List[dict] = []
        self._sharded = False
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree, rec = item
            try:
                t0 = time.perf_counter()
                _write(self.root, step, tree, keep=self.keep)
                rec["write_s"] = time.perf_counter() - t0
            except BaseException as e:  # surfaced on wait()
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, step: int, tree):
        """Copy ``tree`` to the host (the next step updates the parameters
        in place, so the copy is made before this returns), then queue it."""
        self._sharded = self._sharded or _has_dtensor(tree)
        t0 = time.perf_counter()
        host = _host_tree(tree, copy=True)
        rec = {"step": step, "host_copy_s": time.perf_counter() - t0,
               "bytes": sum(_leaf_array(x)[0].nbytes for x in _flatten(host).values())}
        self.records.append(rec)
        if not self._sharded or _rank() == 0:
            self._q.put((step, host, rec))

    def wait(self):
        self._q.join()
        if self._sharded:
            _barrier()
        if self._err is not None:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._t.join()
