"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``repro_torch/kernels/*/csrc/*.cu`` file is compiled for ``sm_90a``
(one ``nvcc -c`` per source, all started together) and linked into one shared
library with a plain C interface, ``build/repro_torch/kernels-<hash>.so`` at
the repository root.  The hash covers the sources, the headers beside them
(``*/csrc/*.cuh``) and the flags, so an edited source or header builds
anew; a file lock keeps concurrent processes from building the same library
twice.  The build happens at first use, never at import.  A
missing ``nvcc``, a failed build or a library that does not load raises
:class:`KernelBuildError`: there is no other way to a kernel.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:meth:`Library.check` turns a non-zero code into a :class:`CudaError`
carrying the code, which
:func:`repro_torch.runtime.fault_tolerance.is_transient` classifies.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

c_int, c_ptr, c_float = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
c_i64 = ctypes.c_int64
# The bucketing scratch of K1 and K2 (tlb_sim/csrc/lru_sets.cuh): counts,
# their length, the scan's block sums, their length, the (tag, j) pairs,
# their length in pairs, then the phase events (null or an array of
# cudaEvent_t) and the stream.
_LRU_SCRATCH = [c_ptr, c_i64, c_ptr, c_i64, c_ptr, c_i64, c_ptr, c_ptr]
# name -> argtypes of every C entry point (pointers and the stream as c_void_p,
# ints as c_int, lengths as c_int64, floats as c_float; every entry point
# returns a cudaError_t as int).
SIGNATURES = {
    # set, tag, tags, last, hits, B, L, TS, W, now0, sets, segs, scratch
    "tlb_sim_launch": [c_ptr] * 5 + [c_int] * 7 + _LRU_SCRATCH,
    # c_set, c_tag, a_set, a_tag, m_set, m_tag, flags,
    # c_tags, c_last, a_tags, a_last, m_tags, m_last, hits,
    # B, L, CS, CW, AS, AW, MS, MW, now0, (sets, segs) x 3, raw, scratch
    "system_sim_launch": [c_ptr] * 14 + [c_int] * 15 + [c_ptr] + _LRU_SCRATCH,
    # tags, seg, init, depths, final, L, C, W, then the plan (parts, steps a
    # part, tile steps, padded row steps, lanes a block, stages, smem bytes),
    # stream
    "stack_scan_launch": [c_ptr] * 5 + [c_int] * 10 + [c_ptr],
    # accel, part, bank_d, bank_p, cache_hit, tlb_hit, mem_hit, pen, fparams,
    # iparams, acc, mshr, cnt, port, bank, lat, ov, done, B, L, A, M, P, T, D,
    # stream
    "timeline_launch": [c_ptr] * 18 + [c_int] * 7 + [c_ptr],
    # q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, dtype, then the tile
    # plan (head dim, block q, block k, stages, threads, smem bytes, width),
    # stream
    "flash_attention_launch": [c_ptr] * 4 + [c_int] * 6 + [c_float] + [c_int] * 9 + [c_ptr],
    # q, k_pool, v_pool, table, ctx, acc, m, l, scratch, B, Hq, Hkv, D, page,
    # pages, scale, q_dtype, then the split plan (splits, tiles a split,
    # warps, smem bytes), stream
    "paged_attention_launch": [c_ptr] * 9 + [c_int] * 6 + [c_float] + [c_int] * 5 + [c_ptr],
    # r, k, v, w, u, o, s, B, H, T, N, chunk, dtype, columns a block, smem
    # bytes, stream
    "rwkv6_scan_launch": [c_ptr] * 7 + [c_int] * 8 + [c_ptr],
    # x, dt, A, Bm, C, D, y, s, B, H, T, P, N, chunk, dtype, heads a block,
    # smem bytes, stream
    "mamba2_scan_launch": [c_ptr] * 8 + [c_int] * 9 + [c_ptr],
    "cuda_error_string": [c_int],
}


# cudaError_t codes the callers tell apart.
CUDA_ERROR_MEMORY_ALLOCATION = 2     # cudaErrorMemoryAllocation


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing, a source did not compile or link, or the built
    library did not load.  Deterministic: retrying cannot help."""


class CudaError(RuntimeError):
    """A kernel's launch returned a non-zero ``cudaError_t`` (``code``)."""

    def __init__(self, what: str, code: int, msg: str):
        self.what, self.code, self.msg = what, int(code), msg
        super().__init__(f"{what}: CUDA error {code} ({msg})")

    def __reduce__(self):
        # Pickled by its own arguments, so that a scheduler worker process
        # can report one to its parent.
        return CudaError, (self.what, self.code, self.msg)


class Library:
    """The loaded kernels plus what their build printed."""

    def __init__(self, path: pathlib.Path, log: str, build_s: float):
        self.path = path
        self.log = log            # nvcc / ptxas -v output of the build
        self.build_s = build_s    # 0.0 when an earlier build was reused
        try:
            self.cdll = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildError(f"the kernels' library {path} did not load: {e}") from e
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name == "cuda_error_string" else ctypes.c_int

    def check(self, err: int, what: str) -> None:
        if err != 0:
            raise CudaError(what, err, self.cdll.cuda_error_string(err).decode())


_LIB: Optional[Library] = None


def sources() -> list:
    """The sources compiled, one object each."""
    return sorted(_PKG.glob("*/csrc/*.cu"))


def hashed_files() -> list:
    """Every file the build reads: the sources and the headers they include."""
    return sorted([*sources(), *_PKG.glob("*/csrc/*.cuh")])


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(pathlib.Path(cuda_home) / "bin" / "nvcc")
    if not os.access(found, os.X_OK):
        raise KernelBuildError(
            "nvcc not found (looked on PATH and under CUDA_HOME); the CUDA kernels "
            "are built from source at first use and need the CUDA toolkit")
    return found


def _run(cmd: list) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return out


def _build(nvcc: str, srcs: list, target: pathlib.Path) -> str:
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [pathlib.Path(tmp) / f"{s.parent.parent.name}_{s.stem}.o" for s in srcs]
        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            logs = list(pool.map(
                _run, [[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                       for s, o in zip(srcs, objs)]))
        so = pathlib.Path(tmp) / target.name
        logs.append(_run([nvcc, "-shared", "-o", str(so), *map(str, objs)]))
        os.replace(so, target)
    return "".join(f"== {s.relative_to(_PKG.parent)}\n{log}" for s, log in zip(srcs, logs))


def load() -> Library:
    """The kernels' library, built on first use (thread- and process-safe)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    srcs = sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in hashed_files():
        digest.update(str(s.relative_to(_PKG)).encode() + b"\0" + s.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"kernels-{digest.hexdigest()[:16]}.so"
    log_path = target.with_suffix(".log")
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        build_s = 0.0
        if not target.exists():
            t0 = time.perf_counter()
            log_path.write_text(_build(_nvcc(), srcs, target))
            build_s = time.perf_counter() - t0
        _LIB = Library(target, log_path.read_text() if log_path.exists() else "", build_s)
    return _LIB
