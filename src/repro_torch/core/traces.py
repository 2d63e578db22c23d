"""Synthetic memory-trace generators for the paper's workloads (Table 2).

The paper evaluates SPARTA with trace-driven functional simulation of index
traversal workloads from ASCYLIB (128 GB footprints) plus RocksDB (16 GB).
We reproduce that methodology with *synthetic* trace generators that model
the documented locality character of each data structure:

* ``hash_table``   — bucket array + chained nodes; near-uniform, no reuse.
* ``bst_internal`` — root-to-leaf pointer chase over a level-ordered tree;
                     extreme reuse at the top levels, uniform at the bottom.
* ``bst_external`` — like the internal BST but keys/values live only in
                     (larger) leaves; internal nodes are slimmer.
* ``skip_list``    — tower traversal; nodes are *scattered* by allocation
                     order, so even the few high-tower nodes exhibit no
                     spatial locality (the paper notes skip lists have the
                     worst locality and a footprint slightly above 128 GB).
* ``rocksdb``      — Zipfian point lookups over SST blocks + memtable
                     (skip-list) probes + occasional sequential range scans.
* ``multiprog``    — 4 x 32 GB instances of the four index workloads in
                     disjoint address ranges, interleaved round-robin.

Traces are streams of **64-byte cache-line addresses** (int64).  One trace
feeds every simulator in :mod:`repro_torch.core.tlbsim`: the accelerator cache is
probed with the line address, a 4 KB-page TLB with ``line >> 6`` and a 2 MB
TLB with ``line >> 15``.

Everything is vectorised numpy; generation of a few million accesses takes
well under a second per workload.  This module is the port's own copy of the
JAX package's ``src/repro/core/traces.py`` and generates byte-identical
traces for every workload and seed (``tests/test_torch_traces.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np

LINE_SHIFT = 6  # 64-byte cache lines
LINES_PER_4K = 1 << (12 - LINE_SHIFT)
LINES_PER_2M = 1 << (21 - LINE_SHIFT)

GIB = 1 << 30

# Cache-line addresses above 2^52 lines (2^58 bytes) exceed any virtual
# address space the simulators model and almost certainly indicate a units
# bug (bytes where lines were meant, or float contamination).
MAX_LINE_ADDR = 1 << 52

WORKLOADS = (
    "hash_table",
    "bst_internal",
    "bst_external",
    "skip_list",
    "rocksdb",
    "multiprog",
)

# Instructions executed per memory access for the CPI model (§6.3): pointer
# chases execute a handful of compare/branch instructions between loads.
INSTR_PER_ACCESS: Dict[str, float] = {
    "hash_table": 6.0,
    "bst_internal": 5.0,
    "bst_external": 5.0,
    "skip_list": 4.0,
    "rocksdb": 8.0,
    "multiprog": 5.0,
}


def validate_lines(lines: np.ndarray, *, name: str = "trace") -> np.ndarray:
    """Strictly validate a stream of cache-line addresses.

    Rejects the inputs that would otherwise surface as garbage miss ratios
    deep inside a sweep: zero-length streams, NaN/non-integral floats,
    negative addresses, and addresses above ``MAX_LINE_ADDR`` (2^52 lines).
    Returns the stream as a 1-D int64 array.  Every error names the offending
    trace and the first bad index so the fix is at load time, not mid-sweep.
    """
    arr = np.asarray(lines)
    if arr.ndim != 1:
        raise ValueError(
            f"{name}: trace must be a 1-D stream of line addresses, "
            f"got shape {arr.shape}")
    if arr.shape[0] == 0:
        raise ValueError(
            f"{name}: zero-length trace — nothing to simulate; check "
            f"n_ops / max_accesses / interleave truncation upstream")
    if np.issubdtype(arr.dtype, np.floating):
        bad = ~np.isfinite(arr)
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"{name}: non-finite address at index {i} ({arr[i]!r}); "
                f"traces must be integer cache-line addresses")
        if not np.array_equal(arr, np.floor(arr)):
            i = int(np.argmax(arr != np.floor(arr)))
            raise ValueError(
                f"{name}: non-integral address at index {i} ({arr[i]!r}); "
                f"traces must be integer cache-line addresses")
        arr = arr.astype(np.int64)
    elif not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(
            f"{name}: trace dtype {arr.dtype} is not an address type; "
            f"expected integer cache-line addresses")
    if arr.min() < 0:
        i = int(np.argmax(arr < 0))
        raise ValueError(
            f"{name}: negative address at index {i} ({int(arr[i])}); "
            f"line addresses must be non-negative")
    if arr.max() > MAX_LINE_ADDR:
        i = int(np.argmax(arr > MAX_LINE_ADDR))
        raise ValueError(
            f"{name}: address at index {i} ({int(arr[i])}) exceeds 2^52 "
            f"lines — bytes passed where line addresses were expected?")
    return arr.astype(np.int64, copy=False)


@dataclasses.dataclass(frozen=True)
class Trace:
    """A stream of cache-line addresses plus workload metadata.

    Construction validates the stream (:func:`validate_lines`) so bad inputs
    fail here, at load time, with an actionable error."""

    name: str
    lines: np.ndarray  # int64 [N] cache-line addresses
    footprint_bytes: int

    def __post_init__(self):
        object.__setattr__(
            self, "lines", validate_lines(self.lines, name=self.name))

    @property
    def num_accesses(self) -> int:
        return int(self.lines.shape[0])

    def vpns(self, page_shift: int = 12) -> np.ndarray:
        """Virtual page numbers at the given page size."""
        return self.lines >> (page_shift - LINE_SHIFT)

    @property
    def instr_per_access(self) -> float:
        return INSTR_PER_ACCESS.get(self.name, 5.0)


_INT64_MAX = float(np.iinfo(np.int64).max)


def _zipf(rng: np.random.Generator, a: float, size: int) -> np.ndarray:
    """``rng.zipf(a, size)`` as numpy 2.0 draws it, whatever numpy runs.

    Later numpy versions draw other Zipf values from the same seed, so the
    hash-table (Fig 2) and rocksdb (Fig 6) traces, and their hit counts,
    would differ from the reference's on another numpy.  This is numpy 2.0's
    loop: a pair of doubles an attempt, ``X = floor(U ** (-1 / (a - 1)))``
    with ``U = 1 - next_double``, kept when ``V X (T - 1) / (b - 1) <= T / b``
    (``T = (1 + 1 / X) ** (a - 1)``, ``b = 2 ** (a - 1)``).  The doubles are
    drawn in bulk, then the generator is rewound and advanced by exactly
    the pairs the ``size`` draws consumed, so the draws after it are
    numpy 2.0's too.  ``math.pow`` is the C library's ``pow``, as in numpy's
    C code (numpy's vectorised ``power`` may use another implementation)."""
    am1 = a - 1.0
    b = math.pow(2.0, am1)
    inv = -1.0 / am1
    out = np.empty(size, dtype=np.int64)
    state = rng.bit_generator.state
    pairs = max(16, size + size // 4)
    while True:
        u = rng.random(2 * pairs).tolist()
        j = k = 0
        while j < size and k < pairs:
            U, V = 1.0 - u[2 * k], u[2 * k + 1]
            k += 1
            X = math.floor(math.pow(U, inv))
            if X > _INT64_MAX or X < 1.0:
                continue
            T = math.pow(1.0 + 1.0 / X, am1)
            if V * X * (T - 1.0) / (b - 1.0) <= T / b:
                out[j] = X
                j += 1
        rng.bit_generator.state = state
        if j == size:
            rng.random(2 * k)
            return out
        pairs *= 2


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Cheap stateless scrambler used to scatter node ids over the heap."""
    x = (x + np.int64(-7046029254386353131)).astype(np.uint64)  # 0x9E3779B97F4A7C15
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return x


def _scatter(ids: np.ndarray, space_lines: int, salt: int) -> np.ndarray:
    """Map structured ids to pseudo-random line addresses in [0, space)."""
    return (_splitmix64(ids.astype(np.int64) + np.int64(salt * 0x51_7C_C1)) % np.uint64(space_lines)).astype(np.int64)


# ---------------------------------------------------------------------------
# Individual workload generators.  Each returns int64 line addresses in
# [0, footprint_lines).
# ---------------------------------------------------------------------------

def _gen_hash_table(rng: np.random.Generator, n_ops: int, footprint_lines: int,
                    zipf_keys: float = 0.0, tslice=(0.0, 1.0)) -> np.ndarray:
    """Bucket array (25% of footprint) + chained nodes (75%).

    ``zipf_keys`` > 1 draws bucket indices from a Zipf popularity law
    (memcached-style hot keys) instead of uniform — used by the Fig 2
    footprint sweep where absolute hot-set size vs TLB reach matters."""
    bucket_lines = footprint_lines // 4
    heap_lines = footprint_lines - bucket_lines
    lo_b, hi_b = int(tslice[0] * bucket_lines), max(int(tslice[1] * bucket_lines), 1)
    if zipf_keys > 1.0:
        ranks = _zipf(rng, zipf_keys, n_ops) - 1
        buckets = lo_b + _scatter(ranks.clip(max=bucket_lines - 1), hi_b - lo_b, salt=23)
        # Hot keys point at hot chain nodes too (correlated placement).
        hot_nodes = True
    else:
        buckets = rng.integers(lo_b, hi_b, size=n_ops, dtype=np.int64)
        hot_nodes = False
    # Chain length ~ geometric, mean ~1.5 node probes per lookup.
    chain = 1 + rng.geometric(0.67, size=n_ops).astype(np.int64).clip(max=4) - 1
    max_chain = int(chain.max(initial=1))
    lo_h = int(tslice[0] * heap_lines)
    hi_h = max(int(tslice[1] * heap_lines), lo_h + 1)
    if hot_nodes:
        # Chain nodes hash off the (zipf-popular) bucket: key popularity
        # carries over to node placement reuse.
        node_probe = lo_h + _scatter(
            (buckets[:, None] * 7 + np.arange(max_chain)[None, :]).ravel(),
            hi_h - lo_h, salt=29,
        ).reshape(n_ops, max_chain) + bucket_lines
    else:
        node_probe = rng.integers(lo_h, hi_h, size=(n_ops, max_chain), dtype=np.int64) + bucket_lines
    b2 = buckets[:, None]
    _op_reuse(rng, [b2, node_probe, chain[:, None]])
    buckets = b2[:, 0]
    chain = chain.copy()
    cols = np.arange(max_chain)[None, :]
    keep = cols < np.maximum(chain, 1)[:, None]
    # Interleave bucket probe then its chain probes, preserving per-op order.
    seq = np.concatenate([buckets[:, None], np.where(keep, node_probe, -1)], axis=1).ravel()
    return seq[seq >= 0]




def _op_reuse(rng: np.random.Generator, rows: "list[np.ndarray]", p: float = 0.3,
              window: int = 64) -> None:
    """Temporal key reuse: with probability ``p`` an op repeats a recent op
    (same path / same key), drawn uniformly from the last ``window`` ops.
    Real server traces re-touch recent keys (sessions, retries, read-modify-
    write); independent draws would understate single-thread TLB hit rates.
    Applied IN PLACE to parallel [n_ops, ...] matrices of one generator."""
    n = rows[0].shape[0]
    reuse = rng.random(n) < p
    back = rng.integers(1, window + 1, size=n)
    src = np.maximum(np.arange(n) - back, 0)
    # Resolve chains (a reuse op pointing at another reuse op) one level deep.
    idx = np.where(reuse, src, np.arange(n))
    for r in rows:
        r[reuse] = r[idx[reuse]]


def _tree_levels(total_nodes: int) -> int:
    return max(1, int(np.ceil(np.log2(total_nodes + 1))))


def _gen_bst(
    rng: np.random.Generator,
    n_ops: int,
    footprint_lines: int,
    *,
    external: bool,
    tslice=(0.0, 1.0),
    scatter_nodes: bool = False,
) -> np.ndarray:
    """Level-ordered binary tree pointer chase.

    Level ``l`` occupies a contiguous address range; a lookup touches one
    uniformly-random node per level.  Top levels therefore live in a handful
    of lines/pages reused by every lookup (great locality), while the deep
    levels are effectively uniform (miss-heavy) — exactly the behaviour the
    paper reports for in-memory search trees.
    """
    node_lines = 1  # 64B nodes
    if external:
        # External BST: slim internal nodes over ~1/4 of the footprint and
        # fat (4-line) leaves over the rest.
        internal_lines = footprint_lines // 4
        leaf_lines = footprint_lines - internal_lines
        n_internal = internal_lines // node_lines
        depth = _tree_levels(n_internal)
    else:
        n_internal = footprint_lines // node_lines
        depth = _tree_levels(n_internal)
        internal_lines = footprint_lines
        leaf_lines = 0

    level_sizes = np.minimum(np.int64(1) << np.arange(depth, dtype=np.int64), np.int64(n_internal))
    level_base = np.concatenate([[0], np.cumsum(level_sizes)[:-1]])
    # Clamp cumulative allocation to the internal region.
    level_base = np.minimum(level_base, internal_lines - 1)

    # One uniform node per level per lookup.  A thread slice restricts the
    # walk to its subtree once levels are wide enough (range-partitioned
    # worker threads share the top of the tree, diverge below).
    u = rng.random(size=(n_ops, depth))
    lo, hi = tslice
    wide = level_sizes >= 64
    base_f = np.where(wide, lo * level_sizes, 0.0)
    span_f = np.where(wide, (hi - lo) * level_sizes, level_sizes.astype(float))
    idx = (base_f[None, :] + u * span_f[None, :]).astype(np.int64)
    path = (level_base[None, :] + idx) * node_lines
    path = np.minimum(path, internal_lines - 1)
    if scatter_nodes:
        # Allocation-order placement: every node lands on its own scattered
        # line (no two tree nodes share a page) — the ASCYLIB reality the
        # paper's "minimal data locality" stresses.  Hot nodes stay hot
        # (same scattered address), but page-level reach collapses.
        path = _scatter(path.ravel(), internal_lines, salt=41).reshape(path.shape)
    _op_reuse(rng, [path])

    if external:
        leaf_lo = int(lo * max(leaf_lines - 4, 1))
        leaf_hi = max(int(hi * max(leaf_lines - 4, 1)), leaf_lo + 1)
        leaf = internal_lines + rng.integers(leaf_lo, leaf_hi, size=(n_ops, 1), dtype=np.int64)
        # Touch 2 lines of the 4-line leaf value.
        path = np.concatenate([path, leaf, leaf + 1], axis=1)
    return path.ravel()


def _gen_skip_list(rng: np.random.Generator, n_ops: int, footprint_lines: int,
                   tslice=(0.0, 1.0)) -> np.ndarray:
    """Skip-list tower traversal with allocation-order scattered nodes.

    There are N/2^l nodes of height >= l, but because nodes are allocated in
    insertion order their addresses are scattered: we map (level, node-id)
    through a stateless hash.  Footprint runs slightly above the nominal
    size (paper §7.3 notes Skip Lists exceed 128 GB).
    """
    space = int(footprint_lines * 1.02)
    n_nodes = footprint_lines  # one line per node
    max_level = _tree_levels(n_nodes)
    levels = np.arange(max_level - 1, -1, -1, dtype=np.int64)  # high -> low
    nodes_at = np.maximum(n_nodes >> (max_level - 1 - np.arange(max_level)), 1)[::-1].copy()
    # ~2 probes per level during search.
    probes_per_level = 2
    u = rng.random(size=(n_ops, max_level, probes_per_level))
    lo, hi = tslice
    counts = nodes_at[::-1].astype(float)
    wide = counts >= 64
    base_f = np.where(wide, lo * counts, 0.0)
    span_f = np.where(wide, (hi - lo) * counts, counts)
    ids = (base_f[None, :, None] + u * span_f[None, :, None]).astype(np.int64)
    _op_reuse(rng, [ids])
    lvl = levels[None, :, None]
    addr = _scatter((ids * np.int64(64) + lvl).ravel(), space, salt=11)
    return addr


def _gen_rocksdb(rng: np.random.Generator, n_ops: int, footprint_lines: int) -> np.ndarray:
    """Zipf point lookups over SST blocks + memtable probes + range scans."""
    # Regions: memtable skip-list (2%), block index (2%), SST data (96%).
    mem_lines = max(footprint_lines // 50, 1)
    idx_lines = max(footprint_lines // 50, 1)
    data_base = mem_lines + idx_lines
    data_lines = footprint_lines - data_base
    n_blocks = max(data_lines // LINES_PER_4K, 1)

    # Zipf block popularity (s ~= 0.99) via inverse-CDF on a truncated zipf.
    ranks = _zipf(rng, 1.2, n_ops)
    blocks = (ranks - 1).clip(max=n_blocks - 1)
    # Scatter popular ranks over the physical block space.
    blocks = _scatter(blocks, n_blocks, salt=3)

    # memtable probe: ~4 scattered lines in the memtable region
    mt = _scatter(rng.integers(0, 1 << 40, size=(n_ops, 4), dtype=np.int64).ravel(), mem_lines, salt=5)
    # index probe: 1 line
    ix = mem_lines + _scatter(blocks, idx_lines, salt=7)
    # data block: 2 sequential lines inside the 4 KB block
    off = rng.integers(0, LINES_PER_4K - 1, size=n_ops, dtype=np.int64)
    d0 = data_base + blocks * LINES_PER_4K + off
    seq = np.stack([mt.reshape(n_ops, 4)[:, 0], mt.reshape(n_ops, 4)[:, 1],
                    mt.reshape(n_ops, 4)[:, 2], mt.reshape(n_ops, 4)[:, 3],
                    ix, d0, d0 + 1], axis=1).ravel()

    # 5% of ops are 32-line sequential range scans, each burst inserted at a
    # random position in the point-lookup stream (range reads arrive
    # interleaved with gets in a real server, not as one tail batch).
    n_scan = n_ops // 20
    scan_start = data_base + rng.integers(0, max(data_lines - 32, 1), size=n_scan, dtype=np.int64)
    scans = scan_start[:, None] + np.arange(32)[None, :]
    return _interleave_bursts(seq, scans, rng)


def _interleave_bursts(stream: np.ndarray, bursts: np.ndarray,
                       rng: np.random.Generator) -> np.ndarray:
    """Insert each burst row (kept contiguous, in row order) at a uniformly
    random position of ``stream``, preserving the stream's own order."""
    n_b, blen = bursts.shape
    n = stream.shape[0]
    if n_b == 0:
        return stream
    ip = np.sort(rng.integers(0, n + 1, size=n_b))
    out = np.empty(n + n_b * blen, stream.dtype)
    # Stream element j shifts right by one burst length per burst inserted at
    # or before it; burst k starts at its insertion point plus the k bursts
    # already inserted to its left.
    shift = np.searchsorted(ip, np.arange(n), side="right")
    out[np.arange(n) + blen * shift] = stream
    burst_pos = (ip + blen * np.arange(n_b))[:, None] + np.arange(blen)
    out[burst_pos] = bursts
    return out


_INDEX_GENS = {
    "hash_table": _gen_hash_table,
    "bst_internal": lambda r, n, f: _gen_bst(r, n, f, external=False),
    "bst_external": lambda r, n, f: _gen_bst(r, n, f, external=True),
    "skip_list": _gen_skip_list,
    "rocksdb": _gen_rocksdb,
}


def generate(
    workload: str,
    *,
    n_ops: int = 50_000,
    seed: int = 0,
    footprint_bytes: int = 128 * GIB,
    max_accesses: int | None = None,
    zipf_keys: float = 0.0,
    thread_slice=(0.0, 1.0),
    scatter_nodes: bool = False,
) -> Trace:
    """Generate a trace for one workload.

    ``n_ops`` is the number of *operations* (lookups); each op expands to
    several memory accesses depending on the structure.
    """
    if workload == "multiprog":
        return _generate_multiprog(n_ops=n_ops, seed=seed, footprint_bytes=footprint_bytes)
    if workload not in _INDEX_GENS:
        raise ValueError(f"unknown workload {workload!r}; options: {WORKLOADS}")
    rng = np.random.default_rng(seed)
    footprint_lines = footprint_bytes >> LINE_SHIFT
    gens = {
        "hash_table": lambda: _gen_hash_table(rng, n_ops, footprint_lines, zipf_keys, thread_slice),
        "bst_internal": lambda: _gen_bst(rng, n_ops, footprint_lines, external=False,
                                         tslice=thread_slice, scatter_nodes=scatter_nodes),
        "bst_external": lambda: _gen_bst(rng, n_ops, footprint_lines, external=True,
                                         tslice=thread_slice, scatter_nodes=scatter_nodes),
        "skip_list": lambda: _gen_skip_list(rng, n_ops, footprint_lines, tslice=thread_slice),
        "rocksdb": lambda: _gen_rocksdb(rng, n_ops, footprint_lines),
    }
    lines = gens[workload]().astype(np.int64)
    if max_accesses is not None and lines.shape[0] > max_accesses:
        lines = lines[:max_accesses]
    return Trace(name=workload, lines=lines, footprint_bytes=footprint_bytes)


def _generate_multiprog(*, n_ops: int, seed: int, footprint_bytes: int) -> Trace:
    """4 x 32 GB single-app instances in disjoint ranges, interleaved."""
    per = footprint_bytes // 4
    parts = []
    for i, w in enumerate(("bst_external", "bst_internal", "hash_table", "skip_list")):
        t = generate(w, n_ops=n_ops // 4, seed=seed + 101 * i, footprint_bytes=per)
        parts.append(t.lines + np.int64(i * (per >> LINE_SHIFT)))
    lines = interleave(parts, granularity=8)
    return Trace(name="multiprog", lines=lines, footprint_bytes=footprint_bytes)


def interleave(streams: Sequence[np.ndarray], granularity: int = 1) -> np.ndarray:
    """Round-robin interleave several access streams at ``granularity``.

    Models concurrent threads issuing to a *shared* memory-side TLB (Fig 5 /
    Fig 8).  Streams are truncated to the shortest length (rounded down to a
    multiple of the granularity).
    """
    n = min(s.shape[0] for s in streams)
    n -= n % granularity
    if n == 0:
        raise ValueError("streams too short to interleave")
    stack = np.stack([s[:n].reshape(-1, granularity) for s in streams], axis=1)
    return stack.reshape(-1)


def thread_traces(
    workload: str,
    n_threads: int,
    *,
    n_ops: int = 20_000,
    seed: int = 0,
    footprint_bytes: int = 128 * GIB,
    region_skew: float = 0.5,
) -> List[np.ndarray]:
    """Per-thread traces over the *same shared dataset* (same footprint,
    different op streams) — the Fig 5 thread-contention setup.

    ``region_skew`` models range-partitioned worker threads (the standard
    server pattern): that fraction of each thread's accesses is remapped
    into its own 1/n_threads slice of the footprint, giving every thread a
    private hot set (the source of shared-TLB capacity contention the paper
    measures); the rest touch the shared structure globally."""
    out = []
    for t in range(n_threads):
        if n_threads > 1 and region_skew > 0:
            tslice = (t / n_threads, (t + 1) / n_threads)
        else:
            tslice = (0.0, 1.0)
        out.append(generate(workload, n_ops=n_ops, seed=seed + 997 * t,
                            footprint_bytes=footprint_bytes,
                            thread_slice=tslice, scatter_nodes=True).lines)
    return out
