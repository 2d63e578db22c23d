"""Partition-local inverted page tables, demand paging, and the paper's OS
allocation algorithms (paper §5, Fig 6).

The port of the JAX package's ``src/repro/core/pagetable.py``.  Three pieces:

1. :class:`InvertedPageTable` — the paper's per-partition hashed/inverted
   page table (modelled on IBM Power HTABs), one per partition, sized to the
   partition's frame count.  Open addressing on (asid, vpn) with a valid bit
   per entry — the structure the memory-side MMU walks *locally* on a TLB
   miss.  A host structure (numpy), as in the JAX package.

2. The OS allocation paths of §5: :func:`alloc_page_vma` (Algorithm 1: the
   partition comes from the faulting virtual address, the frame may be any
   free frame in it) and :func:`adjust_virtual_region` (slide a candidate
   virtual region so its partition sequence matches existing physical
   pages).

3. :func:`page_fault_curve` — the Fig 6 experiment: LRU page-fault rate vs
   available memory for 1 node vs P partitions, computed exactly from LRU
   stack distances.  The JAX package walks a Fenwick tree in a ``lax.scan``,
   one access a step; here the same distances come from a formulation of
   whole-array operations that runs on ``device`` (the card by default):
   with ``prev[i]`` the previous access to access ``i``'s page,

       dist[i] = i - prev[i] - #{k < i : prev[k] > prev[i]}

   (the accesses since ``prev[i]``, less the repeats among them), the count
   an offline dominance count over a merge-sort tree: per level ``L`` one
   sort of the keys ``(k >> L, prev[k])`` and one ``searchsorted`` for the
   queries whose index has bit ``L`` set.  Exact int64 arithmetic.
   :func:`fenwick_stack_distances` keeps the sequential Fenwick walk as the
   plain version the tests and ``chip_smoke.py`` hold it against.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.sparta import mem_partition_index_hash
from repro_torch.kernels.common import as_device

Device = Union[str, torch.device]


# ---------------------------------------------------------------------------
# 1. Partition-local inverted page table.
# ---------------------------------------------------------------------------

class InvertedPageTable:
    """Open-addressing inverted page table for ONE memory partition.

    Entries: (asid, vpn) -> local frame number.  Capacity is proportional to
    the partition's frames (load factor <= 0.75), i.e. table size scales with
    the partition — the property that makes SPARTA page walks local and O(1).
    """

    EMPTY = -1
    TOMB = -2

    def __init__(self, num_frames: int):
        self.capacity = max(8, int(num_frames / 0.75))
        self.keys_asid = np.full(self.capacity, self.EMPTY, dtype=np.int64)
        self.keys_vpn = np.full(self.capacity, self.EMPTY, dtype=np.int64)
        self.frames = np.full(self.capacity, self.EMPTY, dtype=np.int64)
        self.valid = np.zeros(self.capacity, dtype=bool)
        self.size = 0

    def _probe(self, asid: int, vpn: int) -> Tuple[int, Optional[int]]:
        """Returns (insert_slot, found_slot)."""
        h = hash((asid, vpn)) % self.capacity
        first_free = -1
        for i in range(self.capacity):
            j = (h + i) % self.capacity
            if self.keys_asid[j] == self.EMPTY:
                if first_free < 0:
                    first_free = j
                return first_free, None
            if self.keys_asid[j] == self.TOMB:
                if first_free < 0:
                    first_free = j
                continue
            if self.keys_asid[j] == asid and self.keys_vpn[j] == vpn:
                return j, j
        if first_free < 0:
            raise RuntimeError("inverted page table full")
        return first_free, None

    def insert(self, asid: int, vpn: int, frame: int) -> None:
        slot, found = self._probe(asid, vpn)
        if found is None:
            self.size += 1
        self.keys_asid[slot] = asid
        self.keys_vpn[slot] = vpn
        self.frames[slot] = frame
        self.valid[slot] = True

    def lookup(self, asid: int, vpn: int) -> Optional[int]:
        _, found = self._probe(asid, vpn)
        if found is None or not self.valid[found]:
            return None
        return int(self.frames[found])

    def invalidate(self, asid: int, vpn: int) -> bool:
        """Clear the valid bit (the CPU<->accelerator coherence hook, §5)."""
        _, found = self._probe(asid, vpn)
        if found is None:
            return False
        self.valid[found] = False
        self.keys_asid[found] = self.TOMB
        self.size -= 1
        return True


# ---------------------------------------------------------------------------
# 2. OS allocation paths (§5).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Partition:
    """One memory partition: free-frame list + its inverted page table."""

    index: int
    frames: List[int]
    page_table: InvertedPageTable

    def alloc_frame(self) -> Optional[int]:
        return self.frames.pop() if self.frames else None


def make_partitions(num_partitions: int, frames_per_partition: int) -> List[Partition]:
    return [
        Partition(
            index=p,
            frames=list(range(frames_per_partition - 1, -1, -1)),
            page_table=InvertedPageTable(frames_per_partition),
        )
        for p in range(num_partitions)
    ]


def alloc_page_vma(vaddr_vpn: int, asid: int, partitions: List[Partition]) -> Tuple[int, int]:
    """Algorithm 1: ALLOC_PAGES_VMA — partition from the hash, any free frame.

    Returns (partition_index, local_frame).  Raises on partition exhaustion
    (the caller models swapping / eviction).
    """
    p = int(mem_partition_index_hash(int(vaddr_vpn), len(partitions)))
    frame = partitions[p].alloc_frame()
    if frame is None:
        raise MemoryError(f"partition {p} exhausted")
    partitions[p].page_table.insert(asid, vaddr_vpn, frame)
    return p, frame


def adjust_virtual_region(
    candidate_start_vpn: int,
    existing_partition_seq: Sequence[int],
    num_partitions: int,
    *,
    search_limit: int = 1 << 20,
) -> int:
    """§5 shared/remap path: slide the candidate virtual region forward until
    its partition sequence matches the existing physical pages' sequence.

    With the mod-P hash, consecutive virtual pages cycle through partitions,
    so it suffices to match the first page: the adjusted start is the
    smallest vpn >= candidate_start whose hash equals the first existing
    partition.  (The paper's example: candidate V5 with sequence (3,0,1,2,3)
    and P=4 adjusts to V7.)
    """
    if not existing_partition_seq:
        return candidate_start_vpn
    base = existing_partition_seq[0]
    for i, p in enumerate(existing_partition_seq):
        if p != (base + i) % num_partitions:
            raise ValueError("existing physical pages do not form a contiguous partition cycle")
    delta = (base - candidate_start_vpn) % num_partitions
    if delta > search_limit:
        raise RuntimeError("no aligned region found")
    return candidate_start_vpn + delta


# ---------------------------------------------------------------------------
# 3. Demand paging: exact LRU fault curves from stack distances (Fig 6).
# ---------------------------------------------------------------------------

def _previous_occurrence(pages: torch.Tensor) -> torch.Tensor:
    """prev[i] = index of the previous access to pages[i], or -1."""
    order = torch.sort(pages, stable=True).indices
    sorted_pages = pages[order]
    prev_sorted = torch.full_like(order, -1)
    same = sorted_pages[1:] == sorted_pages[:-1]
    prev_sorted[1:] = torch.where(same, order[:-1], -1)
    prev = torch.empty_like(prev_sorted)
    prev[order] = prev_sorted
    return prev


def _distances_from_prev(prev: torch.Tensor, cold: int) -> torch.Tensor:
    """LRU stack distances int64 [n] from ``prev`` (see the module
    docstring); accesses with ``prev < 0`` get ``cold``.

    The range [0, i) splits into one block per set bit L of i: block
    ``(i >> L) - 1`` of level L, i.e. indices [(b << L), (b + 1) << L),
    wholly below i.  Sorting ``(k >> L) * (n + 1) + prev[k] + 1`` orders the
    accesses by block and, within a block, by ``prev``; the entries of block
    b with ``prev[k] > prev[i]`` are then ``((b + 1) << L)`` less the keys at
    or below ``b * (n + 1) + prev[i] + 1``."""
    n = prev.numel()
    idx = torch.arange(n, device=prev.device)
    later = torch.zeros_like(idx)
    span = n + 1
    level = 0
    while (1 << level) < n:
        keys = torch.sort((idx >> level) * span + prev + 1).values
        b = (idx >> level) - 1
        at_or_below = torch.searchsorted(keys, b * span + prev + 1, right=True)
        # Every access is searched (no data-dependent selection, so no wait
        # on the device); only those with bit ``level`` set count.
        later += torch.where((idx >> level) & 1 == 1, ((b + 1) << level) - at_or_below, 0)
        level += 1
    return torch.where(prev >= 0, idx - prev - later, cold)


def _as_pages(pages, device: Device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(pages, dtype=np.int64)).to(as_device(device))


def stack_distances(pages, *, device: Device = "cuda") -> np.ndarray:
    """Exact LRU stack distance per access (n+1 for cold misses), computed on
    ``device``; an int64 numpy array, as the JAX package returns."""
    p = _as_pages(pages, device)
    n = p.numel()
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    return _distances_from_prev(_previous_occurrence(p), n + 1).cpu().numpy()


def stack_distances_batch(streams: List[np.ndarray], *, device: Device = "cuda") -> List[np.ndarray]:
    """Stack distances of several ragged streams in one pass on ``device``.

    The JAX package pads every stream to the longest, ``n_max``, so a cold
    access gets ``n_max + 1`` in **every** stream; so does this one.  The
    streams run concatenated: an access whose page was last seen before its
    own stream began is cold, and no other access's count reaches across a
    stream's start (its ``prev`` lies inside its stream)."""
    if not streams:
        return []
    lens = [int(np.asarray(s).shape[0]) for s in streams]
    cold = max(max(lens), 1) + 1
    pages = _as_pages(np.concatenate([np.asarray(s, dtype=np.int64) for s in streams]),
                      device)
    prev = _previous_occurrence(pages)
    starts = np.repeat(np.cumsum([0] + lens[:-1]), lens)
    prev = torch.where(prev < torch.from_numpy(starts).to(prev.device), -1, prev)
    dist = _distances_from_prev(prev, cold).cpu().numpy()
    return list(np.split(dist, np.cumsum(lens)[:-1]))


def fenwick_stack_distances(pages) -> np.ndarray:
    """The plain version: the JAX package's sequential Fenwick walk, one
    access a step on the host.  The tree holds a 1 at each access that is
    still the latest to its page; a warm access's distance is the count of
    such accesses since its previous one, plus one; a first access's is
    n+1."""
    pages = np.asarray(pages, dtype=np.int64)
    n = pages.shape[0]
    prev = _previous_occurrence(torch.from_numpy(pages)).tolist()
    tree = [0] * (n + 1)

    def prefix(x):
        s = 0
        while x > 0:
            s += tree[x]
            x -= x & -x
        return s

    def update(x, v):
        while x <= n:
            tree[x] += v
            x += x & -x

    out = np.empty(n, dtype=np.int64)
    for i, p in enumerate(prev):
        if p < 0:
            out[i] = n + 1
        else:
            out[i] = prefix(i) - prefix(p + 1) + 1
            update(p + 1, -1)
        update(i + 1, 1)
    return out


def fault_rate(distances: np.ndarray, frames: int) -> float:
    """LRU inclusion property: access faults iff stack distance > frames."""
    if distances.size == 0:
        return 0.0
    return int((distances > frames).sum()) / distances.size


def page_fault_counts(
    vpns,
    mem_frames: Sequence[int],
    *,
    num_partitions: int = 1,
    node_overhead_frames: int = 0,
    node_capacity_jitter: float = 0.0,
    seed: int = 0,
    device: Device = "cuda",
) -> Tuple[np.ndarray, int]:
    """(faults int64 [len(mem_frames)], accesses) behind
    :func:`page_fault_curve`, with its arguments."""
    vpns = np.asarray(vpns, dtype=np.int64)
    n = int(vpns.shape[0])
    if num_partitions == 1:
        d = stack_distances(vpns, device=device)
        return np.array([int((d > int(f)).sum()) for f in mem_frames], dtype=np.int64), n

    rng = np.random.default_rng(seed)
    jitter = 1.0 + node_capacity_jitter * rng.standard_normal(num_partitions)
    part = vpns % num_partitions
    dists = stack_distances_batch([vpns[part == p] for p in range(num_partitions)],
                                  device=device)
    out = []
    for f in mem_frames:
        usable = max(int(f) - node_overhead_frames * num_partitions, num_partitions)
        per = usable / num_partitions
        out.append(sum(int((dists[p] > max(1, int(per * jitter[p]))).sum())
                       for p in range(num_partitions)))
    return np.array(out, dtype=np.int64), n


def page_fault_curve(
    vpns,
    mem_frames: Sequence[int],
    *,
    num_partitions: int = 1,
    node_overhead_frames: int = 0,
    node_capacity_jitter: float = 0.0,
    seed: int = 0,
    device: Device = "cuda",
) -> np.ndarray:
    """Fault rate for each total-memory size, with optional partitioning.

    Partitioned mode splits the trace (``vpn % num_partitions``) and the
    frames (evenly, minus per-node overhead, with deterministic capacity
    jitter from ``numpy.random.default_rng(seed)``, modelling the
    Linux-NUMA-node artifact the paper reports: the 32-node setup needs
    ~1.5-2 GB extra memory for the same fault rate).  The distances run on
    ``device``; the counting is host arithmetic, as in the JAX package.
    """
    faults, n = page_fault_counts(
        vpns, mem_frames, num_partitions=num_partitions,
        node_overhead_frames=node_overhead_frames,
        node_capacity_jitter=node_capacity_jitter, seed=seed, device=device)
    return np.array([int(f) / max(n, 1) for f in faults])
