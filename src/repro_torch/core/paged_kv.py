"""SPARTA-partitioned paged KV-cache management, the port's own copy of
``src/repro/core/paged_kv.py`` (host-side numpy bookkeeping, unchanged).

This is the paper's translation architecture transplanted to LLM serving:

* The KV cache is a *paged* memory: logical page ``l`` of a sequence is an
  index into a physical slot pool ("frames").  The logical->physical map is
  the page table; vLLM calls it the block table.
* SPARTA's invariant: ``partition(l) = l % P`` — a logical page number alone
  names the partition that owns it.  The page may live in *any* free slot of
  that partition's pool (demand allocation).
* Each partition keeps its OWN block table fragment, co-located with its
  pool — the per-partition TLB/page-table of the paper.
* Copy-on-write: ``fork`` shares pages by refcount (prefix sharing / beam
  search); writing a shared page copies it *within the same partition*
  (paper §5, CoW support).
* Demand paging: physical slots are allocated on first write.

The serving engine (:mod:`repro_torch.serve.engine`) collapses the
partitions onto one card's pool (slot = partition * S + local) and reads
:meth:`SpartaKVManager.global_block_table`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

FREE = -1


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    num_partitions: int = 16       # P — size of the mesh `model` axis
    slots_per_partition: int = 256  # physical pages per device pool
    page_size: int = 256            # tokens per KV page

    @property
    def total_slots(self) -> int:
        return self.num_partitions * self.slots_per_partition


def partition_of(logical_page: int, num_partitions: int) -> int:
    """MEM_PARTITION_INDEX_HASH for KV pages."""
    return logical_page % num_partitions


@dataclasses.dataclass
class _Seq:
    length: int = 0                       # tokens written
    pages: List[int] = dataclasses.field(default_factory=list)  # slot per logical page (local index)


class SpartaKVManager:
    """Host-side allocator enforcing the SPARTA partition invariant."""

    def __init__(self, cfg: PagedKVConfig):
        self.cfg = cfg
        P, S = cfg.num_partitions, cfg.slots_per_partition
        # Per-partition free lists (LIFO) and slot refcounts.
        self._free: List[List[int]] = [list(range(S - 1, -1, -1)) for _ in range(P)]
        self._refcount = np.zeros((P, S), dtype=np.int32)
        self._seqs: Dict[int, _Seq] = {}
        self._next_seq_id = 0

    # -- basic queries ------------------------------------------------------

    def num_free(self, partition: int) -> int:
        return len(self._free[partition])

    def seq_length(self, seq_id: int) -> int:
        return self._seqs[seq_id].length

    def seq_pages(self, seq_id: int) -> List[int]:
        return list(self._seqs[seq_id].pages)

    def refcount(self, logical_page_index: int, slot: int) -> int:
        p = partition_of(logical_page_index, self.cfg.num_partitions)
        return int(self._refcount[p, slot])

    # -- allocation ---------------------------------------------------------

    def new_sequence(self) -> int:
        sid = self._next_seq_id
        self._next_seq_id += 1
        self._seqs[sid] = _Seq()
        return sid

    def _alloc_slot(self, partition: int) -> int:
        """Demand allocation: any free slot in the (hash-determined) partition."""
        if not self._free[partition]:
            raise MemoryError(f"KV partition {partition} exhausted")
        slot = self._free[partition].pop()
        assert self._refcount[partition, slot] == 0
        self._refcount[partition, slot] = 1
        return slot

    def _release_slot(self, partition: int, slot: int) -> None:
        self._refcount[partition, slot] -= 1
        assert self._refcount[partition, slot] >= 0
        if self._refcount[partition, slot] == 0:
            self._free[partition].append(slot)

    def append_tokens(self, seq_id: int, n_tokens: int) -> List[dict]:
        """Extend a sequence by ``n_tokens``; returns allocation events:
        {kind: "alloc"|"cow", lp, slot[, old_slot]}.  Triggers CoW if the
        current tail page is shared (a write to a read-only shared page,
        paper §5) — the engine copies the page data old->new slot."""
        seq = self._seqs[seq_id]
        P = self.cfg.num_partitions
        page_size = self.cfg.page_size
        written: List[dict] = []

        # Writing into the tail page of a forked sequence => copy-on-write.
        if seq.length % page_size != 0 and seq.pages:
            lp = len(seq.pages) - 1
            part = partition_of(lp, P)
            slot = seq.pages[lp]
            if self._refcount[part, slot] > 1:
                new_slot = self._alloc_slot(part)  # CoW copy stays in-partition
                self._release_slot(part, slot)
                seq.pages[lp] = new_slot
                written.append({"kind": "cow", "lp": lp, "slot": new_slot,
                                "old_slot": slot, "partition": part})

        new_len = seq.length + n_tokens
        needed_pages = -(-new_len // page_size)
        while len(seq.pages) < needed_pages:
            lp = len(seq.pages)
            part = partition_of(lp, P)
            slot = self._alloc_slot(part)
            seq.pages.append(slot)
            written.append({"kind": "alloc", "lp": lp, "slot": slot, "partition": part})
        seq.length = new_len
        return written

    # -- sharing / CoW ------------------------------------------------------

    def fork(self, parent_id: int) -> int:
        """Share all pages of ``parent`` with a new child (refcount bump).

        Every page keeps its partition (the hash depends only on the logical
        page number, which the child inherits) — the paper's shared-pages
        case needs no placement adjustment for KV because logical numbering
        is per-sequence and preserved by fork.
        """
        parent = self._seqs[parent_id]
        child_id = self.new_sequence()
        child = self._seqs[child_id]
        child.length = parent.length
        child.pages = list(parent.pages)
        for lp, slot in enumerate(parent.pages):
            self._refcount[partition_of(lp, self.cfg.num_partitions), slot] += 1
        return child_id

    def free_sequence(self, seq_id: int) -> None:
        seq = self._seqs.pop(seq_id)
        for lp, slot in enumerate(seq.pages):
            self._release_slot(partition_of(lp, self.cfg.num_partitions), slot)

    # -- device views -------------------------------------------------------

    def local_block_tables(
        self, seq_ids: List[int], max_pages: int
    ) -> np.ndarray:
        """Per-partition local block tables: int32 [P, B, ceil(max_pages/P)].

        Entry [p, b, j] is the local slot of logical page ``j*P + p`` of
        sequence b (FREE if past the end).  Each device receives ONLY its own
        [b, pages_local] fragment — the co-located page table.
        """
        P = self.cfg.num_partitions
        pages_local = -(-max_pages // P)
        out = np.full((P, len(seq_ids), pages_local), FREE, dtype=np.int32)
        for b, sid in enumerate(seq_ids):
            for lp, slot in enumerate(self._seqs[sid].pages):
                if lp >= max_pages:
                    break
                out[lp % P, b, lp // P] = slot
        return out

    def global_block_table(self, seq_ids: List[int], max_pages: int) -> np.ndarray:
        """The *baseline* (centralised-IOMMU analogue): one replicated table
        int32 [B, max_pages] of global slot ids = partition*S + local."""
        S = self.cfg.slots_per_partition
        out = np.full((len(seq_ids), max_pages), FREE, dtype=np.int32)
        for b, sid in enumerate(seq_ids):
            for lp, slot in enumerate(self._seqs[sid].pages):
                if lp >= max_pages:
                    break
                out[b, lp] = partition_of(lp, self.cfg.num_partitions) * S + slot
        return out

    def context_lengths(self, seq_ids: List[int]) -> np.ndarray:
        return np.array([self._seqs[s].length for s in seq_ids], dtype=np.int32)

    # -- invariants (exercised by hypothesis tests) --------------------------

    def check_invariants(self) -> None:
        P, S = self.cfg.num_partitions, self.cfg.slots_per_partition
        # 1. Free lists and refcounts are consistent; no double-free/alloc.
        for p in range(P):
            free = set(self._free[p])
            assert len(free) == len(self._free[p]), "duplicate slot in free list"
            for s in range(S):
                if s in free:
                    assert self._refcount[p, s] == 0
                else:
                    assert self._refcount[p, s] >= 1, f"leaked slot ({p},{s})"
        # 2. Partition invariant + refcount totals match live references.
        counts = np.zeros((P, S), dtype=np.int32)
        for seq in self._seqs.values():
            assert len(seq.pages) == -(-seq.length // self.cfg.page_size) or seq.length == 0
            for lp, slot in enumerate(seq.pages):
                part = partition_of(lp, P)
                assert 0 <= slot < S
                counts[part, slot] += 1
        assert (counts == self._refcount).all(), "refcount drift"
