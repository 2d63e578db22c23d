"""SPARTA core: partition hashing and translation-system configuration.

SPARTA (Split and PARtitioned Translation for Accelerators) divides address
translation between a (tiny or absent) accelerator-side TLB and per-partition
memory-side TLBs.  The single invariant the OS must maintain is::

    MEM_PARTITION_INDEX_HASH(vpn) == partition_of(pfn(vpn))

i.e. the virtual page number alone names the memory partition that holds the
page, while the page may live *anywhere inside* that partition.  Everything in
this package — the trace-driven TLB simulator, the CPI timeline model, the
demand-paging model, and the serving-side paged-KV manager — keys off the
functions and dataclasses in this module.

The port's copy of the JAX package's ``src/repro/core/sparta.py``; the hash
functions take torch tensors (or plain ints).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

PAGE_SHIFT_4K = 12
PAGE_SHIFT_2M = 21


def mem_partition_index_hash(vpn: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """The paper's MEM_PARTITION_INDEX_HASH(): a subset of VA bits (mod P).

    The paper (§4.2) allows any simple hash; the Linux prototype uses
    ``VPN mod P``.  We keep that exact function so the OS-side examples in
    §5 of the paper (shared-mapping phase adjustment) reproduce verbatim.
    """
    return vpn % num_partitions


def partition_local_vpn(vpn: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """The partition-local page identifier (the bits not consumed by the hash)."""
    return vpn // num_partitions


@dataclasses.dataclass(frozen=True)
class TLBConfig:
    """Geometry of one TLB (accelerator-side or one memory-side partition TLB)."""

    entries: int = 128
    ways: int = 4
    page_shift: int = PAGE_SHIFT_4K

    def __post_init__(self):
        if self.entries < 1 or self.ways < 1:
            raise ValueError(f"entries={self.entries}, ways={self.ways}: must be >= 1")
        # entries < ways is permitted: the structure degrades to fully-assoc of
        # size `entries` (see effective_ways).  Otherwise ways must tile entries.
        if self.entries > self.ways and self.entries % self.ways:
            raise ValueError(f"entries={self.entries} not divisible by ways={self.ways}")

    @property
    def sets(self) -> int:
        # Derive from the normalised associativity so entries < ways configs
        # report the (1-set, fully-assoc) geometry they actually simulate as.
        return max(1, self.entries // self.effective_ways)

    @property
    def effective_ways(self) -> int:
        # A config with fewer entries than ways degrades to fully-assoc of size
        # `entries`; normalise so sets >= 1 always holds.
        return min(self.ways, self.entries)


@dataclasses.dataclass(frozen=True)
class TranslationConfig:
    """A full translation system: SPARTA (P>1) or conventional (P==1).

    ``num_partitions == 1`` with ``shared=False`` models conventional
    per-accelerator TLBs; ``num_partitions >= 1`` with ``shared=True`` models
    SPARTA memory-side TLBs shared by all threads/accelerators.
    """

    num_partitions: int = 1
    tlb: TLBConfig = dataclasses.field(default_factory=TLBConfig)
    shared: bool = True  # memory-side TLBs are shared among all accelerators
    # Accelerator-side TLB (only meaningful with physical caches; None => none).
    accel_tlb: Optional[TLBConfig] = None

    @property
    def total_entries(self) -> int:
        n = self.num_partitions * self.tlb.entries
        if self.accel_tlb is not None:
            n += self.accel_tlb.entries
        return n


@dataclasses.dataclass(frozen=True)
class SystemLatencies:
    """Latency parameters (cycles @ accelerator clock) for the Fig 3 timelines.

    Defaults model the paper's 8-socket, 4-channels/socket, 128 GB machine at
    2 GHz: ~20 ns NoC traversal, ~110 ns average inter-socket traversal,
    ~60 ns DRAM access.  These are *assumptions* (the paper does not publish
    its table); see EXPERIMENTS.md for the calibration band check.
    """

    l_cache: float = 2.0        # accelerator cache hit
    l_tlb: float = 2.0          # TLB probe (accel- or memory-side)
    l_dram: float = 120.0       # one DRAM access (60 ns)
    l_noc: float = 40.0         # on-chip network one-way (20 ns)
    l_offchip: float = 400.0    # inter-socket traversal one-way (200 ns avg, multi-hop glueless 8-socket)
    n_sockets: int = 8

    @property
    def t_net(self) -> float:
        """Average one-way network latency from accelerator to a memory channel.

        Data is uniformly spread over sockets, so (1 - 1/n) of accesses pay the
        off-chip hop.  Larger machines => longer average traversals (paper §7.4).
        """
        remote_frac = 1.0 - 1.0 / self.n_sockets
        return self.l_noc + remote_frac * self.l_offchip


def conventional_timelines(lat: SystemLatencies):
    """(hit_total, miss_total, hit_overhead, miss_overhead) for conventional
    translation, accelerator without cache (Fig 3a/3b).

    Translation and data fetch are serialized; a page walk (perfect MMU
    caches => exactly one memory reference, the paper's conservative baseline)
    pays a full network round trip *before* the data fetch round trip.
    """
    data_path = 2 * lat.t_net + lat.l_dram
    hit_total = lat.l_tlb + data_path
    walk = 2 * lat.t_net + lat.l_dram
    miss_total = lat.l_tlb + walk + data_path
    return hit_total, miss_total, lat.l_tlb, lat.l_tlb + walk


def sparta_timelines(lat: SystemLatencies):
    """(hit_total, miss_total, hit_overhead, miss_overhead) for SPARTA
    (Fig 3c/3d).

    The network traversal to the partition is shared between translation and
    data paths; on a memory-side TLB miss the PTE is in the *same* partition,
    so the walk is one local DRAM access with no extra network traversals.
    """
    hit_total = 2 * lat.t_net + lat.l_tlb + lat.l_dram
    miss_total = 2 * lat.t_net + lat.l_tlb + lat.l_dram + lat.l_dram
    return hit_total, miss_total, lat.l_tlb, lat.l_tlb + lat.l_dram
