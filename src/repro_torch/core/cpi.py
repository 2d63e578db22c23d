"""Analytical CPI / timeline performance model (paper §6.3, Figs 3, 9, 10).

The paper models accelerators as simple in-order cores and composes per-access
latency from the Fig 3 timelines using measured hit rates.  This module takes
:class:`repro_torch.core.tlbsim.SystemEvents` (cache / accelerator-TLB /
memory-side-TLB hit rates from the joint trace simulation) plus
:class:`repro_torch.core.sparta.SystemLatencies` and produces:

* average cycles per memory access,
* *translation overhead* cycles per access (the quantity SPARTA reduces
  by 31.5x on average, up to 47x — claim C6),
* end-to-end speedup over the conventional 4 KB baseline (Fig 10),

for the four designs: ``conventional``, ``sparta``, ``dipta`` and ``ideal``.

Timeline composition (virtual-cache accelerator, the Fig 10 setup):

conventional  cache miss => probe accel TLB; on TLB miss walk the page table
              (1 memory reference — perfect MMU caches, the paper's
              conservative baseline) over the network *before* the data
              fetch round trip can begin.
sparta        cache miss => route by partition hash; translation runs at the
              partition overlapped with the row fetch.  Exposed overhead is
              only the memory-side TLB probe, plus one *local* DRAM access
              for the PTE on a memory-side TLB miss.
dipta         set-associative VM with way prediction: correct prediction
              fully overlaps; a misprediction pays an extra serialized DRAM
              access (paper §7.7).
ideal         zero translation overhead.

Every ``AccessTimes`` here is the exact mean of a per-access composition, so
the cycle-approximate timeline engine (:mod:`repro_torch.core.timeline`)
degrades to this module when its queueing is disabled; use the timeline
engine for latency *distributions* and contention in time.

The port's copy of the JAX package's ``src/repro/core/cpi.py``: pure Python
over :class:`~repro_torch.core.tlbsim.SystemEvents`, whose ratios equal the
reference's to the last bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.sparta import SystemLatencies
from repro_torch.core.tlbsim import SystemEvents

# Way-prediction accuracy for DIPTA (paper §7.7: >90% for Hash Table, lower
# elsewhere; exact per-workload numbers are not published — assumption logged
# in EXPERIMENTS.md).
DIPTA_WAY_PREDICTION_ACCURACY: Dict[str, float] = {
    "hash_table": 0.92,   # paper: >90% for Hash Table
    "bst_internal": 0.55,  # pointer chases defeat address-locality way predictors
    "bst_external": 0.55,
    "skip_list": 0.45,     # worst spatial locality of the suite
    "rocksdb": 0.70,
    "multiprog": 0.50,     # paper: needs 16 ways to avoid faults
}


@dataclasses.dataclass(frozen=True)
class AccessTimes:
    """Average per-memory-access timing decomposition (cycles)."""

    total: float              # cache probe + fetch + translation overhead
    translation_overhead: float
    fetch: float              # translation-free component

    @property
    def overhead_fraction(self) -> float:
        return self.translation_overhead / max(self.total, 1e-12)


def _fetch_time(ev: SystemEvents, lat: SystemLatencies) -> float:
    """Translation-free access time: cache probe + miss => full data path."""
    h_c = ev.cache_hit_ratio
    data_path = 2.0 * lat.t_net + lat.l_dram
    return lat.l_cache + (1.0 - h_c) * data_path


def conventional_access(ev: SystemEvents, lat: SystemLatencies) -> AccessTimes:
    """Virtual cache + accelerator TLB + (perfect-MMU-cache) page walks."""
    h_c = ev.cache_hit_ratio
    # Accel TLB is probed only on cache misses in the virtual-cache baseline,
    # so the walk term must be conditioned on the cache-miss stream:
    # (1-h_c) * (1-h_t|miss) == P(cache miss AND TLB miss), which makes this
    # average exactly the mean of the per-access Fig 3 composition (the
    # timeline engine reproduces it access by access — tests/test_timeline.py).
    h_t = ev.accel_tlb_hit_ratio_given_cache_miss()
    walk = 2.0 * lat.t_net + lat.l_dram  # one memory reference, over the network
    overhead = (1.0 - h_c) * (lat.l_tlb + (1.0 - h_t) * walk)
    fetch = _fetch_time(ev, lat)
    return AccessTimes(total=fetch + overhead, translation_overhead=overhead, fetch=fetch)


def sparta_access(
    ev: SystemEvents,
    lat: SystemLatencies,
    *,
    physical_cache: bool = False,
) -> AccessTimes:
    """SPARTA: memory-side translation overlapped with the data fetch.

    Virtual cache (default): no accelerator-side translation hardware at all.
    Physical cache: a tiny accel-side TLB must cover cache *hits*; an accel
    TLB miss on a cache hit stalls for a memory-side PTE fetch (Fig 9).
    """
    h_c = ev.cache_hit_ratio
    h_m = ev.mem_tlb_hit_ratio_given_cache_miss()
    fetch = _fetch_time(ev, lat)
    # Exposed overhead on a cache miss: mem-TLB probe + local PTE read on miss.
    miss_side = (1.0 - h_c) * (lat.l_tlb + (1.0 - h_m) * lat.l_dram)
    if not physical_cache:
        return AccessTimes(total=fetch + miss_side, translation_overhead=miss_side, fetch=fetch)
    # Physical cache: every access probes the tiny accel TLB (l_tlb).  A cache
    # hit whose translation is absent must fetch the PTE from the memory side
    # (full network round trip + mem TLB probe / local walk).  Conditioning on
    # the cache-hit stream keeps h_c * (1-h_a|hit) == P(cache hit AND TLB miss).
    h_a = ev.accel_tlb_hit_ratio_given_cache_hit()
    pte_fetch = 2.0 * lat.t_net + lat.l_tlb + (1.0 - h_m) * lat.l_dram
    overhead = lat.l_tlb + h_c * (1.0 - h_a) * pte_fetch + miss_side
    return AccessTimes(total=fetch + overhead, translation_overhead=overhead, fetch=fetch)


def dipta_access(ev: SystemEvents, lat: SystemLatencies, way_accuracy: float) -> AccessTimes:
    """Idealised DRAM-based DIPTA (no DRAM capacity overhead, §7.7)."""
    h_c = ev.cache_hit_ratio
    # A way misprediction wastes the speculative way read and serialises a
    # second DRAM access (correct way after the page-table check): ~2x tRC.
    overhead = (1.0 - h_c) * (1.0 - way_accuracy) * 2.0 * lat.l_dram
    fetch = _fetch_time(ev, lat)
    return AccessTimes(total=fetch + overhead, translation_overhead=overhead, fetch=fetch)


def ideal_access(ev: SystemEvents, lat: SystemLatencies) -> AccessTimes:
    fetch = _fetch_time(ev, lat)
    return AccessTimes(total=fetch, translation_overhead=0.0, fetch=fetch)


@dataclasses.dataclass(frozen=True)
class PerfResult:
    """Per-(workload, design) performance summary."""

    cycles_per_instr: float
    access: AccessTimes

    def speedup_over(self, base: "PerfResult") -> float:
        return base.cycles_per_instr / self.cycles_per_instr


def cycles_per_instruction(
    access: AccessTimes,
    *,
    instr_per_access: float,
    base_cpi: float = 1.0,
) -> PerfResult:
    """In-order accelerator CPI: execution + amortised memory time."""
    f_mem = 1.0 / max(instr_per_access, 1e-9)
    return PerfResult(
        cycles_per_instr=base_cpi + f_mem * access.total,
        access=access,
    )


def evaluate_design(
    design: str,
    ev: SystemEvents,
    lat: SystemLatencies,
    *,
    instr_per_access: float,
    workload: str = "",
    physical_cache: bool = False,
) -> PerfResult:
    if design == "conventional":
        acc = conventional_access(ev, lat)
    elif design == "sparta":
        acc = sparta_access(ev, lat, physical_cache=physical_cache)
    elif design == "dipta":
        acc = dipta_access(ev, lat, DIPTA_WAY_PREDICTION_ACCURACY.get(workload, 0.75))
    elif design == "ideal":
        acc = ideal_access(ev, lat)
    else:
        raise ValueError(f"unknown design {design!r}")
    return cycles_per_instruction(acc, instr_per_access=instr_per_access)
