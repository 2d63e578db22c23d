"""Trace-driven set-associative LRU TLB / cache simulation (paper §6.2).

The port of the JAX package's ``src/repro/core/tlbsim.py``:

* :func:`simulate_tlb` — one TLB (conventional) or an array of ``P``
  per-partition SPARTA TLBs.  SPARTA partitioning maps virtual page ``v`` to
  partition ``v % P`` and probes only that partition's sets — the paper's
  ``MEM_PARTITION_INDEX_HASH``.
* :func:`simulate_system` — the *joint* accelerator pipeline: data cache +
  accelerator-side TLB + memory-side (per-partition) TLB in a single pass,
  emitting per-access hit bits for each structure.  This feeds the CPI
  model (:mod:`repro_torch.core.cpi`) for Figs 9/10.

Both run on ``device`` (the card by default): on a CUDA device they go
through the hand-written kernels of :mod:`repro_torch.kernels.tlb_sim` and
:mod:`repro_torch.kernels.system_sim` with a batch of one, on the CPU
through those packages' plain PyTorch versions.  Hit tensors stay on the
device that computed them; every ratio is an exact ``int / int`` in Python,
so it equals the JAX package's float64 numpy mean to the last bit.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.sparta import TLBConfig
from repro_torch.kernels.common import as_device

LINE_SHIFT = 6

Device = Union[str, torch.device]


def as_tensor(x, device: Device) -> torch.Tensor:
    """An address stream (numpy array or tensor) as an int64 tensor on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=as_device(device), dtype=torch.int64)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(as_device(device))


# ---------------------------------------------------------------------------
# Key preparation — maps addresses to (set, tag) streams, on the data's device.
# ---------------------------------------------------------------------------

def _prepare_keys(
    vpns: torch.Tensor, sets: int, num_partitions: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compute per-access (global_set_index, tag) int32 streams for a
    (possibly partitioned) set-associative structure.

    Partition ``p = vpn % P`` (the paper's hash), partition-local key
    ``k = vpn // P``; global set index is ``p * sets + (k % sets)``.
    """
    v = vpns.to(torch.int64)
    if num_partitions > 1:
        p = v % num_partitions
        k = v // num_partitions
    else:
        p = torch.zeros_like(v)
        k = v
    set_idx = (p * sets + (k % sets)).to(torch.int32)
    # Store only the true tag (set bits excluded) so it fits int32; (set, tag)
    # uniquely identifies the key.
    tag64 = k // sets
    if tag64.numel() and int(tag64.max()) >= 2**31:
        raise ValueError("tag overflow: key space too large for int32 tags")
    return set_idx, tag64.to(torch.int32)


_POISON_TAG = -2          # never matches a real tag (tags are >= 0, empty = -1)
_POISON_LAST = 2**31 - 1  # argmin never selects a poisoned way (real last <= N)


def padded_tlb_state(
    num_cfgs: int, total_sets: int, ways: int, valid_ways: Tuple[int, ...],
    *, device: Device = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Initial stacked int32 (tags, last) [B, total_sets, ways] for a batch of
    configs padded to a common ``(total_sets, ways)`` envelope.

    Ways beyond config ``b``'s ``valid_ways[b]`` are *poisoned*: their tag can
    never match (real tags are non-negative, empty ways hold -1) and their
    last-use stamp is so large that LRU replacement never selects them, so the
    padded simulation is bit-identical to each config's unpadded one.  Padded
    *sets* need no poisoning — a config's set indices never reach them.
    """
    dev = as_device(device)
    vw = torch.as_tensor(valid_ways, dtype=torch.int32, device=dev).view(-1, 1, 1)
    way_ix = torch.arange(ways, dtype=torch.int32, device=dev).view(1, 1, -1)
    pad = (way_ix >= vw).expand(num_cfgs, total_sets, ways)
    tags0 = torch.where(pad, _POISON_TAG, -1).to(torch.int32)
    last0 = torch.where(pad, _POISON_LAST, 0).to(torch.int32)
    return tags0.contiguous(), last0.contiguous()


def _geom(cfg: Optional[TLBConfig]) -> Tuple[int, int]:
    """(sets, ways) of a structure; absent structures degrade to 1x1.

    The single source of geometry truth is :class:`TLBConfig` itself
    (``sets`` / ``effective_ways``); every simulator and sweep derives
    through here."""
    if cfg is None:
        return 1, 1
    return cfg.sets, cfg.effective_ways


def _ratio(count: torch.Tensor, n: int) -> float:
    """``count / n`` as Python float64 division of exact integers — the same
    bits as numpy's float64 mean of the bool stream."""
    return int(count) / int(n)


class TLBResult(NamedTuple):
    hits: torch.Tensor     # bool [N] (full stream, incl. warmup)
    n_warm: int            # accesses considered after warmup

    @classmethod
    def from_hits(cls, hits: torch.Tensor, warmup_frac: float) -> "TLBResult":
        n0 = int(hits.shape[0] * warmup_frac)
        return cls(hits=hits, n_warm=hits.shape[0] - n0)

    @property
    def miss_ratio(self) -> float:
        h = self.hits[self.hits.shape[0] - self.n_warm:]
        return 1.0 - _ratio(h.sum(), h.numel()) if h.numel() else 1.0

    @property
    def hit_ratio(self) -> float:
        return 1.0 - self.miss_ratio


def simulate_tlb(
    vpns,
    cfg: TLBConfig,
    *,
    num_partitions: int = 1,
    warmup_frac: float = 0.25,
    device: Device = "cuda",
) -> TLBResult:
    """Simulate one conventional TLB (``num_partitions == 1``) or SPARTA's
    array of per-partition TLBs (``num_partitions == P``) on a VPN stream.

    Each partition TLB has ``cfg.entries`` entries (the paper compares equal
    *per-TLB* sizes; total entries = P * entries for SPARTA).
    """
    from repro_torch.kernels.tlb_sim import tlb_sim

    sets, ways = _geom(cfg)
    set_idx, tag = _prepare_keys(as_tensor(vpns, device), sets, num_partitions)
    return TLBResult.from_hits(tlb_sim(set_idx, tag, sets * num_partitions, ways),
                               warmup_frac)


# ---------------------------------------------------------------------------
# Joint system simulation: cache + accel TLB + memory-side TLBs in one pass.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SystemSimConfig:
    """Joint pipeline configuration (Figs 9/10 setups).

    cache        — accelerator data cache geometry (keyed by line address);
                   ``None`` = cacheless accelerator.
    accel_tlb    — accelerator-side TLB; ``None`` = none (virtual cache /
                   pure SPARTA).  ``accel_probe_on_miss_only`` models virtual
                   caches (translation needed only for cache misses).
    mem_tlb      — memory-side TLB geometry (per partition).
    num_partitions — SPARTA P; 1 = conventional/centralised.
    page_shift   — 12 (4 KB) or 21 (2 MB) for both TLB levels.
    """

    cache: Optional[TLBConfig] = TLBConfig(entries=256, ways=4)  # 16KB / 64B
    accel_tlb: Optional[TLBConfig] = None
    mem_tlb: TLBConfig = TLBConfig(entries=128, ways=4)
    num_partitions: int = 1
    page_shift: int = 12
    accel_probe_on_miss_only: bool = True


class SystemEvents(NamedTuple):
    """Per-access hit bits (True = hit) for each structure, after warmup."""

    cache_hit: torch.Tensor
    accel_tlb_hit: torch.Tensor
    mem_tlb_hit: torch.Tensor
    n_warm: int

    def _rate(self, x: torch.Tensor) -> float:
        w = x[x.shape[0] - self.n_warm:]
        return _ratio(w.sum(), w.numel()) if w.numel() else 0.0

    def _given(self, x: torch.Tensor, cond: torch.Tensor) -> float:
        """Hit rate of ``x`` on the post-warmup accesses where ``cond``."""
        n0 = cond.shape[0] - self.n_warm
        c = cond[n0:]
        n = int(c.sum())
        if n == 0:
            return 1.0
        return _ratio((x[n0:] & c).sum(), n)

    @property
    def cache_hit_ratio(self) -> float:
        return self._rate(self.cache_hit)

    @property
    def accel_tlb_hit_ratio(self) -> float:
        return self._rate(self.accel_tlb_hit)

    def mem_tlb_hit_ratio_given_cache_miss(self) -> float:
        return self._given(self.mem_tlb_hit, ~self.cache_hit)

    def accel_tlb_hit_ratio_given_cache_hit(self) -> float:
        return self._given(self.accel_tlb_hit, self.cache_hit)

    def accel_tlb_hit_ratio_given_cache_miss(self) -> float:
        """Accel-TLB hit rate on the cache-miss stream (virtual caches probe
        the TLB only on misses; bits for cache hits are forced True)."""
        return self._given(self.accel_tlb_hit, ~self.cache_hit)


def system_keys(lines: torch.Tensor, cfg: SystemSimConfig):
    """Per-config (cache, accel, mem) (set, tag) int32 streams; an absent
    structure gets all-zero keys."""
    vpns = lines >> (cfg.page_shift - LINE_SHIFT)
    zeros = torch.zeros(lines.shape[0], dtype=torch.int32, device=lines.device)
    cs, _ = _geom(cfg.cache)
    c_set, c_tag = _prepare_keys(lines, cs, 1) if cfg.cache is not None else (zeros, zeros)
    asets, _ = _geom(cfg.accel_tlb)
    a_set, a_tag = _prepare_keys(vpns, asets, 1) if cfg.accel_tlb is not None else (zeros, zeros)
    ms, _ = _geom(cfg.mem_tlb)
    m_set, m_tag = _prepare_keys(vpns, ms, cfg.num_partitions)
    return c_set, c_tag, a_set, a_tag, m_set, m_tag


def system_flags(cfgs, device: Device) -> torch.Tensor:
    """int32 [B, 3] rows (has_cache, has_accel, accel_probe_on_miss_only)."""
    return torch.tensor(
        [[c.cache is not None, c.accel_tlb is not None, c.accel_probe_on_miss_only]
         for c in cfgs], dtype=torch.int32, device=as_device(device))


def system_geoms(cfg: SystemSimConfig) -> Tuple[Tuple[int, int], ...]:
    """((cache sets, ways), (accel sets, ways), (mem total sets, ways))."""
    ms, mw = _geom(cfg.mem_tlb)
    return _geom(cfg.cache), _geom(cfg.accel_tlb), (ms * cfg.num_partitions, mw)


def simulate_system(
    lines,
    cfg: SystemSimConfig,
    *,
    warmup_frac: float = 0.25,
    device: Device = "cuda",
) -> SystemEvents:
    """Run the joint cache + accel-TLB + memory-TLB pipeline on a line trace."""
    from repro_torch.kernels.system_sim import system_sim_batched

    lines = as_tensor(lines, device)
    keys = [k[None] for k in system_keys(lines, cfg)]
    geoms = system_geoms(cfg)
    geom = tuple(x for g in geoms for x in g)
    valid = tuple((g[1],) for g in geoms)
    c_hit, a_hit, m_hit = (
        y[0] for y in system_sim_batched(*keys, system_flags([cfg], lines.device),
                                         geom, valid))
    n0 = int(lines.shape[0] * warmup_frac)
    return SystemEvents(c_hit, a_hit, m_hit, n_warm=lines.shape[0] - n0)


# ---------------------------------------------------------------------------
# Convenience sweeps.
# ---------------------------------------------------------------------------

def miss_ratio(
    vpns,
    entries: int,
    *,
    ways: int = 4,
    num_partitions: int = 1,
    device: Device = "cuda",
) -> float:
    # TLBConfig normalizes entries < ways itself (effective_ways).
    return simulate_tlb(vpns, TLBConfig(entries=entries, ways=ways),
                        num_partitions=num_partitions, device=device).miss_ratio


def miss_ratio_curve(
    lines,
    sizes,
    *,
    ways: int = 4,
    num_partitions: int = 1,
    page_shift: int = 12,
    kernel_mode: str = "auto",
    device: Device = "cuda",
) -> np.ndarray:
    """Miss ratio at each TLB size, via the batched sweep engine
    (:func:`repro_torch.core.sweep.sweep_tlb`): the trace streams once for all
    sizes.  :func:`simulate_tlb` remains the single-config oracle path."""
    from repro_torch.core import sweep  # local import: sweep builds on this module

    specs = [
        sweep.TLBSweepSpec(
            cfg=TLBConfig(entries=int(e), ways=ways),
            num_partitions=num_partitions,
            page_shift=page_shift,
        )
        for e in sizes
    ]
    return sweep.sweep_tlb(lines, specs, kernel_mode=kernel_mode, device=device).miss_ratios
