"""Batched multi-configuration sweep engine for the TLB/system simulator.

Every paper figure (Figs 4, 8, 9, 10) sweeps TLB geometries and partition
counts over the *same* trace.  This module simulates **B configurations in a
single pass**:

* geometries are padded to a common ``(max_total_sets, max_ways)`` envelope,
* per-config ``(tags, last)`` LRU state is stacked on a leading config axis
  (mirroring SPARTA's own per-partition-TLB-array state layout, paper §4.2),
* one kernel launch walks the trace for all of them.

Way-padding is made invisible by *poisoning* (see
:func:`repro_torch.core.tlbsim.padded_tlb_state`): the batched results are
**bit-identical** to the per-config simulators of
:mod:`repro_torch.core.tlbsim` and to the JAX package's sweeps.

``kernel_mode`` selects the backend: ``"cuda"`` (the hand-written kernels of
:mod:`repro_torch.kernels.tlb_sim` / :mod:`repro_torch.kernels.system_sim`),
``"reference"`` (their plain PyTorch versions), ``"stackdist"`` (TLB sweep
only: the exact stack-distance engine of :mod:`repro_torch.core.stackdist`,
whose scan runs as kernel K3 on the card and as its plain version on the
CPU), or ``"auto"``.  ``"auto"`` makes the JAX package's cold-start choice
(``src/repro/core/dispatch.py:131-158``): the TLB sweep takes
``"stackdist"`` when every spec has at most
:data:`repro_torch.core.stackdist.AUTO_MAX_WAYS` ways, and otherwise (and
for the joint system sweep always) ``"cuda"`` for data on the card and
``"reference"`` on the CPU.  The hit bits are the same in every mode.  The
joint system sweep refuses ``"stackdist"`` with ``ValueError`` as the JAX
package does (no stack-distance execution exists for cache-hit-conditional
probes), and so do the streams, which always simulate sequentially.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import stackdist
from repro_torch.core.sparta import TLBConfig
from repro_torch.core.tlbsim import (
    LINE_SHIFT,
    Device,
    SystemEvents,
    SystemSimConfig,
    TLBResult,
    _geom,
    _prepare_keys,
    as_tensor,
    padded_tlb_state,
    system_flags,
    system_geoms,
    system_keys,
)
from repro_torch.kernels.common import SWEEP_MODES, as_device, resolve_mode
from repro_torch.kernels.system_sim import (
    resolve_system_mode,
    system_sim_batched,
    system_sim_batched_carry,
)
from repro_torch.kernels.tlb_sim import tlb_sim_batched, tlb_sim_batched_carry

__all__ = [
    "TLBSweepSpec",
    "BatchedTLBResult",
    "BatchedSystemEvents",
    "TLBSweepStream",
    "SystemSweepStream",
    "envelope_chunks",
    "sweep_tlb",
    "sweep_system",
]


# ---------------------------------------------------------------------------
# State grouping.
# ---------------------------------------------------------------------------

# The streams split their batch into groups whose stacked state stays under
# this budget, with the JAX package's rule and number (its per-core VMEM
# budget, src/repro/core/sweep.py:160).  Keeping them makes the group layout
# and the stream state arrays (``g{gi}_tags``, ...) the reference's, so a
# stream state exported by the JAX package imports here directly.  The
# monolithic sweeps export no state and launch their whole batch at once.
# The CUDA kernels do not depend on the budget (they bucket any batch by
# (config, set) and keep one bucket's row in a thread's registers); the
# grouping stays because it fixes the exported state's layout.
_STATE_GROUP_BUDGET_BYTES = 8 * 1024 * 1024


def envelope_chunks(
    dims: Sequence[Tuple[int, ...]],
    state_elems,
    *,
    stream_words: int,
    budget_bytes: int,
) -> list:
    """Greedy batch chunker: partition item indices so each chunk's footprint
    — per-item state on the chunk's elementwise-max envelope
    (``state_elems(dims)`` 4-byte words) plus the streamed trace columns
    (``stream_words`` per item) — fits the budget.

    Sorting by padded footprint groups like-sized configurations, so a few
    huge items don't inflate the envelope of every small one.  A chunk always
    takes at least one item.
    """
    order = sorted(range(len(dims)), key=lambda i: state_elems(dims[i]))
    chunks, cur = [], []
    env: Tuple[int, ...] = ()
    for i in order:
        new_env = dims[i] if not cur else tuple(map(max, env, dims[i]))
        group_bytes = (state_elems(new_env) + stream_words) * (len(cur) + 1) * 4
        if cur and group_bytes > budget_bytes:
            chunks.append(cur)
            cur, new_env = [], dims[i]
        cur.append(i)
        env = new_env
    chunks.append(cur)
    return chunks


def _state_groups(geoms: Sequence[Tuple[int, int]], *, block: int = 512) -> list:
    """TLB-sweep grouping: stacked LRU state is 2 x (sets + 1) x ways int32 per
    config (+1 for the parked set row) and each config streams 3 x block
    words (set/tag/hit), as the reference counts them."""
    return envelope_chunks(
        geoms, lambda g: 2 * (g[0] + 1) * g[1],
        stream_words=3 * block, budget_bytes=_STATE_GROUP_BUDGET_BYTES)


def _system_state_groups(
    dims: Sequence[Tuple[int, int, int, int, int, int]], *, block: int = 512
) -> list:
    """Joint-system grouping: per config ``2 x ((cs+1)*cw + (as+1)*aw +
    (ms+1)*mw)`` int32 state words and 7 x block streamed words (six key
    views in, one packed hit word out), as the reference counts them."""
    return envelope_chunks(
        dims,
        lambda g: 2 * ((g[0] + 1) * g[1] + (g[2] + 1) * g[3] + (g[4] + 1) * g[5]),
        stream_words=7 * block, budget_bytes=_STATE_GROUP_BUDGET_BYTES)


def _envelope(geos, group) -> Tuple[int, int, Tuple[int, ...]]:
    """(max sets, max ways, per-config ways) of ``geos`` over ``group``."""
    return (max(geos[i][0] for i in group), max(geos[i][1] for i in group),
            tuple(geos[i][1] for i in group))


def _index(group, device: torch.device) -> torch.Tensor:
    return torch.tensor(group, dtype=torch.int64, device=device)


def _check_state(engine: str, arrays: dict, key: str, want: tuple,
                 device: torch.device) -> torch.Tensor:
    if key not in arrays:
        raise ValueError(f"{engine} state missing array {key!r}")
    arr = arrays[key]
    arr = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr))
    if tuple(arr.shape) != want:
        raise ValueError(f"{engine} state array {key!r} has shape "
                         f"{tuple(arr.shape)}, expected {want}")
    return arr.to(device=device, dtype=torch.int32).contiguous()


def _now_from(arrays: dict) -> int:
    now = arrays["now"]
    now = now if isinstance(now, torch.Tensor) else torch.from_numpy(np.asarray(now))
    return int(now.reshape(-1)[0])


# ---------------------------------------------------------------------------
# TLB sweep.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TLBSweepSpec:
    """One point of a TLB sweep: geometry + partitioning + page size.

    ``page_shift=None`` means the input stream is already a VPN stream;
    otherwise the input is a 64-byte line-address stream and VPNs are derived
    per spec (``lines >> (page_shift - LINE_SHIFT)``), so 4 KB and 2 MB
    configs can ride in one batch.
    """

    cfg: TLBConfig
    num_partitions: int = 1
    page_shift: Optional[int] = None

    @property
    def geometry(self) -> Tuple[int, int]:
        """(total_sets, ways) of the simulated structure."""
        sets, ways = _geom(self.cfg)
        return sets * self.num_partitions, ways


@dataclasses.dataclass(frozen=True)
class BatchedTLBResult:
    """Per-access hit bits for B configs sharing one trace."""

    hits: torch.Tensor   # bool [B, N] (full stream, incl. warmup), on its device
    n_warm: int

    def __len__(self) -> int:
        return self.hits.shape[0]

    def __getitem__(self, i: int) -> TLBResult:
        return TLBResult(hits=self.hits[i], n_warm=self.n_warm)

    @property
    def miss_ratios(self) -> np.ndarray:
        """Post-warmup miss ratio per config, float64 [B] (exact integer
        counts over the count, as the reference's numpy mean)."""
        w = self.hits[:, self.hits.shape[1] - self.n_warm:]
        if w.shape[1] == 0:
            return np.ones(self.hits.shape[0])
        return 1.0 - w.sum(1).cpu().numpy() / w.shape[1]


def _mapping_key(sp: TLBSweepSpec) -> Tuple[int, int, Optional[int]]:
    """The (set, tag) stream of a spec depends only on this triple."""
    sets, _ = _geom(sp.cfg)
    return sets, sp.num_partitions, sp.page_shift


def _keys_for_mapping(
    addrs: torch.Tensor, sets: int, num_partitions: int, page_shift: Optional[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(set, tag) streams for one set-mapping — the single address-to-key rule
    every sweep backend shares (bit-identity depends on it)."""
    vpns = addrs if page_shift is None else addrs >> (page_shift - LINE_SHIFT)
    return _prepare_keys(vpns, sets, num_partitions)


def _sweep_keys(
    addrs: torch.Tensor, specs: Sequence[TLBSweepSpec]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked int32 [B, N] (set, tag) streams, one row per spec; each
    distinct set-mapping is computed once."""
    keys = [_mapping_key(sp) for sp in specs]
    rows = {k: _keys_for_mapping(addrs, *k) for k in dict.fromkeys(keys)}
    return (torch.stack([rows[k][0] for k in keys]),
            torch.stack([rows[k][1] for k in keys]))


def _check_specs(specs: Sequence[TLBSweepSpec], what: str) -> None:
    if not specs:
        raise ValueError(f"{what} needs at least one spec")
    shifted = [sp.page_shift is not None for sp in specs]
    if any(shifted) and not all(shifted):
        raise ValueError(
            f"{what} batch mixes page_shift=None (VPN-stream) specs with "
            f"page_shift-set (line-stream) specs; one input stream cannot be both")


def _stackdist_eligible(specs: Sequence[TLBSweepSpec]) -> bool:
    """May ``"auto"`` take the exact stack-distance engine for this TLB sweep?
    Every spec is a pure-LRU TLB, so eligibility is the associativity staying
    within the capped-stack state (the JAX package's rule,
    ``src/repro/core/dispatch.py:131-140``)."""
    return max(sp.cfg.effective_ways for sp in specs) <= stackdist.AUTO_MAX_WAYS


def _tlb_mode(kernel_mode: str, specs: Sequence[TLBSweepSpec], device: Device) -> str:
    mode = resolve_mode(kernel_mode, device, valid=SWEEP_MODES)
    if kernel_mode == "auto" and _stackdist_eligible(specs):
        return "stackdist"
    return mode


def _sweep_tlb_stackdist(addrs: torch.Tensor, specs: Sequence[TLBSweepSpec]) -> torch.Tensor:
    """Hit bits [B, N] via one stack-depth pass per distinct set-mapping.

    Keys are prepared once per *mapping* (not per spec), every mapping's
    depth pass runs data-parallel, and each spec reads its hit bits off its
    bucket's depths at its own associativity.
    """
    keys = [_mapping_key(sp) for sp in specs]
    uniq = list(dict.fromkeys(keys))
    rows = [_keys_for_mapping(addrs, *k) for k in uniq]
    cap = max(sp.cfg.effective_ways for sp in specs)
    depth = stackdist.stack_depths_batched(
        torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows]), cap=cap)
    bucket = {k: i for i, k in enumerate(uniq)}
    return torch.stack([
        stackdist.hits_from_depths(depth[bucket[k]], sp.cfg.effective_ways)
        for k, sp in zip(keys, specs)
    ])


def sweep_tlb(
    addrs,
    specs: Sequence[TLBSweepSpec],
    *,
    warmup_frac: float = 0.25,
    kernel_mode: str = "auto",
    device: Device = "cuda",
) -> BatchedTLBResult:
    """Simulate every spec on one address stream in a single trace pass.

    ``addrs`` (numpy array or tensor) is a VPN stream for specs with
    ``page_shift=None`` and a line stream otherwise (mixing both in one batch
    is a caller error).  Results are bit-identical to calling
    :func:`repro_torch.core.tlbsim.simulate_tlb` once per spec.  The
    sequential modes launch the whole batch at once, padded to its
    envelope.
    """
    _check_specs(specs, "sweep_tlb")
    mode = _tlb_mode(kernel_mode, specs, device)
    addrs = as_tensor(addrs, device)
    if mode == "stackdist":
        hits = _sweep_tlb_stackdist(addrs, specs)
    else:
        set_b, tag_b = _sweep_keys(addrs, specs)
        sets, ways, valid = _envelope([sp.geometry for sp in specs], range(len(specs)))
        hits = tlb_sim_batched(set_b, tag_b, sets, ways, valid, kernel_mode=mode)
    n = hits.shape[1]
    n0 = int(n * warmup_frac)
    return BatchedTLBResult(hits=hits, n_warm=n - n0)


class TLBSweepStream:
    """Resumable chunked execution of :func:`sweep_tlb`.

    The stream owns the carried per-config LRU state on ``device``; each
    :meth:`run_chunk` call advances every config through one slice of the
    address stream and returns that slice's hit bits.  Feeding the chunks of
    a trace in order is **bit-identical** to one monolithic :func:`sweep_tlb`
    call, in either mode and across mode changes at chunk boundaries.  The
    batch is grouped as the reference groups it (``block`` only feeds that
    grouping) and every group's state keeps the reference's spare parked set
    row, so :meth:`export_state` / :meth:`import_state` exchange the same
    arrays as the JAX package's stream (see :mod:`repro_torch.convert`).
    """

    engine = "sweep_tlb"

    def __init__(self, specs: Sequence[TLBSweepSpec], *, block: int = 512,
                 device: Device = "cuda"):
        _check_specs(specs, "TLBSweepStream")
        self.specs = tuple(specs)
        self.block = int(block)
        self.device = as_device(device)
        self._geoms = [sp.geometry for sp in self.specs]
        self.groups = _state_groups(self._geoms, block=self.block)
        self._state = []
        for g in self.groups:
            sets, ways, valid = _envelope(self._geoms, g)
            self._state.append(
                padded_tlb_state(len(g), sets + 1, ways, valid, device=self.device))
        self.now = 0

    @property
    def batch_size(self) -> int:
        return len(self.specs)

    def fingerprint(self) -> dict:
        """JSON-able identity of the stream's layout: a state taken by one
        stream may only be imported by a stream with an equal one."""
        return {
            "engine": self.engine,
            "block": self.block,
            "specs": [[g[0], g[1], sp.num_partitions,
                       sp.page_shift if sp.page_shift is not None else -1]
                      for g, sp in zip(self._geoms, self.specs)],
        }

    def run_chunk(self, addrs, *, kernel_mode: str = "auto") -> torch.Tensor:
        """Advance every config through ``addrs`` (the next trace slice);
        returns hit bits bool [B, len(addrs)] on the stream's device.  State
        commits only after every group ran, so a failed call leaves the
        stream unchanged."""
        mode = resolve_mode(kernel_mode, self.device)
        set_b, tag_b = _sweep_keys(as_tensor(addrs, self.device), self.specs)
        n = set_b.shape[1]
        hits = torch.empty((len(self.specs), n), dtype=torch.bool, device=self.device)
        new_state = []
        for g, (tags, last) in zip(self.groups, self._state):
            ix = _index(g, self.device)
            h, tags, last = tlb_sim_batched_carry(
                set_b[ix], tag_b[ix], tags, last, self.now, kernel_mode=mode)
            hits[ix] = h
            new_state.append((tags, last))
        self._state = new_state
        self.now += n
        return hits

    def export_state(self) -> dict:
        """The carried state as numpy arrays, keyed as the reference keys them."""
        out = {"now": np.array([self.now], np.int64)}
        for gi, (tags, last) in enumerate(self._state):
            out[f"g{gi}_tags"] = tags.cpu().numpy()
            out[f"g{gi}_last"] = last.cpu().numpy()
        return out

    def import_state(self, arrays: dict) -> None:
        """Load a state from :meth:`export_state` (numpy arrays or tensors)."""
        state = []
        for gi, (tags, _) in enumerate(self._state):
            state.append(tuple(
                _check_state(self.engine, arrays, f"g{gi}_{part}",
                             tuple(tags.shape), self.device)
                for part in ("tags", "last")))
        self._state = state
        self.now = _now_from(arrays)


# ---------------------------------------------------------------------------
# Joint system sweep: cache + accel TLB + memory-side TLBs, B configs at once.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchedSystemEvents:
    """Stacked per-access hit bits for B system configs on one trace."""

    cache_hit: torch.Tensor      # bool [B, N]
    accel_tlb_hit: torch.Tensor  # bool [B, N]
    mem_tlb_hit: torch.Tensor    # bool [B, N]
    n_warm: int

    def __len__(self) -> int:
        return self.cache_hit.shape[0]

    def __getitem__(self, i: int) -> SystemEvents:
        return SystemEvents(
            cache_hit=self.cache_hit[i],
            accel_tlb_hit=self.accel_tlb_hit[i],
            mem_tlb_hit=self.mem_tlb_hit[i],
            n_warm=self.n_warm,
        )


def _system_layout(cfgs: Sequence[SystemSimConfig]):
    """Per-structure geometries (cache, accel, mem) and per-config dims."""
    geos = tuple(zip(*(system_geoms(c) for c in cfgs)))
    dims = [geos[0][i] + geos[1][i] + geos[2][i] for i in range(len(cfgs))]
    return geos, dims


def _system_streams(lines: torch.Tensor, cfgs: Sequence[SystemSimConfig]):
    """Six stacked int32 [B, N] key streams."""
    return [torch.stack(rows) for rows in zip(*(system_keys(lines, c) for c in cfgs))]


def sweep_system(
    lines,
    cfgs: Sequence[SystemSimConfig],
    *,
    warmup_frac: float = 0.25,
    kernel_mode: str = "auto",
    device: Device = "cuda",
) -> BatchedSystemEvents:
    """Run the joint cache + accel-TLB + memory-TLB pipeline for every config
    in ONE pass over the line trace.

    Configs may differ in every dimension (cache/accel presence, geometries,
    partitions, page size, probe policy); results are bit-identical to
    calling :func:`repro_torch.core.tlbsim.simulate_system` once per config.
    ``"stackdist"`` raises (no exact stack-distance execution exists for
    cache-hit-conditional probes).  The whole batch runs in one launch,
    padded to its envelope.
    """
    if not cfgs:
        raise ValueError("sweep_system needs at least one config")
    mode = resolve_system_mode(kernel_mode, device)
    lines = as_tensor(lines, device)
    streams = _system_streams(lines, cfgs)
    flags = system_flags(cfgs, lines.device)
    geos, _ = _system_layout(cfgs)
    envs = [_envelope(geo, range(len(cfgs))) for geo in geos]
    hits = system_sim_batched(
        *streams, flags, tuple(x for e in envs for x in e[:2]),
        tuple(e[2] for e in envs), kernel_mode=mode)
    n = lines.shape[0]
    n0 = int(n * warmup_frac)
    return BatchedSystemEvents(*hits, n_warm=n - n0)


class SystemSweepStream:
    """Resumable chunked execution of :func:`sweep_system`.

    Same contract as :class:`TLBSweepStream`, with three carried LRU
    structures per config (cache, accel TLB, partitioned mem TLB): feeding a
    line trace chunk by chunk is bit-identical to one monolithic
    :func:`sweep_system` call in either mode and across mode changes at chunk
    boundaries.  The grouping and the spare parked set row per structure are
    the reference's, so the exported state arrays are too.
    """

    engine = "sweep_system"
    _STRUCTS = ("c", "a", "m")

    def __init__(self, cfgs: Sequence[SystemSimConfig], *, block: int = 512,
                 device: Device = "cuda"):
        if not cfgs:
            raise ValueError("SystemSweepStream needs at least one config")
        self.cfgs = tuple(cfgs)
        self.block = int(block)
        self.device = as_device(device)
        self._geos, dims = _system_layout(self.cfgs)
        self.groups = _system_state_groups(dims, block=self.block)
        self._flags = system_flags(self.cfgs, self.device)
        self._state = []
        for g in self.groups:
            st = []
            for geo in self._geos:
                sets, ways, valid = _envelope(geo, g)
                st += padded_tlb_state(len(g), sets + 1, ways, valid, device=self.device)
            self._state.append(tuple(st))
        self.now = 0

    @property
    def batch_size(self) -> int:
        return len(self.cfgs)

    def fingerprint(self) -> dict:
        flags = self._flags.tolist()
        return {
            "engine": self.engine,
            "block": self.block,
            "cfgs": [[*self._geos[0][i], *self._geos[1][i], *self._geos[2][i],
                      *flags[i], c.num_partitions, c.page_shift]
                     for i, c in enumerate(self.cfgs)],
        }

    def run_chunk(self, lines, *, kernel_mode: str = "auto"):
        """Advance every config through ``lines`` (the next trace slice);
        returns (cache, accel_tlb, mem_tlb) hit bits, each bool
        [B, len(lines)] on the stream's device.  Commit-on-success like
        :class:`TLBSweepStream`."""
        mode = resolve_system_mode(kernel_mode, self.device)
        lines = as_tensor(lines, self.device)
        streams = _system_streams(lines, self.cfgs)
        n = lines.shape[0]
        hits = [torch.empty((len(self.cfgs), n), dtype=torch.bool, device=self.device)
                for _ in range(3)]
        new_state = []
        for g, st in zip(self.groups, self._state):
            ix = _index(g, self.device)
            ys, st = system_sim_batched_carry(
                *(s[ix] for s in streams), self._flags[ix], st, self.now,
                kernel_mode=mode)
            for h, y in zip(hits, ys):
                h[ix] = y
            new_state.append(st)
        self._state = new_state
        self.now += n
        return tuple(hits)

    def export_state(self) -> dict:
        """The carried state as numpy arrays, keyed as the reference keys them."""
        out = {"now": np.array([self.now], np.int64)}
        for gi, st in enumerate(self._state):
            for k, s in enumerate(self._STRUCTS):
                out[f"g{gi}_{s}_tags"] = st[2 * k].cpu().numpy()
                out[f"g{gi}_{s}_last"] = st[2 * k + 1].cpu().numpy()
        return out

    def import_state(self, arrays: dict) -> None:
        """Load a state from :meth:`export_state` (numpy arrays or tensors)."""
        state = []
        for gi, st in enumerate(self._state):
            state.append(tuple(
                _check_state(self.engine, arrays, f"g{gi}_{s}_{part}",
                             tuple(st[2 * k].shape), self.device)
                for k, s in enumerate(self._STRUCTS)
                for part in ("tags", "last")))
        self._state = state
        self.now = _now_from(arrays)
