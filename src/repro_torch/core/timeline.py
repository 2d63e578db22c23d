"""Cycle-approximate event-timeline engine (per-access latency + queueing).

The port of the JAX package's ``src/repro/core/timeline.py``.
:mod:`repro_torch.core.cpi` turns measured hit *rates* into average
per-access latency; it cannot express queueing contention on shared
memory-side TLBs or latency *distributions*, exactly the effects SPARTA's
partitioning is designed to remove.  This module composes a **per-access
completion time** from the per-access hit/miss bits of
:func:`repro_torch.core.sweep.sweep_system`, threading three bounded
resources through the Fig 3 timelines:

* an MSHR-style window of outstanding misses per accelerator,
* per-partition memory-side TLB service ports with FIFO queueing (SPARTA),
* banked DRAM service slots (page walks, PTE reads and data fetches all
  occupy a bank).

Outputs are per-access latency/overhead arrays reduced to total cycles,
throughput and p50/p95/p99 tails for the four designs
(``conventional`` / ``sparta`` / ``dipta`` / ``ideal``).  With every resource
unbounded (:meth:`TimelineConfig.unbounded`) all queue waits vanish and the
post-warmup mean latency / translation overhead reproduce
:mod:`repro_torch.core.cpi`'s analytical averages.

The per-access inputs are prepared on the host with numpy, exactly as the
reference prepares them (the PTE bank hash multiplies in uint64, which torch
lacks), and move to the device once; the sequential loop runs as CUDA kernel
K4 on the card and as its plain PyTorch version on the CPU
(:mod:`repro_torch.kernels.timeline`).  The reductions are numpy float64 on
host copies, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import sweep
from repro_torch.core.cpi import DIPTA_WAY_PREDICTION_ACCURACY
from repro_torch.core.sparta import SystemLatencies
from repro_torch.core.tlbsim import LINE_SHIFT, Device, SystemEvents
from repro_torch.kernels.common import as_device
from repro_torch.kernels.timeline import (
    TimelineParams,
    envelope_of,
    pack_params,
    timeline_init_state_batched,
    timeline_sim,
    timeline_sim_batched,
    timeline_sim_batched_carry,
)
from repro_torch.kernels.timeline.ref import STATE_NAMES

__all__ = ["TimelineConfig", "TimelineResult", "TimelineSpec",
           "TimelineSweepStream", "simulate_timeline", "sweep_timeline",
           "round_robin_accel_ids", "DESIGNS"]

DESIGNS = ("conventional", "sparta", "dipta", "ideal")


@dataclasses.dataclass(frozen=True)
class TimelineConfig:
    """Queueing-resource configuration.

    A count of 0 means the resource is *unbounded* — no queueing on it.
    ``mshrs`` bounds outstanding misses per accelerator, ``tlb_ports`` is the
    number of service ports of each partition's memory-side TLB, and
    ``dram_banks`` the machine-wide number of DRAM banks.  ``tlb_service`` /
    ``dram_service`` are the port/bank *occupancy* times per request and
    default to the corresponding probe/access latencies (``l_tlb`` /
    ``l_dram``); ``issue_interval`` is the cycles between successive issue
    attempts of one accelerator (offered-load knob).
    """

    mshrs: int = 8
    tlb_ports: int = 1
    dram_banks: int = 16
    tlb_service: Optional[float] = None
    dram_service: Optional[float] = None
    issue_interval: float = 1.0

    @classmethod
    def unbounded(cls, **kw) -> "TimelineConfig":
        """No queueing anywhere — the cpi-consistency configuration."""
        return cls(mshrs=0, tlb_ports=0, dram_banks=0, **kw)


@dataclasses.dataclass(frozen=True)
class TimelineResult:
    """Per-access timing arrays (host numpy) + reductions (post-warmup like
    SystemEvents), computed in float64 exactly as the reference does."""

    latency: np.ndarray    # f32 [N] issue -> completion cycles
    overhead: np.ndarray   # f32 [N] translation-induced component (incl. waits)
    done: np.ndarray       # f32 [N] absolute completion times
    cache_hit: np.ndarray  # bool [N]
    n_warm: int

    def _warm(self, x: np.ndarray) -> np.ndarray:
        return x[x.shape[0] - self.n_warm:]

    @property
    def mean_latency(self) -> float:
        w = self._warm(self.latency)
        return float(w.mean(dtype=np.float64)) if w.size else 0.0

    @property
    def mean_overhead(self) -> float:
        w = self._warm(self.overhead)
        return float(w.mean(dtype=np.float64)) if w.size else 0.0

    def latency_percentile(self, q: float) -> float:
        w = self._warm(self.latency)
        return float(np.percentile(w, q)) if w.size else 0.0

    def overhead_percentile(self, q: float, *, misses_only: bool = True) -> float:
        """Tail of the translation-induced latency.  ``misses_only`` restricts
        to cache-missing accesses (the translated stream): with high cache
        hit rates an all-access p99 would be identically zero for every
        design and say nothing about translation."""
        w = self._warm(self.overhead)
        if misses_only:
            w = w[~self._warm(self.cache_hit)]
        return float(np.percentile(w, q)) if w.size else 0.0

    @property
    def total_cycles(self) -> float:
        """Makespan: first issue happens at t=0."""
        return float(self.done.max()) if self.done.size else 0.0

    @property
    def throughput(self) -> float:
        """Accesses completed per cycle over the whole stream."""
        return self.done.shape[0] / max(self.total_cycles, 1e-9)

    def summary(self) -> Dict[str, float]:
        return {
            "mean_latency": self.mean_latency,
            "mean_overhead": self.mean_overhead,
            "p50_latency": self.latency_percentile(50),
            "p95_latency": self.latency_percentile(95),
            "p99_latency": self.latency_percentile(99),
            "p99_overhead": self.overhead_percentile(99),
            "total_cycles": self.total_cycles,
            "throughput": self.throughput,
        }


def round_robin_accel_ids(n: int, num_accels: int, granularity: int = 1) -> np.ndarray:
    """Issuing-accelerator ids for a :func:`repro_torch.core.traces.interleave`'d
    trace (round-robin at ``granularity`` accesses per turn)."""
    return ((np.arange(n) // granularity) % num_accels).astype(np.int32)


def _pte_banks(vpns: np.ndarray, banks: int) -> np.ndarray:
    """DRAM bank of each page's PTE: a cheap stateless scatter of the VPN so
    walk/PTE traffic spreads over banks independently of the data lines
    (uint64 arithmetic, on the host)."""
    v = vpns.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    return ((v >> np.uint64(17)) % np.uint64(banks)).astype(np.int32)


def _host(x) -> np.ndarray:
    """A numpy array or tensor (any device) as a host numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _timeline_inputs(
    lines,
    events: SystemEvents,
    design: str,
    lat: SystemLatencies,
    cfg: TimelineConfig,
    num_partitions: int,
    page_shift: int,
    num_accelerators: int,
    accel_ids: Optional[np.ndarray],
    workload: str,
    way_accuracy: Optional[float],
) -> Tuple[Tuple[np.ndarray, ...], TimelineParams]:
    """The single address/event-to-input rule every timeline backend shares:
    per-access id/hit/pen numpy columns plus the static
    :class:`TimelineParams` of one simulation."""
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}; options: {DESIGNS}")
    lines = _host(lines)
    n = int(lines.shape[0])
    if accel_ids is None:
        accel_ids = round_robin_accel_ids(n, num_accelerators)
    vpns = lines >> (page_shift - LINE_SHIFT)

    P = num_partitions if design == "sparta" else 1
    part = (vpns % P).astype(np.int32)
    banks = max(cfg.dram_banks, 1)
    bank_d = (lines % banks).astype(np.int32)
    bank_p = _pte_banks(vpns, banks)

    c = _host(events.cache_hit).astype(np.int32)
    th = _host(events.accel_tlb_hit).astype(np.int32)
    mh = _host(events.mem_tlb_hit).astype(np.int32)

    pen = np.zeros(n, np.float32)
    if design == "dipta":
        acc = way_accuracy if way_accuracy is not None else \
            DIPTA_WAY_PREDICTION_ACCURACY.get(workload, 0.75)
        pen[:] = (1.0 - acc) * 2.0 * lat.l_dram

    params = TimelineParams(
        serial_walk=(design == "conventional"),
        mem_tlb=(design == "sparta"),
        num_accels=int(num_accelerators),
        mshrs=int(cfg.mshrs),
        num_partitions=int(P),
        tlb_ports=int(cfg.tlb_ports),
        dram_banks=int(cfg.dram_banks),
        l_cache=float(lat.l_cache),
        l_tlb=float(lat.l_tlb),
        l_dram=float(lat.l_dram),
        t_net=float(lat.t_net),
        tlb_occ=float(cfg.tlb_service if cfg.tlb_service is not None else lat.l_tlb),
        dram_occ=float(cfg.dram_service if cfg.dram_service is not None else lat.l_dram),
        issue_interval=float(cfg.issue_interval),
    )
    return (np.asarray(accel_ids).astype(np.int32), part, bank_d, bank_p, c, th, mh,
            pen), params


def _result(latency, overhead, done, events: SystemEvents) -> TimelineResult:
    return TimelineResult(latency=latency, overhead=overhead, done=done,
                          cache_hit=_host(events.cache_hit).astype(bool),
                          n_warm=events.n_warm)


def simulate_timeline(
    lines,
    events: SystemEvents,
    design: str,
    lat: SystemLatencies,
    *,
    cfg: TimelineConfig = TimelineConfig(),
    num_partitions: int = 1,
    page_shift: int = 12,
    num_accelerators: int = 1,
    accel_ids: Optional[np.ndarray] = None,
    workload: str = "",
    way_accuracy: Optional[float] = None,
    kernel_mode: str = "auto",
    device: Device = "cuda",
) -> TimelineResult:
    """Per-access completion times for one (design, trace, events) triple.

    ``events`` must come from the simulation of the *same* trace (``lines``)
    with the matching geometry/partitioning (``simulate_system`` or a
    ``sweep_system`` row).  ``num_accelerators`` > 1 models N accelerators
    sharing the memory-side structures: the trace is their interleaved
    stream (``traces.thread_traces`` + ``interleave``) and ``accel_ids``
    names the issuer of each access (round-robin by default).  For a sweep
    of many cells use :func:`sweep_timeline`, bit-identical per cell.
    """
    dev = as_device(device)
    inputs, params = _timeline_inputs(
        lines, events, design, lat, cfg, num_partitions, page_shift,
        num_accelerators, accel_ids, workload, way_accuracy)
    ys = timeline_sim(*(torch.from_numpy(x).to(dev) for x in inputs), params,
                      kernel_mode=kernel_mode)
    return _result(*(_host(y) for y in ys), events)


# ---------------------------------------------------------------------------
# Batched multi-simulation sweep: all (design x workload x accel-count) cells
# advance per trace element in ONE pass.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class TimelineSpec:
    """One cell of a timeline sweep: (trace, events, design, queue config,
    accelerator count) plus the per-design knobs of
    :func:`simulate_timeline`.

    ``events`` must come from the simulation of the *same* ``lines`` trace
    with the matching geometry/partitioning (a ``sweep_system`` row — one
    batched system pass can feed many specs).  ``lat=None`` falls back to the
    ``lat`` argument of :func:`sweep_timeline`, so a shared latency table is
    stated once per sweep.
    """

    lines: np.ndarray
    events: SystemEvents
    design: str
    lat: Optional[SystemLatencies] = None
    cfg: TimelineConfig = TimelineConfig()
    num_partitions: int = 1
    page_shift: int = 12
    num_accelerators: int = 1
    accel_ids: Optional[np.ndarray] = None
    workload: str = ""
    way_accuracy: Optional[float] = None


# The stream splits its sims into groups as the reference does (its 8 MB
# per-core scratch rule, under the port's name from repro_torch.core.sweep),
# so its exported state arrays (``g{gi}_acc_next``, ...) are the reference's.
# The monolithic sweep launches its whole batch at once.
_STATE_GROUP_BUDGET_BYTES = sweep._STATE_GROUP_BUDGET_BYTES


def _timeline_state_groups(
    dims: Sequence[Tuple[int, int, int, int, int]], *, block: int = 512
) -> List[List[int]]:
    """The reference's grouping (``_timeline_vmem_chunks``): the stacked
    queueing state on a group's (A, M, P, T, D) envelope is A + A*M + A +
    P*T + D words per sim and each sim streams 11 x block words (8 input +
    3 output per-access columns)."""
    def state_elems(d):
        A, M, P, T, D = d
        return A + A * M + A + P * T + D

    return sweep.envelope_chunks(
        dims, state_elems,
        stream_words=11 * block, budget_bytes=_STATE_GROUP_BUDGET_BYTES)


# Trailing trace padding shared by sweep_timeline and TimelineSweepStream:
# zero-latency cache hits from accelerator 0 (read state, complete locally,
# outputs dropped).
_PAD_VALS = (0, 0, 0, 0, 1, 1, 1, np.float32(0.0))


def _prepare(specs: Sequence[TimelineSpec], lat: Optional[SystemLatencies], what: str):
    """Every spec's input columns, stacked [B, n_max] with trailing
    ``_PAD_VALS`` padding (numpy, host), the packed parameter rows and the
    per-spec lengths."""
    if not specs:
        raise ValueError(f"{what} needs at least one spec")
    prepared = []
    for sp in specs:
        sp_lat = sp.lat if sp.lat is not None else lat
        if sp_lat is None:
            raise ValueError(f"{what}: spec has lat=None and no lat argument given")
        prepared.append(_timeline_inputs(
            sp.lines, sp.events, sp.design, sp_lat, sp.cfg, sp.num_partitions,
            sp.page_shift, sp.num_accelerators, sp.accel_ids, sp.workload,
            sp.way_accuracy))
    lens = [int(p[0][0].shape[0]) for p in prepared]
    n_max = max(lens)
    packed = [pack_params(params) for _, params in prepared]
    fparams = np.stack([fp for fp, _ in packed])
    iparams = np.stack([ip for _, ip in packed])
    stacked = [np.empty((len(specs), n_max), x.dtype) for x in prepared[0][0]]
    for i, ((inputs, _), n) in enumerate(zip(prepared, lens)):
        for s, x, v in zip(stacked, inputs, _PAD_VALS):
            s[i, :n] = x
            s[i, n:] = v
    return stacked, fparams, iparams, lens


def sweep_timeline(
    specs: Sequence[TimelineSpec],
    lat: Optional[SystemLatencies] = None,
    *,
    kernel_mode: str = "auto",
    device: Device = "cuda",
) -> List[TimelineResult]:
    """Simulate every spec's timeline in a single pass over the trace axis.

    Specs are padded to a common resource envelope (accelerators, MSHRs,
    partitions, TLB ports, DRAM banks, trace length), their queueing states
    stacked on a leading sim axis, and all sims advanced per trace element
    in one launch.  Padding is poisoned so it is unobservable: trailing trace
    padding is zero-latency cache hits from accelerator 0 and padded resource
    slots are never selected.  Per-spec results are **bit-identical** to
    :func:`simulate_timeline`.
    """
    dev = as_device(device)
    stacked, fparams, iparams, lens = _prepare(specs, lat, "sweep_timeline")
    out = timeline_sim_batched(*(torch.from_numpy(s).to(dev) for s in stacked),
                               fparams, iparams, kernel_mode=kernel_mode)
    lat_b, ov_b, done_b = (_host(o) for o in out)
    return [_result(lat_b[i, :n], ov_b[i, :n], done_b[i, :n], sp.events)
            for i, (sp, n) in enumerate(zip(specs, lens))]


class TimelineSweepStream:
    """Resumable chunked execution of :func:`sweep_timeline`.

    The stream prepares the stacked per-access columns of every spec once
    (identically to :func:`sweep_timeline`, including the trailing per-spec
    length padding), moves them to ``device`` and owns the carried queueing
    state there; each :meth:`run_chunk` call advances every sim through one
    slice ``[lo, hi)`` of the stacked trace axis.  Feeding the slices in
    order is **bit-identical** to one monolithic :func:`sweep_timeline` call
    in either mode and across mode changes at chunk boundaries.

    The chunk rules and the state layout are the reference's, so a state
    exported by the JAX package's stream imports here
    (:func:`repro_torch.convert.stream_state_from_numpy`): every chunk
    except the final one must be a multiple of ``block`` (or at most
    ``block`` long), the final chunk is tail-padded with ``_PAD_VALS``, and
    the sims are grouped as the reference groups them.
    """

    engine = "sweep_timeline"

    def __init__(self, specs: Sequence[TimelineSpec],
                 lat: Optional[SystemLatencies] = None, *, block: int = 512,
                 device: Device = "cuda"):
        self.device = as_device(device)
        stacked, self.fparams, self.iparams, self.lens = _prepare(
            specs, lat, "TimelineSweepStream")
        self.specs = tuple(specs)
        self.block = int(block)
        self.n = max(self.lens)
        self._stacked = [torch.from_numpy(s).to(self.device) for s in stacked]
        dims = [tuple(max(int(x), 1) for x in ip[2:7]) for ip in self.iparams]
        self.groups = _timeline_state_groups(dims, block=min(self.block, max(self.n, 1)))
        self._index = [torch.tensor(g, dtype=torch.int64, device=self.device)
                       for g in self.groups]
        self._state = [timeline_init_state_batched(
            len(g), envelope_of(self.iparams[g]), self.iparams[g, 5], device=self.device)
            for g in self.groups]
        self.now = 0

    @property
    def batch_size(self) -> int:
        return len(self.specs)

    def fingerprint(self) -> dict:
        return {
            "engine": self.engine,
            "block": self.block,
            "n": self.n,
            "lens": list(self.lens),
            "fparams": [[float(x) for x in row] for row in self.fparams],
            "iparams": [[int(x) for x in row] for row in self.iparams],
        }

    def run_chunk(self, lo: int, hi: int, *, kernel_mode: str = "auto"):
        """Advance every sim through the stacked-trace slice ``[lo, hi)``;
        returns (latency, overhead, done), each f32 numpy [B, hi - lo].
        Commit-on-success: a failed call leaves the stream unchanged."""
        if lo != self.now:
            raise ValueError(
                f"{self.engine} chunk starts at {lo}, stream is at {self.now}")
        if not lo < hi <= self.n:
            raise ValueError(
                f"{self.engine} chunk [{lo}, {hi}) outside stream [0, {self.n})")
        L = hi - lo
        if hi != self.n and L > self.block and L % self.block:
            raise ValueError(
                f"{self.engine} mid-stream chunk length {L} must be a "
                f"multiple of block {self.block} (or <= block): mid-stream "
                f"padding would perturb accelerator 0's issue clock")
        cols = [s[:, lo:hi] for s in self._stacked]
        pad = (-L) % min(self.block, L) if hi == self.n else 0
        if pad:
            # Final-chunk tail padding, the reference's own discipline; padded
            # outputs are dropped, and no further chunk reads the state.
            cols = [torch.cat([x, torch.full((x.shape[0], pad), v, dtype=x.dtype,
                                             device=self.device)], 1)
                    for x, v in zip(cols, _PAD_VALS)]
        outs = [np.empty((len(self.specs), L), np.float32) for _ in range(3)]
        new_state = []
        for g, ix, st in zip(self.groups, self._index, self._state):
            ys, st = timeline_sim_batched_carry(
                *(c[ix] for c in cols), self.fparams[g], self.iparams[g], st,
                kernel_mode=kernel_mode)
            for o, y in zip(outs, ys):
                o[g] = _host(y[:, :L])
            new_state.append(st)
        self._state = new_state
        self.now = hi
        return tuple(outs)

    def export_state(self) -> dict:
        """The carried state as numpy arrays, keyed as the reference keys them."""
        out = {"now": np.array([self.now], np.int64)}
        for gi, st in enumerate(self._state):
            for name, arr in zip(STATE_NAMES, st):
                out[f"g{gi}_{name}"] = _host(arr)
        return out

    def import_state(self, arrays: dict) -> None:
        """Load a state from :meth:`export_state` (numpy arrays or tensors),
        each array cast to the dtype of the stream's own."""
        state = []
        for gi, st in enumerate(self._state):
            new = []
            for name, ref in zip(STATE_NAMES, st):
                key = f"g{gi}_{name}"
                if key not in arrays:
                    raise ValueError(f"{self.engine} state missing array {key!r}")
                arr = torch.as_tensor(arrays[key])
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"{self.engine} state array {key!r} has shape "
                        f"{tuple(arr.shape)}, expected {tuple(ref.shape)}")
                new.append(arr.to(device=self.device, dtype=ref.dtype).contiguous())
            state.append(tuple(new))
        self._state = state
        self.now = int(_host(arrays["now"]).reshape(-1)[0])

    def finalize(self, latency: np.ndarray, overhead: np.ndarray,
                 done: np.ndarray) -> List[TimelineResult]:
        """Assemble per-spec results from the accumulated [B, n] output
        buffers (each spec sliced back to its own unpadded length)."""
        return [_result(latency[i, :n], overhead[i, :n], done[i, :n], sp.events)
                for i, (sp, n) in enumerate(zip(self.specs, self.lens))]
