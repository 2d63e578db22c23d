"""The slice as a whole: the port's Fig 11 and Fig 5 drivers on the CPU at a
small size against the JAX package's library calls, assembled exactly as the
JAX drivers assemble them (``benchmarks/fig11_tail_latency.py``,
``benchmarks/fig5_contention.py``), on the same traces.

The timeline outputs are bit-identical and every row, percentile and claim
value is numpy float64 on them, so they agree to rtol 1e-12 (in practice
exactly).
"""
import dataclasses
import logging

import numpy as np
import pytest

pytest.importorskip("jax")  # the parity tests need the JAX package (CPU only)
from benchmarks import fig5_contention as jfig5
from benchmarks import fig11_tail_latency as jfig11
from repro.core import timeline as jtl
from repro.core import traces as jtraces
from repro.core.sparta import SystemLatencies as JLatencies
from repro.core.sweep import TLBSweepSpec as JSpec
from repro.core.sweep import sweep_system as jsweep_system
from repro.core.sweep import sweep_tlb as jsweep_tlb
from repro.core.tlbsim import SystemSimConfig as JSystemSimConfig
from repro_torch.bench import fig5, fig11

RTOL = 1e-12
W4 = ("bst_external", "bst_internal", "hash_table", "skip_list")


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float),
                               rtol=RTOL, atol=0, err_msg=what)


def _fields(x):
    return dataclasses.asdict(x)


def test_driver_tables_are_the_jax_drivers():
    for name in ("CACHE", "ACCEL_TLB", "MEM_TLB", "QUEUES"):
        assert _fields(getattr(fig11, name)) == _fields(getattr(jfig11, name)), name
    assert fig11.PARTITIONS == jfig11.PARTITIONS
    for name in ("TLB", "CACHE", "QUEUES"):
        assert _fields(getattr(fig5, name)) == _fields(getattr(jfig5, name)), name
    assert fig5.THREADS == jfig5.THREADS and fig5.PARTS == jfig5.PARTS


@pytest.fixture(scope="module")
def fig11_small():
    return fig11.run(device="cpu", n_ops=30, cap=700, accels=(1, 4, 16), verbose=False)


def test_fig11_small_matches_jax(fig11_small):
    """The JAX driver's assembly: one interleaved stream and one system
    sweep per workload, every accel count replaying it, one timeline sweep."""
    n_ops, cap, accels = 30, 700, (1, 4, 16)
    lat = JLatencies(n_sockets=8)
    specs, cells = [], []
    for w in W4:
        inter = jtraces.interleave(jtraces.thread_traces(w, 16, n_ops=n_ops, seed=7))[:cap]
        assert np.array_equal(fig11_small["lines"][w], inter)
        evs = jsweep_system(inter, [
            JSystemSimConfig(cache=jfig11.CACHE, accel_tlb=jfig11.ACCEL_TLB,
                             mem_tlb=jfig11.MEM_TLB, num_partitions=1, page_shift=12),
            JSystemSimConfig(cache=jfig11.CACHE, accel_tlb=None, mem_tlb=jfig11.MEM_TLB,
                             num_partitions=jfig11.PARTITIONS, page_shift=12),
        ], kernel_mode="reference")
        for A in accels:
            ids = jtl.round_robin_accel_ids(inter.shape[0], A)
            specs.append(jtl.TimelineSpec(inter, evs[0], "conventional", cfg=jfig11.QUEUES,
                                          num_accelerators=A, accel_ids=ids))
            specs.append(jtl.TimelineSpec(inter, evs[1], "sparta", cfg=jfig11.QUEUES,
                                          num_partitions=jfig11.PARTITIONS,
                                          num_accelerators=A, accel_ids=ids))
            cells.append((w, A))
    results = jtl.sweep_timeline(specs, lat, kernel_mode="reference")
    assert fig11_small["cells"] == cells
    for i, (g, r) in enumerate(zip(fig11_small["results"], results)):
        for k in ("latency", "overhead", "done"):
            assert np.array_equal(getattr(g, k), getattr(r, k)), (i, k)
    p99 = {}
    for i, ((w, A), row) in enumerate(zip(cells, fig11_small["rows"])):
        conv, spa = results[2 * i], results[2 * i + 1]
        p99[(w, A)] = (conv.overhead_percentile(99), spa.overhead_percentile(99))
        assert row[:2] == [w, A]
        _close(row[2:], [conv.overhead_percentile(50), spa.overhead_percentile(50),
                         *p99[(w, A)], conv.mean_latency, spa.mean_latency,
                         conv.throughput, spa.throughput], f"{w}/{A}")
    wins = sum(1 for w in W4 if p99[(w, 16)][1] < p99[(w, 16)][0])
    red = [p99[(w, 16)][0] / max(p99[(w, 16)][1], 1e-9) for w in W4]
    claims = fig11_small["claims"]
    assert [c.name for c in claims] == ["C9a", "C9b"]
    _close([c.value for c in claims], [wins, np.mean(red)], "claims")


def test_fig11_rejects_sweep_only_mode():
    with pytest.raises(ValueError, match="stackdist"):
        fig11.run(kernel_mode="stackdist", device="cpu", n_ops=10, cap=100, verbose=False)


@pytest.fixture(scope="module")
def fig5_small():
    return fig5.run(device="cpu", n_ops=8, tl_cap=400, verbose=False)


def test_fig5_small_matches_jax(fig5_small):
    n_ops, tl_cap = 8, 400
    specs = [JSpec(jfig5.TLB, num_partitions=p, page_shift=12) for p in jfig5.PARTS]
    results, inter_max = {}, {}
    for w in W4:
        grid = np.empty((len(jfig5.PARTS), len(jfig5.THREADS)))
        for i_t, t in enumerate(jfig5.THREADS):
            inter = jtraces.interleave(
                jtraces.thread_traces(w, t, n_ops=n_ops, seed=7))[:1_200_000]
            assert np.array_equal(fig5_small["lines"][f"{w}/t{t}"], inter)
            inter_max[w] = inter
            grid[:, i_t] = jsweep_tlb(inter, specs).miss_ratios
        for i_p, p in enumerate(jfig5.PARTS):
            results[f"{w}/P{p}"] = [float(x) for x in grid[i_p]]
            _close(fig5_small["results"][f"{w}/P{p}"], results[f"{w}/P{p}"], f"{w}/P{p}")
    bumps = [results[f"{w}/P1"][-1] - results[f"{w}/P1"][0] for w in W4]
    wins = sum(1 for w in W4 if results[f"{w}/P16"][-1] < results[f"{w}/P1"][0])
    claims = fig5_small["claims"]
    assert [c.name for c in claims] == ["C3a", "C3b"]
    _close([c.value for c in claims], [np.mean(bumps), wins], "claims")

    tl_specs = []
    for w in W4:
        sl = inter_max[w][:tl_cap]
        evs = jsweep_system(sl, [
            JSystemSimConfig(cache=jfig5.CACHE, accel_tlb=None, mem_tlb=jfig5.TLB,
                             num_partitions=p, page_shift=12) for p in jfig5.PARTS],
            kernel_mode="reference")
        tl_specs += [jtl.TimelineSpec(sl, evs[i], "sparta", cfg=jfig5.QUEUES,
                                      num_partitions=p, num_accelerators=16)
                     for i, p in enumerate(jfig5.PARTS)]
    tl_res = jtl.sweep_timeline(tl_specs, JLatencies(n_sockets=8), kernel_mode="reference")
    for i, (g, r) in enumerate(zip(fig5_small["timeline"], tl_res)):
        for k in ("latency", "overhead", "done"):
            assert np.array_equal(getattr(g, k), getattr(r, k)), (i, k)
    for i, w in enumerate(W4):
        want = [r.overhead_percentile(99) for r in tl_res[4 * i:4 * i + 4]]
        _close(fig5_small["timeline_p99"][w], want, f"{w} timeline p99")
        assert fig5_small["timeline_rows"][i][0] == w


def test_fig5_coerces_stackdist_for_the_timeline_half(fig5_small, caplog):
    """``kernel_mode="stackdist"`` runs the grid on the stack-distance engine
    and the timeline half on "auto", with a warning, as the JAX driver does."""
    with caplog.at_level(logging.WARNING, logger="repro_torch.bench.fig5"):
        res = fig5.run(kernel_mode="stackdist", device="cpu", n_ops=8, tl_cap=400,
                       verbose=False)
    assert any("timeline half" in r.getMessage() for r in caplog.records)
    assert res["results"] == fig5_small["results"]
    assert res["timeline_p99"] == fig5_small["timeline_p99"]
