"""The golden hit counts that ``chip_smoke.py`` holds the card to
(``tests/data/torch_golden_*.json``, written by ``tests/torch_golden.py``
with the JAX package) cannot drift: small entries (``hash_table``'s, Fig 8's
one-thread mix, Fig 7) are recomputed here, and the tables the files were
built from are the figure drivers' own, in the JAX package and in the
port."""
import json

import numpy as np
import pytest

pytest.importorskip("jax")  # the golden file is checked against the JAX package
import torch_golden as g

from benchmarks import fig4_tlb_sensitivity as jfig4
from benchmarks import fig10_performance as jfig10
from repro_torch.bench import common as tcommon
from repro_torch.bench import fig4, fig10


@pytest.fixture(scope="module")
def golden():
    return json.loads(g.GOLDEN.read_text())


def test_golden_tables_are_the_drivers(golden):
    assert g.FIG10_CONFIGS == jfig10.CONFIGS == fig10.CONFIGS
    assert (g.FIG10_CACHE, g.FIG10_ACCEL_TLB, g.FIG10_MEM_TLB) == (
        jfig10.CACHE, jfig10.ACCEL_TLB, jfig10.MEM_TLB)
    assert g.FIG4_CONFIGS == jfig4.CONFIGS == fig4.CONFIGS
    assert g.FIG4_SIZES == jfig4.SIZES == fig4.SIZES
    assert g.W4 == tcommon.W4
    assert golden["fig10"]["configs"] == [c[0] for c in fig10.CONFIGS]
    assert golden["fig4"]["specs"] == [[c[0], s] for c in fig4.CONFIGS for s in fig4.SIZES]
    assert golden["fig10"]["n_ops"] == g.FIG10_N_OPS == 25_000
    assert golden["fig4"]["n_ops"] == g.FIG4_N_OPS == 40_000
    assert list(golden["fig10"]["workloads"]) == list(g.W4)
    assert list(golden["fig4"]["workloads"]) == list(g.W4)


def test_golden_traces_match_the_port(golden):
    """The port's figure traces are the traces the golden counts were taken on."""
    import hashlib

    for fig in ("fig10", "fig4"):
        entry = golden[fig]["workloads"]["hash_table"]
        lines = tcommon.trace("hash_table", n_ops=golden[fig]["n_ops"]).lines
        assert lines.shape[0] == entry["num_accesses"]
        assert hashlib.sha256(lines.tobytes()).hexdigest() == entry["sha256"]


def test_golden_fig10_hash_table_recomputes(golden):
    assert g.fig10_entry("hash_table") == golden["fig10"]["workloads"]["hash_table"]


def test_golden_fig4_hash_table_recomputes(golden):
    assert g.fig4_entry("hash_table") == golden["fig4"]["workloads"]["hash_table"]


@pytest.fixture(scope="module")
def golden_timeline():
    return json.loads(g.GOLDEN_TIMELINE.read_text())


def test_timeline_golden_tables_are_the_drivers(golden_timeline):
    from benchmarks import fig5_contention as jfig5
    from benchmarks import fig11_tail_latency as jfig11
    from repro_torch.bench import fig5, fig11

    assert (g.FIG11_CACHE, g.FIG11_ACCEL_TLB, g.FIG11_MEM_TLB, g.QUEUES) == (
        jfig11.CACHE, jfig11.ACCEL_TLB, jfig11.MEM_TLB, jfig11.QUEUES)
    assert g.FIG11_PARTITIONS == jfig11.PARTITIONS == fig11.PARTITIONS
    assert g.FIG11_ACCELS == fig11.ACCELS
    assert (g.FIG5_TLB, g.FIG5_CACHE, g.QUEUES) == (jfig5.TLB, jfig5.CACHE, jfig5.QUEUES)
    assert g.FIG5_THREADS == jfig5.THREADS == fig5.THREADS
    assert g.FIG5_PARTS == jfig5.PARTS == fig5.PARTS
    assert g.FIG5_MAX_ACCESSES == fig5.MAX_ACCESSES
    f11, f5 = golden_timeline["fig11"], golden_timeline["fig5"]
    assert (f11["n_ops"], f11["cap"], f11["accels"]) == (8_000, 400_000, list(fig11.ACCELS))
    assert (f5["n_ops"], f5["tl_cap"]) == (12_000, 40_000)
    assert list(f11["traces"]) == list(f11["timeline"]) == list(g.W4)
    assert all(len(v) == 2 * len(fig11.ACCELS) for v in f11["timeline"].values())
    assert list(f5["grid"]) == list(f5["timeline"]) == list(g.W4)
    assert all(len(v) == len(fig5.PARTS) for v in f5["timeline"].values())


def test_timeline_golden_traces_match_the_port(golden_timeline):
    """The port's Fig 11 and Fig 5 streams are the ones the golden outputs
    were taken on."""
    import hashlib

    from repro_torch.bench import fig11

    f11 = golden_timeline["fig11"]
    lines = fig11.interleaved("hash_table", 16, f11["n_ops"], f11["cap"])
    assert f11["traces"]["hash_table"] == {
        "num_accesses": int(lines.shape[0]),
        "sha256": hashlib.sha256(lines.tobytes()).hexdigest()}
    for t, entry in golden_timeline["fig5"]["grid"]["hash_table"].items():
        lines = g.fig5_interleaved("hash_table", int(t))
        assert entry["num_accesses"] == lines.shape[0]
        assert entry["sha256"] == hashlib.sha256(lines.tobytes()).hexdigest()


def test_golden_fig5_timeline_hash_table_recomputes(golden_timeline):
    assert g.fig5_timeline_entry("hash_table") == golden_timeline["fig5"]["timeline"]["hash_table"]


def test_golden_fig5_grid_hash_table_recomputes(golden_timeline):
    assert g.fig5_grid_entry("hash_table") == golden_timeline["fig5"]["grid"]["hash_table"]


@pytest.fixture(scope="module")
def golden_figs():
    return json.loads(g.GOLDEN_FIGS.read_text())


def test_figs_golden_tables_are_the_drivers(golden_figs):
    import dataclasses

    from benchmarks import fig2_pagewalk as jfig2
    from benchmarks import fig6_pagefault as jfig6
    from benchmarks import fig8_multiprog as jfig8
    from benchmarks import fig9_accel_tlb as jfig9
    from repro_torch.bench import fig2, fig6, fig8, fig9

    def same(*cfgs):
        return len({dataclasses.astuple(c) for c in cfgs}) == 1

    assert g.FIG2_FOOTPRINTS_GB == jfig2.FOOTPRINTS_GB == fig2.FOOTPRINTS_GB
    assert same(g.FIG2_TLB, jfig2.TLB, fig2.TLB)
    assert g.FIG8_PARTS == jfig8.PARTS == fig8.PARTS and same(g.FIG8_TLB, jfig8.TLB, fig8.TLB)
    assert (g.FIG8_SEED, g.FIG8_CAP) == (fig8.SEED, fig8.CAP) == (11, 2_400_000)
    assert g.FIG8_MIXES == fig8.MIXES
    assert g.FIG9_ENTRIES == jfig9.ENTRIES == fig9.ENTRIES and g.FIG9_P == jfig9.P == fig9.P
    assert same(g.FIG9_MEM_TLB, jfig9.MEM_TLB, fig9.MEM_TLB)
    assert same(g.FIG9_CACHE, jfig9.CACHE, fig9.CACHE)
    assert g.FIG6_MEM_FRACS == jfig6.MEM_FRACS == fig6.MEM_FRACS
    assert (g.FIG6_NODE_OVERHEAD_FRAC, g.FIG6_JITTER) == (
        jfig6.NODE_OVERHEAD_FRAC, jfig6.JITTER) == (fig6.NODE_OVERHEAD_FRAC, fig6.JITTER)
    assert [repr(c).replace("repro.core", "") for c in g.fig9_system_configs()] == [
        repr(c).replace("repro_torch.core", "") for c in fig9.system_configs()]
    f2, f8, f9, f6 = (golden_figs[k] for k in ("fig2", "fig8", "fig9", "fig6"))
    assert (f2["n_ops"], f8["n_ops"], f9["n_ops"], f6["n_ops"]) == (
        g.FIG2_N_OPS, g.FIG8_N_OPS, g.FIG9_N_OPS, g.FIG6_N_OPS) == (30_000, 10_000, 25_000,
                                                                    120_000)
    assert f2["footprints_gb"] == list(fig2.FOOTPRINTS_GB) and list(f2["workloads"]) == list(g.W4)
    assert all(list(v) == [str(x) for x in fig2.FOOTPRINTS_GB] for v in f2["workloads"].values())
    assert list(f8["mixes"]) == list(fig8.MIXES) and f8["parts"] == list(fig8.PARTS)
    assert all(len(e["bste"]) == len(fig8.PARTS) for e in f8["mixes"].values())
    assert set(f8["salts"]) == set(fig8.default_salts())
    assert f9["entries"] == list(fig9.ENTRIES) and list(f9["workloads"]) == list(g.W4)
    assert all(len(e["cache"]) == len(fig9.system_configs()) for e in f9["workloads"].values())
    assert len(f6["faults_1"]) == len(f6["faults_32"]) == len(fig6.MEM_FRACS)


def test_golden_fig8_mix_is_the_jax_drivers():
    """The golden generator's mix is the JAX driver's, salted alike in one
    process."""
    from benchmarks import fig8_multiprog as jfig8

    for name in ("bst_e_x2", "+bsti+skip"):
        got = g.fig8_mix(30, g.FIG8_SEED, g.FIG8_MIXES[name], g.fig8_salts())
        want = jfig8._mix(30, g.FIG8_SEED, g.FIG8_MIXES[name])
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        assert got[2] == want[2]


def test_figs_golden_traces_match_the_port(golden_figs):
    """The port's Fig 2, 8 and 6 streams, given the golden salts, are the
    ones the golden counts were taken on."""
    import hashlib

    from repro_torch.bench import fig2, fig6, fig8

    def header(x):
        return {"num_accesses": int(x.shape[0]), "sha256": hashlib.sha256(x.tobytes()).hexdigest()}

    for gb, entry in golden_figs["fig2"]["workloads"]["hash_table"].items():
        lines = fig2.fig2_trace("hash_table", int(gb), golden_figs["fig2"]["n_ops"]).lines
        assert header(lines) == {k: entry[k] for k in ("num_accesses", "sha256")}
    f8 = golden_figs["fig8"]
    inter = fig8._mix(f8["n_ops"], fig8.SEED, fig8.MIXES["bst_e_x1"], f8["salts"])[0][:fig8.CAP]
    assert header(inter) == {k: f8["mixes"]["bst_e_x1"][k] for k in ("num_accesses", "sha256")}
    f6 = golden_figs["fig6"]
    pages = fig6.page_stream(f6["n_ops"])
    assert header(pages) == {k: f6[k] for k in ("num_accesses", "sha256")}
    assert int(np.unique(pages).size) == f6["unique"]


def test_golden_fig2_hash_table_recomputes(golden_figs):
    assert g.fig2_entry("hash_table") == golden_figs["fig2"]["workloads"]["hash_table"]


def test_golden_fig8_smallest_mix_recomputes(golden_figs):
    f8 = golden_figs["fig8"]
    assert g.fig8_entry("bst_e_x1", f8["salts"]) == f8["mixes"]["bst_e_x1"]


def test_golden_fig9_hash_table_recomputes(golden_figs):
    assert g.fig9_entry("hash_table") == golden_figs["fig9"]["workloads"]["hash_table"]


def test_golden_fig7_and_claims_recompute(golden_figs):
    assert g.fig7_golden() == golden_figs["fig7"]
    assert g.fig2_claims(golden_figs["fig2"]["workloads"]) == golden_figs["fig2"]["claims"]
    assert g.fig8_claims(golden_figs["fig8"]["mixes"]) == golden_figs["fig8"]["claims"]
    assert g.fig9_claims(golden_figs["fig9"]["workloads"]) == golden_figs["fig9"]["claims"]


def test_golden_fig6_stream_recomputes_and_the_port_counts_its_faults(golden_figs):
    """Fig 6's page stream, unique pages and memory sizes recompute with the
    JAX package; the fault counts, which JAX's one-access-a-step Fenwick
    scan takes minutes for at this size, equal the port's exact pass on the
    CPU (held to JAX access for access in tests/test_torch_pagetable.py)."""
    from repro_torch.core import pagetable as pt

    f6 = golden_figs["fig6"]
    pages = g.fig6_pages(f6["n_ops"])
    assert g._trace_header(pages) == {k: f6[k] for k in ("num_accesses", "sha256")}
    unique = int(np.unique(pages).size)
    assert unique == f6["unique"]
    assert f6["frames"] == [max(32, int(fr * unique)) for fr in g.FIG6_MEM_FRACS]
    assert f6["overhead_frames"] == max(1, int(g.FIG6_NODE_OVERHEAD_FRAC * unique))
    faults_1, n = pt.page_fault_counts(pages, f6["frames"], device="cpu")
    faults_32, _ = pt.page_fault_counts(pages, f6["frames"], num_partitions=32,
                                        node_overhead_frames=f6["overhead_frames"],
                                        node_capacity_jitter=g.FIG6_JITTER, device="cpu")
    assert (faults_1.tolist(), faults_32.tolist()) == (f6["faults_1"], f6["faults_32"])
    assert [f / n for f in f6["faults_1"]] == f6["rates_1"]
    assert [f / n for f in f6["faults_32"]] == f6["rates_32"]
