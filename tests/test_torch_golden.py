"""The golden hit counts that ``chip_smoke.py`` holds the card to
(``tests/data/torch_golden_sweeps.json``, written by ``tests/torch_golden.py``
with the JAX package) cannot drift: the small ``hash_table`` entries are
recomputed here, and the tables the file was built from are the figure
drivers' own, in the JAX package and in the port."""
import json

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
