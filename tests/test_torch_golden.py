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
