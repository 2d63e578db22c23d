"""The port's roofline (``repro_torch.bench.roofline``) against the JAX
package's ``benchmarks/roofline.py`` on the CPU:

* the closed-form models — per-token forward FLOPs, a cell's FLOPs and its
  per-device HBM bytes — equal JAX's on every (arch x shape) cell, over
  each package's own registry (whose configs are equal);
* ``analyse_cell`` / ``table`` on written dry-run records: the terms at the
  H100's figures, the traced per-device FLOPs in the compute term, the
  closed forms beside them equal JAX's ``analyse_cell`` of the same record,
  a cut record modelled at its depth, failed records and other meshes left
  out.
"""
import json

import pytest

from benchmarks import roofline as jroof
from repro.configs import registry as jreg
from repro.configs.base import SHAPES_BY_NAME as JSHAPES
from repro_torch.bench import roofline as troof
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES_BY_NAME as TSHAPES

CELLS = [(a, s.name) for a, s in jreg.all_cells()]


def test_every_cell_is_in_both_registries():
    assert CELLS == [(a, s.name) for a, s in treg.all_cells()] and len(CELLS) > 30


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_closed_forms_equal_jax(arch, shape):
    jc, tc = jreg.get_config(arch), treg.get_config(arch)
    js, ts = JSHAPES[shape], TSHAPES[shape]
    assert tc.param_count() == jc.param_count()
    for ctx in (1.0, js.seq_len / 2, float(js.seq_len)):
        assert troof.forward_flops_per_token(tc, ctx) == jroof.forward_flops_per_token(jc, ctx)
    assert troof.cell_flops(tc, ts) == jroof.cell_flops(jc, js)
    for chips in (256, 512):
        assert (troof.cell_hbm_bytes(tc, ts, chips, tc.param_count())
                == jroof.cell_hbm_bytes(jc, js, chips, jc.param_count()))


def test_h100_figures():
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == (989e12, 3.35e12, 450e9)


def _record(arch="qwen3-14b", shape="train_4k", mesh="16x16", **kw):
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "chips": 256, "ok": True,
           "flops": 3.1e15, "flops_scope": "device",
           "collective_bytes": {"all-gather": 2.0e11, "all-reduce": 1.5e11,
                                "reduce-scatter": 1e8},
           "param_count": treg.get_config(arch).param_count()}
    rec.update(kw)
    return rec


def test_analyse_cell_reads_the_records_device_counts():
    rec = _record()
    got = troof.analyse_cell(rec)
    coll = sum(rec["collective_bytes"].values())
    assert got["t_compute_s"] == rec["flops"] / 989e12
    assert got["t_collective_s"] == coll / 450e9
    assert got["t_memory_s"] == got["hbm_bytes_per_dev"] / 3.35e12
    terms = {k: got[f"t_{k}_s"] for k in ("compute", "memory", "collective")}
    assert got["dominant"] == max(terms, key=terms.get)
    assert got["roofline_fraction"] == got["t_compute_s"] / max(terms.values())
    want = jroof.analyse_cell(rec)          # no HLO archived: JAX reads the same bytes
    for key in ("model_flops", "compiled_flops_est", "useful_ratio", "hbm_bytes_per_dev",
                "collective_bytes_per_dev"):
        assert got[key] == want[key], key
    assert got["t_compute_analytic_s"] * troof.PEAK_FLOPS == pytest.approx(
        want["t_compute_s"] * jroof.PEAK_FLOPS, rel=1e-12)


def test_analyse_cell_without_device_flops_uses_the_closed_form():
    got = troof.analyse_cell(_record(flops_scope="global"))
    assert got["t_compute_s"] == got["t_compute_analytic_s"]


def test_a_cut_record_is_modelled_at_its_depth():
    full = troof.analyse_cell(_record("zamba2-7b"))
    cut = troof.analyse_cell(_record("zamba2-7b", num_layers=3))
    assert cut["model_flops"] < full["model_flops"] / 10
    assert (cut["cut"], cut["num_layers"], full["cut"], full["num_layers"]) == (True, 3, False, 81)


def test_print_table_names_a_cut_cell(capsys):
    troof.print_table([troof.analyse_cell(_record("zamba2-7b")),
                       troof.analyse_cell(_record("zamba2-7b", num_layers=3))])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ",".join(troof.TABLE_HEADER)
    assert [ln.split(",")[0] for ln in out[1:]] == ["zamba2-7b:L3", "zamba2-7b"]


def test_table_reads_the_written_records(tmp_path):
    recs = [_record(), _record("gemma-7b", "prefill_32k"),
            _record("qwen3-14b", "decode_32k", mesh="2x16x16", chips=512),
            {**_record("stablelm-12b"), "ok": False}]
    for r in recs:
        (tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json").write_text(json.dumps(r))
    rows = troof.table("16x16", tmp_path)
    assert sorted((r["arch"], r["shape"]) for r in rows) == [("gemma-7b", "prefill_32k"),
                                                             ("qwen3-14b", "train_4k")]
    assert [r["arch"] for r in troof.table("2x16x16", tmp_path)] == ["qwen3-14b"]
