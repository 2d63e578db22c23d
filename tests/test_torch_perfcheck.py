"""The port's tolerance-band gate (``repro_torch.bench.perfcheck``) and the
kernel-bench history (``repro_torch.bench.kernel_bench``) on the CPU: the
cases of tests/test_perfcheck.py on the port's modules (a row out of band
fails, too fast included; an unreferenced key or another device warns and
passes; legacy rows are skipped; a missing metric fails; a corrupt file
fails loudly; ``--update-refs`` keeps hand-edited bands), and the history's
append (a given metadata stamp; the card's stamp refused on the CPU; a
corrupt file refused and left as it was) and its calibration feed."""
import json

import pytest
import torch

from repro_torch.bench import kernel_bench, perfcheck
from repro_torch.core import benchtime, dispatch

CARD = {"schema_version": benchtime.SCHEMA_VERSION, "platform": "gpu",
        "device_kind": "NVIDIA H100 80GB HBM3", "device_count": 1,
        "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W", "torch_version": "2.11",
        "cuda_version": "12.8"}


def _row(**kw):
    base = {**CARD, "written_at": "2026-10-18 00:00:00", "bench": "sweep", "backend": "cuda",
            "mode": "cuda", "quick": True, "n_accesses": 12_000, "n_configs": 8,
            "t_reference_s": 1.0, "t_stackdist_s": 0.2, "t_cuda_s": 0.05, "speedup": 20.0,
            "bit_identical": True}
    base.update(kw)
    return base


KEY = "sweep|cuda|cuda|quick"


def _refs(tol=(-0.5, 0.5)):
    return {"schema_version": 2, "references": {KEY: {
        "device_kind": CARD["device_kind"],
        "metrics": {"t_reference_s": {"ref": 1.0, "tol": list(tol)},
                    "t_stackdist_s": {"ref": 0.2, "tol": list(tol)}}}}}


def test_check_rows_within_band_passes():
    fails, warns, n_checked, n_legacy = perfcheck.check_rows(
        [_row(t_reference_s=1.2, t_stackdist_s=0.15)], _refs())
    assert not fails and not warns and n_checked == 1 and n_legacy == 0


def test_check_rows_regression_fails():
    fails, _, _, _ = perfcheck.check_rows([_row(t_reference_s=2.0)], _refs())
    assert len(fails) == 1 and "t_reference_s" in fails[0] and "regression" in fails[0]


def test_check_rows_too_fast_fails():
    fails, _, _, _ = perfcheck.check_rows([_row(t_stackdist_s=0.01)], _refs())
    assert len(fails) == 1 and "suspiciously" in fails[0]


def test_check_rows_abs_slack_widens_upper_bound_only():
    refs = _refs()
    for spec in refs["references"][KEY]["metrics"].values():
        spec["abs_slack_s"] = 1.0
    assert not perfcheck.check_rows([_row(t_reference_s=2.0)], refs)[0]
    assert len(perfcheck.check_rows([_row(t_stackdist_s=0.01)], refs)[0]) == 1


def test_check_rows_other_device_warns_and_passes():
    fails, warns, n_checked, _ = perfcheck.check_rows(
        [_row(device_kind="NVIDIA A100-SXM4-80GB", t_reference_s=99.0)], _refs())
    assert not fails and len(warns) == 1 and "A100" in warns[0] and n_checked == 0


def test_warn_pass_is_string_with_key_and_reason():
    _, warns, _, _ = perfcheck.check_rows([_row(device_kind="other")], _refs())
    assert isinstance(warns[0], str)
    assert warns[0].key == KEY and warns[0].reason == "device_mismatch"
    _, warns, _, _ = perfcheck.check_rows([_row(bench="timeline")], _refs())
    assert warns[0].reason == "unreferenced"


def test_check_perf_history_returns_parseable_summary(tmp_path, capsys):
    hist = tmp_path / "history.json"
    hist.write_text(json.dumps({"history": [_row(bench="timeline"), _row(bench="timeline")]}))
    summary = perfcheck.check_perf_history(hist, tmp_path / "refs.json")
    assert summary["n_failures"] == 0 and summary["n_checked"] == 0
    assert summary["warn_pass"] == {"count": 2, "keys": ["timeline|cuda|cuda|quick"],
                                    "reasons": {"unreferenced": 2}}
    line = [ln for ln in capsys.readouterr().out.splitlines() if "perfcheck summary:" in ln][0]
    assert json.loads(line.split("perfcheck summary:", 1)[1]) == summary


def test_check_rows_legacy_rows_skipped():
    legacy = _row(t_reference_s=500.0)
    del legacy["schema_version"]
    fails, warns, n_checked, n_legacy = perfcheck.check_rows([legacy], _refs())
    assert not fails and not warns and n_checked == 0 and n_legacy == 1


def test_check_rows_missing_metric_fails():
    row = _row()
    del row["t_stackdist_s"]
    fails, _, _, _ = perfcheck.check_rows([row], _refs())
    assert len(fails) == 1 and "missing" in fails[0]


def test_check_perf_history_raises_on_failure(tmp_path):
    hist, refs = tmp_path / "history.json", tmp_path / "references.json"
    hist.write_text(json.dumps({"history": [_row(t_reference_s=3.0)]}))
    refs.write_text(json.dumps(_refs()))
    with pytest.raises(SystemExit, match="perf-regression gate"):
        perfcheck.check_perf_history(hist, refs)


def test_load_history_corrupt_fails_loudly(tmp_path):
    bad = tmp_path / "history.json"
    bad.write_text("{not json")
    with pytest.raises(SystemExit, match="corrupt"):
        perfcheck.load_history(bad)
    bad.write_text(json.dumps([1, 2, 3]))
    with pytest.raises(SystemExit, match="history"):
        perfcheck.load_history(bad)


def test_update_references_baselines_and_preserves_tol(tmp_path):
    refs = tmp_path / "references.json"
    refs.write_text(json.dumps(_refs(tol=(-0.2, 0.1))))
    hist = [_row(t_reference_s=9.0), _row(t_reference_s=4.0, t_stackdist_s=0.8)]
    doc = perfcheck.update_references(hist, refs)
    entry = doc["references"][KEY]
    assert entry["metrics"]["t_reference_s"] == {"ref": 4.0, "tol": [-0.2, 0.1],
                                                 "abs_slack_s": perfcheck.DEFAULT_ABS_SLACK_S}
    assert entry["metrics"]["t_cuda_s"]["tol"] == list(perfcheck.DEFAULT_TOLERANCE)
    assert entry["device_kind"] == CARD["device_kind"]
    fails, warns, n_checked, _ = perfcheck.check_rows([hist[-1]], json.loads(refs.read_text()))
    assert not fails and not warns and n_checked == 1


# -- the kernel-bench history's gate ------------------------------------------

def _full_history(**overrides):
    rows = [_row(),
            _row(bench="timeline", n_accesses=2_000, t_reference_s=3.0, t_cuda_s=0.01),
            _row(bench="timeline_batched", n_sims=12, n_accesses=600, t_looped_s=9.0,
                 t_batched_s=1.0, t_cuda_s=0.02),
            _row(bench="system_batched", n_configs=9, n_accesses=4_000, t_looped_s=2.0,
                 t_batched_s=0.5, t_cuda_s=0.01)]
    for r in rows:
        r.update(overrides)
    return {"history": rows}


def test_check_bench_history_passes_on_clean_history(tmp_path, capsys):
    hist = tmp_path / "history.json"
    hist.write_text(json.dumps(_full_history()))
    summary = kernel_bench.check_bench_history(hist, refs_path=tmp_path / "refs.json")
    out = capsys.readouterr().out
    assert "bit-identical" in out and "perfcheck" in out
    assert summary["warn_pass"]["count"] == 4


def test_check_bench_history_missing_bench_fails(tmp_path):
    hist = tmp_path / "history.json"
    doc = _full_history()
    doc["history"] = doc["history"][:2]
    hist.write_text(json.dumps(doc))
    with pytest.raises(SystemExit, match="timeline_batched"):
        kernel_bench.check_bench_history(hist, refs_path=tmp_path / "refs.json")


def test_check_bench_history_bit_identity_fails(tmp_path):
    hist = tmp_path / "history.json"
    hist.write_text(json.dumps(_full_history(bit_identical=False)))
    with pytest.raises(SystemExit, match="non-bit-identical"):
        kernel_bench.check_bench_history(hist, refs_path=tmp_path / "refs.json")


def test_check_bench_history_corrupt_history_fails(tmp_path):
    hist = tmp_path / "history.json"
    hist.write_text("]{ definitely not json")
    with pytest.raises(SystemExit, match="corrupt"):
        kernel_bench.check_bench_history(hist, refs_path=tmp_path / "refs.json")


def test_committed_references_gate_every_required_bench_on_the_card():
    refs = perfcheck.load_references()["references"]
    for bench in kernel_bench.REQUIRED_BENCHES:
        keys = [k for k in refs if k.startswith(f"{bench}|cuda|") and k.endswith("|quick")]
        assert keys, f"no quick card baseline for {bench}"
        for k in keys:
            assert refs[k]["device_kind"].startswith("NVIDIA H100"), refs[k]
            assert set(refs[k]["metrics"]) >= {"t_cuda_s"}, refs[k]


# -- appending and calibrating ------------------------------------------------

def test_append_entry_stamps_the_given_metadata(tmp_path):
    path = tmp_path / "sub" / "history.json"
    for i in range(2):
        kernel_bench.append_entry({"bench": "sweep", "t_cuda_s": 0.1 * (i + 1)}, path,
                                  metadata=CARD)
    rows = json.loads(path.read_text())["history"]
    assert [r["t_cuda_s"] for r in rows] == [0.1, 0.2]
    assert all(r["device_kind"] == CARD["device_kind"] and r["nvidia_smi"] == CARD["nvidia_smi"]
               and r["schema_version"] == benchtime.SCHEMA_VERSION for r in rows)
    assert not list(tmp_path.glob("sub/*.tmp-*"))


def test_append_entry_refuses_a_corrupt_history(tmp_path):
    bad = tmp_path / "history.json"
    bad.write_text("{corrupt")
    with pytest.raises(RuntimeError, match="refusing to overwrite"):
        kernel_bench.append_entry({"bench": "sweep"}, bad, metadata=CARD)
    assert bad.read_text() == "{corrupt"
    bad.write_text("[1, 2]")
    with pytest.raises(RuntimeError, match="refusing to overwrite"):
        kernel_bench.append_entry({"bench": "sweep"}, bad, metadata=CARD)


def test_append_entry_refuses_the_cpu_stamp(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; its stamp is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_bench.append_entry({"bench": "sweep"}, tmp_path / "history.json")
    assert not (tmp_path / "history.json").exists()


def test_each_bench_row_feeds_the_calibration_store(tmp_path):
    rows = _full_history()["history"]
    n = sum(kernel_bench.record_calibration(r, tmp_path) for r in rows)
    assert n == 3 + 2 + 2 + 2
    store = dispatch.CalibrationStore.for_dir(tmp_path, device=CARD)
    assert store.exists()
    sweep, tl = rows[0], rows[1]
    sim = sweep["n_accesses"] * sweep["n_configs"]
    assert store.rate("sweep_tlb", "cuda", 8) == pytest.approx(sim / sweep["t_cuda_s"])
    assert store.rate("sweep_tlb", "stackdist", 8) == pytest.approx(sim / sweep["t_stackdist_s"])
    assert store.rate("sweep_timeline", "cuda", 1) == pytest.approx(
        tl["n_accesses"] / tl["t_cuda_s"])
