"""The port's benchmark entry point (``python -m repro_torch.bench.run``) on the
CPU, against ``python -m benchmarks.run``:

* ``--quick --only fig7,fig6 --device cpu``: the same claim lines, the same
  summary count and exit code 0 as the JAX package's (both run in-process);
* the exit codes with stub figures: 0 with one claim out of band, 1 with
  two, 75 when a sweep is preempted, 79 (``EX_DEGRADED``) when a shard was
  quarantined;
* ``--explain-dispatch``: the cold-start tables, then, with a history of
  this device's kernel-bench rows, a table seeded from their rates and the
  decisions made from it;
* ``--gc``: expired calibration tables deleted, young and foreign files kept;
* the roofline table from dry-run records; the CPU's default list without
  ``kernels``, which needs the card.
"""
import json
import logging
import os
import re
import time
import types

import pytest
import torch

from benchmarks import run as jrun
from repro_torch.bench import common, run
from repro_torch.bench.common import Claim
from repro_torch.core import dispatch
from repro_torch.core.orchestrator import Preempted
from repro_torch.core.scheduler import EX_DEGRADED

CLAIM = re.compile(r"^\[(PASS|MISS)\] ")


@pytest.fixture(autouse=True)
def _narration_restored():
    """Each package's ``main`` installs its narration handler on its logger
    (``repro_torch``, ``repro``; on this test's captured stderr) and stops
    its propagation; later tests in this process read those records with
    caplog, through the root."""
    loggers = [logging.getLogger(name) for name in ("repro_torch", "repro")]
    saved = [(lg.level, list(lg.handlers), lg.propagate) for lg in loggers]
    yield
    for lg, (level, handlers, propagate) in zip(loggers, saved):
        lg.setLevel(level)
        lg.handlers[:] = handlers
        lg.propagate = propagate


def _claims(text):
    return [ln for ln in text.splitlines() if CLAIM.match(ln)]


def test_quick_figures_print_the_jax_packages_claims(tmp_path, capsys):
    rc = run.main(["--quick", "--only", "fig7,fig6", "--device", "cpu",
                   "--cache-dir", str(tmp_path), "--dryrun-dir", str(tmp_path / "none")])
    port = capsys.readouterr().out
    jrun.main(["--quick", "--only", "fig7,fig6"])
    jax = capsys.readouterr().out
    assert rc == 0
    assert _claims(port) == _claims(jax) and len(_claims(port)) == 2 * 4
    summary = [ln for ln in port.splitlines() if ln.endswith("claims in band")]
    assert summary == [ln for ln in jax.splitlines() if ln.endswith("claims in band")]
    assert summary == ["4/4 claims in band"]
    assert (tmp_path / "runlogs" / "fig7.jsonl").exists()


def _stub(monkeypatch, *behaviours):
    """Figures ``figA``, ``figB``, ... each doing one of ``behaviours``: a
    number of claims out of band, ``"preempt"`` or ``"degrade"``."""
    mods = {}
    for i, b in enumerate(behaviours):
        def run_fig(quick=False, *, device="cuda", _b=b, _i=i):
            if _b == "preempt":
                raise Preempted(None, 1, 2)
            if _b == "degrade":
                common._DEGRADED_RUNS.append(f"fig{_i}")
                return {"claims": [Claim(f"S{_i}", "ok", 1.0, (0, 2))]}
            return {"claims": [Claim(f"S{_i}.{j}", "stub", 1.0 if j >= _b else 5.0, (0, 2))
                               for j in range(3)]}
        mods[f"fig{i}"] = types.SimpleNamespace(run=run_fig)
    monkeypatch.setattr(run, "_modules", lambda: mods)
    monkeypatch.setattr(common, "_DEGRADED_RUNS", [])
    return ",".join(mods)


@pytest.mark.parametrize("behaviours,code", [((0, 1), 0), ((1, 1), 1), ((0, 2), 1),
                                             ((0, "preempt"), 75), ((0, "degrade"), EX_DEGRADED),
                                             ((2, "degrade"), 1)],
                         ids=["one-out", "two-out", "two-in-one", "preempt", "degraded",
                              "out-before-degraded"])
def test_exit_codes(monkeypatch, tmp_path, capsys, behaviours, code):
    only = _stub(monkeypatch, *behaviours)
    assert run.main(["--only", only, "--device", "cpu", "--cache-dir", str(tmp_path),
                     "--dryrun-dir", str(tmp_path)]) == code
    assert EX_DEGRADED == 79


def test_explain_dispatch_reads_the_history_it_is_given(tmp_path, capsys):
    assert run.main(["--explain-dispatch", "--device", "cpu",
                     "--cache-dir", str(tmp_path / "cold"), "--history",
                     str(tmp_path / "none.json")]) == 0
    cold = capsys.readouterr().out
    assert "cold_start" in cold and cold.count("<-- chosen") == 4
    row = {**dispatch.CPU_DEVICE, "schema_version": 2, "bench": "sweep", "quick": True,
           "n_accesses": 120_000, "n_configs": 8, "t_reference_s": 8.0, "t_stackdist_s": 0.5}
    hist = tmp_path / "history.json"
    hist.write_text(json.dumps({"history": [row]}))
    assert run.main(["--explain-dispatch", "--device", "cpu", "--cache-dir", str(tmp_path),
                     "--history", str(hist)]) == 0
    out = capsys.readouterr().out
    assert "measured:" in out
    sweep = [ln for ln in out.splitlines() if ln.startswith("sweep_tlb,")]
    assert f"sweep_tlb,stackdist,{120_000 * 8 / 0.5}," in "\n".join(sweep)
    assert any(ln.startswith("sweep_tlb,stackdist,") and ln.endswith("<-- chosen")
               for ln in sweep)
    assert (tmp_path / "calibration" / "calib-cpu.json").exists()


def test_gc_deletes_expired_calibration_tables(tmp_path, capsys):
    cal = tmp_path / "calibration"
    old = dispatch.CalibrationStore(cal / "calib-old.json", device=dispatch.CPU_DEVICE)
    old.record("sweep_tlb", "reference", 8, 1e6, weight=1e5)
    young = dispatch.CalibrationStore(cal / "calib-young.json", device=dispatch.CPU_DEVICE)
    young.record("sweep_tlb", "reference", 8, 1e6, weight=1e5)
    (cal / "notes.txt").write_text("not a table")
    past = time.time() - 3600
    for p in (cal / "calib-old.json", cal / "notes.txt"):
        os.utime(p, (past, past))
    assert run.main(["--gc", "--gc-age-s", "60", "--cache-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"deleted,{cal / 'calib-old.json'}" in out
    assert f"kept_young,{cal / 'calib-young.json'}" in out
    assert f"skipped_foreign,{cal / 'notes.txt'}" in out
    assert not (cal / "calib-old.json").exists() and (cal / "calib-young.json").exists()


def test_roofline_table_prints_from_dry_run_records(monkeypatch, tmp_path, capsys):
    from repro_torch.configs import registry

    rec = {"arch": "qwen3-14b", "shape": "train_4k", "mesh": "16x16", "chips": 256, "ok": True,
           "flops": 3.1e15, "flops_scope": "device", "collective_bytes": {"all-gather": 2e11},
           "param_count": registry.get_config("qwen3-14b").param_count()}
    (tmp_path / "qwen3-14b__train_4k__16x16.json").write_text(json.dumps(rec))
    only = _stub(monkeypatch, 0)
    assert run.main(["--only", only, "--device", "cpu", "--cache-dir", str(tmp_path / "c"),
                     "--dryrun-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "# Roofline (16x16" in out and "\nqwen3-14b,train_4k," in out


def test_kernels_run_on_the_card_only(tmp_path):
    assert "kernels" in run.FIGS
    if torch.cuda.is_available():
        pytest.skip("a card is present; the kernel benches would run")
    with pytest.raises(RuntimeError, match="card"):
        run.main(["--only", "kernels", "--device", "cpu", "--cache-dir", str(tmp_path)])
