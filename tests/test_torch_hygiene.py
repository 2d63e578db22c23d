"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` use
neither JAX nor the JAX package, and an entry point left at its default
device raises on a machine without a card instead of running on the CPU."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_importing_every_module_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20


_FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+jax(lib)?\b", re.M),
    re.compile(r"^\s*from\s+repro(\.|\s)", re.M),
    re.compile(r"^\s*import\s+repro(\.|\s|$)", re.M),
    re.compile(r"\brepro\.(core|kernels|runtime|models)\b"),
]


def test_source_scan_finds_no_jax_or_reference_imports():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        text = f.read_text()
        for pat in _FORBIDDEN:
            m = pat.search(text)
            assert m is None, f"{f.relative_to(ROOT)}: {m.group(0)!r}"


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    from repro_torch.bench import fig2, fig6, fig8, fig9, fig10
    from repro_torch.core import pagetable, sweep, tlbsim
    from repro_torch.core.sparta import TLBConfig

    lines = np.arange(100, dtype=np.int64)
    with pytest.raises(RuntimeError, match="cuda"):
        sweep.sweep_tlb(lines, [sweep.TLBSweepSpec(TLBConfig(), page_shift=12)])
    with pytest.raises(RuntimeError, match="cuda"):
        sweep.sweep_system(lines, [tlbsim.SystemSimConfig()])
    with pytest.raises(RuntimeError, match="cuda"):
        sweep.SystemSweepStream([tlbsim.SystemSimConfig()])
    with pytest.raises(RuntimeError, match="cuda"):
        tlbsim.simulate_tlb(lines, TLBConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        fig10.run(n_ops=10, verbose=False)
    with pytest.raises(RuntimeError, match="cuda"):
        fig2.run(n_ops=10, verbose=False)
    with pytest.raises(RuntimeError, match="cuda"):
        fig6.run(n_ops=10, verbose=False)
    with pytest.raises(RuntimeError, match="cuda"):
        fig8.run(n_ops=10, verbose=False)
    with pytest.raises(RuntimeError, match="cuda"):
        fig9.run(n_ops=10, verbose=False)
    with pytest.raises(RuntimeError, match="cuda"):
        pagetable.page_fault_curve(lines, [4, 8])


def test_scheduler_modules_load_no_jax_and_default_to_the_card():
    """The shard scheduler, the smoke that SIGKILLs its workers and the fault
    seams those workers unpickle load no JAX; the scheduler's sharded entry
    points and the routed figures left at their default device raise
    without a card, before any worker is started."""
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, repro_torch.core.scheduler, "
         "repro_torch.bench.smoke_sched, repro_torch.bench.faultinject, "
         "repro_torch.bench.fig11, repro_torch.bench.fig5; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stdout + proc.stderr
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    import multiprocessing

    from repro_torch.bench import fig5, fig11
    from repro_torch.core import scheduler, sweep, tlbsim
    from repro_torch.core.sparta import TLBConfig

    lines = np.arange(100, dtype=np.int64)
    sched = scheduler.ScheduleConfig(workers=2, executor="process")
    specs = [sweep.TLBSweepSpec(TLBConfig(), num_partitions=p, page_shift=12) for p in (1, 2)]
    with pytest.raises(RuntimeError, match="cuda"):
        scheduler.run_sweep_tlb(lines, specs, sched=sched)
    with pytest.raises(RuntimeError, match="cuda"):
        scheduler.run_sweep_system(lines, [tlbsim.SystemSimConfig()] * 2, sched=sched)
    with pytest.raises(RuntimeError, match="cuda"):
        fig11.run(n_ops=10, cap=100, verbose=False, sched=sched)
    with pytest.raises(RuntimeError, match="cuda"):
        fig5.run(n_ops=10, tl_cap=100, verbose=False)
    assert not multiprocessing.active_children()


def test_serving_entry_points_default_to_the_card():
    """``SpartaEngine``, ``models.init`` and ``launch.serve`` left at their
    default device raise without a card; the serving modules load no JAX."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    from repro_torch import models
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.serve.engine import SpartaEngine

    cfg = registry.get_smoke("qwen3-14b")
    params = models.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        SpartaEngine(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        models.init(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--requests", "1"])
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, repro_torch.launch.serve, repro_torch.serve.engine; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stdout + proc.stderr


def test_serving_family_modules_load_no_jax_and_default_to_the_card():
    """The MoE, VLM and whisper families, the global-view paged attention,
    the serve step and the registry's shape cells load no JAX; the families'
    ``init`` left at its default device raises without a card."""
    mods = ("repro_torch.models.moe", "repro_torch.models.vlm", "repro_torch.models.whisper",
            "repro_torch.models.paged_global", "repro_torch.serve.serve_step",
            "repro_torch.configs.registry")
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys, {', '.join(mods)}; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stdout + proc.stderr
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    from repro_torch import models
    from repro_torch.configs import registry

    for arch in ("qwen3-moe-30b-a3b", "internvl2-2b", "whisper-medium"):
        with pytest.raises(RuntimeError, match="cuda"):
            models.init(registry.get_smoke(arch))


def test_benchtime_measures_and_refuses_cpu_metadata():
    from repro_torch.core import benchtime

    calls = []
    m = benchtime.measure(lambda x: calls.append(x) or x * 2, 21, reps=3, warmup=2)
    assert len(calls) == 5 and m.result == 42 and len(m.times_s) == 3
    assert m.best_s == min(m.times_s) and m.spread_frac >= 0.0
    with pytest.raises(ValueError):
        benchtime.measure(lambda: None, reps=0)
    if torch.cuda.is_available():
        pytest.skip("a card is present; device_metadata describes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchtime.device_metadata()


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_training_modules_load_no_jax_and_default_to_the_card():
    """The loss, optimizer, train step, data pipeline, pytree checkpoints,
    training loop and launcher load no JAX; ``launch.train`` and
    ``opt_state_from_numpy`` left at their default device raise without a
    card."""
    mods = ("repro_torch.models.losses", "repro_torch.train.optimizer",
            "repro_torch.train.train_step", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.checkpoint", "repro_torch.runtime.fault_tolerance",
            "repro_torch.launch.train", "repro_torch.convert")
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys, {', '.join(mods)}; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'jaxlib', 'repro', 'ml_dtypes')))"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stdout + proc.stderr
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    from repro_torch import convert
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "qwen3-14b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        convert.opt_state_from_numpy({"m": {}, "v": {}, "step": np.int32(0)})


def test_distributed_modules_load_no_jax_and_default_to_the_card(tmp_path):
    """The mesh, sharding, compression, collectives, pipeline and elastic
    modules load no JAX; ``make_mesh``, ``make_production_mesh``,
    ``elastic_restore`` and ``launch.train --mesh`` left at their default
    device raise without a card, before any process group starts."""
    mods = ("repro_torch.launch.mesh", "repro_torch.distributed.sharding",
            "repro_torch.distributed.compression", "repro_torch.distributed.collectives",
            "repro_torch.distributed.pipeline", "repro_torch.runtime.elastic")
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys, {', '.join(mods)}; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stdout + proc.stderr
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    import torch.distributed as dist

    from repro_torch import models
    from repro_torch.configs import registry
    from repro_torch.launch import mesh, train
    from repro_torch.runtime import elastic
    from repro_torch.train.optimizer import init_state

    with pytest.raises(RuntimeError, match="cuda"):
        mesh.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "qwen3-14b", "--smoke", "--steps", "1", "--mesh", "1x1",
                    "--ckpt", str(tmp_path)])
    cfg = registry.get_smoke("qwen3-14b")
    params = models.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        elastic.elastic_restore(tmp_path, cfg, elastic.plan_remesh(1, model_axis=1),
                                {"params": params, "opt_state": init_state(params)})
    assert not dist.is_initialized()


def test_make_mesh_checks_the_world_size():
    """A mesh of the wrong size for the world names both sizes; the
    one-rank CPU world ``make_mesh`` starts is gloo's, and ``destroy``
    tears it down."""
    code = (
        "import torch.distributed as dist\n"
        "from repro_torch.launch import mesh\n"
        "try:\n"
        "    mesh.make_production_mesh(device='cpu')\n"
        "except ValueError as e:\n"
        "    print('refused:', e)\n"
        "m = mesh.make_mesh((1, 1), ('data', 'model'), device='cpu')\n"
        "print(tuple(m.mesh_dim_names), tuple(m.mesh.shape), dist.get_backend())\n"
        "mesh.destroy()\n"
        "print(dist.is_initialized())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == [
        "refused: a 16x16 mesh needs 256 ranks; the world has 1",
        "('data', 'model') (1, 1) gloo", "False"], proc.stdout


def test_bench_modules_load_no_jax_and_default_to_the_card(tmp_path):
    """The benchmark entry point, the kernel benches, the band gate and the
    roofline load no JAX; the entry point, the kernel benches and the history's
    stamp left at their default device raise without a card."""
    mods = ("repro_torch.bench.run", "repro_torch.bench.kernel_bench",
            "repro_torch.bench.perfcheck", "repro_torch.bench.roofline")
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys, {', '.join(mods)}; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro', "
         "'benchmarks')))"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stdout + proc.stderr
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    import logging

    from repro_torch.bench import kernel_bench, run

    root = logging.getLogger("repro_torch")
    saved = (root.level, list(root.handlers), root.propagate)
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            run.main(["--quick", "--only", "fig7", "--cache-dir", str(tmp_path)])
    finally:   # main's narration handler stops propagation to caplog's root
        root.setLevel(saved[0])
        root.handlers[:] = saved[1]
        root.propagate = saved[2]
    with pytest.raises(RuntimeError, match="cuda"):
        kernel_bench.run(quick=True, history=tmp_path / "h.json", calibration_dir=tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        kernel_bench.main(["--quick", "--history", str(tmp_path / "h.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_bench.append_entry({"bench": "sweep"}, tmp_path / "h.json")
    assert not (tmp_path / "h.json").exists()
