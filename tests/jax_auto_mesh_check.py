"""Run the bodies of the three multi-device tests of tests/test_distributed.py
on meshes with Auto axes, and print what each reports.

    PYTHONPATH=src python tests/jax_auto_mesh_check.py     # ~1 min on the CPU

On jax 0.9.0 ``jax.make_mesh`` (which ``repro.launch.mesh`` calls) gives
Explicit axes, and those tests fail under sharding-in-types.  Here each
body runs in a subprocess with 8 forced host devices, as the test file
runs it, with ``jax.make_mesh`` building Auto axes; nothing of the JAX
package or of the test file changes.  The train body's loss and largest
parameter difference are printed after its own checks.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

PRELUDE = textwrap.dedent("""
    import jax
    from jax.sharding import AxisType
    _make = jax.make_mesh
    jax.make_mesh = lambda shape, axes, **kw: _make(
        shape, axes, axis_types=(AxisType.Auto,) * len(tuple(axes)))
""")
SUFFIX = {
    "test_sharded_train_step_matches_single_device": textwrap.dedent("""
        print("loss", float(m1["loss"]), float(m2["loss"]),
              "largest parameter difference", max(jax.tree.leaves(d)))
    """),
}


def main() -> int:
    import test_distributed as td

    codes = {}
    for name in ("test_sharded_train_step_matches_single_device",
                 "test_serve_step_sharded_lowers_and_runs",
                 "test_pipeline_parallel_matches_sequential"):
        td._run_subprocess = lambda code, name=name: codes.setdefault(name, code)
        getattr(td, name)()
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    bad = 0
    for name, code in codes.items():
        src = PRELUDE + textwrap.dedent(code) + SUFFIX.get(name, "")
        r = subprocess.run([sys.executable, "-c", src], env=env, capture_output=True,
                           text=True, timeout=600)
        bad += r.returncode != 0
        print(f"{name}: rc {r.returncode}")
        print(textwrap.indent(r.stdout.strip() or r.stderr[-2000:], "  "), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
