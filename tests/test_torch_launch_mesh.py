"""``python -m repro_torch.launch.train --mesh`` on the CPU: the launcher
under ``torchrun`` with 4 gloo ranks on a 2x2 ``("data", "model")`` mesh
exits 0, prints the JAX launcher's lines once (rank 0 only), and its lines
and its checkpoints equal those of the same command without ``--mesh`` on
one process (losses as printed, to the last printed digit; in the
checkpoints of steps 1 and 3 the moments within 1e-4 (m) and 2e-4 (v) of
each leaf's scale and the parameters within lr / 10 absolute: AdamW moves
an element by about lr whatever its gradient's size, so an element whose
gradient is at the level of rounding moves by a share of lr either way, the
rule the single-device port's card-against-CPU check uses).  Each run has
its own time limit (tests/_torch_worlds.py)."""
import re
import sys

import numpy as np
import pytest

import _torch_worlds as W
from repro_torch.checkpoint import checkpoint as ckpt

LR = 3e-3
ARGS = ["--arch", "qwen3-14b", "--smoke", "--steps", "3", "--device", "cpu", "--lr", str(LR)]
TOL = {"m": 1e-4, "v": 2e-4}          # of the leaf's scale
PARAMS_ABS = LR / 10


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("launch")
    mesh = W.start([sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *ARGS,
                    "--mesh", "2x2", "--ckpt", str(out / "mesh")], W.env())
    single = W.start([sys.executable, "-m", "repro_torch.launch.train", *ARGS,
                      "--ckpt", str(out / "single")], W.env())
    return {"mesh": W.finish(mesh, 300), "single": W.finish(single, 300), "dir": out}


def _lines(run, root):
    return [ln.replace(str(root), "<ckpt>") for ln in run.stdout.splitlines()]


def test_mesh_launcher_exits_zero_and_prints_once(runs):
    for name in ("mesh", "single"):
        run = runs[name]
        assert run.returncode == 0, (name, run.stdout, run.stderr[-4000:])
    lines = _lines(runs["mesh"], runs["dir"] / "mesh")
    assert sum(ln.startswith("done at step 3") for ln in lines) == 1, lines
    assert sum(ln.startswith("step 0: loss") for ln in lines) == 1, lines


def test_mesh_launcher_lines_equal_the_single_device_run(runs):
    got = _lines(runs["mesh"], runs["dir"] / "mesh")
    want = _lines(runs["single"], runs["dir"] / "single")
    assert len(got) == len(want) == 2, (got, want)
    num = re.compile(r"[-+]?\d+\.\d+(?:e[-+]\d+)?")
    for a, b in zip(got, want):
        assert num.sub("#", a) == num.sub("#", b), (a, b)
        for x, y in zip(num.findall(a), num.findall(b)):
            digits = len(y.split(".")[1].split("e")[0])
            assert abs(float(x) - float(y)) <= 10.0 ** -digits * (
                10 ** int(y.split("e")[1]) if "e" in y else 1), (a, b)


@pytest.mark.parametrize("step", [1, 3])
def test_mesh_launcher_checkpoints_equal_the_single_device_run(runs, step):
    got, s1 = ckpt.restore(runs["dir"] / "mesh", step=step)
    want, s2 = ckpt.restore(runs["dir"] / "single", step=step)
    assert s1 == s2 == step and sorted(got) == sorted(want)
    assert int(got["opt_state::step"]) == step
    for k, w in want.items():
        w, g = np.asarray(w, np.float64), np.asarray(got[k], np.float64)
        assert g.shape == w.shape, k
        err = float(np.abs(g - w).max())
        if k.startswith("params::"):
            assert err <= PARAMS_ABS, k
        elif k != "opt_state::step":
            assert err <= TOL[k.split("::")[1]] * max(float(np.abs(w).max()), 1e-30), k
