"""The port's examples (``repro_torch.examples``) on the CPU, held to the JAX
package's ``examples/``:

* **quickstart**: the JAX example's printed lines, and the numbers behind
  them, equal to the port's exactly (the simulators are bit-identical), and
  both equal to ``tests/data/torch_golden_examples.json``, which
  ``chip_smoke.py`` holds the card's run to.  The port's plain LRU versions
  take ~70 (``tlb_sim``) and ~270 (``system_sim``) µs an access on this CPU,
  ~9 min for the example's 640,000-access trace, so here the wrappers' plain
  versions are replaced by :func:`_tlb_carry_model` /
  :func:`_system_carry_model`, the same LRU walk in plain Python lists; both
  are held bit for bit (hits and carried state) to the port's plain versions
  on a prefix of every call the example makes.  On the card the kernels run
  the whole trace.
* **serve_paged**: the JAX example run in this process, and the port's
  with the JAX example's initial parameters carried across
  (``convert.params_from_numpy``): the same generated tokens for every
  request (float32), the same printed lines but the wall time.
* **train_distributed** at 6 steps, a checkpoint every 3, on its 2 x 4 gloo
  world: each step's loss within 1e-5 and gradient norm within 1e-4
  (relative) of the JAX package's sharded step on an Auto-axis 2 x 4 mesh
  (the example's optimizer, data and initial parameters; JAX's own example
  fails on this jax, ROADMAP.md §3) — the train world's tolerances
  (``tests/test_torch_distributed.py``); the loss falls; the elastic
  restore onto 1 x 4 takes the last checkpoint, bit for bit the trained
  state.
"""
import contextlib
import dataclasses
import io
import json
import pathlib
import re
import runpy
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import _torch_worlds as W
import torch_golden
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.examples import quickstart, serve_paged
from repro_torch.kernels.system_sim import ops as k2ops
from repro_torch.kernels.tlb_sim import ops as k1ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
PREFIX = 3_000                       # accesses on which the Python model meets the plain version
TRAIN_STEPS, TRAIN_EVERY = 6, 3
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4      # the train world's (tests/test_torch_distributed.py)
WALL = re.compile(r" \([0-9.]+s\)$")


# -- quickstart ------------------------------------------------------------------

def _probe(row_tags: list, row_last: list, t: int, now: int) -> bool:
    """One LRU probe of a set row, in place: the first matching way on a hit,
    else the first least-recently-used way, takes the tag and the stamp (the
    plain versions' ``lru_probe``)."""
    try:
        way, hit = row_tags.index(t), True
    except ValueError:
        way, hit = row_last.index(min(row_last)), False
    row_tags[way], row_last[way] = t, now
    return hit


def _tlb_carry_model(set_idx, tag, tags, last, now0):
    """``tlb_sim_batched_carry_ref`` in plain Python: (hits, tags', last')."""
    T, La, hits = tags.tolist(), last.tolist(), []
    for b, (sets, ts) in enumerate(zip(set_idx.tolist(), tag.tolist())):
        tb, lb = T[b], La[b]
        hits.append([_probe(tb[s], lb[s], t, now0 + j + 1)
                     for j, (s, t) in enumerate(zip(sets, ts))])
    as32 = lambda x: torch.tensor(x, dtype=torch.int32).view(tags.shape)
    return torch.tensor(hits, dtype=torch.bool).view(set_idx.shape), as32(T), as32(La)


def _system_carry_model(inputs, flags, state, now0):
    """``system_sim_batched_carry_ref`` in plain Python: a structure is probed
    (and updated) only where it applies the access, as the plain version's
    ``update`` masks do; an unapplied probe's bit is never read."""
    st = [s.tolist() for s in state]
    cols = [x.tolist() for x in inputs]
    out = ([], [], [])
    for b, (has_c, has_a, miss_only) in enumerate(flags.tolist()):
        ct, cl, at, al, mt, ml = (s[b] for s in st)
        hits = ([], [], [])
        for j, (cs, cg, as_, ag, ms, mg) in enumerate(zip(*(c[b] for c in cols))):
            now = now0 + j + 1
            c_hit = bool(has_c) and _probe(ct[cs], cl[cs], cg, now)
            do_a = bool(has_a) and (not miss_only or not c_hit)
            a_hit = bool(has_a) and (not do_a or _probe(at[as_], al[as_], ag, now))
            m_hit = c_hit or _probe(mt[ms], ml[ms], mg, now)
            for h, x in zip(hits, (c_hit, a_hit, m_hit)):
                h.append(x)
        for o, h in zip(out, hits):
            o.append(h)
    B, L = inputs[0].shape
    return (tuple(torch.tensor(h, dtype=torch.bool).view(B, L) for h in out),
            tuple(torch.tensor(s, dtype=torch.int32).view(x.shape) for s, x in zip(st, state)))


@pytest.fixture(scope="module")
def jax_quickstart():
    return torch_golden.jax_quickstart()


@pytest.fixture(scope="module")
def port_quickstart():
    calls = {"tlb_sim": [], "system_sim": []}

    def tlb(set_idx, tag, tags, last, now0):
        calls["tlb_sim"].append((set_idx, tag, tags, last, now0))
        return _tlb_carry_model(set_idx, tag, tags, last, now0)

    def system(inputs, flags, state, now0):
        calls["system_sim"].append((inputs, flags, state, now0))
        return _system_carry_model(inputs, flags, state, now0)

    real = k1ops.tlb_sim_batched_carry_ref, k2ops.system_sim_batched_carry_ref
    k1ops.tlb_sim_batched_carry_ref, k2ops.system_sim_batched_carry_ref = tlb, system
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            res = quickstart.main(["--device", "cpu"])
    finally:
        k1ops.tlb_sim_batched_carry_ref, k2ops.system_sim_batched_carry_ref = real
    return {"result": res, "stdout": out.getvalue(), "calls": calls}


def test_golden_file_is_the_jax_quickstart(jax_quickstart):
    golden = json.loads(torch_golden.GOLDEN_EXAMPLES.read_text())["quickstart"]
    assert golden == jax_quickstart


def test_quickstart_prints_the_jax_lines(jax_quickstart, port_quickstart):
    assert port_quickstart["stdout"].splitlines() == jax_quickstart["lines"]
    assert port_quickstart["result"]["lines"] == jax_quickstart["lines"]


@pytest.mark.parametrize("key", ["accesses", "miss_ratio", "speedup", "ideal_speedup",
                                 "overhead_conventional", "overhead_sparta",
                                 "overhead_reduction"])
def test_quickstart_numbers_equal_jax(jax_quickstart, port_quickstart, key):
    assert port_quickstart["result"][key] == jax_quickstart[key]    # exact


def test_quickstart_goes_through_tlb_sim_and_system_sim(port_quickstart):
    calls = port_quickstart["calls"]
    assert [c[0].shape for c in calls["tlb_sim"]] == [(1, 640_000)] * 4
    assert [(c[0][0].shape, c[1].tolist()) for c in calls["system_sim"]] == [
        ((1, 640_000), [[1, 1, 1]]), ((1, 640_000), [[1, 0, 1]])]


@pytest.mark.parametrize("i", range(6))
def test_python_lru_model_equals_the_plain_version(port_quickstart, i):
    """The model that stood in for the plain versions above, bit for bit
    against them on each of the example's calls cut to its first accesses."""
    from repro_torch.kernels.system_sim.ref import system_sim_batched_carry_ref
    from repro_torch.kernels.tlb_sim.ref import tlb_sim_batched_carry_ref

    calls = port_quickstart["calls"]
    if i < 4:
        set_idx, tag, tags, last, now0 = calls["tlb_sim"][i]
        args = (set_idx[:, :PREFIX], tag[:, :PREFIX], tags, last, now0)
        got, want = _tlb_carry_model(*args), tlb_sim_batched_carry_ref(*args)
        assert got[0].any() and not got[0].all()
    else:
        inputs, flags, state, now0 = calls["system_sim"][i - 4]
        args = (tuple(x[:, :PREFIX] for x in inputs), flags, state, now0)
        (gh, gs), (wh, ws) = _system_carry_model(*args), system_sim_batched_carry_ref(*args)
        got, want = list(gh) + list(gs), list(wh) + list(ws)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# -- serve_paged -----------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_runs():
    from repro_torch.convert import params_from_numpy

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        g = runpy.run_path(str(ROOT / "examples" / "serve_paged.py"), run_name="__main__")
    jax_run = {"lines": out.getvalue().splitlines(),
               "generated": {rid: [int(x) for x in r.generated]
                             for rid, r in g["eng"].finished.items()}}
    cfg = serve_paged.config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(g["cfg"])
    tree = jax.tree.map(np.asarray, g["params"])      # tfm.init(PRNGKey(0), cfg)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port = serve_paged.main(["--device", "cpu"],
                                params=params_from_numpy(tree, cfg, device="cpu"))
    return {"jax": jax_run, "port": port, "port_stdout": out.getvalue().splitlines()}


def test_serve_paged_generates_the_jax_tokens(serve_runs):
    jx, port = serve_runs["jax"]["generated"], serve_runs["port"]["generated"]
    assert len(jx) == 11 and port == jx


def test_serve_paged_prints_the_jax_lines(serve_runs):
    strip = lambda lines: [WALL.sub("", ln) for ln in lines]
    assert strip(serve_runs["port_stdout"]) == strip(serve_runs["jax"]["lines"])
    assert serve_runs["port"]["lines"] == serve_runs["port_stdout"]
    assert "served 8 requests / 96 tokens in 21 engine steps" in serve_runs["port_stdout"][1]


def test_serve_paged_numbers(serve_runs):
    port = serve_runs["port"]
    assert port["free_pages"] == [56, 56, 57, 64]
    assert port["fork_pages"] == 0 and port["invariants"]
    assert (port["requests"], port["tokens"], port["steps"]) == (8, 96, 21)
    assert port["branches"] == {8: 6, 9: 6, 10: 6}


# -- train_distributed -----------------------------------------------------------

JAX_TRAIN_REF = textwrap.dedent(r"""
    import sys, pathlib
    import jax, numpy as np, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro import models
    from repro.configs import registry
    from repro.data.pipeline import DataConfig, batch_for_model
    from repro.distributed import sharding as shd
    from repro.train.optimizer import OptimizerConfig, init_state
    from repro.train.train_step import make_train_step

    out, steps = pathlib.Path(sys.argv[1]), int(sys.argv[2])
    cfg = registry.get_smoke("qwen3-14b")
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    params = models.init(jax.random.PRNGKey(0), cfg)
    opt = init_state(params)
    named = lambda specs: jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                       is_leaf=lambda x: isinstance(x, P))
    nps = named(shd.param_specs(params, cfg, mode="train"))
    nos = named(shd.opt_state_specs(params, cfg))
    bs = NamedSharding(mesh, P("data", None))
    p = jax.tree.map(jax.device_put, params, nps)
    o = jax.tree.map(jax.device_put, opt, nos)
    step = jax.jit(make_train_step(cfg, OptimizerConfig(lr=3e-3, warmup_steps=5,
                                                        total_steps=steps)),
                   in_shardings=(nps, nos, bs), out_shardings=(nps, nos, None))
    data = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
    loss, norm = [], []
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in batch_for_model(data, cfg, i).items()}
        p, o, m = step(p, o, b)
        loss.append(float(m["loss"]))
        norm.append(float(m["grad_norm"]))
    np.savez(out / "jax_train_example.npz", loss=np.array(loss), grad_norm=np.array(norm))
""")

PORT_TRAIN = ("import json, sys\n"
              "from repro_torch.examples import train_distributed\n"
              "res = train_distributed.main(sys.argv[3:], init_dir=sys.argv[2])\n"
              "open(sys.argv[1], 'w').write(json.dumps(res))\n")


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    from repro import models as jmodels
    from repro.configs import registry as jreg

    out = tmp_path_factory.mktemp("train_example")
    params = jax.tree.map(np.asarray, jmodels.init(jax.random.PRNGKey(0),
                                                   jreg.get_smoke("qwen3-14b")))
    ckpt.save(out / "init", 0, {"params": params})
    jax_ref = W.start([sys.executable, "-c", JAX_TRAIN_REF, str(out), str(TRAIN_STEPS)],
                      W.jax_env())
    port = W.start([sys.executable, "-c", PORT_TRAIN, str(out / "port.json"), str(out / "init"),
                    "--device", "cpu", "--steps", str(TRAIN_STEPS),
                    "--checkpoint-every", str(TRAIN_EVERY), "--ckpt", str(out / "ckpt")], W.env())
    runs = {"port": W.finish(port, 400), "jax": W.finish(jax_ref, 400)}
    res = {"runs": runs, "ckpt": out / "ckpt"}
    if (out / "port.json").exists():
        res["port"] = json.loads((out / "port.json").read_text())
    if (out / "jax_train_example.npz").exists():
        res["jax"] = dict(np.load(out / "jax_train_example.npz"))
    return res


def _need(runs, name):
    run = runs["runs"][name]
    assert name in runs, f"the {name} run failed (rc {run.returncode}):\n{run.stderr[-4000:]}"
    return runs[name]


@pytest.mark.parametrize("i", range(TRAIN_STEPS))
def test_train_distributed_steps_match_jax(train_runs, i):
    port, jx = _need(train_runs, "port"), _need(train_runs, "jax")
    loss, want = port["losses"][i], float(jx["loss"][i])
    assert abs(loss - want) <= LOSS_TOL * abs(want), (loss, want)
    norm, want = port["grad_norms"][i], float(jx["grad_norm"][i])
    assert abs(norm - want) <= GRAD_TOL * want, (norm, want)


def test_train_distributed_prints_the_jax_lines(train_runs):
    port = _need(train_runs, "port")
    lines = port["lines"]
    assert lines[0] == "mesh {'data': 2, 'model': 4}; arch family=dense"
    assert re.fullmatch(rf"steps={TRAIN_STEPS} loss \d+\.\d{{3}} -> \d+\.\d{{3}} "
                        r"\(mean step \d+\.\d{2}s\)", lines[1]), lines[1]
    assert lines[2] == (f"elastic restart: restored step {TRAIN_STEPS} onto mesh (1, 4) "
                        "(1 spare devices)")
    assert port["losses"][-1] < port["losses"][0]


def test_train_distributed_elastic_restore_is_the_last_checkpoint(train_runs):
    port = _need(train_runs, "port")
    assert port["steps"] == TRAIN_STEPS
    assert port["restored_step"] == port["last_checkpoint_step"] == TRAIN_STEPS
    assert ckpt.latest_step(train_runs["ckpt"]) == TRAIN_STEPS
    assert (port["plan_shape"], port["spare_devices"]) == ([1, 4], 1)
    assert port["restore_bit_identical"] is True
