"""The port's distributed layer on real multi-rank gloo worlds on the CPU,
against the single-device port and the JAX package's sharded paths
(tests/_torch_worlds.py runs the worlds, each under its own time limit):

* the 2x4 ``("data", "model")`` sharded train step of qwen3-14b's smoke
  config (DTensor parameters, moments and batch placed by the sharding
  rules) against the single-device port and JAX's sharded step on an
  Auto-axis mesh: losses within 1e-5, step 1's gradients within 1e-4 of
  each leaf's scale, parameters after 1 and 3 steps within 1e-4 of scale
  (the tolerances the single-device port is held to); the step under an
  activation policy against the step without it, and the placements the
  constrained activations took;
* ``hierarchical_psum`` on 2x2x2 ``("pod", "data", "model")`` against the
  exact sum, a flat all-reduce and JAX's, bit for bit on integer-valued
  float32 leaves whose sizes do not divide the intra size;
* ``pipeline_apply`` over 4 stages against the sequential layers (1e-5) and
  JAX's (1e-6);
* a 2x4 checkpoint restored by ``elastic_restore`` on 2x2 and on one rank
  bit for bit (and read bit for bit by the JAX package), then one more step
  on 2x2 against one more single-device step from the same checkpoint.
"""
import time

import jax
import numpy as np
import pytest
import torch

import _torch_worlds as W
from repro import models as jmodels
from repro.checkpoint import checkpoint as jckpt
from repro.configs import registry as jreg
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.convert import stack_index

LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-4
PIPE_TOL, PIPE_JAX_TOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("worlds")
    params = jax.tree.map(np.asarray, jmodels.init(jax.random.PRNGKey(0), jreg.get_smoke(W.ARCH)))
    ckpt.save(out / "init", 0, {"params": params})
    jax_ref = W.start([W.sys.executable, "-c", W.JAX_REF, str(out)], W.jax_env())
    train = W.start(W.world_cmd("train", out), W.env())
    # The elastic world starts once the train world has committed its step-2
    # checkpoint (a rename), while the train world goes on.
    elastic = None
    deadline = time.monotonic() + 300
    while train.poll() is None and time.monotonic() < deadline:
        if ckpt.latest_step(out / "ckpt_2x4") == 2:
            elastic = W.start(W.world_cmd("elastic", out), W.env())
            break
        time.sleep(0.5)
    runs = {"train": W.finish(train, max(1.0, deadline + 120 - time.monotonic())),
            "jax": W.finish(jax_ref, 300)}
    if elastic is None and ckpt.latest_step(out / "ckpt_2x4") == 2:
        elastic = W.start(W.world_cmd("elastic", out), W.env())
    if elastic is not None:
        runs["elastic"] = W.finish(elastic, 300)
    res = {"dir": out, "runs": runs}
    for name in ("train", "elastic"):
        if (out / f"{name}.pt").exists():
            res[name] = torch.load(out / f"{name}.pt", weights_only=False)
    if (out / "jax_ref.npz").exists():
        res["jax"] = dict(np.load(out / "jax_ref.npz"))
    return res


def _need(worlds, name):
    run = worlds["runs"].get(name)
    key = "jax" if name == "jax" else name
    assert key in worlds, (f"the {name} run failed (rc {run and run.returncode}):\n"
                           f"{run and run.stderr[-4000:]}")
    return worlds[key]


def _jax_leaf(tree: dict, prefix: str, name: str) -> np.ndarray:
    leaf, idx = stack_index(name)
    a = tree[prefix + leaf.replace(".", "/")]
    return a[idx] if idx else a


def _gap(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.asarray(want)) if not isinstance(want, torch.Tensor) else want
    return float((got.double() - want.double()).abs().max() / want.double().abs().max()
                 .clamp_min(1e-30))


@pytest.mark.parametrize("i", range(W.STEPS))
def test_sharded_losses_match_single_device_and_jax(worlds, i):
    res, jx = _need(worlds, "train"), _need(worlds, "jax")
    got = res["sharded"]["metrics"][i]
    for ref in (res["single"]["metrics"][i],
                {"loss": float(jx[f"loss/{i}"]), "grad_norm": float(jx[f"grad_norm/{i}"])}):
        assert abs(got["loss"] - ref["loss"]) <= LOSS_TOL * abs(ref["loss"]), (got, ref)
        assert abs(got["grad_norm"] - ref["grad_norm"]) <= GRAD_TOL * ref["grad_norm"], (got, ref)


@pytest.mark.parametrize("ref", ["single", "jax"])
def test_sharded_step1_gradients_match(worlds, ref):
    res = _need(worlds, "train")
    got = res["sharded"]["grads"][0]
    jx = _need(worlds, "jax") if ref == "jax" else None
    worst = max((_gap(g, res["single"]["grads"][0][n] if jx is None
                      else _jax_leaf(jx, "grads1/", n)), n) for n, g in got.items())
    assert worst[0] <= GRAD_TOL, worst


@pytest.mark.parametrize("after", [1, 3])
@pytest.mark.parametrize("ref", ["single", "jax"])
def test_sharded_parameters_match(worlds, ref, after):
    res = _need(worlds, "train")
    got = res["sharded"]["params"][after - 1]
    jx = _need(worlds, "jax") if ref == "jax" else None
    worst = max((_gap(p, res["single"]["params"][after - 1][n] if jx is None
                      else _jax_leaf(jx, f"params{after}/", n)), n) for n, p in got.items())
    assert worst[0] <= PARAM_TOL, worst


def test_parameters_are_placed_by_the_rules(worlds):
    pl = _need(worlds, "train")["sharded"]["placements"]
    assert pl["embed"] == "(Shard(dim=1), Shard(dim=0))"          # [V, D]: (model, data)
    assert pl["layers.0.attn.wq"] == "(Shard(dim=0), Shard(dim=1))"
    assert pl["layers.1.mlp.w_down"] == "(Shard(dim=1), Shard(dim=0))"
    assert pl["final_norm.scale"] == "(Replicate(), Replicate())"


def test_activation_policy_step_equals_the_step_without_it(worlds):
    res = _need(worlds, "train")
    pol, ref = res["policy"], res["sharded"]
    assert abs(pol["metrics"]["loss"] - ref["metrics"][0]["loss"]) <= LOSS_TOL * ref[
        "metrics"][0]["loss"]
    assert max(_gap(g, ref["grads"][0][n]) for n, g in pol["grads"].items()) <= GRAD_TOL
    assert max(_gap(p, ref["params"][0][n]) for n, p in pol["params"].items()) <= PARAM_TOL
    # q's 4 heads over model (4 | 4), k/v's 2 replicated, the residual
    # stream's batch over data.
    assert set(pol["constrained"]) == {
        ("('data', None, None)", "(Shard(dim=0), Replicate())"),
        ("('data', None, 'model', None)", "(Shard(dim=0), Shard(dim=2))"),
        ("('data', None, None, None)", "(Shard(dim=0), Replicate())")}


@pytest.mark.parametrize("check", ["hier_vs_numpy", "hier_vs_flat", "wide_vs_numpy"])
def test_hierarchical_psum_is_exact(worlds, check):
    res = _need(worlds, "train")["psum"]
    assert res["all_ranks_ok"] == [1, 1, 1]
    assert [n for n, ok in res[check] if not ok] == []
    assert len(res[check]) == 3


def test_hierarchical_psum_equals_jax(worlds):
    res, jx = _need(worlds, "train")["psum"], _need(worlds, "jax")
    for name, got in res["same_input"].items():
        want = jx[f"psum/{name}"]
        assert got.numpy().tobytes() == want.tobytes(), name
        assert torch.equal(got, 4 * res["input"][name]), name     # pod 2 x data 2


@pytest.mark.parametrize("check", ["sequential", "jax", "every_rank", "stage_sharded"])
def test_pipeline_matches(worlds, check):
    res = _need(worlds, "elastic")["pipeline"]
    out = res["out"]
    assert tuple(out.shape) == (W.PIPE["M"], W.PIPE["mb"], W.PIPE["D"])
    if check == "sequential":
        assert float((out - res["sequential"]).abs().max()) < PIPE_TOL
    elif check == "jax":
        assert float((out - torch.from_numpy(_need(worlds, "jax")["pipeline"])).abs().max()) \
            < PIPE_JAX_TOL
    elif check == "every_rank":
        assert res["same_on_every_rank"]
    else:
        assert res["stage_sharded_equal"]


def test_saved_checkpoint_is_the_sharded_state_and_jax_reads_it(worlds):
    res = _need(worlds, "train")
    root = worlds["dir"] / "ckpt_2x4"
    flat, step = ckpt.restore(root)
    jflat, jstep = jckpt.restore(root)
    assert step == jstep == 2 and sorted(flat) == sorted(jflat)
    for k, a in flat.items():
        assert np.asarray(jflat[k]).tobytes() == np.asarray(a).tobytes(), k
    saved = res["saved"]
    for n, t in saved["params"].items():
        assert t.numpy().tobytes() == np.asarray(_jax_leaf(
            {k.replace("::", "/"): v for k, v in flat.items()}, "params/", n)).tobytes(), n
    for kind in ("m", "v"):
        for n, t in saved[kind].items():
            assert t.numpy().tobytes() == np.asarray(_jax_leaf(
                {k.replace("::", "/"): v for k, v in flat.items()},
                f"opt_state/{kind}/", n)).tobytes(), (kind, n)
    assert int(saved["step"]) == int(flat["opt_state::step"]) == 2


@pytest.mark.parametrize("where", ["restored_2x2", "restored_1"])
def test_elastic_restore_is_bit_identical(worlds, where):
    res = _need(worlds, "elastic")[where]
    assert res["step"] == 2 and res["differing"] == []
    assert res["mesh"] == ((2, 2) if where == "restored_2x2" else (1, 1))
    if where == "restored_1":
        assert res["world"] == 1
    else:
        pl = _need(worlds, "elastic")["restored_2x2"]["placements"]
        assert pl["embed"] == "(Shard(dim=1), Shard(dim=0))"


def test_elastic_restart_continues_like_the_single_device_run(worlds):
    res = _need(worlds, "elastic")
    got, ref = res["mesh_step"], res["single_step"]
    assert abs(got["metrics"]["loss"] - ref["metrics"]["loss"]) <= LOSS_TOL * ref["metrics"][
        "loss"]
    assert got["metrics"]["lr"] == ref["metrics"]["lr"]
    assert max(_gap(g, ref["grads"][n]) for n, g in got["grads"].items()) <= GRAD_TOL
    assert max(_gap(p, ref["params"][n]) for n, p in got["params"].items()) <= PARAM_TOL
