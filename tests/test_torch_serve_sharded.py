"""The sharded serve step on a multi-rank gloo world on the CPU
(tests/_torch_worlds.py's ``serve`` world, 8 ranks): the JAX package's
sharded serve test (tests/test_distributed.py::
test_serve_step_sharded_lowers_and_runs: stablelm-12b's smoke config with
4-token pages, B 4, 12 decode steps, 4 partitions, pools
``P(None, "data", "model", ...)`` on a 2x4 ``("data", "model")`` mesh) run
through the port's ``make_serve_step`` on DTensors placed by
``shard_params(mode="serve")`` and ``shard_serve_inputs``, from the JAX
package's initial parameters and tokens:

* the logits at every step against JAX's sharded step on an Auto-axis mesh
  (2e-5 of the logits' scale, float32) and against the port's single-device
  step (1e-5: the merge sums the partitions in another order, so bit
  identity is not asked across ranks); the new pools against the
  single-device pools (1e-5 of their scale: a layer's rows are projections
  of the layer below's output);
* one traced step: no collective as large as one layer's local pool shard
  (a partition never reads another's pages), and the collectives
  ``CommDebugMode`` counts equal the ones the dry run's ``StepTrace`` sizes;
* zamba2-7b's smoke config (the hybrid family) through the registry's inputs
  on a 2x2 mesh against its single-device step (1e-5): a decode batch, conv
  and ssm state sharded on ``model``, and one long sequence whose
  partitions span both axes.
"""
import jax
import numpy as np
import pytest
import torch

import _torch_worlds as W
from repro.configs import registry as jreg
from repro.models import transformer as jtfm
from repro_torch.checkpoint import checkpoint as ckpt

JAX_TOL, SINGLE_TOL, HYBRID_TOL = 2e-5, 1e-5, 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_world")
    cfg = W.serve_cfg(jreg)
    B, T = W.SERVE["B"], W.SERVE["T"]
    params = jax.tree.map(np.asarray, jtfm.init(jax.random.PRNGKey(0), cfg))
    ckpt.save(out / "serve_init", 0, {"params": params})
    np.save(out / "serve_tokens.npy",
            np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, T), 0, cfg.vocab)))
    jax_ref = W.start([W.sys.executable, "-c", W.JAX_SERVE_REF, str(out)], W.jax_env())
    serve = W.start(W.world_cmd("serve", out), W.env())
    runs = {"serve": W.finish(serve, 360), "jax": W.finish(jax_ref, 300)}
    res = {"runs": runs}
    if (out / "serve.pt").exists():
        res["serve"] = torch.load(out / "serve.pt", weights_only=False)
    if (out / "jax_serve.npz").exists():
        res["jax"] = dict(np.load(out / "jax_serve.npz"))
    return res


def _need(world, name):
    run = world["runs"][name]
    assert name in world, f"the {name} run failed (rc {run.returncode}):\n{run.stderr[-4000:]}"
    return world[name]


def _gap(got, want) -> float:
    got, want = torch.as_tensor(np.asarray(got)).double(), torch.as_tensor(np.asarray(want))
    want = want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("t", range(W.SERVE["T"]))
def test_sharded_logits_match_jax_sharded_step(world, t):
    got = _need(world, "serve")["sharded"]["logits"][t]
    assert _gap(got, _need(world, "jax")["logits"][t]) <= JAX_TOL


@pytest.mark.parametrize("t", range(W.SERVE["T"]))
def test_sharded_logits_match_single_device(world, t):
    res = _need(world, "serve")
    assert _gap(res["sharded"]["logits"][t], res["single"]["logits"][t]) <= SINGLE_TOL


@pytest.mark.parametrize("pool", ["k_pools", "v_pools"])
def test_sharded_pools_match_single_device(world, pool):
    res = _need(world, "serve")
    got, want = res["sharded"][pool], res["single"][pool]
    assert got.shape == want.shape and bool(want.abs().sum() > 0)
    assert _gap(got, want) <= SINGLE_TOL


def test_placements_follow_the_serve_specs(world):
    res = _need(world, "serve")
    pool = "(Shard(dim=1), Shard(dim=2))"
    assert res["placements"]["k_pools"] == res["placements"]["v_pools"] == pool
    assert res["placements"]["tables"] == "(Shard(dim=0), Shard(dim=1))"
    assert res["placements"]["tokens"] == res["placements"]["ctx_len"] == \
        "(Shard(dim=0), Replicate())"
    # Each rank holds 2 of the 4 sequences and 1 of the 4 partitions.
    assert res["local_shapes"]["k_pools"][1:3] == (2, 1)
    assert res["sharded"]["logits_placements"] == "(Shard(dim=0), Shard(dim=1))"
    assert res["sharded"]["out_placements"] == {"k_pools": pool, "v_pools": pool}


def test_no_collective_is_pool_sized(world):
    traced = _need(world, "serve")["sharded"]["traced"]
    layer = traced["pool_layer_shard_bytes"]
    assert layer > 0 and traced["sizes"], traced
    assert [s for s in traced["sizes"] if s[1] >= layer] == [], (layer, traced["sizes"])
    # The merge's all-reduces over the partitions happen every layer.
    reduces = sum(1 for kind, _ in traced["sizes"] if kind == "all-reduce")
    assert reduces >= 3 * jreg.get_smoke(W.SERVE_ARCH).num_layers, traced["sizes"]


def test_comm_debug_mode_counts_the_traced_collectives(world):
    traced = _need(world, "serve")["sharded"]["traced"]
    assert traced["comm_total"] == len(traced["sizes"]) > 0, traced


HYBRID_PLACEMENTS = {
    "decode": {"conv_state": "(Shard(dim=2), Shard(dim=4))",
               "ssm_state": "(Shard(dim=2), Shard(dim=3))",
               "k_pools": "(Shard(dim=1), Shard(dim=2))"},
    "long_decode": {"conv_state": "(Replicate(), Replicate())",
                    "ssm_state": "(Replicate(), Replicate())",
                    "k_pools": "(Shard(dim=2), Shard(dim=2))"},
}


@pytest.mark.parametrize("what", ["logits", "conv_state", "ssm_state", "k_pools", "v_pools"])
@pytest.mark.parametrize("kind", sorted(W.HYBRID))
def test_hybrid_2x2_step_matches_single_device(world, kind, what):
    hyb = _need(world, "serve")["hybrid"][kind]
    for k, want in HYBRID_PLACEMENTS[kind].items():
        assert hyb["placements"][k] == want, (k, hyb["placements"])
    assert _gap(hyb["sharded"][what], hyb["single"][what]) <= HYBRID_TOL
