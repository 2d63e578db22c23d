"""The vocab-parallel chunked loss and the last-position prefill on gloo
worlds on the CPU (tests/_torch_worlds.py's ``vocab`` world), against the
single-device port and the JAX package:

* ``chunked_cross_entropy`` on random float32 inputs — T = 13 over 4-token
  blocks (a padded last block), −1 labels (a row's tail all −1), a
  250-word vocabulary that model=4 splits 63/63/63/61 and labels drawn
  seven times in ten from the first shard — on a 2x4 ``("data", "model")``
  mesh with the head in train placements (D over data, V over model): the
  loss within 1e-5 and the gradients of hidden and head within 1e-4 of
  their scale of the single-device port's and of JAX's (the tolerances of
  tests/test_torch_distributed.py's sharded losses); on a 1 x 1 mesh the
  single-device port's loss and gradients bit for bit;
* ``make_prefill_step`` (the last position unembedded) on 2x4 from the JAX
  package's initial parameters, for a dense config whose 6 query heads
  split 2/2/2/0 over model=4 (a rank attends no head) and for the MoE,
  RWKV6 and Zamba2 smoke configs (their scans on each rank's batch rows and
  heads): the logits placed (data, model) as the JAX dry run's
  ``out_shardings``, within 1e-5 of their scale of the single-device
  step's, and within 1e-4 (the transformer tests' tolerance, absolute and
  relative) of JAX's ``make_prefill_step`` jitted on an Auto-axis 2x4 mesh;
* the RWKV6 and Zamba2 losses and gradients on 2x4 against the
  single-device port's, at the sharded losses' tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_worlds as W
from repro import models as jmodels
from repro.configs import registry as jreg
from repro.models.losses import chunked_cross_entropy as jchunked
from repro_torch.checkpoint import checkpoint as ckpt

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
PREFILL_TOL, PREFILL_JAX_TOL = 1e-5, 1e-4


def _loss_inputs():
    g = np.random.default_rng(27)
    B, T, D, V = (W.VOCAB_LOSS[k] for k in ("B", "T", "D", "V"))
    shard = -(-V // 4)
    labels = np.where(g.random((B, T)) < 0.7, g.integers(0, shard, (B, T)),
                      g.integers(shard, V, (B, T)))
    labels[g.random((B, T)) < 0.2] = -1
    labels[-1, -5:] = -1
    return {"hidden": g.standard_normal((B, T, D)).astype(np.float32),
            "head": (g.standard_normal((D, V)) * 0.5).astype(np.float32),
            "labels": labels.astype(np.int32)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("vocab_world")
    np.savez(out / "vocab_loss.npz", **_loss_inputs())
    np.save(out / "prefill_tokens.npy",
            np.random.default_rng(28).integers(0, 256, (W.PREFILL_B, W.PREFILL_T))
            .astype(np.int32))
    for kind in W.PREFILL_ARCHS:
        params = jax.tree.map(np.asarray, jmodels.init(jax.random.PRNGKey(0),
                                                       W.prefill_cfg(jreg, kind)))
        ckpt.save(out / f"prefill_{kind}", 0, {"params": params})
    jax_ref = W.start([W.sys.executable, "-c", W.JAX_VOCAB_REF, str(out)], W.jax_env())
    run = W.run_world(W.world_cmd("vocab", out), 300, W.env())
    jrun = W.finish(jax_ref, 300)
    res = {"run": run, "jax_run": jrun}
    if (out / "vocab.pt").exists():
        res["port"] = torch.load(out / "vocab.pt", weights_only=False)
    if (out / "jax_vocab.npz").exists():
        res["jax"] = dict(np.load(out / "jax_vocab.npz"))
    return res


def _need(world, key):
    run = world["jax_run" if key == "jax" else "run"]
    assert key in world, f"the {key} run failed (rc {run.returncode}):\n{run.stderr[-4000:]}"
    return world[key]


def _gap(got, want) -> float:
    got, want = torch.as_tensor(np.array(got)), torch.as_tensor(np.array(want))
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def _jax_loss():
    x = _loss_inputs()
    loss, (gh, gw) = jax.value_and_grad(
        lambda h, w: jchunked(h, w, jnp.asarray(x["labels"]), block=W.VOCAB_LOSS["block"]),
        argnums=(0, 1))(jnp.asarray(x["hidden"]), jnp.asarray(x["head"]))
    return {"loss": np.asarray(loss), "hidden": np.asarray(gh), "head": np.asarray(gw)}


def test_inputs_split_the_labels_unevenly_over_the_vocabulary():
    x = _loss_inputs()
    V, T, block = W.VOCAB_LOSS["V"], W.VOCAB_LOSS["T"], W.VOCAB_LOSS["block"]
    shard = -(-V // 4)
    per_shard = np.bincount(x["labels"][x["labels"] >= 0] // shard, minlength=4)
    assert V % 4 and T % block and (x["labels"] == -1).any()
    assert per_shard[0] > per_shard[1:].sum() and per_shard.min() > 0, per_shard


@pytest.mark.parametrize("ref", ["single", "jax"])
def test_sharded_loss_and_gradients_match(world, ref):
    port = _need(world, "port")
    got = port["sharded"]
    want = port["single"] if ref == "single" else _jax_loss()
    assert abs(float(got["loss"]) - float(want["loss"])) <= LOSS_TOL * abs(float(want["loss"]))
    for name in ("hidden", "head"):
        assert _gap(got[name], want[name]) <= GRAD_TOL, (name, _gap(got[name], want[name]))


def test_single_device_loss_matches_jax(world):
    got, want = _need(world, "port")["single"], _jax_loss()
    assert abs(float(got["loss"]) - float(want["loss"])) <= LOSS_TOL * abs(float(want["loss"]))
    for name in ("hidden", "head"):
        assert _gap(got[name], want[name]) <= GRAD_TOL, name


def test_sharded_gradients_keep_their_placements(world):
    loss_pl, hidden_pl, head_pl = _need(world, "port")["sharded"]["placements"]
    assert loss_pl == "(Replicate(), Replicate())"
    assert hidden_pl == "(Shard(dim=0), Replicate())"        # the batch over data
    assert head_pl == "(Shard(dim=0), Shard(dim=1))"         # D over data, V over model


@pytest.mark.parametrize("name", ["loss", "hidden", "head"])
def test_one_rank_mesh_is_the_single_device_loss_bit_for_bit(world, name):
    port = _need(world, "port")
    got, want = port["one_rank"][name], port["single"][name]
    assert torch.equal(torch.as_tensor(got), torch.as_tensor(want)), name


@pytest.mark.parametrize("kind", list(W.PREFILL_ARCHS))
def test_sharded_prefill_matches_single_device(world, kind):
    got = _need(world, "port")["prefill"][kind]
    assert tuple(got["sharded"].shape) == (W.PREFILL_B, 256)
    assert _gap(got["sharded"], got["single"]) <= PREFILL_TOL


@pytest.mark.parametrize("kind", list(W.PREFILL_ARCHS))
def test_sharded_prefill_matches_jax(world, kind):
    got, jx = _need(world, "port")["prefill"][kind], _need(world, "jax")
    np.testing.assert_allclose(got["sharded"].numpy(), jx[kind], atol=PREFILL_JAX_TOL,
                               rtol=PREFILL_JAX_TOL)
    np.testing.assert_allclose(got["single"].numpy(), jx[kind], atol=PREFILL_JAX_TOL,
                               rtol=PREFILL_JAX_TOL)


@pytest.mark.parametrize("kind", list(W.PREFILL_ARCHS))
def test_sharded_prefill_is_placed_data_by_model(world, kind):
    got = _need(world, "port")["prefill"][kind]
    assert got["placements"] == "(Shard(dim=0), Shard(dim=1))"
    assert got["local_shape"] == (W.PREFILL_B // 2, 256 // 4)


@pytest.mark.parametrize("kind", list(W.SCAN_GRAD_KINDS))
def test_sharded_scan_gradients_match_single_device(world, kind):
    got = _need(world, "port")["grads"][kind]
    single, sharded = got["single"], got["sharded"]
    assert abs(sharded["loss"] - single["loss"]) <= LOSS_TOL * abs(single["loss"])
    worst = max((_gap(g, single["grads"][n]), n) for n, g in sharded["grads"].items())
    assert worst[0] <= GRAD_TOL, worst
