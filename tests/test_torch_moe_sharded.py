"""MoE's sharded train step and its routing on the CPU:

* qwen3-moe-30b-a3b's smoke config from the JAX package's initial parameters,
  3 steps on a 2x2 ``("data", "model")`` gloo mesh (tests/_torch_worlds.py's
  ``moe`` world: expert weights sharded on E over ``model``) against 3
  single-device steps from the same state, at the ``train`` world's
  tolerances (tests/test_torch_distributed.py: losses within 1e-5, step 1's
  gradients and the parameters after 1 and 3 steps within 1e-4 of each
  leaf's scale); step 1 on a 1 x 1 mesh bit for bit; one MoE block's
  collectives: no gather of the whole batch or of the dispatch buffer;
* the routing's bookkeeping, rewritten so that DTensor has a rule for each
  op (the dispatch buffer written from each rank's own shards, nothing of
  a DTensor written in place into a plain tensor), against the scatter
  formulation it replaced, on plain tensors: the same output and aux loss
  bit for bit, with and without assignments dropped past capacity.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_worlds as W
from repro import models as jmodels
from repro.configs import registry as jreg
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import registry as treg
from repro_torch.models import moe as tmoe

LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_world")
    params = jax.tree.map(np.asarray, jmodels.init(jax.random.PRNGKey(0),
                                                   jreg.get_smoke(W.MOE_ARCH)))
    ckpt.save(out / "moe_init", 0, {"params": params})
    run = W.run_world(W.world_cmd("moe", out), 360, W.env())
    assert (out / "moe.pt").exists(), f"the moe world failed (rc {run.returncode}):\n" \
                                      f"{run.stderr[-4000:]}"
    return torch.load(out / "moe.pt", weights_only=False)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("i", range(W.STEPS))
def test_sharded_losses_match_single_device(world, i):
    got, want = world["sharded"]["metrics"][i], world["single"]["metrics"][i]
    assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"]), (got, want)
    assert abs(got["grad_norm"] - want["grad_norm"]) <= GRAD_TOL * want["grad_norm"], (got, want)


def test_sharded_step1_gradients_match_single_device(world):
    got, want = world["sharded"]["grads"][0], world["single"]["grads"][0]
    worst = max((_gap(g, want[n]), n) for n, g in got.items())
    assert worst[0] <= GRAD_TOL, worst


@pytest.mark.parametrize("after", [1, 3])
def test_sharded_parameters_match_single_device(world, after):
    got, want = world["sharded"]["params"][after - 1], world["single"]["params"][after - 1]
    worst = max((_gap(p, want[n]), n) for n, p in got.items())
    assert worst[0] <= PARAM_TOL, worst


def test_experts_shard_over_model(world):
    pl = world["sharded"]["placements"]
    assert pl["layers.0.moe.w_gate"] == "(Shard(dim=1), Shard(dim=0))"
    assert pl["layers.0.moe.w_down"] == "(Shard(dim=2), Shard(dim=0))"
    assert pl["layers.0.moe.router"] == "(Shard(dim=0), Replicate())"


def test_sharded_block_keeps_tokens_and_experts_sharded(world):
    """Tokens stay sharded over ``data`` and experts over ``model``: the
    dispatch and combine move each rank's experts' slots (a reduce-scatter
    and an all-gather over ``data``) and sum its tokens' outputs over
    ``model``; no collective gathers the whole token batch or yields the
    whole dispatch buffer."""
    t = world["sharded"]["traced_block"]
    kinds = {k for k, _ in t["sizes"]}
    assert {"reduce-scatter", "all-gather", "all-reduce"} <= kinds, t["sizes"]
    assert max(nb for _, nb in t["sizes"]) < t["buffer_bytes"], t
    assert not [nb for k, nb in t["sizes"] if k == "all-gather" and nb == t["batch_bytes"]], t


def test_one_rank_mesh_step_is_bit_identical(world):
    got, want = world["one_rank"], world["single"]
    assert got["metrics"] == want["metrics"][0]
    bad = [n for n, p in got["params"].items() if not torch.equal(p, want["params"][0][n])]
    assert bad == []


def _moe_forward_scatter(p, x, cfg):
    """``moe_forward`` as written before the routing's rewrite: the dispatch
    buffer filled by an indexed write."""
    moe = cfg.moe
    B, T, D = x.shape
    E, K = moe.num_experts, moe.top_k
    tokens = B * T
    C = tmoe._capacity(tokens, cfg)
    xf = x.reshape(tokens, D)
    gates = torch.softmax(xf.float() @ p.router, dim=-1)
    weights, ids = tmoe._top_k(gates, K)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_ids = ids.reshape(-1)
    tk = tokens * K
    me = gates.mean(0)
    counts = torch.zeros(E, dtype=torch.int32).scatter_add_(
        0, flat_ids, torch.ones(tk, dtype=torch.int32))
    aux = moe.router_aux_weight * E * torch.sum(me * (counts.float() / tk))
    sort = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[sort]
    pos = torch.arange(tk)
    is_start = torch.ones(tk, dtype=torch.bool)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg_start = torch.cummax(torch.where(is_start, pos, 0), 0).values
    rank = pos - seg_start
    keep = rank < C
    slot = sorted_ids * C + torch.clamp_max(rank, C - 1)
    token_of = sort // K
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype)
    buf[torch.where(keep, slot, E * C)] = xf[token_of]
    h = buf[:E * C].view(E, C, D)
    act = (lambda a: F.gelu(a, approximate="tanh")) if cfg.activation == "gelu_glu" else F.silu
    hg = act(torch.bmm(h, p.w_gate.to(x.dtype)))
    hu = torch.bmm(h, p.w_up.to(x.dtype))
    ho = torch.bmm(hg * hu, p.w_down.to(x.dtype)).reshape(E * C, D)
    w_flat = weights.reshape(-1)[sort]
    contrib = ho[torch.clamp_max(slot, E * C - 1)] * \
        torch.where(keep, w_flat, 0.0)[:, None].to(x.dtype)
    unsort = torch.empty_like(sort)
    unsort[sort] = pos
    return contrib[unsort].view(tokens, K, D).sum(1).reshape(B, T, D), aux, int((~keep).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.25], ids=["fits", "drops"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b"])
def test_routing_equals_the_scatter_formulation_bit_for_bit(arch, capacity_factor, dtype):
    cfg = treg.get_smoke(arch)
    cfg = dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(11)
    p = tmoe.MoE(gen, cfg, dt, device="cpu")
    x = torch.randn(4, 16, cfg.d_model, generator=gen).to(dt)
    with torch.no_grad():
        out, aux = tmoe.moe_forward(p, x, cfg)
        want, want_aux, dropped = _moe_forward_scatter(p, x, cfg)
    assert (dropped > 0) == (capacity_factor < 1), dropped
    assert torch.equal(out, want) and torch.equal(aux, want_aux)
