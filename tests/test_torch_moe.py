"""The port's MoE family (``models/moe.py`` and the MoE layers of
``models/transformer.py``) against the JAX package on the CPU, on the smoke
configs of qwen3-moe-30b-a3b and dbrx-132b with the JAX weights carried
across by ``convert.params_from_numpy``:

* ``moe_forward``'s output and aux loss within 1e-5, with and without
  assignments dropped past capacity, and top-k's tie order;
* ``forward`` and ``prefill_with_kv`` within 1e-4, ``decode_step`` (logits
  and pools) within 1e-4;
* a greedy decode loop equal to ``forward`` at every position where capacity
  drops nothing (prefill drops past capacity, decode at batch 2 does not);
* the port's engine generating the JAX engine's tokens for
  qwen3-moe-30b-a3b, with continuous batching and a fork.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import np_of, t_of

from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.serve.engine import SpartaEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.serve.engine import SpartaEngine

MOE = ["qwen3-moe-30b-a3b", "dbrx-132b"]
MOE_TOL, TOL = 1e-5, 1e-4


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np_of(got), np.asarray(want, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


def _cfgs(arch: str, capacity_factor=None, **overrides):
    jcfg = dataclasses.replace(jreg.get_smoke(arch), **overrides)
    tcfg = dataclasses.replace(treg.get_smoke(arch), **overrides)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    return jcfg, tcfg


def _models(arch: str, seed: int = 0, **overrides):
    jcfg, tcfg = _cfgs(arch, **overrides)
    params = jtfm.init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                                        device="cpu")
    return jcfg, tcfg, params, tparams


def _dropped(tparams_moe, x: np.ndarray, cfg) -> int:
    """Assignments past capacity in one ``moe_forward`` call on x."""
    gates = torch.softmax(t_of(x).reshape(-1, cfg.d_model) @ tparams_moe.router, -1)
    ids = tmoe._top_k(gates, cfg.moe.top_k)[1]
    per_expert = torch.bincount(ids.reshape(-1), minlength=cfg.moe.num_experts)
    cap = tmoe._capacity(x.shape[0] * x.shape[1], cfg)
    return int((per_expert - cap).clamp_min(0).sum())


@pytest.mark.parametrize("drops", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_matches_jax(arch, drops):
    """Out and aux loss; with a capacity factor of 0.25 over 64 tokens the
    capacity is 8 and assignments are dropped (never written)."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=0.25 if drops else None)
    params = jmoe.moe_params(jax.random.PRNGKey(3), jcfg)
    tp = tmoe.MoE(None, tcfg, device="meta")
    tp.load_state_dict({k: t_of(np.asarray(v)) for k, v in params.items()}, assign=True)
    x = np.random.default_rng(4).standard_normal((4, 16, jcfg.d_model)).astype(np.float32)
    want, want_aux = jmoe.moe_forward(params, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_forward(tp, t_of(x), tcfg)
    assert (_dropped(tp, x, tcfg) > 0) == drops
    _close(got, want, MOE_TOL, "out")
    _close(aux, want_aux, MOE_TOL, "aux")
    assert got.dtype == torch.float32 and aux.dtype == torch.float32 and aux.dim() == 0


def test_capacity_and_top_k_ties_equal_jax():
    cfg = treg.get_smoke("qwen3-moe-30b-a3b")
    jcfg = jreg.get_smoke("qwen3-moe-30b-a3b")
    for tokens in (1, 4, 25, 64, 1000):
        assert tmoe._capacity(tokens, cfg) == jmoe._capacity(tokens, jcfg)
    gates = np.array([[0.25, 0.25, 0.1, 0.25, 0.15],
                      [0.2, 0.2, 0.2, 0.2, 0.2],
                      [0.1, 0.3, 0.3, 0.0, 0.3]], np.float32)
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(gates), k)
        gv, gi = tmoe._top_k(t_of(gates), k)
        np.testing.assert_array_equal(np_of(gi), np.asarray(wi))
        np.testing.assert_array_equal(np_of(gv), np.asarray(wv))


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(np.int32)


@pytest.mark.parametrize("arch", MOE)
def test_forward_and_prefill_with_kv_match_jax(arch):
    jcfg, tcfg, params, tparams = _models(arch, seed=1, kv_page_size=4)
    tok = _tokens(jcfg, 2, 10, 2)
    want, want_aux = jtfm.forward(params, jnp.asarray(tok), jcfg, kernel_mode="reference")
    got, aux = ttfm.forward(tparams, t_of(tok), tcfg, kernel_mode="reference")
    _close(got, want, TOL, "logits")
    _close(aux, want_aux, MOE_TOL, "aux")
    assert float(aux) > 0
    want = jtfm.prefill_with_kv(params, jnp.asarray(tok), jcfg, kernel_mode="reference")
    got = ttfm.prefill_with_kv(tparams, t_of(tok), tcfg, kernel_mode="reference")
    for g, w, name in zip(got, want, ("logits", "k pages", "v pages")):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, TOL, name)


@pytest.mark.parametrize("arch", MOE)
def test_decode_step_matches_jax(arch):
    jcfg, tcfg, params, tparams = _models(arch, seed=3, kv_page_size=4)
    rng = np.random.default_rng(4)
    shape = (jcfg.num_layers, 16, 4, jcfg.num_kv_heads, jcfg.head_dim)
    kp, vp = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    table = np.array([[3, 5, -1], [7, 1, 2], [9, 4, 6]], np.int32)
    ctx = np.array([6, 11, 9], np.int32)
    tok = np.array([5, 9, 1], np.int32)
    want = jtfm.decode_step(params, jnp.asarray(tok), jcfg, jnp.asarray(kp), jnp.asarray(vp),
                            jnp.asarray(table), jnp.asarray(ctx), kernel_mode="reference")
    got = ttfm.decode_step(tparams, t_of(tok), tcfg, t_of(kp), t_of(vp), t_of(table),
                           t_of(ctx), kernel_mode="reference")
    for g, w, name in zip(got, want, ("logits", "k pools", "v pools")):
        _close(g, w, TOL, name)


def test_decode_loop_equals_forward_where_nothing_is_dropped():
    """At 2 sequences of 9 tokens with 8 experts, top-2 and a capacity
    factor of 8 the capacity (max(8, 36)) holds every assignment, so
    ``forward`` drops nothing and a decode loop gives its logits at every
    position."""
    _, tcfg = _cfgs("qwen3-moe-30b-a3b", capacity_factor=8.0, kv_page_size=4)
    tparams = ttfm.init(tcfg, seed=2, device="cpu")
    B, T = 2, 9
    tok = t_of(_tokens(tcfg, B, T, 5))
    assert tmoe._capacity(B * T, tcfg) >= B * T * tcfg.moe.top_k
    want, _ = ttfm.forward(tparams, tok, tcfg, kernel_mode="reference")
    pages = -(-T // 4)
    kp = torch.zeros((tcfg.num_layers, B * pages, 4, tcfg.num_kv_heads, tcfg.head_dim))
    vp = torch.zeros_like(kp)
    table = torch.arange(B * pages, dtype=torch.int32).reshape(B, pages)
    for t in range(T):
        ctx = torch.full((B,), t + 1, dtype=torch.int32)
        logits, _, _ = ttfm.decode_step(tparams, tok[:, t], tcfg, kp, vp, table, ctx,
                                        kernel_mode="reference")
        _close(logits, np_of(want[:, t]), 2e-4, f"position {t}")


def _serve(engine):
    """tests/test_system.py's continuous-batching traffic (three requests,
    two batch slots), then a fork of the first with copy-on-write."""
    r1 = engine.submit([1, 2, 3, 4, 5], max_new_tokens=4)
    engine.submit([7, 8, 9], max_new_tokens=4)
    engine.submit([4, 4, 4, 4], max_new_tokens=3)
    engine.run_to_completion()
    engine.kv.check_invariants()
    engine.fork_request(r1, max_new_tokens=3)
    engine.run_to_completion()
    engine.kv.check_invariants()
    return {rid: list(r.generated) for rid, r in engine.finished.items()}


def test_engine_tokens_equal_jax_engine_for_moe():
    jcfg, tcfg, params, tparams = _models("qwen3-moe-30b-a3b", seed=1, dtype="float32",
                                          kv_page_size=4)
    kw = dict(num_partitions=2, slots_per_partition=32, max_batch=2)
    want = _serve(JaxEngine(jcfg, params, **kw))
    got = _serve(SpartaEngine(tcfg, tparams, device="cpu", **kw))
    assert got == want
    assert [len(got[r]) for r in range(4)] == [4, 4, 3, 3]


def test_launcher_serves_moe_on_the_cpu(capsys):
    assert tserve.main(["--device", "cpu", "--requests", "2", "--max-new", "3",
                        "--arch", "qwen3-moe-30b-a3b"]) == 0
    assert capsys.readouterr().out.startswith("2 requests, 6 tokens")
