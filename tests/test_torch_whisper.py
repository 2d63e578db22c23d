"""The port's whisper (``models/whisper.py``) and VLM (``models/vlm.py``)
families against the JAX package on the CPU, on the smoke configs of
whisper-medium and internvl2-2b with the JAX weights carried across by
``convert.params_from_numpy``:

* whisper: ``sinusoid_positions``, ``encode``, ``decode_train``,
  ``forward`` / ``forward_hidden`` through the family dispatch,
  ``precompute_cross_kv`` and ``decode_step`` (logits and pools), within
  1e-4; and a teacher-forced decode loop equal to ``decode_train``'s logits
  at every position within 2e-4 (tests/test_decode_consistency.py's check
  of the dense path);
* ``attention_forward``'s ``kv_override`` and ``attention_decode_paged``
  within 1e-4;
* the VLM: ``forward`` and ``forward_hidden`` through the family dispatch
  within 1e-4, and the port's engine generating the JAX engine's tokens for
  internvl2-2b's backbone (text only, as the JAX launcher serves it), with
  continuous batching and a fork.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import np_of, t_of

from repro import models as jmodels
from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import whisper as jwh
from repro.serve.engine import SpartaEngine as JaxEngine
from repro.train.train_step import make_prefill_step as jprefill_step
from repro_torch import convert, models
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import whisper as twh
from repro_torch.serve.engine import SpartaEngine
from repro_torch.train.train_step import make_prefill_step

TOL = 1e-4


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np_of(got), np.asarray(want, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


def _models(arch: str, seed: int = 0, **overrides):
    jcfg = dataclasses.replace(jreg.get_smoke(arch), **overrides)
    tcfg = dataclasses.replace(treg.get_smoke(arch), **overrides)
    params = jmodels.init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                                        device="cpu")
    return jcfg, tcfg, params, tparams


def _whisper_batch(cfg, B=2, S=30, T=7, seed=1):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}


def test_sinusoid_positions_equal_jax():
    """Within 1e-4: at 1,500 positions the angles reach 1,499 rad, where one
    float32 rounding of the angle (the two packages compute the power
    differently) moves a sine by up to 6e-5."""
    for length, d in ((1, 2), (30, 64), (1500, 1024)):
        _close(twh.sinusoid_positions(length, d), jwh.sinusoid_positions(length, d), TOL,
               f"{length} x {d}")


def test_encode_decode_train_and_forward_match_jax():
    jcfg, tcfg, params, tparams = _models("whisper-medium", seed=2)
    batch = _whisper_batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: t_of(v) for k, v in batch.items()}
    want_enc = jwh.encode(params, jb["frames"], jcfg, kernel_mode="reference")
    enc = twh.encode(tparams, tb["frames"], tcfg, kernel_mode="reference")
    _close(enc, want_enc, what="encode")
    _close(twh.decode_train(tparams, enc, tb["tokens"], tcfg, kernel_mode="reference"),
           jwh.decode_train(params, want_enc, jb["tokens"], jcfg, kernel_mode="reference"),
           what="decode_train")
    want, _ = jmodels.forward(params, jb, jcfg, kernel_mode="reference")
    got, aux = models.forward(tparams, tb, tcfg, kernel_mode="reference")
    _close(got, want, what="forward")
    assert float(aux) == 0.0
    jh, jhead, _ = jmodels.forward_hidden(params, jb, jcfg, kernel_mode="reference")
    th, thead, _ = models.forward_hidden(tparams, tb, tcfg, kernel_mode="reference")
    _close(th, jh, what="hidden")
    _close(thead, jhead, 0, "head")
    _close(make_prefill_step(tcfg, kernel_mode="reference")(tparams, tb),
           jprefill_step(jcfg)(params, jb), what="prefill step")


def test_precompute_cross_kv_and_decode_step_match_jax():
    """Logits and pools after one decode step over pools with an unmapped
    page, a context that ends mid-page and one on a page boundary."""
    jcfg, tcfg, params, tparams = _models("whisper-medium", seed=3, kv_page_size=4)
    batch = _whisper_batch(jcfg, B=3, S=20)
    want_enc = jwh.encode(params, jnp.asarray(batch["frames"]), jcfg, kernel_mode="reference")
    want_ck, want_cv = jwh.precompute_cross_kv(params, want_enc, jcfg)
    ck, cv = twh.precompute_cross_kv(tparams, t_of(np.asarray(want_enc)), tcfg)
    _close(ck, want_ck, what="cross k")
    _close(cv, want_cv, what="cross v")
    assert tuple(ck.shape) == (jcfg.num_layers, 3, 20, jcfg.num_kv_heads, jcfg.head_dim)
    rng = np.random.default_rng(4)
    shape = (jcfg.num_layers, 16, 4, jcfg.num_kv_heads, jcfg.head_dim)
    kp, vp = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    table = np.array([[3, 5, -1], [7, 1, 2], [9, 4, 6]], np.int32)
    ctx = np.array([6, 11, 8], np.int32)
    tok = np.array([5, 9, 1], np.int32)
    want = jwh.decode_step(params, jnp.asarray(tok), jcfg, jnp.asarray(kp), jnp.asarray(vp),
                           want_ck, want_cv, jnp.asarray(table), jnp.asarray(ctx),
                           kernel_mode="reference")
    tk, tv = t_of(kp), t_of(vp)
    got = twh.decode_step(tparams, t_of(tok), tcfg, tk, tv, ck, cv, t_of(table), t_of(ctx),
                          kernel_mode="reference")
    for g, w, name in zip(got, want, ("logits", "k pools", "v pools")):
        _close(g, w, what=name)
    assert got[1] is tk and got[2] is tv               # the pools are updated in place


def test_decode_steps_equal_decode_train():
    """Teacher forcing: ``decode_step`` over paged self-attention KV and the
    precomputed cross KV gives ``decode_train``'s logits at every position
    (within 2e-4, the dense path's bound in tests/test_decode_consistency.py)."""
    _, tcfg, _, tparams = _models("whisper-medium", seed=5, kv_page_size=4)
    batch = {k: t_of(v) for k, v in _whisper_batch(tcfg, B=2, S=24, T=11, seed=6).items()}
    enc = twh.encode(tparams, batch["frames"], tcfg, kernel_mode="reference")
    want = twh.decode_train(tparams, enc, batch["tokens"], tcfg, kernel_mode="reference")
    ck, cv = twh.precompute_cross_kv(tparams, enc, tcfg)
    B, T, pages = 2, 11, 3
    kp = torch.zeros((tcfg.num_layers, B * pages, 4, tcfg.num_kv_heads, tcfg.head_dim))
    vp = torch.zeros_like(kp)
    table = torch.arange(B * pages, dtype=torch.int32).reshape(B, pages)
    for t in range(T):
        ctx = torch.full((B,), t + 1, dtype=torch.int32)
        logits, _, _ = twh.decode_step(tparams, batch["tokens"][:, t], tcfg, kp, vp, ck, cv,
                                       table, ctx, kernel_mode="reference")
        _close(logits, np_of(want[:, t]), 2e-4, f"position {t}")


def test_cross_attention_and_paged_decode_attention_match_jax():
    """``attention_forward`` with ``kv_override`` (whisper's cross-attention)
    and ``attention_decode_paged`` (the residuals over one partition's pool
    and the new row) against the JAX package's."""
    jcfg, tcfg, params, tparams = _models("whisper-medium", seed=7, kv_page_size=4)
    jl = jax.tree_util.tree_map(lambda a: a[0], params["dec_layers"])["cross_attn"]
    tl = tparams.dec_layers[0].cross_attn
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    want = jattn.attention_forward(jl, jnp.asarray(x), jcfg, causal=False,
                                   kv_override=jattn.cross_kv(jl, jnp.asarray(enc), jcfg),
                                   kernel_mode="reference")
    got = tattn.attention_forward(tl, t_of(x), tcfg, causal=False,
                                  kv_override=tattn.cross_kv(tl, t_of(enc), tcfg),
                                  kernel_mode="reference")
    _close(got, want, what="cross-attention")
    shape = (12, 4, jcfg.num_kv_heads, jcfg.head_dim)
    kp, vp = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    table = np.array([[3, 5, -1], [7, 1, 2]], np.int32)
    ctx = np.array([6, 11], np.int32)
    x1 = x[:, :1]
    want = jattn.attention_decode_paged(jl, jnp.asarray(x1), jcfg, jnp.asarray(kp),
                                        jnp.asarray(vp), jnp.asarray(table), jnp.asarray(ctx),
                                        kernel_mode="reference")
    got = tattn.attention_decode_paged(tl, t_of(x1), tcfg, t_of(kp), t_of(vp), t_of(table),
                                       t_of(ctx), kernel_mode="reference")
    for g, w, name in zip(got, want, ("acc", "m", "l", "k", "v")):
        _close(g, w, what=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_vlm_forward_and_forward_hidden_match_jax(seed):
    jcfg, tcfg, params, tparams = _models("internvl2-2b", seed=seed)
    rng = np.random.default_rng(10 + seed)
    batch = {"patch_embeds": rng.standard_normal(
                 (2, jcfg.num_image_tokens, jcfg.d_model)).astype(np.float32),
             "tokens": rng.integers(0, jcfg.vocab, (2, 9)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: t_of(v) for k, v in batch.items()}
    want, _ = jmodels.forward(params, jb, jcfg, kernel_mode="reference")
    got, aux = models.forward(tparams, tb, tcfg, kernel_mode="reference")
    assert tuple(got.shape) == (2, 9, jcfg.vocab)
    _close(got, want, what="logits")
    assert float(aux) == 0.0
    jh, jhead, _ = jmodels.forward_hidden(params, jb, jcfg, kernel_mode="reference")
    th, thead, _ = models.forward_hidden(tparams, tb, tcfg, kernel_mode="reference")
    _close(th, jh, what="hidden")
    _close(thead, jhead, 0, "head")


def test_engine_tokens_equal_jax_engine_for_vlm():
    jcfg, tcfg, params, tparams = _models("internvl2-2b", seed=1, kv_page_size=4)
    kw = dict(num_partitions=2, slots_per_partition=32, max_batch=2)
    out = []
    for eng in (JaxEngine(jcfg, params, **kw), SpartaEngine(tcfg, tparams, device="cpu", **kw)):
        r1 = eng.submit([1, 2, 3, 4, 5], max_new_tokens=4)
        eng.submit([7, 8, 9], max_new_tokens=4)
        eng.submit([4, 4, 4, 4], max_new_tokens=3)
        eng.run_to_completion()
        eng.fork_request(r1, max_new_tokens=3)
        eng.run_to_completion()
        eng.kv.check_invariants()
        out.append({rid: list(r.generated) for rid, r in eng.finished.items()})
    assert out[1] == out[0]
    assert [len(out[1][r]) for r in range(4)] == [4, 4, 3, 3]
