"""The port's rwkv6 (Finch) family against the JAX package on the CPU: the
smoke config in float32 with the JAX weights carried across by
``convert.params_from_numpy``; ``forward``, ``forward_hidden``, the decode
steps from ``init_decode_state``, ``make_prefill_step`` and
``convert.decode_state_from_numpy`` within 2e-4 (the JAX package's own
decode-consistency tolerance, tests/test_decode_consistency.py).
rwkv6-1.6b's full-width parameters are held to JAX's ``eval_shape`` on the
meta device.  In bfloat16 each layer stays within 2e-2 of JAX's output's
scale, and the decode loop within 2e-2 of the forward, as in JAX."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import rwkv6 as jr
from repro.train import train_step as jts
from repro_torch import convert, models
from repro_torch.configs import registry as treg
from repro_torch.models import rwkv6 as tr
from repro_torch.train import train_step as tts

TOL = 2e-4
BF16_TOL = 2e-2     # max |port - JAX| / max |JAX| in bfloat16 (K5's bfloat16 tolerance)
ARCH = "rwkv6-1.6b"


def _close(got, want, tol: float = TOL, what: str = ""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


def _rel(got, want) -> float:
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _models(seed: int = 0, **overrides):
    jcfg = dataclasses.replace(jreg.get_smoke(ARCH), **overrides)
    tcfg = dataclasses.replace(treg.get_smoke(ARCH), **overrides)
    params = jr.init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                                        device="cpu")
    return jcfg, tcfg, params, tparams


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(np.int32)


@pytest.mark.parametrize("T", [1, 13, 40])
def test_forward_and_forward_hidden_match_jax(T):
    jcfg, tcfg, params, tparams = _models()
    tok = _tokens(jcfg, 2, T, T)
    want, _ = jr.forward(params, jnp.asarray(tok), jcfg, kernel_mode="reference")
    got, aux = tr.forward(tparams, torch.from_numpy(tok), tcfg, kernel_mode="reference")
    _close(got, want)
    assert float(aux) == 0.0
    jh, jhead, _ = jr.forward_hidden(params, jnp.asarray(tok), jcfg, kernel_mode="reference")
    th, thead, _ = models.forward_hidden(tparams, {"tokens": torch.from_numpy(tok)}, tcfg,
                                         kernel_mode="reference")
    _close(th, jh, what="hidden")
    _close(thead, jhead, tol=0, what="head")


def test_time_and_channel_mix_with_state_match_jax():
    """One layer's time-mix and channel-mix at T = 1 with carried shift and
    wkv state (the decode branch) and at T = 5 without (the scan)."""
    jcfg, tcfg, params, tparams = _models(seed=1)
    rng = np.random.default_rng(1)
    jl = jax.tree_util.tree_map(lambda a: a[1], params["layers"])
    tl = tparams.layers[1]
    D = jcfg.d_model
    H, N = tr._heads(tcfg)
    shift = rng.standard_normal((2, D)).astype(np.float32)
    wkv = rng.standard_normal((2, H, N, N)).astype(np.float32)
    for T, st in ((1, True), (5, False)):
        x = rng.standard_normal((2, T, D)).astype(np.float32)
        kw = dict(shift_state=shift, wkv_state=wkv) if st else {}
        want = jr._time_mix(jl["tm"], jnp.asarray(x), jcfg, "reference",
                            **{k: jnp.asarray(v) for k, v in kw.items()})
        got = tr._time_mix(tl.tm, torch.from_numpy(x), tcfg, "reference",
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
        for g, w, name in zip(got, want, ("out", "shift", "wkv")):
            _close(g, w, what=f"time-mix T={T} {name}")
        want = jr._channel_mix(jl["cm"], jnp.asarray(x),
                               jnp.asarray(shift) if st else None)
        got = tr._channel_mix(tl.cm, torch.from_numpy(x),
                              torch.from_numpy(shift) if st else None)
        for g, w in zip(got, want):
            _close(g, w, what=f"channel-mix T={T}")


def test_decode_steps_match_jax_and_forward():
    """A decode loop from init_decode_state: each step's logits and state
    equal JAX's, and the logits equal the full-sequence forward at every
    position (JAX's decode-consistency property)."""
    jcfg, tcfg, params, tparams = _models(seed=2)
    B, T = 2, 10
    tok = _tokens(jcfg, B, T, 3)
    full, _ = tr.forward(tparams, torch.from_numpy(tok), tcfg, kernel_mode="reference")
    jstate = jr.init_decode_state(jcfg, B)
    tstate = tr.init_decode_state(tcfg, B, device="cpu")
    for name in jstate:
        _close(tstate[name], jstate[name], tol=0, what=name)
    for t in range(T):
        jl, jstate = jr.decode_step(params, jnp.asarray(tok[:, t]), jcfg, jstate,
                                    kernel_mode="reference")
        tl, tstate = tr.decode_step(tparams, torch.from_numpy(tok[:, t]), tcfg, tstate,
                                    kernel_mode="reference")
        _close(tl, jl, what=f"logits {t}")
        _close(tl, full[:, t], what=f"forward {t}")
        for name in jstate:
            _close(tstate[name], jstate[name], what=f"{name} {t}")


@pytest.mark.parametrize("seed", [0, 1])
def test_layers_match_jax_in_bfloat16(seed):
    """One layer's time-mix (T = 7 through the scan; T = 1 with carried
    shift and wkv state) and channel-mix in bfloat16 from the same bfloat16
    inputs: within 2e-2 of JAX's output's scale, the float32 states within
    2e-3.  The port rounds each op to its dtype; XLA keeps float32 inside a
    fusion, so the two differ by a few bfloat16 steps (at most 0.9% of scale
    measured), not more."""
    jcfg, tcfg, params, tparams = _models(seed=seed, dtype="bfloat16")
    rng = np.random.default_rng(seed)
    jl = jax.tree_util.tree_map(lambda a: a[1], params["layers"])
    tl = tparams.layers[1]
    H, N = tr._heads(tcfg)
    x = jnp.asarray(rng.standard_normal((2, 7, jcfg.d_model)), jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    shift = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    wkv = (rng.standard_normal((2, H, N, N)) * 0.3).astype(np.float32)
    for T, st in ((7, False), (1, True)):
        kw = dict(shift_state=shift, wkv_state=wkv) if st else {}
        want = jax.jit(lambda p, x: jr._time_mix(
            p, x, jcfg, "reference", **{k: jnp.asarray(v) for k, v in kw.items()}))(
                jl["tm"], x[:, :T])
        got = tr._time_mix(tl.tm, tx[:, :T], tcfg, "reference",
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
        assert got[0].dtype == torch.bfloat16
        assert _rel(got[0], want[0]) <= BF16_TOL, f"time-mix T={T}"
        assert _rel(got[2], want[2]) <= BF16_TOL / 10, f"wkv T={T}"
        want = jax.jit(lambda p, x: jr._channel_mix(
            p, x, jnp.asarray(shift) if st else None))(jl["cm"], x[:, :T])
        got = tr._channel_mix(tl.cm, tx[:, :T], torch.from_numpy(shift) if st else None)
        assert _rel(got[0], want[0]) <= BF16_TOL, f"channel-mix T={T}"


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_matches_forward_in_bfloat16_as_in_jax(seed):
    """The decode-consistency property in bfloat16: the decode loop's logits
    at every position within 2e-2 of the forward's scale with the same
    greedy tokens, in the port and in JAX alike (the decode step forms its
    outer product in float32, as the scan does: rounded to bfloat16 it put
    the port's decode 3-6% of scale away from its forward here)."""
    jcfg, tcfg, params, tparams = _models(seed=seed, dtype="bfloat16")
    B, T = 2, 24
    tok = _tokens(jcfg, B, T, seed + 3)
    jfull = jax.jit(lambda p, t: jr.forward(p, t, jcfg, kernel_mode="reference")[0])(
        params, jnp.asarray(tok))
    full, _ = tr.forward(tparams, torch.from_numpy(tok), tcfg, kernel_mode="reference")
    jstep = jax.jit(lambda p, t, s: jr.decode_step(p, t, jcfg, s, kernel_mode="reference"))
    jstate = jr.init_decode_state(jcfg, B)
    tstate = tr.init_decode_state(tcfg, B, device="cpu")
    jdec, dec = [], []
    for t in range(T):
        jl, jstate = jstep(params, jnp.asarray(tok[:, t]), jstate)
        tl, tstate = tr.decode_step(tparams, torch.from_numpy(tok[:, t]), tcfg, tstate,
                                    kernel_mode="reference")
        jdec.append(np.asarray(jl, np.float32))
        dec.append(tl.float())
    dec = torch.stack(dec, 1)
    assert _rel(torch.from_numpy(np.stack(jdec, 1)), jfull) <= BF16_TOL
    assert _rel(dec, full.float()) <= BF16_TOL
    assert torch.equal(dec.argmax(-1), full.float().argmax(-1))


def test_prefill_step_matches_jax():
    jcfg, tcfg, params, tparams = _models(seed=3)
    tok = _tokens(jcfg, 3, 24, 4)
    want = jts.make_prefill_step(jcfg, kernel_mode="reference")(params,
                                                                {"tokens": jnp.asarray(tok)})
    got = tts.make_prefill_step(tcfg)(tparams, {"tokens": torch.from_numpy(tok)})
    assert tuple(got.shape) == (3, jcfg.vocab)
    _close(got, want)


def test_decode_state_from_numpy_carries_a_jax_state():
    """A state exported from JAX mid-decode resumes in the port to JAX's
    logits; a leaf of the wrong shape is refused."""
    jcfg, tcfg, params, tparams = _models(seed=4)
    tok = _tokens(jcfg, 2, 6, 5)
    jstate = jr.init_decode_state(jcfg, 2)
    for t in range(3):
        _, jstate = jr.decode_step(params, jnp.asarray(tok[:, t]), jcfg, jstate)
    tstate = convert.decode_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), tcfg,
                                             device="cpu")
    assert all(v.dtype == torch.float32 for v in tstate.values())
    for t in range(3, 6):
        jl, jstate = jr.decode_step(params, jnp.asarray(tok[:, t]), jcfg, jstate)
        tl, tstate = tr.decode_step(tparams, torch.from_numpy(tok[:, t]), tcfg, tstate)
        _close(tl, jl, what=f"logits {t}")
    bad = jax.tree_util.tree_map(np.asarray, jstate)
    bad["wkv"] = bad["wkv"][..., :-1]
    with pytest.raises(ValueError, match="wkv"):
        convert.decode_state_from_numpy(bad, tcfg, device="cpu")


def test_full_width_parameters_equal_jax_on_meta():
    """rwkv6-1.6b's width without allocating it: every parameter of the
    port's module on the meta device has the name, shape and dtype the
    converter maps the JAX package's abstract parameters to."""
    cfg = treg.get_config(ARCH)
    model = models.init(cfg, device="meta")
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in model.state_dict().items()}
    abstract = jreg.abstract_params(jreg.get_config(ARCH))
    want = {name: (tuple(leaf.shape[1:] if i is not None else leaf.shape), str(leaf.dtype))
            for name, (leaf, i) in convert.port_param_leaves(abstract)}
    assert got == want
    assert sum(int(np.prod(s)) for s, _ in got.values()) == 1_584_041_984
    assert got["layers.23.tm.w_lora_b"] == ((64, 2048), "float32")
    assert got["layers.0.tm.u"] == ((32, 64), "float32")
    assert got["lm_head"] == ((2048, 65536), "bfloat16")


def test_init_is_seeded_and_default_device_is_the_card():
    cfg = treg.get_smoke(ARCH)
    a, b = (tr.init(cfg, seed=5, device="cpu") for _ in range(2))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    assert not any(p.requires_grad for p in a.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            models.init(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            tr.init_decode_state(cfg, 1)
