"""The port's zamba2 hybrid (Mamba2 blocks + one shared attention block)
against the JAX package on the CPU: the smoke config in float32 with the JAX
weights carried across by ``convert.params_from_numpy``;
``mamba2.block_forward`` (prefill and a T = 1 step with state),
``forward``, ``forward_hidden``, the decode steps over paged shared-attention
pools with the same block table, ``make_prefill_step`` and
``convert.decode_state_from_numpy`` within 2e-4 (the JAX package's own
decode-consistency tolerance, tests/test_decode_consistency.py).
zamba2-7b's full-width parameters are held to JAX's ``eval_shape`` on the
meta device.  In bfloat16 a Mamba2 block stays within 2e-2 of JAX's
output's scale, and the decode loop within 2e-2 of the forward, as in JAX."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import mamba2 as jm2
from repro.models import zamba2 as jz
from repro.train import train_step as jts
from repro_torch import convert, models
from repro_torch.configs import registry as treg
from repro_torch.models import mamba2 as tm2
from repro_torch.models import zamba2 as tz
from repro_torch.train import train_step as tts

TOL = 2e-4
BF16_TOL = 2e-2     # max |port - JAX| / max |JAX| in bfloat16 (K5's bfloat16 tolerance)
ARCH = "zamba2-7b"


def _close(got, want, tol: float = TOL, what: str = ""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


def _rel(got, want) -> float:
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _models(seed: int = 0, **overrides):
    jcfg = dataclasses.replace(jreg.get_smoke(ARCH), **overrides)
    tcfg = dataclasses.replace(treg.get_smoke(ARCH), **overrides)
    params = jz.init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                                        device="cpu")
    return jcfg, tcfg, params, tparams


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(np.int32)


def test_mamba2_block_forward_matches_jax():
    """One Mamba2 block: prefill (state None) and a T = 1 step from a random
    conv and ssm state, outputs and new states."""
    jcfg, tcfg, params, tparams = _models(seed=1)
    rng = np.random.default_rng(1)
    jp = jax.tree_util.tree_map(lambda a: a[1, 0], params["mamba"])
    tp = tparams.mamba[1][0]
    D = jcfg.d_model
    x = rng.standard_normal((2, 11, D)).astype(np.float32)
    want = jm2.block_forward(jp, jnp.asarray(x), jcfg, kernel_mode="reference")
    got = tm2.block_forward(tp, torch.from_numpy(x), tcfg, kernel_mode="reference")
    _close(got[0], want[0], what="prefill out")
    for k in ("conv", "ssm"):
        _close(got[1][k], want[1][k], what=f"prefill {k}")
    st = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in jm2.init_block_state(jcfg, 2).items()}
    x1 = x[:, :1]
    want = jm2.block_forward(jp, jnp.asarray(x1), jcfg, kernel_mode="reference",
                             state={k: jnp.asarray(v) for k, v in st.items()})
    got = tm2.block_forward(tp, torch.from_numpy(x1), tcfg, kernel_mode="reference",
                            state={k: torch.from_numpy(v) for k, v in st.items()})
    _close(got[0], want[0], what="step out")
    for k in ("conv", "ssm"):
        _close(got[1][k], want[1][k], what=f"step {k}")


@pytest.mark.parametrize("T", [1, 13, 40])
def test_forward_and_forward_hidden_match_jax(T):
    jcfg, tcfg, params, tparams = _models()
    tok = _tokens(jcfg, 2, T, T)
    want, _ = jz.forward(params, jnp.asarray(tok), jcfg, kernel_mode="reference")
    got, aux = models.forward(tparams, {"tokens": torch.from_numpy(tok)}, tcfg,
                              kernel_mode="reference")
    _close(got, want)
    assert float(aux) == 0.0
    jh, jhead, _ = jz.forward_hidden(params, jnp.asarray(tok), jcfg, kernel_mode="reference")
    th, thead, _ = tz.forward_hidden(tparams, torch.from_numpy(tok), tcfg,
                                     kernel_mode="reference")
    _close(th, jh, what="hidden")
    _close(thead, jhead, tol=0, what="head")


def test_decode_steps_match_jax_and_forward():
    """A decode loop from init_decode_state over paged shared-attention pools
    (4-token pages, a table that is not the identity): each step's logits,
    Mamba2 state and pools equal JAX's, and the logits equal the
    full-sequence forward at every position.  The port's pools are updated
    in place."""
    jcfg, tcfg, params, tparams = _models(seed=2, kv_page_size=4)
    G, per = tz.group_dims(tcfg)
    B, T, page = 2, 11, 4
    tok = _tokens(jcfg, B, T, 3)
    full, _ = tz.forward(tparams, torch.from_numpy(tok), tcfg, kernel_mode="reference")
    table = np.array([[5, 2, 7], [0, 6, 3]], np.int32)
    shape = (G, 8, page, jcfg.num_kv_heads, jcfg.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    jstate = jz.init_decode_state(jcfg, B)
    tstate = tz.init_decode_state(tcfg, B, device="cpu")
    for name in jstate:
        _close(tstate[name], jstate[name], tol=0, what=name)
    for t in range(T):
        ctx = np.full(B, t + 1, np.int32)
        jl, jstate, jk, jv = jz.decode_step(params, jnp.asarray(tok[:, t]), jcfg, jstate, jk,
                                            jv, jnp.asarray(table), jnp.asarray(ctx),
                                            kernel_mode="reference")
        tl, tstate, tk2, tv2 = tz.decode_step(tparams, torch.from_numpy(tok[:, t]), tcfg,
                                              tstate, tk, tv, torch.from_numpy(table),
                                              torch.from_numpy(ctx), kernel_mode="reference")
        assert tk2 is tk and tv2 is tv
        _close(tl, jl, what=f"logits {t}")
        _close(tl, full[:, t], what=f"forward {t}")
        for name in jstate:
            _close(tstate[name], jstate[name], what=f"{name} {t}")
    _close(tk, jk, what="k pools")
    _close(tv, jv, what="v pools")


@pytest.mark.parametrize("seed", [0, 1])
def test_mamba2_block_matches_jax_in_bfloat16(seed):
    """One Mamba2 block in bfloat16 from the same bfloat16 input: prefill
    and a T = 1 step from a random state, within 2e-2 of JAX's output's
    scale (the port rounds each op to its dtype, XLA keeps float32 inside a
    fusion: at most 0.9% of scale measured), the float32 ssm states too."""
    jcfg, tcfg, params, tparams = _models(seed=seed, dtype="bfloat16")
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(lambda a: a[1, 0], params["mamba"])
    tp = tparams.mamba[1][0]
    x = jnp.asarray(rng.standard_normal((2, 11, jcfg.d_model)), jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    st = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
          for k, v in jm2.init_block_state(jcfg, 2).items()}
    for T, state in ((11, None), (1, st)):
        want = jax.jit(lambda p, x: jm2.block_forward(
            p, x, jcfg, kernel_mode="reference",
            state=None if state is None else {k: jnp.asarray(v) for k, v in state.items()}))(
                jp, x[:, :T])
        got = tm2.block_forward(
            tp, tx[:, :T], tcfg, kernel_mode="reference",
            state=None if state is None else {k: torch.from_numpy(v) for k, v in state.items()})
        assert got[0].dtype == torch.bfloat16
        assert _rel(got[0], want[0]) <= BF16_TOL, f"out T={T}"
        assert _rel(got[1]["ssm"], want[1]["ssm"]) <= BF16_TOL, f"ssm T={T}"


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_matches_forward_in_bfloat16_as_in_jax(seed):
    """The decode-consistency property in bfloat16 over paged pools: the
    decode loop's logits at every position within 2e-2 of the forward's
    scale with the same greedy tokens, in the port and in JAX alike."""
    jcfg, tcfg, params, tparams = _models(seed=seed, dtype="bfloat16", kv_page_size=4)
    G, per = tz.group_dims(tcfg)
    B, T = 2, 22
    tok = _tokens(jcfg, B, T, seed + 3)
    table = np.array([[5, 2, 7, 9, 11, 1], [0, 6, 3, 4, 8, 10]], np.int32)
    shape = (G, 12, 4, jcfg.num_kv_heads, jcfg.head_dim)
    jfull = jax.jit(lambda p, t: jz.forward(p, t, jcfg, kernel_mode="reference")[0])(
        params, jnp.asarray(tok))
    full, _ = tz.forward(tparams, torch.from_numpy(tok), tcfg, kernel_mode="reference")
    jstep = jax.jit(lambda p, t, s, k, v, c: jz.decode_step(
        p, t, jcfg, s, k, v, jnp.asarray(table), c, kernel_mode="reference"))
    jstate, jk, jv = jz.init_decode_state(jcfg, B), jnp.zeros(shape), jnp.zeros(shape)
    tstate, tk, tv = tz.init_decode_state(tcfg, B, device="cpu"), *torch.zeros((2,) + shape)
    jdec, dec = [], []
    for t in range(T):
        ctx = np.full(B, t + 1, np.int32)
        jl, jstate, jk, jv = jstep(params, jnp.asarray(tok[:, t]), jstate, jk, jv,
                                   jnp.asarray(ctx))
        tl, tstate, _, _ = tz.decode_step(tparams, torch.from_numpy(tok[:, t]), tcfg, tstate,
                                          tk, tv, torch.from_numpy(table),
                                          torch.from_numpy(ctx), kernel_mode="reference")
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
    jcfg, tcfg, params, tparams = _models(seed=4)
    tstate = convert.decode_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jz.init_decode_state(jcfg, 3)), tcfg, device="cpu")
    want = tz.init_decode_state(tcfg, 3, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in tstate.items()} == \
           {k: (v.shape, v.dtype) for k, v in want.items()}
    rng = np.random.default_rng(4)
    state = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in want.items()}
    got = convert.decode_state_from_numpy(state, tcfg, device="cpu")
    for k in state:
        assert np.array_equal(got[k].numpy(), state[k])
    with pytest.raises(ValueError, match="ssm"):
        convert.decode_state_from_numpy({**state, "ssm": state["ssm"][:, :1]}, tcfg,
                                        device="cpu")
    with pytest.raises(ValueError, match="recurrent"):
        convert.decode_state_from_numpy(state, treg.get_smoke("qwen3-14b"), device="cpu")


def test_full_width_parameters_equal_jax_on_meta():
    """zamba2-7b's width without allocating it: every parameter of the
    port's module on the meta device has the name, shape and dtype the
    converter maps the JAX package's abstract parameters to (the Mamba2
    blocks stacked [27, 3] in JAX, ``mamba.g.j`` in the port)."""
    cfg = treg.get_config(ARCH)
    model = models.init(cfg, device="meta")
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in model.state_dict().items()}
    abstract = jreg.abstract_params(jreg.get_config(ARCH))
    want = {}
    for name, (leaf, i) in convert.port_param_leaves(abstract):
        skip = 0 if i is None else (1 if isinstance(i, int) else len(i))
        want[name] = (tuple(leaf.shape[skip:]), str(leaf.dtype))
    assert got == want
    assert sum(int(np.prod(s)) for s, _ in got.values()) == 6_751_130_832
    assert got["mamba.26.2.in_proj"] == ((3584, 14576), "bfloat16")
    assert got["mamba.0.0.A_log"] == ((112,), "float32")
    assert got["shared_attn.attn.wq"] == ((3584, 3584), "bfloat16")


def test_init_is_seeded_and_default_device_is_the_card():
    cfg = treg.get_smoke(ARCH)
    a, b = (tz.init(cfg, seed=5, device="cpu") for _ in range(2))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    assert not any(p.requires_grad for p in a.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            models.init(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            tz.init_decode_state(cfg, 1)
