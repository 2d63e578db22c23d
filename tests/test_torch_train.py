"""The port's training pieces against the JAX package on the CPU: the
optimizer (``schedule``, ``apply_updates``), the chunked loss, ``loss_fn``
and its gradients for all six families, ``make_train_step`` with one and two
microbatches and a gradient transform, ``remat``, and the kernels' refusal
to run under autograd.  Weights cross over through ``convert`` and the
batches come from the (byte-identical) data pipeline.

Tolerances: the schedule within 5e-7 relative (``SCHEDULE_RTOL``: the
two packages' float32 cosines round differently); ``apply_updates`` within
1e-6 of each leaf's scale in float32 and one bf16 ulp in bfloat16; the
chunked loss and its gradients within 1e-5; the families' losses within
1e-5 and their gradients within 1e-4 of each leaf's scale; three train
steps within 1e-4 absolute on the parameters (a step moves a weight by at
most ~lr = 1e-3).  The sums run in other orders in the two packages, so
they are close, not bit-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import registry as jreg
from repro.models import losses as jlosses
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert, models
from repro_torch.configs import registry as treg
from repro_torch.data.pipeline import DataConfig, batch_for_model
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba2_scan import mamba2_scan
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_partial
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models import losses
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_loss_fn, make_train_step

FAMILIES = ["qwen3-14b", "qwen3-moe-30b-a3b", "rwkv6-1.6b", "zamba2-7b", "whisper-medium",
            "internvl2-2b"]
SEQ = 16


def _flat(tree, prefix=""):
    """{path: numpy array} of a nested dict tree (JAX or port layout)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v.detach().float() if isinstance(v, torch.Tensor)
                                             else np.asarray(v, np.float32), np.float32)
    return out


def _leafwise(got: dict, want: dict, rel: float, what: str):
    """Every leaf within ``rel`` of its own scale (max |want|)."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), (what, sorted(set(g) ^ set(w)))
    for k in w:
        scale = max(float(np.abs(w[k]).max()), 1e-30)
        err = float(np.abs(g[k] - w[k]).max())
        assert err <= rel * scale, f"{what} {k}: {err} > {rel} x {scale}"


def _setup(arch: str, dtype: str = "float32", seed: int = 0):
    jcfg = dataclasses.replace(jreg.get_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(treg.get_smoke(arch), dtype=dtype)
    jparams = jmodels.init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                        device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(cfg, batch: int, step: int = 0):
    data = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=batch)
    return batch_for_model(data, cfg, step)


def _port_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


# -- optimizer ---------------------------------------------------------------

# The schedule's float32 cosine rounds differently in XLA and in PyTorch (and
# XLA's jitted and eager schedules differ from each other by up to 1.6e-7 at
# these steps); near the end of the decay 1 + cos cancels, so one ulp of the
# cosine is up to ~2e-7 of the rate.  5e-7 is that, with room.
SCHEDULE_RTOL = 5e-7


@pytest.mark.parametrize("warmup,total", [(10, 50), (1, 3)])
def test_schedule_matches_jax(warmup, total):
    jc = jopt.OptimizerConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    tc = topt.OptimizerConfig(**dataclasses.asdict(jc))
    steps = np.arange(total + 11, dtype=np.float32)
    got = np.array([topt.schedule(tc, torch.tensor(s)).item() for s in steps], np.float32)
    eager = np.array([jopt.schedule(jc, jnp.float32(s)) for s in steps], np.float32)
    jitted = np.asarray(jax.vmap(lambda s: jopt.schedule(jc, s))(jnp.asarray(steps)))
    np.testing.assert_allclose(got, eager, rtol=SCHEDULE_RTOL, atol=0)
    np.testing.assert_allclose(got, jitted, rtol=SCHEDULE_RTOL, atol=0)
    assert got[0] == 0.0 and got[warmup] == np.float32(3e-4)


def test_optimizer_config_defaults_match_jax():
    assert dataclasses.asdict(topt.OptimizerConfig()) == \
        dataclasses.asdict(jopt.OptimizerConfig())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(dtype):
    """Two AdamW steps (the second on non-zero moments) from one random tree
    and random gradients.  In float32 the gradients are clipped (grad_clip
    below their norm).  In bf16 the clip scale is rounded to bf16 before it
    multiplies (as in the JAX package), so the norm's last-digit difference
    (its sum runs in another order) could flip that rounding and move every
    gradient by a bf16 ulp: there grad_clip is above the norm (scale 1)."""
    jcfg, tcfg, jparams, tparams = _setup("qwen3-14b", dtype)
    rng = np.random.default_rng(1)
    jgrads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32), p.dtype), jparams)
        for _ in range(2)]
    oc = jopt.OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                              grad_clip=0.5 if dtype == "float32" else 1e4)
    toc = topt.OptimizerConfig(**dataclasses.asdict(oc))
    jstate = jopt.init_state(jparams)
    tstate = topt.init_state(tparams)
    for g in jgrads:
        tg = {name: convert._tensor_of(np.asarray(leaf if i is None else leaf[i]),
                                       torch.device("cpu"))
              for name, (leaf, i) in convert.port_param_leaves(
                  jax.tree_util.tree_map(np.asarray, g))}
        jparams, jstate, jm = jopt.apply_updates(jparams, g, jstate, oc)
        tparams, tstate, tm = topt.apply_updates(tparams, tg, tstate, toc)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=SCHEDULE_RTOL)
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    assert tstate["step"].dtype == torch.int32
    got = convert.jax_layout(dict(tparams.named_parameters()))
    if dtype == "float32":
        _leafwise(got, jparams, 1e-6, "params")
    else:   # within one bf16 ulp of the JAX value
        g, w = _flat(got), _flat(jparams)
        for k in w:
            ulp = np.abs(w[k]) * 2.0 ** -7 + 1e-30
            assert np.all(np.abs(g[k] - w[k]) <= ulp), k
    jo = convert.opt_state_to_numpy(tstate)
    _leafwise(jo["m"], jstate["m"], 1e-6, "m")
    _leafwise(jo["v"], jstate["v"], 1e-6, "v")


# -- the loss ------------------------------------------------------------------

def test_chunked_cross_entropy_value_and_grad_match_jax():
    rng = np.random.default_rng(2)
    B, T, D, V = 2, 37, 16, 50          # 37 tokens: not a multiple of the block
    hidden = rng.standard_normal((B, T, D)).astype(np.float32)
    head = rng.standard_normal((D, V)).astype(np.float32) * 0.3
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, -3:] = -1
    jv, (jgh, jgw) = jax.value_and_grad(
        lambda h, w: jlosses.chunked_cross_entropy(h, w, jnp.asarray(labels), block=8),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(head))
    h = torch.from_numpy(hidden).requires_grad_(True)
    w = torch.from_numpy(head).requires_grad_(True)
    tv = losses.chunked_cross_entropy(h, w, torch.from_numpy(labels), block=8)
    tgh, tgw = torch.autograd.grad(tv, (h, w))
    assert tv.dtype == torch.float32 and tv.shape == ()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgh.numpy(), np.asarray(jgh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgw.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-5)
    with torch.no_grad():     # the same value without the checkpointed blocks
        np.testing.assert_allclose(
            losses.chunked_cross_entropy(h, w, torch.from_numpy(labels), block=8).item(),
            tv.item(), rtol=1e-7)


def test_cross_entropy_and_vlm_loss_match_jax():
    from repro.models import layers as jlayers
    from repro.models import vlm as jvlm
    from repro_torch.models import layers as tlayers
    from repro_torch.models import vlm as tvlm

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 30)).astype(np.float32)
    labels = rng.integers(0, 30, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        got = tlayers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                    None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    jcfg, tcfg, jparams, tparams = _setup("internvl2-2b")
    b = _batch(jcfg, 2)
    want = jvlm.loss_fn(jparams, {k: jnp.asarray(v) for k, v in b.items()}, jcfg,
                        kernel_mode="reference")
    got = tvlm.loss_fn(tparams, _port_batch(b), tcfg, kernel_mode="reference")
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# rwkv6 at initialisation is ill-conditioned: the bonus u starts at 0, so
# the first token's head output is exactly 0, where the per-head
# normalisation's derivative is 1 / sqrt(1e-6) = 1000.  One float32 rounding
# in the forward then moves u's and the lower layers' gradients by up to
# ~1e-3 of their scale: against the port run in float64, the JAX package's
# float32 gradients are 7.5e-5 off and the port's 8.6e-4.  So at init it is
# held within 2e-3, and with a random u (``rwkv6-1.6b/u``, away from that
# point) within the others' 1e-4.
GRAD_TOL = {"rwkv6-1.6b": 2e-3}


@pytest.mark.parametrize("arch", FAMILIES + ["rwkv6-1.6b/u"])
def test_loss_and_gradients_match_jax(arch):
    arch, _, variant = arch.partition("/")
    jcfg, tcfg, jparams, tparams = _setup(arch)
    if variant == "u":
        tree = jax.tree_util.tree_map(np.asarray, jparams)
        u = tree["layers"]["tm"]["u"]
        tree["layers"]["tm"]["u"] = (np.random.default_rng(5).standard_normal(u.shape)
                                     * 0.5).astype(np.float32)
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        tparams = convert.params_from_numpy(tree, tcfg, device="cpu")
    b = _batch(jcfg, 2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jl, jg = jax.jit(jax.value_and_grad(jts.make_loss_fn(jcfg)))(jparams, jb)
    tparams.requires_grad_(True)
    names, leaves = zip(*tparams.named_parameters())
    tl = make_loss_fn(tcfg)(tparams, _port_batch(b))
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5, atol=1e-5)
    tol = GRAD_TOL.get(arch, 1e-4) if not variant else 1e-4
    _leafwise(convert.jax_layout(dict(zip(names, tg))), jg, tol, f"{arch} grads")


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gives_equal_gradients(arch):
    _, tcfg, _, tparams = _setup(arch)
    b = _port_batch(_batch(tcfg, 2))
    tparams.requires_grad_(True)
    names, leaves = zip(*tparams.named_parameters())
    out = []
    for remat in (True, False):
        loss = models.loss_fn(tparams, b, tcfg, kernel_mode="reference", remat=remat)
        out.append((loss.item(), torch.autograd.grad(loss, leaves)))
    assert out[0][0] == out[1][0]
    for n, a, c in zip(names, out[0][1], out[1][1]):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7, msg=n)


# -- the train step --------------------------------------------------------------

@pytest.mark.parametrize("arch,microbatches", [("qwen3-14b", 1), ("qwen3-14b", 2),
                                               ("internvl2-2b", 2)])
def test_train_step_matches_jax(arch, microbatches):
    """Three steps at lr = 1e-3 with a gradient transform that scales by
    0.5 (applied before the optimizer in both packages)."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    oc = jopt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jts.make_train_step(
        jcfg, oc, microbatches=microbatches,
        compress_grads=lambda g: jax.tree_util.tree_map(lambda x: x * 0.5, g)))
    tstep = make_train_step(tcfg, topt.OptimizerConfig(**dataclasses.asdict(oc)),
                            microbatches=microbatches,
                            compress_grads=lambda g: {k: x * 0.5 for k, x in g.items()})
    jstate, tstate = jopt.init_state(jparams), topt.init_state(tparams)
    for i in range(3):
        b = _batch(jcfg, 4, step=i)
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tparams, tstate, tm = tstep(tparams, tstate, _port_batch(b))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=SCHEDULE_RTOL)
        assert all(tm[k].shape == () and tm[k].dtype == torch.float32 for k in tm)
    g, w = _flat(convert.jax_layout(dict(tparams.named_parameters()))), _flat(jparams)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4, err_msg=k)
    assert all(p.requires_grad for p in tparams.parameters())


def test_train_step_leaves_params_unchanged_when_the_loss_raises():
    _, tcfg, _, tparams = _setup("qwen3-14b")
    before = {n: p.detach().clone() for n, p in tparams.named_parameters()}
    state = topt.init_state(tparams)
    step = make_train_step(tcfg, microbatches=2)
    bad = {"tokens": torch.full((4, SEQ), tcfg.vocab + 5, dtype=torch.int32)}
    with pytest.raises(IndexError):
        step(tparams, state, bad)
    with pytest.raises(ValueError, match="does not split into 2 microbatches"):
        step(tparams, state, {"tokens": torch.zeros((3, SEQ), dtype=torch.int32)})
    for n, p in tparams.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    assert int(state["step"]) == 0 and all(not m.any() for m in state["m"].values())


# -- the kernels refuse autograd ------------------------------------------------------

def _refusal_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)   # noqa: E731
    q, k, v = r(1, 2, 8, 16), r(1, 2, 8, 16), r(1, 2, 8, 16)
    pool = r(4, 8, 2, 16)
    table = torch.zeros((1, 1), dtype=torch.int32)
    ctx = torch.full((1,), 5, dtype=torch.int32)
    B, H, T, N = 1, 2, 8, 8
    return {
        "K5": (lambda x, mode: flash_attention(x, k, v, kernel_mode=mode), q),
        "K6": (lambda x, mode: paged_attention(x, pool, pool, table, ctx, kernel_mode=mode),
               r(1, 2, 16)),
        "K6_partial": (lambda x, mode: paged_attention_partial(x, pool, pool, table, ctx,
                                                               kernel_mode=mode), r(1, 2, 16)),
        "K7": (lambda x, mode: rwkv6_scan(x, r(B, H, T, N), r(B, H, T, N),
                                          -torch.rand(B, H, T, N, generator=g), r(H, N),
                                          kernel_mode=mode), r(B, H, T, N)),
        "K8": (lambda x, mode: mamba2_scan(x, torch.rand(1, 2, 8, generator=g), -torch.ones(2),
                                           r(1, 8, 4), r(1, 8, 4), torch.ones(2),
                                           kernel_mode=mode), r(1, 2, 8, 4)),
    }


@pytest.mark.parametrize("kernel", ["K5", "K6", "K6_partial", "K7", "K8"])
def test_kernels_refuse_autograd(kernel):
    """``cuda`` on CPU inputs that require a gradient raises the refusal, not
    the device error; without autograd it is the device error; ``auto`` on
    the CPU (the plain version) differentiates."""
    op, x = _refusal_cases()[kernel]
    with pytest.raises(RuntimeError, match="no backward pass.*kernel_mode=\"reference\""):
        op(x.clone().requires_grad_(True), "cuda")
    with torch.no_grad(), pytest.raises(ValueError, match="needs data on a CUDA device"):
        op(x.clone().requires_grad_(True), "cuda")
    with pytest.raises(ValueError, match="needs data on a CUDA device"):
        op(x, "cuda")
    xg = x.clone().requires_grad_(True)
    out = op(xg, "auto")
    out = out[0] if isinstance(out, tuple) else out
    (gx,) = torch.autograd.grad(out.sum(), xg)
    assert torch.isfinite(gx).all()


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-1.6b", "zamba2-7b"])
def test_train_step_refuses_the_kernels(arch):
    _, tcfg, _, tparams = _setup(arch)
    step = make_train_step(tcfg, kernel_mode="cuda")
    with pytest.raises(RuntimeError, match="no backward pass"):
        step(tparams, topt.init_state(tparams), _port_batch(_batch(tcfg, 2)))
