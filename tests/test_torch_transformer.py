"""The port's dense transformer against the JAX package: configs, layers,
``_project_qkv``, ``forward``, ``prefill_with_kv`` (logits and KV pages) and
``decode_step`` (logits and pools) on the smoke configs of the four dense
archs, with the JAX weights carried across by ``convert.params_from_numpy``,
within 1e-4 (tests/test_system.py's tolerance).  qwen3-14b's full-width
parameter shapes are held to the JAX package's on the meta device."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch import convert, models
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm

TOL = 1e-4
DENSE = ["qwen3-14b", "stablelm-12b", "gemma-7b", "starcoder2-7b"]


def _close(got: torch.Tensor, want, tol: float = TOL, what: str = ""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


def _models(arch: str, seed: int = 0, **overrides):
    jcfg = dataclasses.replace(jreg.get_smoke(arch), **overrides)
    tcfg = dataclasses.replace(treg.get_smoke(arch), **overrides)
    params = jtfm.init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                                        device="cpu")
    return jcfg, tcfg, params, tparams


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_configs_equal_jax(arch):
    for get in ("get_config", "get_smoke"):
        j, t = getattr(jreg, get)(arch), getattr(treg, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
        assert (j.q_dim, j.kv_dim, j.is_attention_free, j.supports_long_context) == \
               (t.q_dim, t.kv_dim, t.is_attention_free, t.supports_long_context)


def test_norms_rope_and_mlps_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    bias = rng.standard_normal(16).astype(np.float32) * 0.1
    tx = torch.from_numpy(x)
    _close(tlayers.rmsnorm(tx, torch.from_numpy(scale)), jlayers.rmsnorm(x, scale))
    _close(tlayers.layernorm(tx, torch.from_numpy(scale), torch.from_numpy(bias)),
           jlayers.layernorm(x, scale, bias))
    _close(tlayers.rope_freqs(16, 1e6), jlayers.rope_freqs(16, 1e6), tol=1e-7)
    for pos in (np.arange(5)[None, :], np.array([[7], [300]])):
        xs = x[:, :pos.shape[1]]
        _close(tlayers.apply_rope(torch.from_numpy(xs), torch.from_numpy(pos), 10_000.0),
               jlayers.apply_rope(jnp.asarray(xs), jnp.asarray(pos), 10_000.0))
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    for act in ("silu_glu", "gelu_glu", "gelu"):
        jp = jlayers.mlp_params(jax.random.PRNGKey(1), 32, 48, act)
        tp = tlayers.MLP(None, 32, 48, act, device="meta")
        tp.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()},
                           assign=True)
        _close(tlayers.mlp_forward(tp, torch.from_numpy(h), act),
               jlayers.mlp_forward(jp, jnp.asarray(h), act), what=act)


@pytest.mark.parametrize("arch", DENSE)
def test_project_qkv_matches_jax(arch):
    jcfg, tcfg, params, tparams = _models(arch, seed=1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    pos = np.array([[3], [11]]).repeat(7, 1) + np.arange(7)
    jl = jax.tree_util.tree_map(lambda a: a[1], params["layers"])["attn"]
    got = tattn._project_qkv(tparams.layers[1].attn, torch.from_numpy(x), tcfg,
                             torch.from_numpy(pos))
    want = jattn._project_qkv(jl, jnp.asarray(x), jcfg, jnp.asarray(pos))
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w, what=name)


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch):
    jcfg, tcfg, params, tparams = _models(arch)
    tok = _tokens(jcfg, 2, 13, 2)
    want, _ = jtfm.forward(params, jnp.asarray(tok), jcfg, kernel_mode="reference")
    got, aux = ttfm.forward(tparams, torch.from_numpy(tok), tcfg, kernel_mode="reference")
    _close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", DENSE)
def test_forward_hidden_matches_jax(arch):
    """The family dispatch's ``forward_hidden``: the final-normed hidden
    states and the unembedding matrix (tied for gemma)."""
    jcfg, tcfg, params, tparams = _models(arch, seed=5)
    tok = _tokens(jcfg, 2, 9, 6)
    jh, jhead, _ = jtfm.forward_hidden(params, jnp.asarray(tok), jcfg, kernel_mode="reference")
    th, thead, aux = models.forward_hidden(tparams, {"tokens": torch.from_numpy(tok)}, tcfg,
                                           kernel_mode="reference")
    _close(th, jh, what="hidden")
    _close(thead, jhead, tol=0, what="head")
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_with_kv_matches_jax(arch):
    jcfg, tcfg, params, tparams = _models(arch, seed=2, kv_page_size=4)
    tok = _tokens(jcfg, 2, 10, 3)                     # 10 tokens: a ragged last page
    want = jtfm.prefill_with_kv(params, jnp.asarray(tok), jcfg, kernel_mode="reference")
    got = ttfm.prefill_with_kv(tparams, torch.from_numpy(tok), tcfg, kernel_mode="reference")
    for g, w, name in zip(got, want, ("logits", "k pages", "v pages")):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, what=name)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_jax(arch):
    """Logits and pools after one decode step over pools with an unmapped
    page, a context that ends mid-page and one on a page boundary."""
    jcfg, tcfg, params, tparams = _models(arch, seed=3, kv_page_size=4)
    rng = np.random.default_rng(4)
    shape = (jcfg.num_layers, 16, 4, jcfg.num_kv_heads, jcfg.head_dim)
    kp, vp = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    table = np.array([[3, 5, -1], [7, 1, 2], [9, 4, 6]], np.int32)
    ctx = np.array([6, 11, 9], np.int32)
    tok = np.array([5, 9, 1], np.int32)
    want = jtfm.decode_step(params, jnp.asarray(tok), jcfg, jnp.asarray(kp), jnp.asarray(vp),
                            jnp.asarray(table), jnp.asarray(ctx), kernel_mode="reference")
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = ttfm.decode_step(tparams, torch.from_numpy(tok), tcfg, tk, tv,
                           torch.from_numpy(table), torch.from_numpy(ctx),
                           kernel_mode="reference")
    for g, w, name in zip(got, want, ("logits", "k pools", "v pools")):
        _close(g, w, what=name)
    assert got[1] is tk and got[2] is tv            # the pools are updated in place


def test_local_ctx_from_global_matches_jax():
    ctx = np.arange(0, 70, dtype=np.int32)
    for P in (1, 2, 4):
        for me in range(P):
            want = jtfm.local_ctx_from_global(jnp.asarray(ctx), jnp.int32(me), P, 8)
            got = ttfm.local_ctx_from_global(torch.from_numpy(ctx), me, P, 8)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_parameter_shapes_equal_jax_on_meta(arch):
    """The published width, without allocating it: every parameter of the
    port's module on the meta device has the name, shape and dtype the
    converter maps the JAX package's abstract parameters to."""
    cfg = treg.get_config(arch)
    model = ttfm.init(cfg, device="meta")
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in model.state_dict().items()}
    abstract = jreg.abstract_params(jreg.get_config(arch))
    want = {name: (tuple(leaf.shape[1:] if i is not None else leaf.shape), str(leaf.dtype))
            for name, (leaf, i) in convert.port_param_leaves(abstract)}
    assert got == want
    n = sum(int(np.prod(s)) for s, _ in got.values())
    norms = sum(int(np.prod(s)) for k, (s, _) in got.items() if "norm" in k or "ln" in k)
    assert n - norms == cfg.param_count()
    if arch == "qwen3-14b":
        assert cfg.param_count() == 14_767_882_240 and got["lm_head"] == ((5120, 151936),
                                                                          "bfloat16")


@pytest.mark.parametrize("arch", [a for a in treg.ARCH_IDS
                                  if a not in DENSE + ["rwkv6-1.6b", "zamba2-7b"]])
def test_other_families_raise_naming_the_roadmap(arch):
    """The families that once raised (moe, vlm, encdec) are ported: each
    builds through the family dispatch; only an unknown family raises."""
    cfg = treg.get_smoke(arch)
    model = models.init(cfg, device="meta")
    assert models.get_family_module(cfg).init(cfg, device="meta").state_dict().keys() == \
        model.state_dict().keys()
    with pytest.raises(ValueError, match="unknown model family"):
        models.init(dataclasses.replace(cfg, family="retrieval"), device="meta")


def test_moe_config_raises_and_converter_refuses_mismatched_leaves():
    """A MoE config builds MoE layers (``moe`` in place of ``mlp``, the
    experts stacked on a parameter axis), and the converter refuses a leaf
    whose shape does not match the port's."""
    cfg = treg.get_smoke("qwen3-moe-30b-a3b")
    layer = ttfm.init(cfg, device="meta").layers[0]
    assert not hasattr(layer, "mlp") and tuple(layer.moe.w_gate.shape) == (
        cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert)
    jcfg = jreg.get_smoke("qwen3-14b")
    tree = jax.tree_util.tree_map(np.asarray, jtfm.init(jax.random.PRNGKey(0), jcfg))
    tree["embed"] = tree["embed"][:, :8]
    with pytest.raises(ValueError, match="embed"):
        convert.params_from_numpy(tree, treg.get_smoke("qwen3-14b"), device="cpu")


def test_init_is_seeded_and_default_device_is_the_card():
    cfg = treg.get_smoke("gemma-7b")
    a, b = (ttfm.init(cfg, seed=5, device="cpu") for _ in range(2))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    assert not any(p.requires_grad for p in a.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ttfm.init(cfg)
