"""The port's shape cells, global-view paged attention
(``models/paged_global.py``) and partition-explicit serve step
(``serve/serve_step.py``) against the JAX package on the CPU.

* the registry's cells: ``SHAPES``, ``cell_applicable``, ``all_cells``,
  ``pool_geometry``, ``input_specs`` (shapes and dtypes, every cell) and
  ``abstract_params`` (names, shapes and dtypes of all ten architectures at
  full width, on the meta device);
* ``local_ctx_all_partitions``, ``paged_attention_global`` with and without
  the hot tail, ``write_kv_global`` against JAX's default "scatter" write
  at two geometries (tolerance 0, including its unmapped-slot quirk);
* ``decode_block_global`` at P = 1, 2 and 4 and ``make_serve_step`` for all
  six families on ``input_specs``-shaped inputs (2e-4 on logits, 1e-4 on
  the new state), with the JAX weights carried across by
  ``convert.params_from_numpy``; and the serve step against each family's
  single-partition decode path in the port (tests/_serve_cases.py, the
  check chip_smoke.py makes on the card).
"""
import dataclasses

import _serve_cases as sc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import np_of, t_of

from repro import models as jmodels
from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import paged_global as jpg
from repro.serve import serve_step as jss
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import paged_global as tpg
from repro_torch.serve import serve_step as tss

LOGITS_TOL, STATE_TOL, ATTN_TOL = 2e-4, 1e-4, 1e-5
FAMILIES = {"dense": "qwen3-14b", "moe": "qwen3-moe-30b-a3b", "vlm": "internvl2-2b",
            "hybrid": "zamba2-7b", "ssm": "rwkv6-1.6b", "encdec": "whisper-medium"}
# A decode cell of the tests' own: 2 sequences of up to 48 tokens.
SMALL = tbase.ShapeConfig("decode_small", 48, 2, "decode")


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np_of(got).astype(np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=what)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "").replace("dtype(", "").strip("')")


# -- shape cells ----------------------------------------------------------------

def test_shapes_cells_and_geometry_equal_jax():
    assert [dataclasses.asdict(s) for s in tbase.SHAPES] == \
           [dataclasses.asdict(s) for s in jbase.SHAPES]
    assert sorted(tbase.SHAPES_BY_NAME) == sorted(jbase.SHAPES_BY_NAME)
    assert [s.lowers_serve_step for s in tbase.SHAPES] == \
           [s.lowers_serve_step for s in jbase.SHAPES]
    for arch in treg.ARCH_IDS:
        for ts, js in zip(tbase.SHAPES, jbase.SHAPES):
            assert tbase.cell_applicable(treg.get_config(arch), ts) == \
                   jbase.cell_applicable(jreg.get_config(arch), js)
            for P in (1, 3, 16):
                assert treg.pool_geometry(treg.get_config(arch), ts, P) == \
                       jreg.pool_geometry(jreg.get_config(arch), js, P)
    got = [(a, s.name) for a, s in treg.all_cells()]
    assert got == [(a, s.name) for a, s in jreg.all_cells()]
    assert len(got) == 32


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_input_specs_equal_jax_for_every_cell(arch):
    for cfg_of in ("get_config", "get_smoke"):
        tcfg, jcfg = getattr(treg, cfg_of)(arch), getattr(jreg, cfg_of)(arch)
        for ts, js in zip(tbase.SHAPES, jbase.SHAPES):
            ok, _ = tbase.cell_applicable(tcfg, ts)
            if not ok:
                with pytest.raises(ValueError):
                    treg.input_specs(tcfg, ts)
                continue
            for P in (16, 4):
                got = treg.input_specs(tcfg, ts, num_partitions=P)
                want = jreg.input_specs(jcfg, js, num_partitions=P)
                assert sorted(got) == sorted(want), (arch, ts.name)
                for k, t in got.items():
                    assert t.device.type == "meta"
                    assert (tuple(t.shape), _dtype_name(t.dtype)) == \
                           (tuple(want[k].shape), _dtype_name(want[k].dtype)), (arch, ts.name, k)


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_abstract_params_equal_jax_at_full_width_on_meta(arch):
    """Every architecture at its published width, nothing allocated: the
    port's parameter names, shapes and dtypes are those the converter maps
    the JAX package's abstract parameters to."""
    cfg = treg.get_config(arch)
    model = treg.abstract_params(cfg)
    got = {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in model.state_dict().items()}
    assert all(v.device.type == "meta" for v in model.state_dict().values())
    stacked = lambda i: 0 if i is None else len(i) if isinstance(i, tuple) else 1  # noqa: E731
    want = {name: (tuple(leaf.shape[stacked(i):]), _dtype_name(leaf.dtype))
            for name, (leaf, i) in convert.port_param_leaves(jreg.abstract_params(
                jreg.get_config(arch)))}
    assert got == want


# -- global-view paged attention --------------------------------------------------

def _global_case(seed, B, P, pl, page, Hkv, G, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv * G, hd)).astype(np.float32)
    kp, vp = (rng.standard_normal((B, P, pl, page, Hkv, hd)).astype(np.float32)
              for _ in range(2))
    tables = np.stack([np.stack([rng.permutation(pl) for _ in range(P)]) for _ in range(B)])
    tables = tables.astype(np.int32)
    tables[0, P - 1, pl - 1] = -1                     # an unmapped page
    ctx = rng.integers(0, P * pl * page, B).astype(np.int32)
    ctx[-1] = 0
    extra = tuple(rng.standard_normal((B, Hkv, hd)).astype(np.float32) for _ in range(2))
    return q, kp, vp, tables, ctx, extra


def test_local_ctx_all_partitions_equals_jax():
    ctx = np.arange(0, 90, dtype=np.int32)
    for P in (1, 2, 3, 4):
        got = tpg.local_ctx_all_partitions(t_of(ctx), P, 8)
        want = jax.jit(jpg.local_ctx_all_partitions, static_argnums=(1, 2))(
            jnp.asarray(ctx), P, 8)
        np.testing.assert_array_equal(np_of(got), np.asarray(want))


@pytest.mark.parametrize("P,G", [(1, 1), (2, 2), (4, 4), (3, 5)])
def test_paged_attention_global_equals_jax(P, G):
    q, kp, vp, tables, ctx, extra = _global_case(P * 10 + G, 3, P, 3, 4, 2, G, 16)
    jitted = jax.jit(jpg.paged_attention_global)
    for ex in (None, extra):
        want = jitted(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
                      jnp.asarray(ctx),
                      extra_kv=None if ex is None else tuple(jnp.asarray(e) for e in ex))
        got = tpg.paged_attention_global(t_of(q), t_of(kp), t_of(vp), t_of(tables), t_of(ctx),
                                         extra_kv=None if ex is None else
                                         tuple(t_of(e) for e in ex))
        assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
        _close(got, want, ATTN_TOL, f"extra_kv={ex is not None}")


@pytest.mark.parametrize("P,pl,page", [(2, 3, 4), (4, 2, 2)])
def test_write_kv_global_equals_jax(P, pl, page):
    """Every (partition, page, offset) a context can end on, and the
    unmapped-slot quirk of the JAX package's default "scatter" write: where
    the current page's table entry is -1, the row goes into the owner's
    slot 0 at the offset."""
    B = 3
    rng = np.random.default_rng(7 + P)
    pool = rng.standard_normal((B, P, pl, page, 2, 8)).astype(np.float32)
    tables = np.stack([np.stack([rng.permutation(pl) for _ in range(P)]) for _ in range(B)])
    tables = tables.astype(np.int32)
    tables[1, 1, 0] = -1                              # logical page 1 of sequence 1
    jitted = jax.jit(jpg.write_kv_global, static_argnums=4)
    for c in range(1, P * pl * page + 1):
        ctx = np.array([c, page + 1 + (c % page), c], np.int32)  # sequence 1 on page 1
        new = rng.standard_normal((B, 2, 8)).astype(np.float32)
        want = jitted(jnp.asarray(pool), jnp.asarray(tables), jnp.asarray(new),
                      jnp.asarray(ctx), page)
        tp = t_of(pool)
        got = tpg.write_kv_global(tp, t_of(tables), t_of(new), t_of(ctx), page)
        assert got is tp                              # updated in place
        np.testing.assert_array_equal(np_of(got), np.asarray(want), err_msg=f"ctx {ctx}")
    # The quirk itself: the unmapped page's row lands in slot 0.
    ctx = np.array([1, page + 2, 1], np.int32)
    new = np.full((B, 2, 8), 9.0, np.float32)
    got = np_of(tpg.write_kv_global(t_of(pool), t_of(tables), t_of(new), t_of(ctx), page))
    assert np.all(got[1, 1, 0, 1] == 9.0)
    assert np.array_equal(got[1, 1, 1:], pool[1, 1, 1:])


def _models(arch: str, seed: int = 0, **overrides):
    jcfg = dataclasses.replace(jreg.get_smoke(arch), **overrides)
    tcfg = dataclasses.replace(treg.get_smoke(arch), **overrides)
    params = jmodels.init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                                        device="cpu")
    return jcfg, tcfg, params, tparams


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen3-moe-30b-a3b"])
def test_decode_block_global_equals_jax(arch, P):
    jcfg, tcfg, params, tparams = _models(arch, seed=P, kv_page_size=4)
    q, kp, vp, tables, ctx, _ = _global_case(P, 2, P, 2, 4, jcfg.num_kv_heads,
                                             jcfg.num_heads // jcfg.num_kv_heads, jcfg.head_dim)
    ctx = np.maximum(ctx, 0) + 1                      # incl. the new token
    x = np.random.default_rng(P).standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jl = jax.tree_util.tree_map(lambda a: a[1], params["layers"])
    for skip in (False, True):
        want = jax.jit(jpg.decode_block_global, static_argnames=("cfg", "skip_mlp"))(
            jl, jnp.asarray(x), jcfg, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
            jnp.asarray(ctx), skip_mlp=skip)
        got = tpg.decode_block_global(tparams.layers[1], t_of(x), tcfg, t_of(kp), t_of(vp),
                                      t_of(tables), t_of(ctx), skip_mlp=skip)
        for g, w, name in zip(got, want, ("x", "k_pool", "v_pool")):
            _close(g, w, STATE_TOL, f"{name} skip_mlp={skip}")


# -- the serve step ------------------------------------------------------------------

def _numpy_inputs(tcfg, seed: int, P: int):
    """``input_specs``' inputs of SMALL at P partitions from a numpy seed:
    contexts 1 to 40 tokens (the new token included)."""
    rng = np.random.default_rng(seed)
    specs = treg.input_specs(tcfg, SMALL, num_partitions=P)
    ctx = t_of(rng.integers(1, 41, SMALL.global_batch).astype(np.int32))
    return sc.random_inputs(
        tcfg, specs, ctx,
        normal=lambda shape: t_of(rng.standard_normal(shape).astype(np.float32)),
        integers=lambda high, shape: t_of(rng.integers(0, high, shape).astype(np.int32)))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_serve_step_equals_jax_and_the_single_partition_path(family):
    arch = FAMILIES[family]
    jcfg, tcfg, params, tparams = _models(arch, seed=3, kv_page_size=4)
    inputs = _numpy_inputs(tcfg, 11, P=4)
    jspecs = jreg.input_specs(jcfg, jbase.ShapeConfig(**dataclasses.asdict(SMALL)),
                              num_partitions=4)
    assert sorted(jspecs) == sorted(inputs)
    sp = sc.single_partition(inputs) if "k_pools" in inputs else {}
    jin = {k: jnp.asarray(np_of(v)) for k, v in inputs.items()}
    want_logits, want_state = jax.jit(jss.make_serve_step(jcfg, kernel_mode="reference"))(
        params, jin)
    snapshot = {k: v.clone() for k, v in inputs.items()}
    logits, state = tss.make_serve_step(tcfg, kernel_mode="reference")(tparams, inputs)
    _close(logits, want_logits, LOGITS_TOL, f"{arch} logits")
    assert sorted(state) == sorted(want_state)
    for k in state:
        _close(state[k], want_state[k], STATE_TOL, f"{arch} {k}")
    # The port's own single-partition decode path over the same state.
    single, single_state = sc.decode_single(tcfg, tparams, sp, snapshot, kernel_mode="reference")
    _close(single, logits, LOGITS_TOL, f"{arch} single-partition logits")
    for k, v in single_state.items():
        _close(v, state[k], STATE_TOL, f"{arch} single-partition {k}")


def test_prefix_written_through_write_kv_global_reads_back_in_both_layouts():
    """tests/_serve_cases.write_prefix fills the global-view pools through
    ``write_kv_global``; read through ``single_partition``'s table, every
    sequence's rows come back in order."""
    L, B, P, pl, page, Hkv, hd = 2, 3, 4, 2, 4, 2, 8
    rng = np.random.default_rng(5)
    pools = torch.zeros((L, B, P, pl, page, Hkv, hd))
    tables = t_of(np.stack([np.stack([rng.permutation(pl) for _ in range(P)])
                            for _ in range(B)]).astype(np.int32))
    kv = t_of(rng.standard_normal((L, B, P * pl * page, Hkv, hd)).astype(np.float32))
    ctx0 = t_of(np.array([29, 1, 32], np.int32))
    sc.write_prefix(pools, tables, kv, ctx0, page)
    sp = sc.single_partition({"k_pools": pools, "v_pools": pools, "tables": tables})
    for b in range(B):
        rows = sp["k_pools"][:, sp["table"][b].long()].reshape(L, -1, Hkv, hd)
        n = int(ctx0[b])
        assert torch.equal(rows[:, :n], kv[:, b, :n])
        assert not rows[:, n:].any()
