"""The port's gradient compression (``repro_torch.distributed.compression``)
and elastic re-meshing policy (``repro_torch.runtime.elastic.plan_remesh``)
against the JAX package's on the CPU: top-k with error feedback, the int8
round trip and the byte counts bit for bit on seeded float32 trees with
planted ties, the conservation ``kept + new_err == g + err`` exactly, the
compressors as ``make_train_step``'s ``compress_grads``, and the remesh
plans."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.distributed import compression as jcomp
from repro.runtime import elastic as jel
from repro_torch.distributed import compression as tcomp
from repro_torch.runtime import elastic as tel

RATIOS = [0.01, 0.05, 0.1, 0.5, 1.0]


def _tree(seed: int):
    """float32 leaves of several ranks; ties planted at the top of |g| (the
    same magnitude with both signs, repeated), exact zeros, a row of zeros
    (int8's scale 1.0) and a tiny leaf (k = max(1, ...))."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    w.flat[rng.choice(w.size, 40, replace=False)] = np.float32(3.5) * rng.choice([-1, 1], 40)
    w[5] = 0.0
    b = np.round(rng.standard_normal(37) * 4).astype(np.float32)     # many ties
    c = rng.standard_normal((3, 4, 5)).astype(np.float32) * 1e-3
    return {"w": w, "nested": {"b": b, "c": c}, "s": np.array([0.25, -0.25], np.float32)}


def _err(seed: int, tree):
    rng = np.random.default_rng(seed + 100)
    return {k: (_err(seed, v) if isinstance(v, dict) else
                (rng.standard_normal(v.shape) * 0.5).astype(np.float32))
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    """(path, leaf) in sorted path order (JAX returns dicts key-sorted)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _to_t(tree):
    return {k: _to_t(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _to_j(tree):
    return {k: _to_j(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _bits(a) -> bytes:
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a).tobytes()


@pytest.mark.parametrize("zero_err", [True, False], ids=["init", "carried"])
@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_bit_identical_to_jax(seed, ratio, zero_err):
    g = _tree(seed)
    err = {k: (np.zeros_like(v) if not isinstance(v, dict) else
               {kk: np.zeros_like(vv) for kk, vv in v.items()}) for k, v in g.items()} \
        if zero_err else _err(seed, g)
    jk, je = jcomp.topk_compress(_to_j(g), _to_j(err), ratio)
    tk, te = tcomp.topk_compress(_to_t(g), _to_t(err), ratio)
    for (name, a), (_, b) in zip(_flat(jk), _flat(tk)):
        assert b.dtype == torch.float32 and _bits(a) == _bits(b), name
    for (name, a), (_, b) in zip(_flat(je), _flat(te)):
        assert _bits(a) == _bits(b), name
    # Nothing is lost, only deferred: kept + new error == g + err exactly.
    for (name, gl), (_, el), (_, kl), (_, nl) in zip(_flat(g), _flat(err), _flat(tk), _flat(te)):
        assert np.array_equal(kl.numpy() + nl.numpy(), gl + el), name
        k = max(1, int(gl.size * ratio))
        assert (kl.numpy() != 0).sum() >= min(k, np.count_nonzero(gl + el)), name


def test_topk_keeps_every_tie_at_the_threshold():
    g = torch.tensor([1.0, -3.0, 3.0, 2.0, 3.0, 0.5])
    kept, err = tcomp.topk_compress_leaf(g, torch.zeros(6), 2 / 6)   # k = 2, three at |3|
    assert kept.tolist() == [0.0, -3.0, 3.0, 0.0, 3.0, 0.0]
    assert err.tolist() == [1.0, 0.0, 0.0, 2.0, 0.0, 0.5]
    assert _bits(kept) == _bits(jcomp.topk_compress_leaf(
        jnp.asarray(g.numpy()), jnp.zeros(6, jnp.float32), 2 / 6)[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_roundtrip_bit_identical_to_jax(seed):
    g = _tree(seed)
    g["half"] = (np.arange(-8, 8, dtype=np.float32) * np.float32(0.5)).reshape(2, 8)  # .5 ties
    jo, to = jcomp.int8_roundtrip(_to_j(g)), tcomp.int8_roundtrip(_to_t(g))
    for (name, a), (_, b) in zip(_flat(jo), _flat(to)):
        assert _bits(a) == _bits(b), name
    for name, leaf in _flat(g):
        jq, js = jcomp.int8_quantize(jnp.asarray(leaf))
        tq, ts = tcomp.int8_quantize(torch.from_numpy(leaf.copy()))
        assert tq.dtype == torch.int8 and _bits(jq) == _bits(tq), name
        assert _bits(js) == _bits(ts), name
    # The JAX test's bound: one quantisation step of the row's scale.
    w = torch.from_numpy(g["w"])
    scale = w.abs().amax(-1).max()
    assert (to["w"] - w).abs().max() <= scale / 127.0 + 1e-6


@pytest.mark.parametrize("kind", ["topk", "int8", "none"])
def test_compressed_bytes_equal_jax(kind):
    g = _tree(0)
    g["bf16"] = np.ones((4, 8), np.float32)
    jt, tt = _to_j(g), _to_t(g)
    jt["bf16"], tt["bf16"] = jt["bf16"].astype(jnp.bfloat16), tt["bf16"].bfloat16()
    for ratio in RATIOS:
        jc, tc = jcomp.CompressionConfig(kind, ratio), tcomp.CompressionConfig(kind, ratio)
        assert tcomp.compressed_bytes(tt, tc) == jcomp.compressed_bytes(jt, jc)


def test_compressors_as_compress_grads():
    """Both compressors run as ``make_train_step``'s ``compress_grads``: the
    top-k step's kept gradients plus the carried error equal the raw ones
    (the same step with an identity tap), and the int8 step applies the
    round trip of those gradients."""
    from repro_torch import models
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, batch_for_model
    from repro_torch.train.optimizer import OptimizerConfig, init_state
    from repro_torch.train.train_step import make_train_step

    cfg = registry.get_smoke("qwen3-14b")
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    batch = {k: torch.from_numpy(v) for k, v in batch_for_model(data, cfg, 0).items()}
    seen = {}

    def run(compress):
        params = models.init(cfg, seed=0, device="cpu")
        step = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=1),
                               compress_grads=compress)
        return step(params, init_state(params), batch)

    run(lambda g: seen.setdefault("raw", {n: t.clone() for n, t in g.items()}))
    compress, state = tcomp.topk_with_feedback(models.init(cfg, device="cpu"), 0.05)

    def tap_topk(g):
        kept = compress(g)
        seen["kept"] = {n: t.clone() for n, t in kept.items()}
        return kept

    params, _, m = run(tap_topk)
    assert np.isfinite(float(m["loss"]))
    for n, raw in seen["raw"].items():
        assert torch.equal(seen["kept"][n] + state["err"][n], raw), n
        k = max(1, int(raw.numel() * 0.05))
        assert int((seen["kept"][n] != 0).sum()) >= min(k, int((raw != 0).sum())), n
    kept_share = sum(int((t != 0).sum()) for t in seen["kept"].values()) / sum(
        t.numel() for t in seen["raw"].values())
    assert 0.04 < kept_share < 0.1

    def tap_int8(g):
        out = tcomp.int8_roundtrip(g)
        seen["int8"] = out
        return out

    run(tap_int8)
    for n, raw in seen["raw"].items():
        assert torch.equal(seen["int8"][n], tcomp.int8_roundtrip({n: raw})[n]), n


@pytest.mark.parametrize("available,model_axis", [(1, 1), (4, 2), (8, 4), (253, 16), (256, 16),
                                                   (511, 16), (7, 2), (16, 16)])
def test_plan_remesh_equals_jax(available, model_axis):
    want = jel.plan_remesh(available, model_axis=model_axis)
    got = tel.plan_remesh(available, model_axis=model_axis)
    assert (got.shape, got.axes, got.dropped_devices, got.size) == \
        (want.shape, want.axes, want.dropped_devices, want.size)
    if available == 253:
        assert got.shape == (15, 16) and got.dropped_devices == 13


def test_plan_remesh_refuses_too_few_devices():
    with pytest.raises(ValueError, match="need >= 16 devices, have 15"):
        tel.plan_remesh(15)
    with pytest.raises(ValueError) as jerr:
        jel.plan_remesh(15)
    assert str(jerr.value) == "need >= 16 devices, have 15"
