"""The port's stack-distance engine (``repro_torch.core.stackdist`` and the
plain version of kernel K3, ``repro_torch.kernels.stackdist.ref``) against
the JAX package's: depths, final stacks and lane carries bit-identical
(tolerance 0)."""
import numpy as np
import pytest
import torch
from _torch_parity import assert_same, t_of

pytest.importorskip("jax")  # the parity tests need the JAX package (CPU only)
import jax.numpy as jnp

from repro.core import stackdist as jsd
from repro.kernels.stackdist import stack_scan as jstack_scan
from repro_torch.core import stackdist as tsd
from repro_torch.kernels.stackdist import stack_scan


def _valid_stacks(rng, shape, W, n_tags=12):
    """Random capped LRU stacks: distinct tags first, then -1 (empty)."""
    out = np.full(shape + (W,), -1, np.int32)
    for ix in np.ndindex(*shape):
        k = int(rng.integers(0, min(W, n_tags) + 1))
        out[ix][:k] = rng.choice(n_tags, k, replace=False)
    return out


@pytest.mark.parametrize("W", [1, 4, 8, 40])
def test_stack_scan_plain_matches_jax(W):
    rng = np.random.default_rng(W)
    L, C = 9, 70
    tags = rng.integers(0, 3 * W, (L, C)).astype(np.int32)
    tags[-1, -5:] = -2                     # padding tags, as the engine uses
    seg = rng.random((L, C)) < 0.08
    init = _valid_stacks(rng, (L,), W, n_tags=3 * W)
    jd, jf = jstack_scan(jnp.asarray(tags), jnp.asarray(seg), jnp.asarray(init),
                         kernel_mode="reference")
    td, tf = stack_scan(t_of(tags), t_of(seg), t_of(init), kernel_mode="reference")
    assert_same(td, jd, "depths")
    assert_same(tf, jf, "final")
    assert td.dtype == tf.dtype == torch.int32


@pytest.mark.parametrize("W", [1, 2, 4, 16])
def test_lane_prefix_matches_jax(W):
    """The doubling-scan prefix equals the reference's lane-by-lane walk."""
    rng = np.random.default_rng(100 + W)
    G, NB = 3, 77
    finals = _valid_stacks(rng, (G, NB), W)
    has_start = rng.random((G, NB)) < 0.15
    has_start[:, 0] = True
    want = jsd._lane_prefix(jnp.asarray(finals), jnp.asarray(has_start))
    assert_same(tsd._lane_prefix(t_of(finals), t_of(has_start)), want)


@pytest.mark.parametrize("n,G,sets,tags,cap,block", [
    (2000, 3, 4, 20, 4, 32),       # many lanes per stream
    (1111, 2, 16, 64, 8, 64),      # length not a block multiple
    (700, 4, 1, 30, 16, 32),       # one set: one long segment across lanes
    (2048, 2, 64, 1000, 4, 1024),  # mostly cold
    (33, 1, 2, 5, 1, 32),          # one way, one padded lane
])
def test_stack_depths_batched_matches_jax(n, G, sets, tags, cap, block):
    rng = np.random.default_rng(n + G)
    s = rng.integers(0, sets, (G, n))
    t = rng.integers(0, tags, (G, n))
    want = jsd.stack_depths_batched(s, t, cap=cap, kernel_mode="reference", block=block)
    got = tsd.stack_depths_batched(t_of(s), t_of(t), cap=cap, kernel_mode="reference",
                                   block=block)
    assert_same(got, want)
    assert_same(tsd.stack_depths(t_of(s[0]), t_of(t[0]), cap=cap, block=block), want[0])


def test_prev_occurrence_reuse_distances_and_hits_match_jax():
    rng = np.random.default_rng(5)
    s, t = rng.integers(0, 8, 1500), rng.integers(0, 40, 1500)
    assert_same(tsd.prev_occurrence(t_of(s), t_of(t)), jsd.prev_occurrence(s, t))
    want = jsd.reuse_distances(s, t, kernel_mode="reference", block=32)
    got = tsd.reuse_distances(t_of(s), t_of(t), kernel_mode="reference", block=32)
    assert_same(got, want)
    assert int(got.max()) == tsd.STACKDIST_INF == int(jsd.STACKDIST_INF)
    d = tsd.stack_depths(t_of(s), t_of(t), cap=8, block=64)
    for w in (1, 3, 8):
        assert_same(tsd.hits_from_depths(d, w), jsd.hits_from_depths(d.numpy(), w))


def test_stack_depths_errors_and_empty():
    s = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match=">= 1"):
        tsd.stack_depths_batched(s, s, cap=0)
    with pytest.raises(ValueError, match="MAX_CAP"):
        tsd.stack_depths_batched(s, s, cap=tsd.MAX_CAP + 1)
    with pytest.raises(ValueError, match="int32"):
        tsd.stack_depths_batched(s, s - 1, cap=4)
    empty = tsd.stack_depths_batched(s[:, :0], s[:, :0], cap=4)
    assert empty.shape == (1, 0) and empty.dtype == torch.int32
    assert (tsd.AUTO_MAX_WAYS, tsd.MAX_CAP) == (jsd.AUTO_MAX_WAYS, jsd.MAX_CAP)
