"""K1 (``repro_torch.kernels.tlb_sim``) against the JAX package's TLB
simulation: hits and carried ``(tags, last)`` state bit-identical.

The JAX side runs ``kernel_mode="reference"`` (its own suite holds
``pallas_interpret`` equal to it) and, where the carried state's parked row
matters, ``pallas_interpret`` itself.  The port runs on the CPU, i.e. its
plain PyTorch version; ``tests/test_torch_cuda.py`` holds the CUDA kernel to
that plain version on a card.
"""
import numpy as np
import pytest
import torch
from _torch_parity import assert_same, split_points, t_of

pytest.importorskip("jax")  # the parity tests need the JAX package (CPU only)
import jax.numpy as jnp

from repro.core import tlbsim as jsim
from repro.core.sparta import TLBConfig as JTLBConfig
from repro.kernels import tlb_sim as jops
from repro_torch.core import tlbsim as tsim
from repro_torch.core.sparta import TLBConfig
from repro_torch.kernels import tlb_sim as tops
from repro_torch.kernels.tlb_sim.kernel import tlb_sim_carry_cuda
from repro_torch.kernels.tlb_sim.ref import tlb_sim_batched_carry_ref


def _keys(rng, TS, shape, tags=50):
    s = rng.integers(0, TS, shape).astype(np.int32)
    t = rng.integers(0, tags, shape).astype(np.int32)
    return s, t


@pytest.mark.parametrize("TS,W,N", [(16, 4, 1024), (64, 4, 2048), (8, 2, 512), (5, 3, 777)])
def test_tlb_sim_single_matches_jax(rng, TS, W, N):
    s, t = _keys(rng, TS, N)
    want = jops.tlb_sim(jnp.asarray(s), jnp.asarray(t), TS, W, kernel_mode="reference")
    got = tops.tlb_sim(t_of(s), t_of(t), TS, W)
    assert_same(got, want)


@pytest.mark.parametrize("TS,W,N,valid", [
    (16, 4, 1024, (4, 2, 1)),     # heterogeneous associativity
    (32, 4, 512, (4, 4, 4, 3)),
    (9, 8, 1001, (8, 1, 5, 2, 7, 3, 6, 4)),
])
def test_tlb_sim_batched_matches_jax(rng, TS, W, N, valid):
    s, t = _keys(rng, TS, (len(valid), N))
    want = jops.tlb_sim_batched(jnp.asarray(s), jnp.asarray(t), TS, W, valid,
                                kernel_mode="reference")
    got = tops.tlb_sim_batched(t_of(s), t_of(t), TS, W, valid)
    assert_same(got, want)
    # Each batched row == the single-config op on that config's geometry.
    for b, vw in enumerate(valid):
        assert_same(got[b], tops.tlb_sim(t_of(s[b]), t_of(t[b]), TS, vw), f"row {b}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tlb_sim_carry_random_chunks_match_jax(seed):
    rng = np.random.default_rng(seed)
    TS, W, N, valid = 12, 4, 1203, (4, 3, 1, 2)
    s, t = _keys(rng, TS, (len(valid), N))
    jtags, jlast = jsim.padded_tlb_state(len(valid), TS + 1, W, valid)
    ttags, tlast = tsim.padded_tlb_state(len(valid), TS + 1, W, valid, device="cpu")
    jh, th = [], []
    bounds = [0, *split_points(rng, N), N]
    for lo, hi in zip(bounds, bounds[1:]):
        h, jtags, jlast = jops.tlb_sim_batched_carry(
            jnp.asarray(s[:, lo:hi]), jnp.asarray(t[:, lo:hi]), jtags, jlast, lo,
            kernel_mode="reference")
        jh.append(np.asarray(h))
        h, ttags, tlast = tops.tlb_sim_batched_carry(
            t_of(s[:, lo:hi]), t_of(t[:, lo:hi]), ttags, tlast, lo)
        th.append(h)
        assert_same(ttags, jtags, f"tags after chunk {lo}:{hi}")
        assert_same(tlast, jlast, f"last after chunk {lo}:{hi}")
    assert_same(torch.cat(th, 1), np.concatenate(jh, 1))
    mono = jops.tlb_sim_batched(jnp.asarray(s), jnp.asarray(t), TS + 1, W, valid,
                                kernel_mode="reference")
    assert_same(torch.cat(th, 1), mono)


def test_tlb_sim_carry_parked_row_matches_jax_pallas():
    """The spare parked set row round-trips untouched and the state equals
    the TPU kernel's (interpreted) after chunks that needed no padding."""
    rng = np.random.default_rng(4)
    TS, W, valid = 8, 2, (2, 1)
    s, t = _keys(rng, TS, (2, 512))
    jtags, jlast = jsim.padded_tlb_state(2, TS + 1, W, valid)
    ttags, tlast = tsim.padded_tlb_state(2, TS + 1, W, valid, device="cpu")
    for lo, hi in ((0, 256), (256, 384), (384, 512)):
        jh, jtags, jlast = jops.tlb_sim_batched_carry(
            jnp.asarray(s[:, lo:hi]), jnp.asarray(t[:, lo:hi]), jtags, jlast, lo,
            block=128, kernel_mode="pallas_interpret")
        th, ttags, tlast = tops.tlb_sim_batched_carry(
            t_of(s[:, lo:hi]), t_of(t[:, lo:hi]), ttags, tlast, lo)
        assert_same(th, jh)
        assert_same(ttags, jtags)
        assert_same(tlast, jlast)
    fresh = tsim.padded_tlb_state(2, TS + 1, W, valid, device="cpu")
    assert_same(ttags[:, TS], fresh[0][:, TS])
    assert_same(tlast[:, TS], fresh[1][:, TS])


def test_padded_state_and_keys_match_jax(rng):
    for args in [(3, 7, 4, (4, 1, 2)), (1, 1, 1, (1,))]:
        for j, t in zip(jsim.padded_tlb_state(*args),
                        tsim.padded_tlb_state(*args, device="cpu")):
            assert_same(t, j)
    vpns = rng.integers(0, 1 << 31, 3000).astype(np.int64)
    for sets, parts in [(32, 1), (32, 8), (1, 128), (512, 4)]:
        js, jtag = jsim._prepare_keys(vpns, sets, parts)
        ts, ttag = tsim._prepare_keys(t_of(vpns), sets, parts)
        assert_same(ts, js)
        assert_same(ttag, jtag)


def test_tag_overflow_raises():
    vpns = np.array([0, 1 << 40], np.int64)
    with pytest.raises(ValueError, match="tag overflow"):
        jsim._prepare_keys(vpns, 1, 1)
    with pytest.raises(ValueError, match="tag overflow"):
        tsim._prepare_keys(t_of(vpns), 1, 1)


@pytest.mark.parametrize("entries,ways,parts", [(64, 4, 1), (16, 4, 8), (2, 4, 4), (32, 8, 2)])
def test_simulate_tlb_and_miss_ratio_match_jax(rng, entries, ways, parts):
    vpns = rng.integers(0, 600, 1500).astype(np.int64)
    want = jsim.simulate_tlb(vpns, JTLBConfig(entries=entries, ways=ways),
                             num_partitions=parts)
    got = tsim.simulate_tlb(vpns, TLBConfig(entries=entries, ways=ways),
                            num_partitions=parts, device="cpu")
    assert_same(got.hits, want.hits)
    assert got.n_warm == want.n_warm
    assert got.miss_ratio == want.miss_ratio      # exact float64 equality
    assert got.hit_ratio == want.hit_ratio
    assert tsim.miss_ratio(vpns, entries, ways=ways, num_partitions=parts,
                           device="cpu") == want.miss_ratio


def test_miss_ratio_curve_matches_jax(rng):
    lines = rng.integers(0, 1 << 22, 1500).astype(np.int64)
    sizes = (4, 16, 64, 256)
    want = jsim.miss_ratio_curve(lines, sizes, num_partitions=4, kernel_mode="reference")
    got = tsim.miss_ratio_curve(lines, sizes, num_partitions=4, device="cpu")
    assert got.dtype == np.float64
    assert np.array_equal(got, want)


def test_modes_and_cpu_wrapper(rng):
    s, t = _keys(rng, 8, (2, 300))
    tags, last = tsim.padded_tlb_state(2, 8, 4, (4, 2), device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tops.tlb_sim_batched_carry(t_of(s), t_of(t), tags, last, 0, kernel_mode="cuda")
    with pytest.raises(ValueError, match="kernel_mode"):
        tops.tlb_sim_batched_carry(t_of(s), t_of(t), tags, last, 0, kernel_mode="pallas")
    # On CPU tensors the kernel wrapper runs the plain version, and neither
    # modifies the caller's state.
    before = (tags.clone(), last.clone())
    a = tlb_sim_carry_cuda(t_of(s), t_of(t), tags, last, 5)
    b = tlb_sim_batched_carry_ref(t_of(s), t_of(t), tags, last, 5)
    for x, y in zip(a, b):
        assert_same(x, y)
    assert_same(tags, before[0])
    assert_same(last, before[1])
