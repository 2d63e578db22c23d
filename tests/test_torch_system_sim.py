"""K2 (``repro_torch.kernels.system_sim``) against the JAX package's joint
system simulation: hits, carried state and every hit ratio bit-identical.

The JAX side runs ``kernel_mode="reference"`` and, for the parked-row
check, ``pallas_interpret``; the port runs its plain version on the CPU.
``tests/test_torch_cuda.py`` holds the CUDA kernel to that plain version on
a card.
"""
import numpy as np
import pytest
import torch
from _torch_parity import assert_same, random_lines, split_points, t_of

pytest.importorskip("jax")  # the parity tests need the JAX package (CPU only)
import jax.numpy as jnp

from repro.core import sweep as jsweep
from repro.core import tlbsim as jsim
from repro.core.sparta import TLBConfig as JTLBConfig
from repro.kernels import system_sim as jops
from repro_torch.core import sweep as tsweep
from repro_torch.core import tlbsim as tsim
from repro_torch.core.sparta import TLBConfig
from repro_torch.kernels import system_sim as tops

HIT_KEYS = ("cache_hit", "accel_tlb_hit", "mem_tlb_hit")


def _hetero(C, T):
    """The heterogeneous 8-config batch of tests/test_system_sweep.py."""
    return [
        C(),                                               # cache, no accel TLB
        C(cache=None, num_partitions=8),                   # cacheless
        C(accel_tlb=T(entries=8, ways=4), num_partitions=4,
          accel_probe_on_miss_only=False),
        C(accel_tlb=T(entries=2, ways=4), page_shift=21, num_partitions=32),
        C(mem_tlb=T(entries=64, ways=8)),
        C(cache=T(entries=512, ways=8), num_partitions=16),
        C(cache=None, accel_tlb=T(entries=16, ways=2), num_partitions=2,
          accel_probe_on_miss_only=False),
        C(page_shift=21, num_partitions=128),
    ]


def _both_hetero():
    return _hetero(jsim.SystemSimConfig, JTLBConfig), _hetero(tsim.SystemSimConfig, TLBConfig)


@pytest.mark.parametrize("seed", [0, 9])
def test_sweep_system_heterogeneous_matches_jax(seed):
    lines = random_lines(seed)
    jcfgs, tcfgs = _both_hetero()
    want = jsweep.sweep_system(lines, jcfgs, kernel_mode="reference")
    got = tsweep.sweep_system(lines, tcfgs, device="cpu")
    assert got.n_warm == want.n_warm
    for k in HIT_KEYS:
        assert_same(getattr(got, k), getattr(want, k), k)
    for i in range(len(tcfgs)):
        a, b = got[i], want[i]
        assert a.cache_hit_ratio == b.cache_hit_ratio
        assert a.accel_tlb_hit_ratio == b.accel_tlb_hit_ratio
        assert a.mem_tlb_hit_ratio_given_cache_miss() == b.mem_tlb_hit_ratio_given_cache_miss()
        assert a.accel_tlb_hit_ratio_given_cache_hit() == b.accel_tlb_hit_ratio_given_cache_hit()
        assert (a.accel_tlb_hit_ratio_given_cache_miss()
                == b.accel_tlb_hit_ratio_given_cache_miss())


def test_simulate_system_per_config_oracle_matches_jax():
    lines = random_lines(2)
    jcfgs, tcfgs = _both_hetero()
    batched = tsweep.sweep_system(lines, tcfgs, device="cpu")
    for i, (jc, tc) in enumerate(zip(jcfgs, tcfgs)):
        want = jsim.simulate_system(lines, jc)
        got = tsim.simulate_system(lines, tc, device="cpu")
        assert got.n_warm == want.n_warm
        for k in HIT_KEYS:
            assert_same(getattr(got, k), getattr(want, k), f"cfg {i} {k}")
            assert_same(getattr(batched, k)[i], getattr(want, k), f"batched cfg {i} {k}")


def _flag_batch(C, T):
    """A config and three neighbours that differ from it only in flags."""
    return [C(accel_tlb=T(entries=16, ways=4), num_partitions=4),
            C(cache=None, num_partitions=4),
            C(accel_tlb=None, num_partitions=4),
            C(accel_tlb=T(entries=16, ways=4), num_partitions=4,
              accel_probe_on_miss_only=False)]


def test_flags_are_data_not_structure():
    """Flipping a neighbour's flags must not perturb a config's bits."""
    lines = random_lines(3, n=900)
    cfgs = _flag_batch(tsim.SystemSimConfig, TLBConfig)
    solo = tsweep.sweep_system(lines, cfgs[:1], device="cpu")
    batched = tsweep.sweep_system(lines, cfgs, device="cpu")
    want = jsweep.sweep_system(lines, _flag_batch(jsim.SystemSimConfig, JTLBConfig),
                               kernel_mode="reference")
    for k in HIT_KEYS:
        assert_same(getattr(batched, k)[0], getattr(solo, k)[0], k)
        assert_same(getattr(batched, k), getattr(want, k), k)


def _op_inputs(cfgs, lines):
    """Stacked key streams, flags, envelope geometry and valid ways."""
    streams = [np.stack(r) for r in zip(*(jsweep._system_keys(lines, c) for c in cfgs))]
    flags = np.asarray([[c.cache is not None, c.accel_tlb is not None,
                         c.accel_probe_on_miss_only] for c in cfgs], np.int32)
    geos = [[jsim._geom(c.cache) for c in cfgs], [jsim._geom(c.accel_tlb) for c in cfgs],
            [(jsim._geom(c.mem_tlb)[0] * c.num_partitions, c.mem_tlb.effective_ways)
             for c in cfgs]]
    envs = [(max(g[0] for g in geo), max(g[1] for g in geo), tuple(g[1] for g in geo))
            for geo in geos]
    return streams, flags, envs


@pytest.mark.parametrize("seed", [0, 1])
def test_system_carry_random_chunks_match_jax(seed):
    rng = np.random.default_rng(seed)
    lines = random_lines(seed + 20, n=1111)
    jcfgs, _ = _both_hetero()
    streams, flags, envs = _op_inputs(jcfgs, lines)
    B = len(jcfgs)
    jstate = tuple(x for e in envs for x in jsim.padded_tlb_state(B, e[0] + 1, e[1], e[2]))
    tstate = tuple(x for e in envs
                   for x in tsim.padded_tlb_state(B, e[0] + 1, e[1], e[2], device="cpu"))
    jflags = jnp.asarray(flags)
    bounds = [0, *split_points(rng, len(lines)), len(lines)]
    jh, th = [], []
    for lo, hi in zip(bounds, bounds[1:]):
        ys, jstate = jops.system_sim_batched_carry(
            *(jnp.asarray(s[:, lo:hi]) for s in streams), jflags, jstate, lo,
            kernel_mode="reference")
        jh.append(np.stack([np.asarray(y) for y in ys]))
        ys, tstate = tops.system_sim_batched_carry(
            *(t_of(s[:, lo:hi]) for s in streams), t_of(flags), tstate, lo)
        th.append(torch.stack(ys))
        for a, b in zip(tstate, jstate):
            assert_same(a, b, f"state after chunk {lo}:{hi}")
    assert_same(torch.cat(th, 2), np.concatenate(jh, 2))
    geom = tuple(x for e in envs for x in e[:2])
    mono = tops.system_sim_batched(*(t_of(s) for s in streams), t_of(flags), geom,
                                   tuple(e[2] for e in envs))
    assert_same(torch.cat(th, 2), torch.stack(mono))


def test_system_carry_parked_rows_match_jax_pallas():
    """Parked rows round-trip untouched; the state equals the TPU kernel's
    (interpreted) after chunks that needed no padding."""
    lines = random_lines(5, n=512)
    jcfgs, _ = _both_hetero()
    jcfgs = jcfgs[:3]
    streams, flags, envs = _op_inputs(jcfgs, lines)
    B = len(jcfgs)
    jstate = tuple(x for e in envs for x in jsim.padded_tlb_state(B, e[0] + 1, e[1], e[2]))
    tstate = tuple(x for e in envs
                   for x in tsim.padded_tlb_state(B, e[0] + 1, e[1], e[2], device="cpu"))
    for lo, hi in ((0, 256), (256, 512)):
        jys, jstate = jops.system_sim_batched_carry(
            *(jnp.asarray(s[:, lo:hi]) for s in streams), jnp.asarray(flags), jstate, lo,
            block=128, kernel_mode="pallas_interpret")
        tys, tstate = tops.system_sim_batched_carry(
            *(t_of(s[:, lo:hi]) for s in streams), t_of(flags), tstate, lo)
        for a, b in zip(tys, jys):
            assert_same(a, b)
        for a, b in zip(tstate, jstate):
            assert_same(a, b)


def test_system_mode_resolution():
    for bad in ("stackdist",):
        with pytest.raises(ValueError, match="stack-inclusion"):
            tops.resolve_system_mode(bad, "cpu")
    with pytest.raises(ValueError, match="kernel_mode"):
        tops.resolve_system_mode("pallas_interpret", "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tops.resolve_system_mode("cuda", "cpu")
    assert tops.resolve_system_mode("auto", "cpu") == "reference"
    assert tops.resolve_system_mode("reference", "cpu") == "reference"
