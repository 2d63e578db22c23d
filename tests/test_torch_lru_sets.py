"""The set-parallel order of work of K1 and K2 (``csrc/lru_sets.cuh``)
against the JAX package: the plain models ``tlb_sim_set_parallel_ref`` and
``system_sim_set_parallel_ref`` (stable bucketing by (config, set), then
round r applies the r-th access of every bucket at once; K2 as a cache pass
and two gated TLB passes) give the JAX reference's hits and carried state
bit for bit (tolerance 0), chunk by chunk, on random heterogeneous batches,
skewed streams and the edge cases of ``tests/_lru_cases.py``.  Also the
bucketing plan's sizes.
"""
import numpy as np
import pytest
import torch
from _lru_cases import chunks, k1_cases, k2_cases
from _torch_parity import assert_same, random_lines, split_points, t_of

pytest.importorskip("jax")  # the parity tests need the JAX package (CPU only)
import jax.numpy as jnp

from repro.core import tlbsim as jsim
from repro.kernels import system_sim as jsys
from repro.kernels import tlb_sim as jtlb
from repro_torch.core import tlbsim as tsim
from repro_torch.kernels.system_sim.ref import (
    system_sim_batched_carry_ref,
    system_sim_set_parallel_ref,
)
from repro_torch.kernels.tlb_sim import kernel as k1
from repro_torch.kernels.tlb_sim.ref import (
    bucket_ranks,
    tlb_sim_batched_carry_ref,
    tlb_sim_set_parallel_ref,
)
from test_torch_system_sim import _both_hetero, _op_inputs


def _k1_hetero(seed: int) -> dict:
    """A random batch padded to its envelope, valid ways 1-8."""
    rng = np.random.default_rng(seed)
    B, L, TS, W = 8, 1_201, 13, 8
    return {"name": f"hetero_{seed}", "set": rng.integers(0, TS, (B, L)).astype(np.int32),
            "tag": rng.integers(0, 30, (B, L)).astype(np.int32), "TS": TS + 1, "W": W,
            "valid": (8, 1, 5, 2, 7, 3, 6, 4), "now0": 5, "cuts": split_points(rng, L)}


def _k2_hetero(seed: int) -> dict:
    """The heterogeneous 8-config system batch of tests/test_torch_system_sim.py."""
    jcfgs, _ = _both_hetero()
    lines = random_lines(seed + 30, n=1_111)
    streams, flags, envs = _op_inputs(jcfgs, lines)
    rng = np.random.default_rng(seed)
    return {"name": f"hetero_{seed}", "streams": [s.astype(np.int32) for s in streams],
            "flags": flags, "geom": [(e[0] + 1, e[1], e[2]) for e in envs], "now0": 0,
            "cuts": split_points(rng, len(lines))}


K1 = [_k1_hetero(0), _k1_hetero(1), *k1_cases()]
K2 = [_k2_hetero(0), _k2_hetero(1), *k2_cases()]


@pytest.mark.parametrize("case", K1, ids=[c["name"] for c in K1])
def test_tlb_set_parallel_model_matches_jax(case):
    s, t, now0 = case["set"], case["tag"], case["now0"]
    B, L = s.shape
    args = (B, case["TS"], case["W"], case["valid"])
    jtags, jlast = jsim.padded_tlb_state(*args)
    ttags, tlast = tsim.padded_tlb_state(*args, device="cpu")
    for lo, hi in chunks(L, case["cuts"]):
        jh, jtags, jlast = jtlb.tlb_sim_batched_carry(
            jnp.asarray(s[:, lo:hi]), jnp.asarray(t[:, lo:hi]), jtags, jlast, now0 + lo,
            kernel_mode="reference")
        th, ttags, tlast = tlb_sim_set_parallel_ref(
            t_of(s[:, lo:hi]), t_of(t[:, lo:hi]), ttags, tlast, now0 + lo)
        what = f"{case['name']} chunk {lo}:{hi}"
        assert_same(th, jh, f"{what} hits")
        assert_same(ttags, jtags, f"{what} tags")
        assert_same(tlast, jlast, f"{what} last")


@pytest.mark.parametrize("case", K2, ids=[c["name"] for c in K2])
def test_system_set_parallel_model_matches_jax(case):
    streams, flags, now0 = case["streams"], case["flags"], case["now0"]
    B, L = streams[0].shape
    jstate = tuple(x for S, W, v in case["geom"] for x in jsim.padded_tlb_state(B, S, W, v))
    tstate = tuple(x for S, W, v in case["geom"]
                   for x in tsim.padded_tlb_state(B, S, W, v, device="cpu"))
    for lo, hi in chunks(L, case["cuts"]):
        jys, jstate = jsys.system_sim_batched_carry(
            *(jnp.asarray(x[:, lo:hi]) for x in streams), jnp.asarray(flags), jstate,
            now0 + lo, kernel_mode="reference")
        tys, tstate = system_sim_set_parallel_ref(
            [t_of(x[:, lo:hi]) for x in streams], t_of(flags), tstate, now0 + lo)
        what = f"{case['name']} chunk {lo}:{hi}"
        for k, (a, b) in enumerate(zip(tys, jys)):
            assert_same(a, b, f"{what} hits {'cam'[k]}")
        for k, (a, b) in enumerate(zip(tstate, jstate)):
            assert_same(a, b, f"{what} state {k}")


@pytest.mark.parametrize("seed", [0, 1])
def test_set_parallel_models_equal_the_sequential_plain_versions(seed):
    """The two plain versions of each kernel agree, carried state included,
    from a state that earlier accesses left behind."""
    case = _k1_hetero(seed)
    s, t = t_of(case["set"]), t_of(case["tag"])
    state = tsim.padded_tlb_state(8, case["TS"], case["W"], case["valid"], device="cpu")
    state = tlb_sim_batched_carry_ref(s, t, *state, 0)[1:]
    for a, b in zip(tlb_sim_set_parallel_ref(s, t, *state, 1_201),
                    tlb_sim_batched_carry_ref(s, t, *state, 1_201)):
        assert_same(a, b)
    case = _k2_hetero(seed)
    streams, flags = [t_of(x) for x in case["streams"]], t_of(case["flags"])
    state = tuple(x for S, W, v in case["geom"]
                  for x in tsim.padded_tlb_state(8, S, W, v, device="cpu"))
    state = system_sim_batched_carry_ref(streams, flags, state, 0)[1]
    got = system_sim_set_parallel_ref(streams, flags, state, 1_111)
    want = system_sim_batched_carry_ref(streams, flags, state, 1_111)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert_same(a, b)


def test_bucket_ranks_count_earlier_equal_keys():
    keys = torch.from_numpy(np.random.default_rng(3).integers(0, 7, 500))
    want = [int((keys[:i] == keys[i]).sum()) for i in range(len(keys))]
    assert bucket_ranks(keys).tolist() == want


# (B, L, sets used, segments, tasks): K1's largest TLBSweepStream group (52
# configs, 2,048 entries x 128 partitions / 4 ways); K2 over Fig 10's
# longest trace (skip_list, 1,400,000 accesses), its mem TLB (32 sets x 128
# partitions) and its cache (64 sets); K1 at B = 1 over skip_list (512
# sets); Fig 4's 60 specs over skip_list in one launch; a chunk shorter than
# a segment.
PLANS = [
    (52, 65_537, 65_536, 2, 52 * 8 * 2),
    (9, 1_400_000, 4_096, 227, 9 * 227),
    (9, 1_400_000, 64, 341, 9 * 341),
    (1, 1_400_000, 512, 341, 341),
    (60, 1_400_000, 65_536, 2, 60 * 8 * 2),
    (3, 100, 9, 1, 3),
]


@pytest.mark.parametrize("B,L,sets,segs,tasks", PLANS)
def test_bucket_plan_sizes(B, L, sets, segs, tasks):
    p = k1.bucket_plan(B, L, sets)
    assert (p.sets, p.segs, p.tasks) == (sets, segs, tasks)
    assert p.ranges == -(-sets // k1.RANGE) and (p.ranges - 1) * k1.RANGE < sets
    assert p.counts == B * sets * segs <= max(k1.COUNT_CAP, B * sets)
    assert p.segs * p.seg_len >= L > (p.segs - 1) * p.seg_len
    assert p.segs == 1 or p.seg_len >= k1.SEG_MIN
    counts, partials, pairs = k1.scratch_sizes([[p]], B, L)
    assert (counts, pairs) == (p.counts + 1, B * L)
    assert (partials - 1) * k1.SCAN_CHUNK < counts <= partials * k1.SCAN_CHUNK


def test_system_scratch_serves_both_phases():
    """K2's scratch: the counts of the larger phase (the cache alone, then
    both TLBs) and a pair per access of each TLB."""
    B, L = 9, 600_000
    c, a, m = (k1.bucket_plan(B, L, n) for n in (64, 32, 4_096))
    counts, partials, pairs = k1.scratch_sizes([[c], [a, m]], B, L)
    assert counts == max(c.counts, a.counts + m.counts) + 1
    assert pairs == 2 * B * L
    assert partials == -(-counts // k1.SCAN_CHUNK)


def test_plan_and_check_reject_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="no bucketing"):
        k1.bucket_plan(0, 10, 4)
    s = torch.tensor([[0, 5, 3]], dtype=torch.int32)
    assert k1.check_launch(s, 8, 4, 0) == 6
    with pytest.raises(ValueError, match="set index"):
        k1.check_launch(s, 5, 4, 0)
    with pytest.raises(ValueError, match="stamps"):
        k1.check_launch(s, 8, 4, 2**31 - 4)
