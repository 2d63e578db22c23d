"""The lane-splitting order of work of the stack scan kernel K3
(``csrc/stackdist.cu``) against the JAX package, bit for bit (tolerance 0).

* :func:`stack_plan` picks P threads a lane from (L, C, W) and the SM count
  alone: P = 1 at Fig 4's large launches, 16 or 32 at Fig 5's grid launches,
  and every plan fits the kernel's limits (threads a block, shared bytes, a
  full warp per lane).
* :func:`compose_effects`, the operator the kernel scans the parts'
  effects with, is associative, and on the engine's own effects (distinct
  tags, then -1) it is the engine's ``_merge_effects``.
* :func:`stack_scan_parts_ref`, a plain model here of the kernel's order of work
  (P parts walked from an unknown stack, effects scanned by doubling from
  ``init_stack``, parts re-walked), equals JAX's ``stack_scan_ref`` at
  W in {1, 4, 16, 32} and P in {1, 2, 8, 32}, and on the edge cases of
  ``tests/_stack_cases.py`` at the P each runs on the card.
"""
from typing import Tuple

import numpy as np
import pytest
import torch
from _stack_cases import CASES, MODEL_CASES, PAD_TAG, case_inputs, case_parts
from _torch_parity import assert_same, t_of

pytest.importorskip("jax")  # the parity tests need the JAX package (CPU only)
import jax.numpy as jnp

from repro.kernels.stackdist.ref import stack_scan_ref as jax_stack_scan_ref
from repro_torch.core.stackdist import _merge_effects
from repro_torch.kernels.stackdist import kernel as k3
from repro_torch.kernels.stackdist.ref import lru_stack_step, stack_scan_ref

H100_SMS = 132


def _jax(tags, seg, init):
    return jax_stack_scan_ref(jnp.asarray(tags), jnp.asarray(seg), jnp.asarray(init))


# ---------------------------------------------------------------------------
# The kernel's order of work for P > 1 threads a lane, in plain PyTorch.
# ---------------------------------------------------------------------------

def effect_step(
    stack: torch.Tensor,      # int32 [..., W]; only the first n slots are known
    n: torch.Tensor,          # int32 [...]
    tag: torch.Tensor,        # int32 [...]
    seg_start: torch.Tensor,  # bool  [...]
    live: torch.Tensor,       # bool  [...]; False leaves the state as it is
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One access of a part's walk from an unknown stack: the tag is looked up
    in the first n slots alone (all W once a segment has started), a miss
    grows n, and the slots rotate as in ``lru_stack_step`` (``ref.py``)."""
    W = stack.shape[-1]
    known = torch.where(seg_start, W, n)
    cur = torch.where(seg_start[..., None], -1, stack)
    way_ix = torch.arange(W, dtype=torch.int32, device=stack.device)
    eq = (cur == tag[..., None]) & (way_ix < known[..., None])
    found = eq.any(-1)
    idx = torch.where(found, eq.to(torch.int32).argmax(-1).to(torch.int32), W - 1)
    shifted = torch.cat([tag[..., None], cur[..., :-1]], -1)
    new = torch.where(way_ix <= idx[..., None], shifted, cur)
    new_n = torch.clamp(known + (~found).to(torch.int32), max=W)
    return torch.where(live[..., None], new, stack), torch.where(live, new_n, n).to(torch.int32)


def compose_effects(
    a: torch.Tensor, na: torch.Tensor,   # the earlier effect: int32 [..., W], [...]
    b: torch.Tensor, nb: torch.Tensor,   # the later effect
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The effect of A's accesses then B's: ``b[:nb]`` followed by ``a[:na]``
    less the first occurrence of each of ``b[:nb]``, cut to W slots, and its
    known length.  An effect with n = W is a whole stack (the part held a
    segment start, or W distinct tags); slots at or past n are unknown and
    kept as b has them.  Associative, and seeded with ``(init_stack, W)`` it
    gives the stack after the accesses, for any tag values and any
    init_stack (repeats and -1 slots included)."""
    W = a.shape[-1]
    way_ix = torch.arange(W, dtype=torch.int32, device=a.device)
    in_b = ((a[..., :, None] == b[..., None, :]) & (way_ix < nb[..., None, None])).any(-1)
    earlier = way_ix[None, :] < way_ix[:, None]                     # [j, i]: i < j
    first = ~((a[..., :, None] == a[..., None, :]) & earlier).any(-1)
    kept = (way_ix < na[..., None]) & ~(in_b & first)
    k = kept.to(torch.int32)
    pos = nb[..., None] + torch.cumsum(k, -1) - k
    pos = torch.where(kept & (pos < W), pos, W).to(torch.int64)
    spare = torch.full(b.shape[:-1] + (1,), -1, dtype=b.dtype, device=b.device)
    out = torch.cat([b, spare], -1).scatter(-1, pos, a)[..., :W]
    return out, torch.clamp(nb + k.sum(-1), max=W).to(torch.int32)


def stack_scan_parts_ref(
    tags: torch.Tensor,        # int32 [L, C]
    seg_flags: torch.Tensor,   # bool  [L, C]
    init_stack: torch.Tensor,  # int32 [L, W]
    parts: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain ``stack_scan_ref`` in the kernel's order of work with ``parts``
    threads a lane (``kernels/stackdist/csrc/stackdist.cu``): part p holds steps [p Q, (p + 1)
    Q), Q = ceil(C / parts); each part walks from an unknown stack to its
    effect (:func:`effect_step`); the effects are scanned by doubling, as the
    kernel's warp shuffles do, with part 0 seeded by ``(init_stack, W)``
    (:func:`compose_effects`); each part re-walks from the prefix before it.
    Returns what ``stack_scan_ref`` returns, bit for bit."""
    L, C = tags.shape
    W = init_stack.shape[-1]
    P = parts
    Q = -(-C // P)
    dev = tags.device
    pad = P * Q - C
    t = torch.nn.functional.pad(tags.to(torch.int32), (0, pad)).reshape(L, P, Q)
    f = torch.nn.functional.pad(seg_flags.to(torch.bool), (0, pad)).reshape(L, P, Q)
    live = (torch.arange(P * Q, device=dev) < C).reshape(P, Q).expand(L, P, Q)
    init = init_stack.to(torch.int32)
    if P == 1:                     # one part: its carry-in is init_stack
        return stack_scan_ref(tags, seg_flags, init)
    s = torch.full((L, P, W), -1, dtype=torch.int32, device=dev)
    n = torch.zeros((L, P), dtype=torch.int32, device=dev)
    for q in range(Q):
        s, n = effect_step(s, n, t[..., q], f[..., q], live[..., q])
    full = torch.full((L,), W, dtype=torch.int32, device=dev)
    s0, n0 = compose_effects(init, full, s[:, 0], n[:, 0])
    s, n = torch.cat([s0[:, None], s[:, 1:]], 1), torch.cat([n0[:, None], n[:, 1:]], 1)
    k = 1
    while k < P:
        sk, nk = compose_effects(s[:, :-k], n[:, :-k], s[:, k:], n[:, k:])
        s, n = torch.cat([s[:, :k], sk], 1), torch.cat([n[:, :k], nk], 1)
        k *= 2
    stack = torch.cat([init[:, None], s[:, :-1]], 1)
    depths = torch.empty((L, P, Q), dtype=torch.int32, device=dev)
    for q in range(Q):
        new, depths[..., q] = lru_stack_step(stack, t[..., q], f[..., q])
        stack = torch.where(live[..., q, None], new, stack)
    return depths.reshape(L, P * Q)[:, :C], stack[:, -1]


# ---------------------------------------------------------------------------
# The plan.
# ---------------------------------------------------------------------------

# (L, P) at C = 1,024 and W = 4, the engine's lanes: Fig 4's launches
# (bst_external / bst_internal 32,500 and 10,000; hash_table 5,820;
# skip_list 31,464 and 19,152), Fig 5's grid launches (hash_table 120-1,844;
# the other traces 1,500-4,688), and L = 0, 1 and 300,000.
_MAIN_PATH_PARTS = [
    (32_500, 1), (31_464, 1), (19_152, 1), (10_000, 16), (5_820, 16),
    (4_688, 16), (3_000, 16), (1_844, 16), (1_500, 16), (924, 32), (464, 32),
    (236, 32), (120, 32),
    (0, 1), (1, 32), (300_000, 1),
]


@pytest.mark.parametrize("L,P", _MAIN_PATH_PARTS)
def test_stack_plan_at_the_main_path_shapes(L, P):
    plan = k3.stack_plan(L, 1024, 4, H100_SMS)
    assert plan.parts == P
    assert plan.design == ("streamed" if P == 1 else "resident")
    assert plan == k3.stack_plan(L, 1024, 4, H100_SMS)
    if P > 1:
        # A resident block holds whole rows: both walks read them once.
        assert plan.tile_steps == plan.part_steps == 1024 // P and plan.stages == 1
        assert plan.chain_steps == 2 * 1024 // P
    else:
        assert plan.chain_steps == 1024 and plan.stages == 2
    if L:
        # The blocks cover the SMs, or hold the fewest lanes they may.
        assert plan.blocks >= H100_SMS or plan.threads == 32


@pytest.mark.parametrize("W", [1, 4, 16, 32, 33])
def test_stack_plan_fits_the_kernel(W):
    """Every plan passes what ``stack_scan_launch`` checks, over lane counts
    on both sides of P = 1 and C from 1 to past a resident row."""
    for L in (0, 1, 7, 120, 1_844, 4_688, 16_895, 16_896, 300_000):
        for C in (1, 5, 70, 257, 1_024, 1_025, 16_384, 60_000):
            _check_plan(k3.stack_plan(L, C, W, H100_SMS), L, C, W)


def _check_plan(plan, L, C, W):
    _check_layout(plan, L, C, W)
    assert plan.parts in (1, 16, 32)
    if plan.parts > 1:             # the policy: resident only where it pays
        assert plan.part_steps >= k3.MIN_PART_STEPS
        assert 0 < L < H100_SMS * k3.STREAM_LANES_PER_SM


def _check_layout(plan, L, C, W):
    """What ``stack_scan_launch`` checks before it launches."""
    assert plan.blocks * plan.lanes_per_block >= L
    if W > k3.MAX_REG_WAYS:
        assert plan.design == "device-memory" and plan.parts == 1
        return
    P = plan.parts
    assert P in (1, 2, 4, 8, 16, 32)
    assert 32 <= plan.threads <= k3.MAX_THREADS and plan.threads % 32 == 0
    assert plan.part_steps == -(-C // P)
    assert plan.row_steps % 16 == 0 and plan.row_steps >= plan.tile_steps >= 1
    assert plan.smem_bytes == plan.stages * plan.threads * plan.row_steps * 5
    assert plan.smem_bytes <= k3.SMEM_LIMIT
    if P == 1:
        assert plan.tile_steps == min(k3.TILE_STEPS, C)
        assert plan.stages == (2 if C > plan.tile_steps else 1)
    else:
        assert plan.tile_steps == plan.part_steps and plan.stages == 1
        assert plan.row_steps % k3.RES_TILE_STEPS == 0


def test_plan_for_parts_lays_out_any_p_and_refuses_what_does_not_fit():
    for P in (1, 2, 4, 8, 16, 32):
        plan = k3.plan_for_parts(300, 70, 4, H100_SMS, P)
        assert plan.parts == P
        _check_layout(plan, 300, 70, 4)
    with pytest.raises(ValueError, match="power of two"):
        k3.plan_for_parts(300, 70, 4, H100_SMS, 3)
    with pytest.raises(ValueError, match="fit"):
        k3.plan_for_parts(300, 60_000, 4, H100_SMS, 2)   # 16 rows of 240 KB


# ---------------------------------------------------------------------------
# The operator.
# ---------------------------------------------------------------------------

def _effects(rng, shape, W, n_tags):
    """Random effects: the first n slots distinct tags (n = W: any stack,
    repeats and -1 included), the rest unknown (random)."""
    s = rng.integers(-2, n_tags, shape + (W,)).astype(np.int32)
    n = rng.integers(0, W + 1, shape).astype(np.int32)
    for ix in np.ndindex(*shape):
        if n[ix] < W:
            s[ix][:n[ix]] = rng.choice(n_tags, n[ix], replace=False)
    return torch.from_numpy(s), torch.from_numpy(n)


def _known(s, n):
    """Slots past n are unknown: mask them for comparison."""
    way = torch.arange(s.shape[-1])
    return torch.where(way < n[..., None], s, -99), n


@pytest.mark.parametrize("W", [1, 3, 4, 16, 32])
def test_compose_effects_is_associative(W):
    rng = np.random.default_rng(W)
    a, b, c = (_effects(rng, (400,), W, 2 * W + 2) for _ in range(3))
    left = compose_effects(*compose_effects(*a, *b), *c)
    right = compose_effects(*a, *compose_effects(*b, *c))
    for x, y in zip(_known(*left), _known(*right)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("W", [1, 2, 4, 16])
def test_compose_effects_is_the_engines_merge_on_its_effects(W):
    """On per-lane finals from empty stacks (distinct tags, then -1) the
    operator is ``(f1, s1) . (f2, s2) = (f1 | f2, s2 if f2 else
    merge(s1, s2))``, with n = W for f (or W distinct tags)."""
    rng = np.random.default_rng(50 + W)
    s = np.full((2, 500, W), -1, np.int32)
    for ix in np.ndindex(2, 500):
        k = int(rng.integers(0, W + 1))
        s[ix][:k] = rng.choice(3 * W, k, replace=False)
    f2 = torch.from_numpy(rng.random(500) < 0.3)
    s1, s2 = torch.from_numpy(s[0]), torch.from_numpy(s[1])
    n1, n2 = ((x >= 0).sum(-1).to(torch.int32) for x in (s1, s2))
    n2 = torch.where(f2, W, n2).to(torch.int32)
    got, _ = compose_effects(s1, n1, s2, n2)
    want = torch.where(f2[:, None], s2, _merge_effects(s1, s2))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The order of work against JAX.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [1, 2, 8, 32])
@pytest.mark.parametrize("W", [1, 4, 16, 32])
def test_parts_model_matches_jax(W, P):
    """L = 9 lanes of C = 70 steps (not a multiple of 8 or 32; P = 32 gives
    parts of 3 steps, one of 1 and 8 empty ones past C), 8% segment starts, some
    parts starting a segment on their first step, padding tags, and carry-in
    stacks with repeated tags and -1 between tags."""
    rng = np.random.default_rng(10 * W + P)
    L, C = 9, 70
    tags = rng.integers(0, 3 * W, (L, C)).astype(np.int32)
    seg = rng.random((L, C)) < 0.08
    q = -(-C // P)
    seg[0, ::q] = True
    tags[-1, -11:] = PAD_TAG
    seg[-1, -11] = True
    tags[-2, 5:] = PAD_TAG
    init = rng.integers(-1, 3 * W, (L, W)).astype(np.int32)
    jd, jf = _jax(tags, seg, init)
    td, tf = stack_scan_parts_ref(t_of(tags), t_of(seg), t_of(init), P)
    assert_same(td, jd, "depths")
    assert_same(tf, jf, "final")


@pytest.mark.parametrize("case", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_parts_model_matches_jax_on_the_card_cases(case):
    tags, seg, init = case_inputs(case)
    P = case_parts(case, k3.stack_plan)
    jd, jf = _jax(tags, seg, init)
    td, tf = stack_scan_parts_ref(t_of(tags), t_of(seg), t_of(init), P)
    assert_same(td, jd, f"{case[0]} depths (P = {P})")
    assert_same(tf, jf, f"{case[0]} final (P = {P})")


def test_the_card_cases_reach_both_designs_and_their_edges():
    """The card's cases take both designs, P = 32 and P = 1 by the plan, the
    16-byte and the 4-byte copies, and ragged tiles."""
    plans = {c[0]: (k3.stack_plan(*c[1:4], H100_SMS) if c[4] is None
                    else k3.plan_for_parts(*c[1:4], H100_SMS, c[4])) for c in CASES}
    assert plans["engine_one_lane"].parts == 32
    assert plans["engine_streamed_c1024"].parts == plans["engine_streamed_c1025"].parts == 1
    assert plans["engine_c16384_streamed"].design == "streamed"
    assert plans["random_w40"].design == "device-memory"
    vec = [n for n, (_, L, C, W, _) in zip(plans, CASES)
           if C % 16 == 0 and plans[n].part_steps % 16 == 0 and plans[n].tile_steps % 16 == 0]
    assert "engine_c1024" in vec and "engine_streamed_c1024" in vec
    assert "engine_c1025" not in vec and "engine_streamed_c1025" not in vec
    assert 1025 % plans["engine_streamed_c1025"].tile_steps
