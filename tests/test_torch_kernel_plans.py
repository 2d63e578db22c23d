"""The launch plans of K6 (paged decode attention) and K8 (the Mamba2 scan)
and plain models of the two kernels' orders of work, held to the JAX
package on the CPU.

* K6's :func:`split_plan` cuts each sequence's table into contiguous ranges
  of whole 32-key tiles, one block each; its ranges cover every tile once.
  A plain model of the kernel's order of work (the splits' blocks, their
  warps' tiles w, w + W, ..., the warps' merge, then the splits' merge) in
  float64 equals JAX's ``paged_attention_ref`` residuals within 2e-5, and
  JAX's ``merge_partials`` of the model's split partials equals JAX's
  normalised attention, on numpy-seeded inputs with unmapped pages,
  contexts of 0, splits past the context and splits whose pages are all
  unmapped.
* K8's :func:`heads_plan` gives every head of every batch row one
  warpgroup.  A plain model of the tensor-core kernel's chunked form with
  its operand rounding (every float32 operand split into bf16 high and low
  parts; x exact in bf16) equals JAX's ``mamba2_scan_ref`` at zamba2's
  decays, the state within 5e-4 (the float32 check the kernel is held to).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan.ref import mamba2_scan_ref as jax_mamba2_ref
from repro.kernels.paged_attention.ref import merge_partials as jax_merge
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_paged_ref
from repro_torch.kernels.flash_attention.kernel import SMEM_LIMIT
from repro_torch.kernels.mamba2_scan.kernel import HEADS_PER_BLOCK, heads_plan
from repro_torch.kernels.paged_attention.kernel import TILE, split_plan

H100_SMS = 132
NEG_INF = -1e30
ATTN_TOL = 2e-5     # the JAX package's float32 attention tolerance
STATE_TOL = 5e-4    # the JAX package's scan tolerance, the float32 state check


# ---------------------------------------------------------------------------
# K6: the split plan.
# ---------------------------------------------------------------------------

# (B, Hkv, pages, page, D, G): qwen3-14b's decode (batch 4 and 1, tables of
# 1-16 256-token pages, head dim 128, 5 query heads a KV head), zamba2-7b's
# (64-token pages, head dim 112, group 1), the other dense head dims, and
# pages that are not whole tiles.
_PLAN_SHAPES = [
    (4, 8, 9, 256, 128, 5),
    (4, 8, 1, 256, 128, 5),
    (4, 8, 3, 256, 128, 5),
    (1, 8, 8, 256, 128, 5),
    (1, 8, 16, 256, 128, 5),
    (4, 32, 3, 64, 112, 1),
    (3, 8, 5, 64, 160, 4),
    (2, 16, 4, 16, 256, 1),
    (3, 4, 6, 8, 32, 1),
    (3, 4, 7, 4, 64, 2),
    (2, 2, 5, 33, 64, 4),
]


def _ranges(plan, tiles):
    return [(s * plan.tiles_per_split, min((s + 1) * plan.tiles_per_split, tiles))
            for s in range(plan.splits)]


@pytest.mark.parametrize("B,Hkv,pages,page,D,G", _PLAN_SHAPES)
def test_split_plan_covers_every_tile_once(B, Hkv, pages, page, D, G):
    plan = split_plan(B, Hkv, pages, page, H100_SMS, D, G)
    tiles = -(-pages * page // TILE)
    covered = [t for lo, hi in _ranges(plan, tiles) for t in range(lo, hi)]
    assert covered == list(range(tiles))
    assert all(lo < hi for lo, hi in _ranges(plan, tiles))      # no split is empty
    assert 1 <= plan.warps <= plan.tiles_per_split
    assert plan == split_plan(B, Hkv, pages, page, H100_SMS, D, G)
    if plan.splits == 1 and 2 * B * Hkv >= H100_SMS:
        # Unsplit: a warp a tile in one block, the blocks fill half the card.
        assert plan.warps == tiles <= 8 and plan.smem_bytes <= SMEM_LIMIT
        return
    assert plan.warps <= 4 and plan.smem_bytes <= SMEM_LIMIT // 2   # two blocks an SM
    # Two blocks on every SM where the table has the tiles for it.
    assert B * Hkv * plan.splits >= min(2 * H100_SMS, B * Hkv * tiles)


@pytest.mark.parametrize("seed", range(4))
def test_split_plan_blocks_cover_ragged_contexts_once(seed):
    """The blocks that do work (a range that starts before ceil(ctx / 32))
    take each tile of each context exactly once, for ragged contexts,
    contexts of 0 and contexts that end on a split boundary."""
    rng = np.random.default_rng(seed)
    B, Hkv, page, D, G = 4, 8, 256, 128, 5
    pages = int(rng.integers(1, 17))
    plan = split_plan(B, Hkv, pages, page, H100_SMS, D, G)
    span = plan.tiles_per_split * TILE
    ctxs = [0, pages * page, min(pages * page, span), *rng.integers(1, pages * page + 1, 5)]
    tiles = -(-pages * page // TILE)
    for ctx in ctxs:
        need = -(-int(ctx) // TILE)
        done = []
        for lo, hi in _ranges(plan, tiles):
            if lo < need:                         # else: the empty partial
                done += range(lo, min(hi, need))
        assert done == list(range(need)), (pages, ctx)


# ---------------------------------------------------------------------------
# K6: a plain model of the split kernel's order of work.
# ---------------------------------------------------------------------------

def _k6_model(q, kp, vp, tbl, ctx, plan):
    """The kernel's order of work in float64: block (split, KV head, b)
    takes tiles [s * per, min((s + 1) * per, ceil(n_keys / 32))); warp w of
    it tiles w, w + W, ... with an online softmax per 32-key tile (a tile of
    invalid keys skipped); the warps' partials merged, then the splits'.
    Returns the merged residuals and the split partials."""
    q, kp, vp = q.double(), kp.double(), vp.double()
    B, Hq, D = q.shape
    _, page, Hkv, _ = kp.shape
    pages = tbl.shape[1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    S, per, W = plan.splits, plan.tiles_per_split, plan.warps
    p_acc = torch.zeros((S, B, Hq, D), dtype=torch.float64)
    p_m = torch.full((S, B, Hq), NEG_INF, dtype=torch.float64)
    p_l = torch.zeros((S, B, Hq), dtype=torch.float64)
    for b in range(B):
        n_keys = min(int(ctx[b]), pages * page)
        need = -(-n_keys // TILE)
        qb = q[b].reshape(Hkv, G, D)
        for s in range(S):
            t0, t1 = s * per, min((s + 1) * per, need)
            if t0 >= t1:
                continue
            wm = torch.full((W, Hkv, G), NEG_INF, dtype=torch.float64)
            wl = torch.zeros((W, Hkv, G), dtype=torch.float64)
            wa = torch.zeros((W, Hkv, G, D), dtype=torch.float64)
            for w in range(W):
                for tile in range(t0 + w, t1, W):
                    keys = tile * TILE + torch.arange(TILE)
                    pg = torch.clamp(keys // page, max=pages - 1)
                    slot = tbl[b, pg].long()
                    valid = (keys < n_keys) & (slot >= 0)
                    if not bool(valid.any()):
                        continue
                    safe = torch.where(valid, slot, 0)
                    k = kp[safe, keys % page] * valid[:, None, None]       # [32, Hkv, D]
                    v = vp[safe, keys % page] * valid[:, None, None]
                    sc = torch.einsum("hgd,jhd->hgj", qb, k) * scale
                    sc = torch.where(valid, sc, NEG_INF)
                    m_new = torch.maximum(wm[w], sc.amax(-1))
                    alpha = torch.exp(wm[w] - m_new)
                    p = torch.where(valid, torch.exp(sc - m_new[..., None]), 0.0)
                    wl[w] = wl[w] * alpha + p.sum(-1)
                    wa[w] = wa[w] * alpha[..., None] + torch.einsum("hgj,jhd->hgd", p, v)
                    wm[w] = m_new
            mx = wm.amax(0)
            alpha = torch.exp(wm - mx)
            p_m[s, b] = mx.reshape(Hq)
            p_l[s, b] = (wl * alpha).sum(0).reshape(Hq)
            p_acc[s, b] = (wa * alpha[..., None]).sum(0).reshape(Hq, D)
    mx = p_m.amax(0)
    alpha = torch.exp(p_m - mx)
    return ((p_acc * alpha[..., None]).sum(0), mx, (p_l * alpha).sum(0)), (p_acc, p_m, p_l)


def _k6_inputs(seed, B, Hq, Hkv, D, page, pages, slots, ctx, unmapped=()):
    """Pools and a table of distinct slots; ``ctx`` per sequence (None: a
    random context ending mid-page); ``unmapped``: (b, first page, last
    page) ranges set to -1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((slots, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((slots, page, Hkv, D)).astype(np.float32)
    tbl = rng.permutation(slots)[:B * pages].reshape(B, pages).astype(np.int32)
    cl = np.array([int(rng.integers(1, pages * page + 1)) if c is None else c for c in ctx],
                  np.int32)
    for b, lo, hi in unmapped:
        tbl[b, lo:hi + 1] = -1
    return q, kp, vp, tbl, cl


def _k6_cases():
    """(name, sms, B, Hq, Hkv, D, page, pages, slots, ctx, unmapped): the SM
    count is cut so that the small shapes split as the card's do."""
    return [
        # qwen3's group of 5 on 4 sequences, ragged, a hole and a context of 0.
        ("ragged", 32, 4, 10, 2, 32, 16, 9, 48, [None, None, None, 0], [(1, 1, 1)]),
        # A context that ends exactly on a split boundary (and one a key past it).
        ("split_edge", 16, 2, 10, 2, 32, 16, 9, 48, ["edge", "edge+1"], []),
        # Splits wholly past ctx: short contexts in a wide table.
        ("past_ctx", 64, 3, 8, 2, 16, 32, 8, 32, [5, 40, 33], []),
        # A split whose pages are all unmapped.
        ("unmapped_split", 16, 2, 10, 2, 32, 16, 9, 48, [144, 130], [(0, 2, 5)]),
        # One page a table.
        ("one_page", 64, 3, 8, 2, 32, 64, 1, 8, [64, 17, 0], []),
        # zamba2's group 1 and 64-token pages.
        ("zamba2", 64, 4, 4, 4, 16, 64, 3, 16, [None, None, 160, 1], [(2, 1, 1)]),
    ]


@pytest.mark.parametrize("case", _k6_cases(), ids=lambda c: c[0])
def test_split_then_merge_model_matches_jax(case):
    name, sms, B, Hq, Hkv, D, page, pages, slots, ctx, unmapped = case
    plan = split_plan(B, Hkv, pages, page, sms, D, Hq // Hkv)
    assert plan.splits > 1
    edge = plan.tiles_per_split * TILE
    ctx = [edge if c == "edge" else edge + 1 if c == "edge+1" else c for c in ctx]
    arrs = _k6_inputs(len(name), B, Hq, Hkv, D, page, pages, slots, ctx, unmapped)
    (acc, m, l), parts = _k6_model(*(torch.from_numpy(a) for a in arrs), plan)
    j_acc, j_m, j_l = jax_paged_ref(*(jnp.asarray(a) for a in arrs), return_residuals=True)
    for got, want in ((acc, j_acc), (m, j_m), (l, j_l)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64),
                                   atol=ATTN_TOL, rtol=ATTN_TOL)
    merged = jax_merge(*(jnp.asarray(p.float().numpy()) for p in parts))
    np.testing.assert_allclose(np.asarray(merged), np.asarray(jax_paged_ref(
        *(jnp.asarray(a) for a in arrs))), atol=ATTN_TOL, rtol=ATTN_TOL)
    # Splits past the context leave the empty partial, and a sequence with
    # no valid key keeps the initial residuals.
    tiles_needed = [-(-min(int(c), pages * page) // TILE) for c in arrs[4]]
    for s in range(plan.splits):
        for b in range(B):
            if s * plan.tiles_per_split >= tiles_needed[b]:
                assert float(parts[1][s, b].max()) == NEG_INF
                assert float(parts[2][s, b].abs().max()) == 0.0
    if 0 in arrs[4].tolist():
        b = arrs[4].tolist().index(0)
        assert float(m[b].max()) == NEG_INF and float(l[b].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# K8: the heads plan and a plain model of the tensor-core kernel.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H", [(4, 112), (2, 112), (1, 8), (1, 5), (2, 3), (4, 4),
                                 (1, 112), (3, 7), (1, 7), (1, 201), (4, 111)])
def test_heads_plan_covers_every_head_once(B, H):
    plan = heads_plan(B, H, H100_SMS)
    hb = plan.heads_per_block
    assert hb in HEADS_PER_BLOCK and plan.blocks == B * -(-H // hb)
    assert plan.smem_bytes <= SMEM_LIMIT and plan.blocks_per_sm >= 1
    seen = [(b, blk * hb + slot) for b in range(B) for blk in range(plan.blocks // B)
            for slot in range(hb) if blk * hb + slot < H]
    assert sorted(seen) == [(b, h) for b in range(B) for h in range(H)]


def test_heads_plan_picks_each_instance():
    """The three built instances, at the shapes the card test runs them."""
    assert [heads_plan(B, H, H100_SMS).heads_per_block
            for B, H in ((1, 7), (1, 201), (4, 111))] == [1, 2, 4]


def test_heads_plan_at_zamba2_fills_the_card():
    """zamba2-7b's prefill (4 x 112 heads): four heads a block, one wave of
    112 blocks."""
    plan = heads_plan(4, 112, H100_SMS)
    assert plan.heads_per_block == 4 and plan.blocks == 112
    assert plan.blocks <= H100_SMS * plan.blocks_per_sm


def test_split_plan_at_the_serving_shapes():
    """qwen3-14b's decode at batch 4 (8 KV heads) splits a table of nine
    256-token pages into 12 ranges of 6 tiles, 384 blocks of 3 warps, two on
    every SM; zamba2-7b's (32 KV heads, three 64-token pages) runs unsplit,
    a warp a tile, 128 blocks."""
    assert split_plan(4, 8, 9, 256, H100_SMS, 128, 5)[:3] == (12, 6, 3)
    assert split_plan(4, 32, 3, 64, H100_SMS, 112, 1)[:3] == (1, 6, 6)


def _split(v):
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def _k8_model(x, dt, A, Bm, C, D, chunk):
    """The tensor-core kernel's chunked form in float32: C B^T, C S, att x
    and B_dec^T x as sums of bf16 parts' products (hi hi + hi lo + lo hi
    between two split operands, hi x + lo x with x), the decay arithmetic in
    float32, exponents only of differences of in-chunk cumulative
    log-decays."""
    B_, H, T, P = x.shape
    N = Bm.shape[-1]
    S = torch.zeros((B_, H, N, P))
    ys = []
    for t0 in range(0, T, chunk):
        xc, dtc = x[:, :, t0:t0 + chunk], dt[:, :, t0:t0 + chunk]
        L = xc.shape[2]
        Bh, Bl = _split(Bm[:, t0:t0 + L])
        Ch, Cl = _split(C[:, t0:t0 + L])
        lc = torch.cumsum(A[None, :, None] * dtc, -1)                       # [B, H, L]
        cb = Ch @ Bh.transpose(1, 2) + Ch @ Bl.transpose(1, 2) + Cl @ Bh.transpose(1, 2)
        causal = torch.tril(torch.ones(L, L, dtype=torch.bool))
        decay = torch.exp(torch.where(causal, lc[..., :, None] - lc[..., None, :], -math.inf))
        att = cb[:, None] * dtc[:, :, None, :] * decay
        ah, al = _split(att)
        Sh, Sl = _split(S)
        inter = Ch[:, None] @ Sh + Ch[:, None] @ Sl + Cl[:, None] @ Sh
        ys.append(inter * torch.exp(lc)[..., None] + ah @ xc + al @ xc
                  + D[None, :, None, None] * xc)
        wdec = dtc * torch.exp(lc[..., -1:] - lc)
        dh, dl = _split((Bh + Bl)[:, None] * wdec[..., None])              # [B, H, L, N]
        S = (S * torch.exp(lc[..., -1])[..., None, None] + dh.transpose(2, 3) @ xc
             + dl.transpose(2, 3) @ xc)
    return torch.cat(ys, 2), S


def _zamba2_inputs(seed, B, H, T, P, N):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, H, T, P)).astype(np.float32) * 0.5)
    x = x.bfloat16().float().numpy()                 # x is exact in bf16 on this path
    dt = np.log1p(np.exp(rng.normal(0.0, 0.63, (B, H, T)))).astype(np.float32)
    A = -np.linspace(1.0, 8.0, H, dtype=np.float32)
    Bm, C = (rng.standard_normal((B, T, N)).astype(np.float32) * 0.5 for _ in range(2))
    D = rng.standard_normal(H).astype(np.float32)
    return x, dt, A, Bm, C, D


@pytest.mark.parametrize("B,H,T,P,N,chunk", [
    (2, 8, 256, 64, 64, 64),      # zamba2's head shape, four chunks
    (1, 5, 40, 64, 64, 40),       # T < chunk: one short chunk
    (2, 3, 96, 16, 32, 32),       # N, P below the 64-wide tiles
])
def test_k8_split_bf16_model_matches_jax_at_zamba2_decays(B, H, T, P, N, chunk):
    ins = _zamba2_inputs(B * 100 + T, B, H, T, P, N)
    y, s = _k8_model(*(torch.from_numpy(a) for a in ins), chunk)
    jy, js = jax_mamba2_ref(*(jnp.asarray(a) for a in ins))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=STATE_TOL, rtol=STATE_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=STATE_TOL, rtol=STATE_TOL)
    # The kernel rounds y to bf16 once: within the bf16 output tolerance.
    np.testing.assert_allclose(y.bfloat16().float().numpy(), np.asarray(jy),
                               atol=2e-2, rtol=2e-2)
