"""The port's attention kernels' plain versions (K5 flash attention, K6 paged
attention) against the JAX package: its naive oracles, its blocked jnp scan
and its Pallas kernels run by the interpreter, on the shapes of
tests/test_kernels.py, within 2e-5 in float32 (2e-2 in bfloat16), the JAX
package's own tolerances.  Inputs come from numpy seeds.  For K5's bf16
tensor-core kernel, its tile plan against the card's shared memory for
every configured head dim, and a plain model of its arithmetic against
JAX's Pallas K5 at chip_smoke.py's bf16 cases."""
import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.paged_attention import merge_partials as jax_merge
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.paged_attention import paged_attention_partial as jax_paged_partial
from repro.models.flash_ref import flash_attention_jnp
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.flash_attention.kernel import (SMEM_LIMIT, flash_attention_cuda,
                                                        tile_plan)
from repro_torch.kernels.flash_attention.ref import attention_ref, flash_attention_ref
from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

F32_TOL, BF16_TOL = 2e-5, 2e-2

# tests/test_kernels.py's flash shapes, plus a ragged GQA prefill and Tq < Tk.
FLASH_CASES = [
    (1, 4, 2, 64, 64, 32, True, "float32"),
    (2, 8, 8, 96, 96, 64, True, "float32"),
    (1, 4, 1, 33, 80, 64, False, "float32"),
    (2, 2, 2, 128, 128, 128, True, "bfloat16"),
    (1, 4, 2, 1, 96, 32, True, "float32"),
    (1, 10, 2, 37, 37, 24, True, "float32"),
    (1, 6, 3, 17, 50, 16, True, "float32"),
]


def _qkv(B, Hq, Hkv, Tq, Tk, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("oracle", ["attention_ref", "pallas_interpret", "jnp_scan"])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,dtype", FLASH_CASES)
def test_flash_plain_matches_jax(B, Hq, Hkv, Tq, Tk, D, causal, dtype, oracle):
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, Hq, Hkv, Tq, Tk, D, dtype)
    if oracle == "attention_ref":
        want = jax_attention_ref(jq, jk, jv, causal=causal)
    elif oracle == "pallas_interpret":
        want = jax_flash(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                         kernel_mode="pallas_interpret")
    else:
        want = flash_attention_jnp(jq, jk, jv, causal=causal)
    got = fa.flash_attention(tq, tk, tv, causal=causal, kernel_mode="reference")
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_and_block_sizes_match_jax(causal):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 4, 2, 50, 70, 32, "float32", seed=1)
    want = jax_attention_ref(jq, jk, jv, causal=causal)
    _close(attention_ref(tq, tk, tv, causal=causal), want, F32_TOL)
    for block_k in (16, 33, 512):
        _close(flash_attention_ref(tq, tk, tv, causal=causal, block_k=block_k), want, F32_TOL)
    # an explicit scale reaches both
    _close(flash_attention_ref(tq, tk, tv, causal=causal, sm_scale=0.3),
           jax_attention_ref(jq, jk, jv, causal=causal, sm_scale=0.3), F32_TOL)


def _paged_np(seed, B, Hq, Hkv, D, page, pages, slots, holes=False):
    """Pools, a table with -1 past each sequence's pages (and, with ``holes``,
    an unmapped page inside a context and a sequence of ctx 0), contexts that
    end mid-page."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((slots, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((slots, page, Hkv, D)).astype(np.float32)
    tbl = np.full((B, pages), -1, np.int32)
    ctx = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(1, pages + 1))
        tbl[b, :n] = rng.choice(slots, n, replace=False)
        ctx[b] = (n - 1) * page + int(rng.integers(1, page + 1))
        if holes and n > 2:
            tbl[b, 1] = -1
    if holes and B > 1:
        ctx[-1] = 0
    return q, kp, vp, tbl, ctx


PAGED_CASES = [  # tests/test_kernels.py's shapes, with and without holes
    (2, 8, 2, 64, 16, 4, 32, False),
    (3, 4, 4, 32, 8, 6, 64, False),
    (1, 16, 8, 128, 32, 3, 16, False),
    (3, 8, 2, 16, 4, 7, 32, True),
    (4, 10, 2, 24, 8, 5, 40, True),
]


@pytest.mark.parametrize("oracle", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("B,Hq,Hkv,D,page,pages,slots,holes", PAGED_CASES)
def test_paged_plain_matches_jax(B, Hq, Hkv, D, page, pages, slots, holes, oracle):
    arrs = _paged_np(D * page, B, Hq, Hkv, D, page, pages, slots, holes)
    jargs = [jnp.asarray(a) for a in arrs]
    targs = [torch.from_numpy(a) for a in arrs]
    want = jax_paged_partial(*jargs, kernel_mode=oracle)
    got = pa.paged_attention_partial(*targs, kernel_mode="reference")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, F32_TOL)
    _close(pa.paged_attention(*targs, kernel_mode="reference"),
           jax_paged(*jargs, kernel_mode=oracle), F32_TOL)
    if holes:   # ctx 0: the initial residuals, which the hot-tail merge needs
        assert float(got[1][-1].max()) == float(np.float32(-1e30))
        assert float(got[2][-1].abs().max()) == 0.0 and float(got[0][-1].abs().max()) == 0.0


def test_paged_bf16_query_matches_jax():
    q, kp, vp, tbl, ctx = _paged_np(5, 3, 8, 2, 32, 8, 4, 16, holes=True)
    jq = jnp.asarray(q, jnp.bfloat16)
    want = jax_paged_partial(jq, *(jnp.asarray(a) for a in (kp, vp, tbl, ctx)),
                             kernel_mode="reference")
    got = paged_attention_ref(torch.from_numpy(q).bfloat16(),
                              *(torch.from_numpy(a) for a in (kp, vp, tbl, ctx)),
                              return_residuals=True)
    for g, w in zip(got, want):
        _close(g, w, F32_TOL)


def test_paged_plain_keeps_float64_pools_in_float64():
    """Given float64 pools the plain version computes in float64 (the oracle
    chip_smoke.py holds K6 to at the serving path's long contexts), and its
    float32 run agrees with it within the float32 tolerance."""
    q, kp, vp, tbl, ctx = (torch.from_numpy(a) for a in _paged_np(7, 2, 8, 2, 32, 16, 4, 16))
    got64 = paged_attention_ref(q.double(), kp.double(), vp.double(), tbl, ctx,
                                return_residuals=True)
    got32 = paged_attention_ref(q, kp, vp, tbl, ctx, return_residuals=True)
    for a, b in zip(got32, got64):
        assert a.dtype == torch.float32 and b.dtype == torch.float64
        torch.testing.assert_close(a.double(), b, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("empty", [False, True])
def test_merge_partials_matches_jax(empty):
    rng = np.random.default_rng(3)
    P, B, Hq, D = 3, 2, 4, 16
    accs = rng.standard_normal((P, B, Hq, D)).astype(np.float32)
    ms = rng.standard_normal((P, B, Hq)).astype(np.float32)
    ls = rng.uniform(0.5, 4.0, (P, B, Hq)).astype(np.float32)
    if empty:   # one partial saw nothing: m = -1e30, l = 0, acc = 0
        accs[1], ms[1], ls[1] = 0.0, -1e30, 0.0
    want = jax_merge(jnp.asarray(accs), jnp.asarray(ms), jnp.asarray(ls))
    got = pa.merge_partials(*(torch.from_numpy(a) for a in (accs, ms, ls)))
    _close(got, want, F32_TOL)


def test_merge_of_split_pages_equals_whole_attention():
    """Two partials over disjoint halves of the table merge to the one-shot
    attention (the JAX package's partition property, in the port)."""
    q, kp, vp, tbl, ctx = (torch.from_numpy(a) for a in _paged_np(9, 2, 4, 2, 32, 8, 4, 16))
    tbl = torch.from_numpy(np.random.default_rng(9).choice(16, (2, 4), replace=False)
                           .astype(np.int32))
    ctx = torch.full((2,), 32, dtype=torch.int32)
    full = pa.paged_attention(q, kp, vp, tbl, ctx, kernel_mode="reference")
    parts = []
    for half in range(2):
        t = tbl.clone()
        t[:, half::2] = -1
        parts.append(pa.paged_attention_partial(q, kp, vp, t, ctx, kernel_mode="reference"))
    merged = pa.merge_partials(*(torch.stack([p[i] for p in parts]) for i in range(3)))
    torch.testing.assert_close(merged, full, atol=F32_TOL, rtol=F32_TOL)


def test_cuda_mode_raises_on_cpu_tensors_and_wrappers_take_the_plain_version():
    (_, _, _), (tq, tk, tv) = _qkv(1, 4, 2, 8, 8, 16, "float32")
    with pytest.raises(ValueError, match="cuda"):
        fa.flash_attention(tq, tk, tv, kernel_mode="cuda")
    arrs = [torch.from_numpy(a) for a in _paged_np(1, 2, 4, 2, 16, 4, 3, 8)]
    with pytest.raises(ValueError, match="cuda"):
        pa.paged_attention_partial(*arrs, kernel_mode="cuda")
    with pytest.raises(ValueError, match="cuda"):
        pa.paged_attention(*arrs, kernel_mode="cuda")
    with pytest.raises(ValueError, match="kernel_mode"):
        fa.flash_attention(tq, tk, tv, kernel_mode="pallas")
    # On CPU tensors the kernel wrappers run the plain versions.
    torch.testing.assert_close(flash_attention_cuda(tq, tk, tv),
                               flash_attention_ref(tq, tk, tv), atol=0, rtol=0)
    for g, w in zip(paged_attention_cuda(*arrs),
                    paged_attention_ref(*arrs, return_residuals=True)):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# K5's bf16 tensor-core kernel: its tile plan and its arithmetic.
# ---------------------------------------------------------------------------

_HEAD_DIMS = sorted({registry.get_config(a).head_dim for a in registry.ARCH_IDS} - {0}
                    | {32, 64})


@pytest.mark.parametrize("D", _HEAD_DIMS)
def test_tile_plan_fits_the_card(D):
    """Every configured head dim (and 32, 64) gets a plan within the H100's
    232,448 bytes of shared memory a block, a padded head dim of whole 64-
    column TMA boxes, products at least D wide in 16-column wgmma steps,
    and 16-key steps of P V."""
    plan = tile_plan(D, torch.bfloat16)
    assert plan.design == "wgmma+tma"
    assert plan.smem_bytes <= SMEM_LIMIT == 232_448
    assert plan.head_dim % 64 == 0 and plan.head_dim >= D
    assert plan.width % 16 == 0 and D <= plan.width <= plan.head_dim
    assert plan.block_k % 16 == 0 and plan.block_q % 64 == 0
    assert plan.threads == 128 * (plan.block_q // 64 + 1) and plan.stages >= 2
    f32 = tile_plan(D, torch.float32)
    assert f32.design == "fma" and f32.smem_bytes <= SMEM_LIMIT and f32.width == D


def _wgmma_model(q, k, v, *, causal: bool, block_k: int) -> torch.Tensor:
    """The bf16 kernel's arithmetic in plain torch: bf16 operands, float32
    products and statistics, the running max in the log2 domain with the
    scale folded into log2 e, KV tiles of ``block_k`` keys, P rounded to
    bf16 before P V, o = acc * (1 / l) rounded to bf16."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    scale_log2 = math.log2(math.e) / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Tq, D)
    q_pos = (torch.arange(Tq) + Tk - Tq)[:, None]
    m = torch.full((B, Hkv, Hq // Hkv, Tq), -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, Tk, block_k):
        kc, vc = k[:, :, k0:k0 + block_k].float(), v[:, :, k0:k0 + block_k].float()
        k_pos = k0 + torch.arange(kc.shape[2])[None, :]
        mask = (k_pos <= q_pos) if causal else torch.ones_like(k_pos <= q_pos)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kc).masked_fill(~mask, -math.inf)
        n = torch.maximum(m, s.amax(-1) * scale_log2)
        base = torch.where(n == -math.inf, 0.0, n)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s * scale_log2 - base[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.bfloat16().float(), vc)
        m = n
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    return (acc * inv[..., None]).reshape(B, Hq, Tq, D).bfloat16()


def _chip_smoke_flash_checks():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [c[:7] for c in mod.FLASH_CHECKS if c[7] == "bfloat16"]


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal", _chip_smoke_flash_checks())
def test_wgmma_arithmetic_matches_jax_pallas(B, Hq, Hkv, Tq, Tk, D, causal):
    """Rounding P to bf16 (and nothing else) keeps the bf16 kernel within the
    JAX package's bf16 tolerance of its Pallas K5 (interpreted, in blocks of
    1,024 rows for speed)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, Hq, Hkv, Tq, Tk, D, "bfloat16", seed=Tq + D)
    want = jax_flash(jq, jk, jv, causal=causal, block_q=1024, block_k=1024,
                     kernel_mode="pallas_interpret")
    got = _wgmma_model(tq, tk, tv, causal=causal, block_k=tile_plan(D, torch.bfloat16).block_k)
    _close(got, want, BF16_TOL)
