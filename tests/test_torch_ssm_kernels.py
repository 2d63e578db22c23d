"""The port's state-space scans (K7 ``rwkv6_scan``, K8 ``mamba2_scan``) and
their decode steps against the JAX package on the CPU: the plain versions
within 1e-5 of JAX's ``reference`` mode, within 5e-4 of its Pallas kernels
run by the interpreter (the tolerance of tests/test_kernels.py), the mode
dispatch, and the reference fault the CUDA kernels are written around (the
TPU kernels' ``exp(-logc)`` rescaling overflows at zamba2's decays)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan import mamba2_decode_step as j_m2_step
from repro.kernels.mamba2_scan import mamba2_scan as j_m2_scan
from repro.kernels.mamba2_scan.ref import mamba2_scan_ref as j_m2_ref
from repro.kernels.rwkv6_scan import rwkv6_decode_step as j_r6_step
from repro.kernels.rwkv6_scan import rwkv6_scan as j_r6_scan
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as j_r6_ref
from repro_torch.kernels import mamba2_scan as t_m2
from repro_torch.kernels import rwkv6_scan as t_r6
from repro_torch.kernels.mamba2_scan.kernel import mamba2_scan_cuda
from repro_torch.kernels.mamba2_scan.ref import mamba2_scan_ref as t_m2_ref
from repro_torch.kernels.rwkv6_scan.kernel import chunk_of, rwkv6_scan_cuda
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref as t_r6_ref

REF_TOL = 1e-5      # plain version against JAX's reference: float32 sums in another order
KERNEL_TOL = 5e-4   # against the interpreted Pallas kernels (tests/test_kernels.py)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _rwkv6_inputs(seed, B, H, T, N, w_range=(0.75, 0.999)):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, N)).astype(np.float32) * 0.5 for _ in range(3))
    w = rng.uniform(*w_range, (B, H, T, N)).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32) * 0.5
    return r, k, v, w, u


def _mamba2_inputs(seed, B, H, T, P, N, zamba2=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, T, P)).astype(np.float32) * 0.5
    if zamba2:   # zamba2's decays: A = -exp(log(linspace(1, 8, H))), dt = softplus(N(0, .63^2))
        dt = np.log1p(np.exp(rng.normal(0.0, 0.63, (B, H, T)))).astype(np.float32)
        A = -np.linspace(1.0, 8.0, H, dtype=np.float32)
    else:
        dt = rng.uniform(0.001, 0.1, (B, H, T)).astype(np.float32)
        A = -rng.uniform(0.5, 4.0, H).astype(np.float32)
    Bm, C = (rng.standard_normal((B, T, N)).astype(np.float32) * 0.5 for _ in range(2))
    D = rng.standard_normal(H).astype(np.float32)
    return x, dt, A, Bm, C, D


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# The JAX test shapes of tests/test_kernels.py.
RWKV6_SHAPES = [(2, 2, 64, 32, 32), (1, 4, 96, 16, 16)]
MAMBA2_SHAPES = [(2, 2, 64, 32, 16, 32), (1, 4, 96, 16, 32, 16)]


@pytest.mark.parametrize("B,H,T,N,chunk", RWKV6_SHAPES)
def test_rwkv6_plain_matches_jax_reference_and_kernel(B, H, T, N, chunk):
    ins = _rwkv6_inputs(B * 10 + N, B, H, T, N)
    o, s = t_r6.rwkv6_scan(*_t(*ins), kernel_mode="reference")
    for mode, tol in (("reference", REF_TOL), ("pallas_interpret", KERNEL_TOL)):
        jo, js = j_r6_scan(*map(jnp.asarray, ins), chunk=chunk, kernel_mode=mode)
        _close(o, jo, tol)
        _close(s, js, tol)


def test_rwkv6_plain_takes_an_initial_state_like_jax():
    ins = _rwkv6_inputs(3, 2, 3, 17, 8)
    s0 = np.random.default_rng(4).standard_normal((2, 3, 8, 8)).astype(np.float32)
    o, s = t_r6_ref(*_t(*ins, s0))
    jo, js = j_r6_ref(*map(jnp.asarray, ins), jnp.asarray(s0))
    _close(o, jo, REF_TOL)
    _close(s, js, REF_TOL)
    # Two halves with the carried state equal one pass.
    t = _t(*ins)
    o1, s1 = t_r6_ref(*[x[:, :, :9] for x in t[:4]], t[4])
    o2, s2 = t_r6_ref(*[x[:, :, 9:] for x in t[:4]], t[4], s1)
    o_all, s_all = t_r6_ref(*t)
    torch.testing.assert_close(torch.cat([o1, o2], 2), o_all, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(s2, s_all, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rwkv6_decode_step_matches_jax(dtype):
    """The decode path's own step, in float32 and with bfloat16 r, k, v,
    against JAX's step jitted as its decode loop runs it: XLA keeps the
    fused outer product k v^T in float32, and the port forms it in float32
    too (as the prefill's scan does)."""
    rng = np.random.default_rng(5)
    B, H, N = 3, 2, 16
    r, k, v = (rng.standard_normal((B, H, N)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.5, 0.99, (B, H, N)).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jo, js = jax.jit(j_r6_step)(*(jnp.asarray(x, jdt) for x in (r, k, v)), jnp.asarray(w),
                                jnp.asarray(u), jnp.asarray(s0))
    to, ts = t_r6.rwkv6_decode_step(*(torch.from_numpy(x).to(tdt) for x in (r, k, v)),
                                    *_t(w, u, s0))
    assert to.dtype == tdt and ts.dtype == torch.float32
    _close(to, np.asarray(jo, np.float32), REF_TOL if tdt == torch.float32 else 1e-2)
    _close(ts, js, REF_TOL)


@pytest.mark.parametrize("B,H,T,P,N,chunk", MAMBA2_SHAPES)
def test_mamba2_plain_matches_jax_reference_and_kernel(B, H, T, P, N, chunk):
    ins = _mamba2_inputs(B * 10 + P, B, H, T, P, N)
    y, s = t_m2.mamba2_scan(*_t(*ins), kernel_mode="reference")
    for mode, tol in (("reference", REF_TOL), ("pallas_interpret", KERNEL_TOL)):
        jy, js = j_m2_scan(*map(jnp.asarray, ins), chunk=chunk, kernel_mode=mode)
        _close(y, jy, tol)
        _close(s, js, tol)


def test_mamba2_plain_takes_an_initial_state_like_jax():
    ins = _mamba2_inputs(6, 2, 3, 19, 8, 4)
    s0 = np.random.default_rng(7).standard_normal((2, 3, 4, 8)).astype(np.float32)
    y, s = t_m2_ref(*_t(*ins, s0))
    jy, js = j_m2_ref(*map(jnp.asarray, ins), jnp.asarray(s0))
    _close(y, jy, REF_TOL)
    _close(s, js, REF_TOL)


def test_mamba2_decode_step_matches_jax():
    rng = np.random.default_rng(8)
    B, H, P, N = 3, 4, 8, 6
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, H)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, H).astype(np.float32)
    Bm, C = (rng.standard_normal((B, N)).astype(np.float32) for _ in range(2))
    D = rng.standard_normal(H).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    jy, js = j_m2_step(*map(jnp.asarray, (x, dt, A, Bm, C, D, s0)))
    ty, ts = t_m2.mamba2_decode_step(*_t(x, dt, A, Bm, C, D, s0))
    _close(ty, jy, REF_TOL)
    _close(ts, js, REF_TOL)


def test_scan_modes_dispatch_by_device():
    """``auto`` on CPU data is the plain version; ``cuda`` on CPU data
    raises; the wrappers given CPU tensors take the plain version."""
    r6 = _t(*_rwkv6_inputs(9, 1, 2, 12, 8))
    m2 = _t(*_mamba2_inputs(9, 1, 2, 12, 8, 4))
    for op, ins, ref in ((t_r6.rwkv6_scan, r6, t_r6_ref), (t_m2.mamba2_scan, m2, t_m2_ref)):
        want = ref(*ins)
        for got in (op(*ins), op(*ins, kernel_mode="auto")):
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        with pytest.raises(ValueError, match="cuda"):
            op(*ins, kernel_mode="cuda")
        with pytest.raises(ValueError, match="kernel_mode"):
            op(*ins, kernel_mode="pallas")
    for g, w in zip(rwkv6_scan_cuda(*r6), t_r6_ref(*r6)):
        assert torch.equal(g, w)
    for g, w in zip(mamba2_scan_cuda(*m2), t_m2_ref(*m2)):
        assert torch.equal(g, w)


def test_chunk_rule_matches_jax():
    """min(chunk, T), and T % chunk == 0 or the kernel refuses (JAX asserts)."""
    assert chunk_of(256, 32) == 32 and chunk_of(20, 32) == 20 and chunk_of(64, 64) == 64
    for T, chunk in ((100, 32), (96, 64)):
        with pytest.raises(ValueError, match="multiple of chunk"):
            chunk_of(T, chunk)
        with pytest.raises(AssertionError):
            j_r6_scan(*map(jnp.asarray, _rwkv6_inputs(0, 1, 1, T, 4)), chunk=chunk,
                      kernel_mode="pallas_interpret")


def test_reference_fault_mamba2_kernel_overflows_at_zamba2_decays():
    """The TPU kernel rescales by exp(-logc), and at zamba2's decays logc
    falls far below -88 within a 64-token chunk: JAX's interpreted kernel
    returns NaN for every head but the slowest, while JAX's reference and
    the port's plain version (the function K8 computes, by differences of
    logc only) are finite and equal."""
    ins = _mamba2_inputs(11, 1, 8, 128, 16, 16, zamba2=True)
    jy_pal, _ = j_m2_scan(*map(jnp.asarray, ins), chunk=64, kernel_mode="pallas_interpret")
    jy_ref, js_ref = j_m2_scan(*map(jnp.asarray, ins), kernel_mode="reference")
    ty, ts = t_m2_ref(*_t(*ins))
    bad = ~np.isfinite(np.asarray(jy_pal)).all(axis=(0, 2, 3))
    assert bad[1:].all(), bad
    assert np.isfinite(np.asarray(jy_ref)).all() and bool(torch.isfinite(ty).all())
    _close(ty, jy_ref, REF_TOL)
    _close(ts, js_ref, REF_TOL)


def test_rwkv6_kernel_assumption_holds_at_rwkv6_init_decays_only():
    """K7's TPU kernel rescales by exp(-logd) too.  At rwkv6's initial decay
    (w = exp(-exp(-1)) ~ 0.69) it stays within 5e-4 of the reference; with
    faster-decaying channels (w in [1e-3, 0.05], logd below -88 within a
    32-token chunk) it
    overflows, while the port's plain version stays finite and equal to
    JAX's reference."""
    ins = _rwkv6_inputs(12, 1, 2, 64, 16, w_range=(0.68, 0.70))
    jo, _ = j_r6_scan(*map(jnp.asarray, ins), chunk=32, kernel_mode="pallas_interpret")
    jref, _ = j_r6_scan(*map(jnp.asarray, ins), kernel_mode="reference")
    np.testing.assert_allclose(np.asarray(jo), np.asarray(jref), atol=KERNEL_TOL)
    ins = _rwkv6_inputs(13, 1, 2, 64, 16, w_range=(1e-3, 0.05))
    jo, _ = j_r6_scan(*map(jnp.asarray, ins), chunk=32, kernel_mode="pallas_interpret")
    jref, _ = j_r6_scan(*map(jnp.asarray, ins), kernel_mode="reference")
    to, _ = t_r6_ref(*_t(*ins))
    assert not np.isfinite(np.asarray(jo)).all()
    assert bool(torch.isfinite(to).all())
    _close(to, jref, REF_TOL)
