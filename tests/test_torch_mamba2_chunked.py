"""The chunked Mamba2 scan with a recomputing backward pass
(``repro_torch.kernels.mamba2_scan.ref.mamba2_scan_chunked``), the plain
version the port trains and dry-runs with, against the exact sequential
oracle (the port's ``mamba2_scan_ref`` and the JAX package's):

* forward within 5e-4 (the chunked scans' tolerance of tests/test_kernels.py)
  at the JAX test shapes, zamba2's head shape at its decays (where the TPU
  kernel's rescaling overflows), T not a multiple of the chunk, T below the
  chunk, T = 0, and an initial state;
* gradients of every input against autograd through the port's oracle:
  within 1e-9 in float64, 5e-4 in float32 (of each gradient's scale);
* the bytes autograd saves (``saved_tensors_hooks``): the inputs and one
  [B, H, N, P] state a chunk, against one a step through the oracle;
* the op's routing: ``reference`` without a gradient is the oracle bit for
  bit; under autograd and on the meta device it is the chunked form.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan.ref import mamba2_scan_ref as j_ref
from repro_torch.kernels.mamba2_scan import mamba2_scan
from repro_torch.kernels.mamba2_scan.ref import mamba2_scan_chunked, mamba2_scan_ref

SCAN_TOL = 5e-4                  # tests/test_kernels.py's chunked-scan tolerance
GRAD_TOL = {torch.float64: 1e-9, torch.float32: 5e-4}


def _inputs(seed, B, H, T, P, N, *, zamba2=False, state=False, dtype=torch.float32):
    """The scan's inputs as tests/test_torch_ssm_kernels.py draws them
    (zamba2: A = -linspace(1, 8, H), dt = softplus(N(0, 0.63^2)))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, T, P)) * 0.5
    if zamba2:
        dt = np.log1p(np.exp(rng.normal(0.0, 0.63, (B, H, T))))
        A = -np.linspace(1.0, 8.0, H)
    else:
        dt = rng.uniform(0.001, 0.1, (B, H, T))
        A = -rng.uniform(0.5, 4.0, H)
    Bm, C = (rng.standard_normal((B, T, N)) * 0.5 for _ in range(2))
    D = rng.standard_normal(H)
    out = [x, dt, A, Bm, C, D]
    if state:
        out.append(rng.standard_normal((B, H, N, P)))
    return [torch.from_numpy(np.asarray(a)).to(dtype) for a in out]


# (B, H, T, P, N, chunk, zamba2 decays, initial state)
CASES = [
    (2, 2, 64, 32, 16, 32, False, False),     # the JAX test shapes
    (1, 4, 96, 16, 32, 16, False, False),
    (2, 7, 192, 64, 64, 64, True, False),     # zamba2's heads a rank at its decays
    (1, 3, 100, 8, 4, 32, False, False),      # T not a multiple of the chunk
    (2, 3, 19, 8, 4, 64, False, True),        # T below the chunk, an initial state
    (1, 4, 130, 16, 16, 64, True, True),
]
IDS = ["jax-a", "jax-b", "zamba2-heads", "ragged-T", "short-T-state", "zamba2-state"]


@pytest.mark.parametrize("B,H,T,P,N,chunk,zamba2,state", CASES, ids=IDS)
def test_chunked_forward_matches_both_oracles(B, H, T, P, N, chunk, zamba2, state):
    ins = _inputs(T + H, B, H, T, P, N, zamba2=zamba2, state=state)
    y, s = mamba2_scan_chunked(*ins, chunk=chunk)
    ty, ts = mamba2_scan_ref(*ins)
    jy, js = j_ref(*(jnp.asarray(t.numpy()) for t in ins))
    assert bool(torch.isfinite(y).all()) and y.shape == (B, H, T, P) and s.shape == (B, H, N, P)
    for got, want in ((y, ty), (s, ts), (y, np.asarray(jy)), (s, np.asarray(js))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCAN_TOL, rtol=SCAN_TOL)


def test_chunked_forward_of_no_steps_is_the_initial_state():
    ins = _inputs(0, 2, 3, 0, 4, 5, state=True)
    y, s = mamba2_scan_chunked(*ins, chunk=8)
    assert y.shape == (2, 3, 0, 4) and torch.equal(s, ins[-1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("B,H,T,P,N,chunk,zamba2,state", CASES, ids=IDS)
def test_chunked_gradients_match_autograd_through_the_oracle(B, H, T, P, N, chunk, zamba2,
                                                             state, dtype):
    ins = [t.requires_grad_() for t in _inputs(T * 3 + H, B, H, T, P, N, zamba2=zamba2,
                                                state=state, dtype=dtype)]
    gen = torch.Generator().manual_seed(T)
    w_y = torch.randn((B, H, T, P), generator=gen, dtype=dtype)
    w_s = torch.randn((B, H, N, P), generator=gen, dtype=dtype)

    def grads(fn):
        y, s = fn()
        return torch.autograd.grad((y * w_y).sum() + (s * w_s).sum(), ins)

    got = grads(lambda: mamba2_scan_chunked(*ins, chunk=chunk))
    want = grads(lambda: mamba2_scan_ref(*ins))
    for g, w in zip(got, want):
        assert g.dtype == dtype
        gap = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        assert gap <= GRAD_TOL[dtype], gap


def _saved_bytes(fn) -> int:
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total


@pytest.mark.parametrize("T", [128, 512])
def test_saved_bytes_grow_with_chunks_not_steps(T):
    B, H, P, N, chunk = 1, 2, 16, 16, 32
    ins = [t.requires_grad_() for t in _inputs(T, B, H, T, P, N)]
    in_bytes = sum(t.numel() * t.element_size() for t in ins)
    state_bytes = B * H * N * P * 4
    chunked = _saved_bytes(lambda: mamba2_scan_chunked(*ins, chunk=chunk))
    oracle = _saved_bytes(lambda: mamba2_scan_ref(*ins))
    assert chunked == in_bytes + (T // chunk) * state_bytes
    assert oracle >= T * state_bytes


def test_reference_mode_routes_by_grad_and_device():
    ins = _inputs(5, 2, 3, 40, 8, 4)
    for got, want in zip(mamba2_scan(*ins, kernel_mode="reference"), mamba2_scan_ref(*ins)):
        assert torch.equal(got, want)
    with torch.no_grad():
        leaves = [t.clone().requires_grad_() for t in ins]
        for got, want in zip(mamba2_scan(*leaves, kernel_mode="reference"),
                             mamba2_scan_ref(*ins)):
            assert torch.equal(got, want)
    leaves = [t.clone().requires_grad_() for t in ins]
    y, _ = mamba2_scan(*leaves, kernel_mode="reference")
    assert type(y.grad_fn).__name__ == "_ChunkedScanBackward"
    meta = [t.to("meta") for t in ins]
    y, s = mamba2_scan(*meta, kernel_mode="reference")
    assert y.device.type == "meta" and y.shape == (2, 3, 40, 8) and s.shape == (2, 3, 4, 8)
