"""Plain PyTorch versions of the Mamba2 (SSD) recurrence, the port of
``src/repro/kernels/mamba2_scan/ref.py``.

Per head h (state size N, head dim P), with scalar decay a_t = exp(A_h dt_t):

    S_t = a_t S_{t-1} + dt_t B_t (x) x_t        (S in R^{N x P})
    y_t = C_t^T S_t + D_h x_t

B_t, C_t are shared across heads (n_groups = 1, the Mamba2 default).

* :func:`mamba2_scan_ref` — the exact sequential oracle, a Python loop over T
  of [B, H, N, P] tensor ops in float32 (float64 inputs stay float64).  The
  op's ``reference`` mode runs it where no gradient is asked for, and
  ``chip_smoke.py`` holds the CUDA kernel K8 against it on the card.
* :func:`mamba2_scan_chunked` — the same function chunk by chunk (the SSD
  form: within a chunk a quadratic form under the decay mask, between
  chunks the carried state), with a backward pass that recomputes each
  chunk in reverse from the chunk's saved boundary state.  Autograd through
  the oracle keeps every step's [B, H, N, P] state; this keeps one a chunk.
  The op's ``reference`` mode runs it under autograd and on the meta device
  (training and the dry run).
* :func:`mamba2_decode_step` — the O(1) single-token step of the decode path
  itself (not a stand-in for a kernel), with the JAX package's dtypes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def mamba2_scan_ref(
    x: torch.Tensor,    # [B, H, T, P]
    dt: torch.Tensor,   # [B, H, T]  (post-softplus, > 0)
    A: torch.Tensor,    # [H]        (negative)
    Bm: torch.Tensor,   # [B, T, N]
    C: torch.Tensor,    # [B, T, N]
    D: torch.Tensor,    # [H]
    state: Optional[torch.Tensor] = None,  # [B, H, N, P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, H, T, P] in x's dtype, final state [B, H, N, P] f32)."""
    B_, H, T, P = x.shape
    N = Bm.shape[-1]
    ct = torch.promote_types(x.dtype, torch.float32)
    S = (torch.zeros((B_, H, N, P), dtype=ct, device=x.device) if state is None
         else state.to(ct))
    xf, dtf, Af, Bf, Cf = (t.to(ct) for t in (x, dt, A, Bm, C))
    Df = D.to(ct)[None, :, None]                           # [1, H, 1]
    outs = []
    for t in range(T):
        a = torch.exp(Af[None, :] * dtf[:, :, t])          # [B, H]
        S = a[..., None, None] * S + (dtf[:, :, t, None, None] * Bf[:, None, t, :, None]
                                      * xf[:, :, t, None, :])
        outs.append((Cf[:, None, t, :, None] * S).sum(2) + Df * xf[:, :, t])
    y = torch.stack(outs, 2) if outs else xf.new_zeros((B_, H, 0, P))
    return y.to(x.dtype), S


def _intra(xc, dtc, A, Bc, Cc):
    """The parts of each chunk that need no carried state.  xc [B, H, c, L,
    P], dtc [B, H, c, L], Bc / Cc [B, c, L, N].  Returns (cum, the in-chunk
    outputs [B, H, c, L, P], the chunk's own state [B, H, c, N, P]).  Every
    decay is exp of a difference of the cumulative log-decay ``cum`` within
    one chunk, at most 0: finite at any decay, where rescaling by exp(-cum)
    overflows float32 once cum passes -88 (the TPU kernel's fault)."""
    L = xc.shape[-2]
    cum = torch.cumsum(A[None, :, None, None] * dtc, -1)          # [B, H, c, L]
    causal = torch.ones((L, L), dtype=torch.bool, device=xc.device).tril()
    decay = torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :],
                                  float("-inf")))                 # [B, H, c, t, s]
    w = decay * torch.einsum("bctn,bcsn->bcts", Cc, Bc)[:, None] * dtc[..., None, :]
    y = torch.einsum("bhcts,bhcsp->bhctp", w, xc)
    to_end = torch.exp(cum[..., -1:] - cum) * dtc                 # [B, H, c, L]
    s_own = torch.einsum("bcsn,bhcsp->bhcnp", Bc, to_end[..., None] * xc)
    return cum, y, s_own


def _readout(cum, Cc, xc, D, S0):
    """What each step of a chunk reads from the state it starts from
    (S0 [B, H, c, N, P]), plus the D skip."""
    return (torch.exp(cum)[..., None] * torch.einsum("bctn,bhcnp->bhctp", Cc, S0)
            + D[None, :, None, None, None] * xc)


def _chunk(xc, dtc, A, Bc, Cc, D, S0):
    """(outputs, end states) of chunks that start from S0 [B, H, c, N, P]."""
    cum, y, s_own = _intra(xc, dtc, A, Bc, Cc)
    S1 = torch.exp(cum[..., -1])[..., None, None] * S0 + s_own
    return y + _readout(cum, Cc, xc, D, S0), S1


def _chunked(x, dt, Bm, C, L: int):
    """x, dt, Bm, C padded with zeros to a multiple of L steps and cut into
    chunks ([B, H, c, L, P], [B, H, c, L], [B, c, L, N] twice).  A padded
    step has dt = 0, so its decay is exp(0) = 1 and it adds nothing."""
    B_, H, T, P = x.shape
    N, pad = Bm.shape[-1], -T % L
    if pad:
        x, dt = F.pad(x, (0, 0, 0, pad)), F.pad(dt, (0, pad))
        Bm, C = F.pad(Bm, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
    c = (T + pad) // L
    return (x.reshape(B_, H, c, L, P), dt.reshape(B_, H, c, L),
            Bm.reshape(B_, c, L, N), C.reshape(B_, c, L, N))


class _ChunkedScan(torch.autograd.Function):
    """:func:`mamba2_scan_chunked`.  The forward pass saves its inputs and
    each chunk's starting state, O(B H N P T / chunk); the backward pass
    walks the chunks in reverse, recomputes one chunk at a time under
    autograd from its saved state and hands the state's gradient to the
    chunk before."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, C, D, state, chunk):
        B_, H, T, P = x.shape
        N = Bm.shape[-1]
        ct = torch.promote_types(x.dtype, torch.float32)
        S0 = (torch.zeros((B_, H, N, P), dtype=ct, device=x.device) if state is None
              else state.to(ct))
        L = max(1, min(chunk, T))
        xc, dtc, Bc, Cc = _chunked(*(t.to(ct) for t in (x, dt, Bm, C)), L)
        Af, Df = A.to(ct), D.to(ct)
        cum, y, s_own = _intra(xc, dtc, Af, Bc, Cc)
        g = torch.exp(cum[..., -1])                                   # [B, H, c]
        starts = [S0]
        for c in range(xc.shape[2]):
            starts.append(g[:, :, c, None, None] * starts[-1] + s_own[:, :, c])
        S = torch.stack(starts[:-1], 2) if xc.shape[2] else S0.new_zeros((B_, H, 0, N, P))
        y = (y + _readout(cum, Cc, xc, Df, S)).reshape(B_, H, -1, P)[:, :, :T]
        ctx.save_for_backward(x, dt, A, Bm, C, D, S)
        ctx.L, ctx.has_state = L, state is not None
        return y.to(x.dtype), starts[-1]

    @staticmethod
    def backward(ctx, dy, dS):
        x, dt, A, Bm, C, D, S = ctx.saved_tensors
        T, ct = x.shape[2], S.dtype
        xc, dtc, Bc, Cc = _chunked(*(t.to(ct) for t in (x, dt, Bm, C)), ctx.L)
        dyc = F.pad(dy.to(ct), (0, 0, 0, -T % ctx.L)).reshape(xc.shape)
        dS = dS.to(ct)
        grads = [torch.zeros_like(t) for t in (xc, dtc, Bc, Cc)]
        dA, dD = torch.zeros_like(A, dtype=ct), torch.zeros_like(D, dtype=ct)
        for c in reversed(range(xc.shape[2])):
            one = slice(c, c + 1)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (
                    xc[:, :, one], dtc[:, :, one], A.to(ct), Bc[:, one], Cc[:, one], D.to(ct),
                    S[:, :, one])]
                y1, S1 = _chunk(*leaves)
                got = torch.autograd.grad((y1, S1[:, :, 0]), leaves, (dyc[:, :, one], dS))
            for buf, g, at in zip(grads, (got[0], got[1], got[3], got[4]), (2, 2, 1, 1)):
                buf.narrow(at, c, 1).copy_(g)
            dA += got[2]
            dD += got[5]
            dS = got[6][:, :, 0]
        dx, ddt, dB, dC = grads
        unpad = lambda t, at: t.flatten(at, at + 1).narrow(at, 0, T)   # noqa: E731
        return (unpad(dx, 2).to(x.dtype), unpad(ddt, 2).to(dt.dtype), dA.to(A.dtype),
                unpad(dB, 1).to(Bm.dtype), unpad(dC, 1).to(C.dtype), dD.to(D.dtype),
                dS if ctx.has_state else None, None)


def mamba2_scan_chunked(
    x: torch.Tensor,    # [B, H, T, P]
    dt: torch.Tensor,   # [B, H, T]  (post-softplus, > 0)
    A: torch.Tensor,    # [H]        (negative)
    Bm: torch.Tensor,   # [B, T, N]
    C: torch.Tensor,    # [B, T, N]
    D: torch.Tensor,    # [H]
    state: Optional[torch.Tensor] = None,  # [B, H, N, P]
    *,
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba2_scan_ref`'s function in chunks of ``min(chunk, T)``
    steps (T need not be a multiple: the last chunk is padded with steps
    that change nothing), with a recomputing backward pass (the class
    above).  Returns (y [B, H, T, P] in x's dtype, final state [B, H, N, P]
    in float32, or float64 for float64 x)."""
    return _ChunkedScan.apply(x, dt, A, Bm, C, D, state, chunk)


def mamba2_decode_step(
    x: torch.Tensor,    # [B, H, P]
    dt: torch.Tensor,   # [B, H]
    A: torch.Tensor,    # [H]
    Bm: torch.Tensor,   # [B, N]
    C: torch.Tensor,    # [B, N]
    D: torch.Tensor,    # [H]
    state: torch.Tensor,  # [B, H, N, P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) single-token step for decode."""
    a = torch.exp(A[None, :] * dt)                        # [B, H]
    S = a[..., None, None] * state + (
        dt[..., None, None] * Bm[:, None, :, None] * x[:, :, None, :])
    y = (C[:, None, :, None] * S).sum(2) + D[None, :, None] * x
    return y.to(x.dtype), S
