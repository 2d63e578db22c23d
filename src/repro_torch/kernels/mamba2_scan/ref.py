"""Plain PyTorch versions of the Mamba2 (SSD) recurrence, the port of
``src/repro/kernels/mamba2_scan/ref.py``.

Per head h (state size N, head dim P), with scalar decay a_t = exp(A_h dt_t):

    S_t = a_t S_{t-1} + dt_t B_t (x) x_t        (S in R^{N x P})
    y_t = C_t^T S_t + D_h x_t

B_t, C_t are shared across heads (n_groups = 1, the Mamba2 default).

* :func:`mamba2_scan_ref` — the exact sequential oracle, a Python loop over T
  of [B, H, N, P] tensor ops in float32.  The op's ``reference`` mode runs
  it, and ``chip_smoke.py`` holds the CUDA kernel K8 against it on the card.
* :func:`mamba2_decode_step` — the O(1) single-token step of the decode path
  itself (not a stand-in for a kernel), with the JAX package's dtypes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


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
    S = (torch.zeros((B_, H, N, P), dtype=torch.float32, device=x.device) if state is None
         else state.float())
    xf, dtf, Af, Bf, Cf = x.float(), dt.float(), A.float(), Bm.float(), C.float()
    Df = D.float()[None, :, None]                          # [1, H, 1]
    outs = []
    for t in range(T):
        a = torch.exp(Af[None, :] * dtf[:, :, t])          # [B, H]
        S = a[..., None, None] * S + (dtf[:, :, t, None, None] * Bf[:, None, t, :, None]
                                      * xf[:, :, t, None, :])
        outs.append((Cf[:, None, t, :, None] * S).sum(2) + Df * xf[:, :, t])
    y = torch.stack(outs, 2) if outs else xf.new_zeros((B_, H, 0, P))
    return y.to(x.dtype), S


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
