"""Plain PyTorch versions of the RWKV6 (Finch) recurrence, the port of
``src/repro/kernels/rwkv6_scan/ref.py``.

Per head (head size N), with receptance r, key k, value v, data-dependent
per-channel decay w in (0, 1) and a learned bonus u:

    a_t    = k_t (x) v_t                      (outer product, [N, N])
    o_t[j] = sum_i r_t[i] (S[i,j] + u[i] a_t[i,j])
    S      = diag(w_t) S + a_t

* :func:`rwkv6_scan_ref` — the exact sequential oracle, a Python loop over T
  of [B, H, N, N] tensor ops in float32.  The op's ``reference`` mode runs
  it, and ``chip_smoke.py`` holds the CUDA kernel K7 against it on the card.
* :func:`rwkv6_decode_step` — the O(1) single-token step of the decode path
  itself (not a stand-in for a kernel): it keeps the JAX package's dtypes
  (the outer product ``a`` is formed in the inputs' dtype).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rwkv6_scan_ref(
    r: torch.Tensor,  # [B, H, T, N]
    k: torch.Tensor,  # [B, H, T, N]
    v: torch.Tensor,  # [B, H, T, N]
    w: torch.Tensor,  # [B, H, T, N] decay in (0, 1)
    u: torch.Tensor,  # [H, N] bonus
    state: Optional[torch.Tensor] = None,  # [B, H, N, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (o [B, H, T, N] in r's dtype, final state [B, H, N, N] f32)."""
    B, H, T, N = r.shape
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device) if state is None
         else state.float())
    rf, kf, vf, wf = r.float(), k.float(), v.float(), w.float()
    uf = u.float()[None, :, :, None]                      # [1, H, N, 1]
    outs = []
    for t in range(T):
        a = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        outs.append(((S + uf * a) * rf[:, :, t, :, None]).sum(-2))
        S = wf[:, :, t, :, None] * S + a
    o = torch.stack(outs, 2) if outs else rf.new_zeros((B, H, 0, N))
    return o.to(r.dtype), S


def rwkv6_decode_step(
    r: torch.Tensor,  # [B, H, N] single token
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,  # [H, N]
    state: torch.Tensor,  # [B, H, N, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) single-token step (the serve path: no KV cache).  The outer
    product is formed in float32, as the prefill's scan forms it: the JAX
    package's dtypes would round it to ``k``'s, but XLA keeps the fused
    product in float32, so this is what the JAX package computes."""
    a = k.float()[..., :, None] * v.float()[..., None, :]
    o = ((state + u[None, :, :, None] * a) * r[..., :, None]).sum(-2)
    state = w[..., :, None] * state + a
    return o.to(r.dtype), state
