"""Public RWKV6 scan op with kernel-mode dispatch (the port of
``src/repro/kernels/rwkv6_scan/ops.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import refuse_autograd, resolve_mode
from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_cuda
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_decode_step, rwkv6_scan_ref

__all__ = ["rwkv6_scan", "rwkv6_decode_step"]


def rwkv6_scan(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    *,
    chunk: int = 32,
    kernel_mode: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, H, T, N], final state [B, H, N, N]) from a zero state.
    ``reference`` runs the sequential plain version at any T; ``cuda`` runs
    K7 in chunks of ``min(chunk, T)`` and raises ``ValueError`` unless T is a
    multiple of it."""
    refuse_autograd("rwkv6_scan", kernel_mode, r.device, r, k, v, w, u)
    mode = resolve_mode(kernel_mode, r.device)
    if mode == "reference":
        return rwkv6_scan_ref(r, k, v, w, u)
    return rwkv6_scan_cuda(r.contiguous(), k.contiguous(), v.contiguous(),
                           w.float().contiguous(), u.float().contiguous(), chunk=chunk)
