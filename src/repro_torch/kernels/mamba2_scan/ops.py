"""Public Mamba2 SSD scan op with kernel-mode dispatch (the port of
``src/repro/kernels/mamba2_scan/ops.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import refuse_autograd, resolve_mode
from repro_torch.kernels.mamba2_scan.kernel import mamba2_scan_cuda
from repro_torch.kernels.mamba2_scan.ref import mamba2_decode_step, mamba2_scan_ref

__all__ = ["mamba2_scan", "mamba2_decode_step"]


def mamba2_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int = 64,
    kernel_mode: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [B, H, T, P], final state [B, H, N, P]) from a zero state.
    ``reference`` runs the sequential plain version at any T; ``cuda`` runs
    K8 in chunks of ``min(chunk, T)`` and raises ``ValueError`` unless T is a
    multiple of it."""
    refuse_autograd("mamba2_scan", kernel_mode, x.device, x, dt, A, Bm, C, D)
    mode = resolve_mode(kernel_mode, x.device)
    if mode == "reference":
        return mamba2_scan_ref(x, dt, A, Bm, C, D)
    f32 = [t.float().contiguous() for t in (dt, A, Bm, C, D)]
    return mamba2_scan_cuda(x.contiguous(), *f32, chunk=chunk)
