"""Public Mamba2 SSD scan op with kernel-mode dispatch (the port of
``src/repro/kernels/mamba2_scan/ops.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import refuse_autograd, resolve_mode
from repro_torch.kernels.mamba2_scan.kernel import mamba2_scan_cuda
from repro_torch.kernels.mamba2_scan.ref import (
    mamba2_decode_step, mamba2_scan_chunked, mamba2_scan_ref,
)

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
    ``reference`` runs the plain version at any T: the sequential oracle,
    or, where a gradient is asked for or the data lies on the meta device
    (training, the dry run), the chunked form in chunks of ``chunk`` with a
    recomputing backward pass, whose saved state grows with T / chunk and
    not with T.  ``cuda`` runs K8 in chunks of ``min(chunk, T)`` and raises
    ``ValueError`` unless T is a multiple of it."""
    ins = (x, dt, A, Bm, C, D)
    refuse_autograd("mamba2_scan", kernel_mode, x.device, *ins)
    mode = resolve_mode(kernel_mode, x.device)
    if mode == "reference":
        if x.device.type == "meta" or (torch.is_grad_enabled()
                                       and any(t.requires_grad for t in ins)):
            return mamba2_scan_chunked(*ins, chunk=chunk)
        return mamba2_scan_ref(*ins)
    f32 = [t.float().contiguous() for t in (dt, A, Bm, C, D)]
    return mamba2_scan_cuda(x.contiguous(), *f32, chunk=chunk)
