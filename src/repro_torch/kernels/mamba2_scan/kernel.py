"""Python wrapper of the hand-written CUDA Mamba2 SSD scan kernel (K8).

``csrc/mamba2_scan.cu`` holds the kernel and says which Pallas TPU kernel it
replaces, why it exponentiates only differences of cumulative log-decays (the
TPU kernel overflows at zamba2's decays), and what bounds it on the card.
:func:`mamba2_scan_cuda` checks its inputs, allocates the outputs, launches
the kernel on PyTorch's current stream and counts the launch in
:data:`launches`.  Given CPU tensors it runs the plain version (``ref.py``)
instead; given CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import DTYPE_CODES
from repro_torch.kernels.mamba2_scan.ref import mamba2_scan_ref
from repro_torch.kernels.rwkv6_scan.kernel import check, chunk_of

# Launches of the CUDA kernel in this process; chip_smoke.py resets and reads
# it to show which path ran through the kernel.
launches = 0

MAX_DIM = 64             # head dim P and state size N the shared-memory layout takes


def mamba2_scan_cuda(
    x: torch.Tensor,    # [B, H, T, P] float32 or bfloat16
    dt: torch.Tensor,   # [B, H, T] float32
    A: torch.Tensor,    # [H] float32
    Bm: torch.Tensor,   # [B, T, N] float32
    C: torch.Tensor,    # [B, T, N] float32
    D: torch.Tensor,    # [H] float32
    *,
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [B, H, T, P] in x's dtype, final state [B, H, N, P] float32)."""
    if x.device.type == "cpu":
        return mamba2_scan_ref(x, dt, A, Bm, C, D)
    global launches
    dev = x.device
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"x must be [B, H, T, P] and Bm [B, T, N], got "
                         f"{tuple(x.shape)} and {tuple(Bm.shape)}")
    B, H, T, P = x.shape
    N = Bm.shape[-1]
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    check("x", x, x.dtype, (B, H, T, P), dev)
    check("dt", dt, torch.float32, (B, H, T), dev)
    check("A", A, torch.float32, (H,), dev)
    check("Bm", Bm, torch.float32, (B, T, N), dev)
    check("C", C, torch.float32, (B, T, N), dev)
    check("D", D, torch.float32, (H,), dev)
    if not (0 < P <= MAX_DIM and 0 < N <= MAX_DIM):
        raise ValueError(f"head dim {P}, state size {N}: the kernel takes each in "
                         f"(0, {MAX_DIM}]")
    y = torch.empty_like(x)
    s = torch.zeros((B, H, N, P), dtype=torch.float32, device=dev)
    if B == 0 or H == 0 or T == 0:
        return y, s
    Cc = chunk_of(T, chunk)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cdll.mamba2_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
            D.data_ptr(), y.data_ptr(), s.data_ptr(), B, H, T, P, N, Cc,
            DTYPE_CODES[x.dtype], stream)
    lib.check(err, "mamba2_scan_launch")
    launches += 1
    return y, s
