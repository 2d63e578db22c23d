"""Python wrapper of the hand-written CUDA RWKV6 scan kernel (K7).

``csrc/rwkv6_scan.cu`` holds the kernel and says which Pallas TPU kernel it
replaces, why it exponentiates only differences of cumulative log-decays, and
what bounds it on the card.  :func:`rwkv6_scan_cuda` checks its inputs,
allocates the outputs, launches the kernel on PyTorch's current stream and
counts the launch in :data:`launches`.  Given CPU tensors it runs the plain
version (``ref.py``) instead; given CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import DTYPE_CODES
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

# Launches of the CUDA kernel in this process; chip_smoke.py resets and reads
# it to show which path ran through the kernel.
launches = 0

MAX_HEAD = 64            # head size N the shared-memory layout takes
MAX_CHUNK = 64


def check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"{name} must be a {dtype} tensor on {device}, got "
                         f"{x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous with shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")


def chunk_of(T: int, chunk: int) -> int:
    """The chunk the kernel runs (``min(chunk, T)``, as in the JAX kernel);
    raises ``ValueError`` where the JAX kernel asserts ``T % chunk == 0``."""
    chunk = min(chunk, T)
    if chunk <= 0 or T % chunk:
        raise ValueError(f"T={T} must be a multiple of chunk={chunk}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk={chunk}: the kernel takes chunks of at most {MAX_CHUNK}")
    return chunk


def rwkv6_scan_cuda(
    r: torch.Tensor,  # [B, H, T, N] float32 or bfloat16
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # [B, H, T, N] float32
    u: torch.Tensor,  # [H, N] float32
    *,
    chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, H, T, N] in r's dtype, final state [B, H, N, N] float32)."""
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, w, u)
    global launches
    dev = r.device
    if r.dim() != 4:
        raise ValueError(f"r must be [B, H, T, N], got {tuple(r.shape)}")
    B, H, T, N = r.shape
    if r.dtype not in DTYPE_CODES:
        raise ValueError(f"r must be float32 or bfloat16, got {r.dtype}")
    for name, x in (("r", r), ("k", k), ("v", v)):
        check(name, x, r.dtype, (B, H, T, N), dev)
    check("w", w, torch.float32, (B, H, T, N), dev)
    check("u", u, torch.float32, (H, N), dev)
    if not 0 < N <= MAX_HEAD:
        raise ValueError(f"head size {N}: the kernel takes 0 < N <= {MAX_HEAD}")
    o = torch.empty_like(r)
    s = torch.zeros((B, H, N, N), dtype=torch.float32, device=dev)
    if B == 0 or H == 0 or T == 0:
        return o, s
    C = chunk_of(T, chunk)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cdll.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            o.data_ptr(), s.data_ptr(), B, H, T, N, C, DTYPE_CODES[r.dtype], stream)
    lib.check(err, "rwkv6_scan_launch")
    launches += 1
    return o, s
