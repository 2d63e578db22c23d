"""Python wrapper of the hand-written CUDA Mamba2 SSD scan kernels (K8).

``csrc/mamba2_scan.cu`` holds the kernels and says which Pallas TPU kernel
they replace, why they exponentiate only differences of cumulative
log-decays (the TPU kernel overflows at zamba2's decays), and what bounds
them on the card: x in bfloat16 or float32 takes the tensor-core kernel
(``mma.sync`` on split bf16 operands; float32 x split too).  Both are
bound by bytes: for float32 x at ``ssm_exact``'s 6 calls 0.0333 ms, against
0.18 ms measured (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, K8 float32).
:func:`heads_plan` chooses how many heads of a batch row a block takes; the
C side refuses a plan that does not match its layout for x's dtype.
:func:`mamba2_scan_cuda` checks its inputs, allocates the outputs, launches
the kernel on PyTorch's current stream and counts the launch in
:data:`launches`.  Given CPU tensors it runs the plain version (``ref.py``)
instead; given CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import note_launch
from repro_torch.kernels.flash_attention.kernel import DTYPE_CODES
from repro_torch.kernels.mamba2_scan.ref import mamba2_scan_ref
from repro_torch.kernels.paged_attention.kernel import sm_count
from repro_torch.kernels.rwkv6_scan.kernel import check, chunk_of

# Launches of the CUDA kernel in this process; chip_smoke.py resets and reads
# it to show which path ran through the kernel.
launches = 0

MAX_DIM = 64             # head dim P and state size N the shared-memory layout takes
HEADS_PER_BLOCK = (4, 2, 1)   # the tensor-core kernel's instances for bf16 x
# float32 x: at four heads a block (128 registers a thread) the third product
# with x spills, so its blocks take two heads or one.
HEADS_PER_BLOCK_F32 = (2, 1)
TILE = 64                # a chunk and N, P padded to 64 x 64 tiles
# Shared memory of the tensor-core kernel: B and C as bf16 high and low
# parts [64][72], C B^T float32 [64][68]; per head x [64][72] bf16, two
# [64][72] bf16 tiles, four [64] float32 vectors, and for float32 x its
# bf16 low parts, one more [64][72] tile.
TILE_BYTES = TILE * 72 * 2
SHARED_BYTES = 4 * TILE_BYTES + TILE * 68 * 4
HEAD_BYTES = {torch.bfloat16: 3 * TILE_BYTES + 4 * TILE * 4,
              torch.float32: 4 * TILE_BYTES + 4 * TILE * 4}
SM_BYTES = 233_472       # shared memory of one SM (H100), 1 KB of it reserved a block
SM_THREADS_AT_128_REGS = 512   # 65,536 registers at 128 a thread


class HeadsPlan(NamedTuple):
    """The grid of one tensor-core launch."""
    heads_per_block: int  # warpgroups (heads of one batch row) a block
    blocks: int
    blocks_per_sm: int    # resident at once, by shared memory and registers
    smem_bytes: int


def _plan(B: int, H: int, hb: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    smem = SHARED_BYTES + hb * HEAD_BYTES[dtype]
    per_sm = min(SM_BYTES // (smem + 1024), SM_THREADS_AT_128_REGS // (128 * hb))
    return B * -(-H // hb), per_sm, smem


def heads_plan(B: int, H: int, sms: int, dtype: torch.dtype = torch.bfloat16) -> HeadsPlan:
    """Heads a block for x of ``dtype`` by occupancy: the fewest heads
    resident on the busiest SM over all waves (a warpgroup's products share
    the SM's tensor cores with the others'), then the most heads a block
    (C B^T formed once for them; at zamba2's prefill four heads a block ran
    3-4% faster than two, with the same four heads on the busiest SM)."""
    def cost(hb):
        blocks, per_sm, _ = _plan(B, H, hb, dtype)
        waves = -(-blocks // (sms * per_sm))
        return (waves * hb * min(per_sm, -(-blocks // sms)), -hb)

    hb = min(HEADS_PER_BLOCK if dtype == torch.bfloat16 else HEADS_PER_BLOCK_F32, key=cost)
    blocks, per_sm, smem = _plan(B, H, hb, dtype)
    return HeadsPlan(hb, blocks, per_sm, smem)


def design(dtype: torch.dtype) -> str:
    """The kernel x of this dtype takes: the tensor-core kernel for both."""
    return "mma.sync+split-bf16"


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
    plan = heads_plan(B, H, sm_count(dev.index), x.dtype)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cdll.mamba2_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
            D.data_ptr(), y.data_ptr(), s.data_ptr(), B, H, T, P, N, Cc,
            DTYPE_CODES[x.dtype], plan.heads_per_block, plan.smem_bytes, stream)
    lib.check(err, "mamba2_scan_launch")
    launches += 1
    note_launch("mamba2_scan")
    return y, s
