"""Python wrapper of the hand-written CUDA RWKV6 scan kernels (K7).

``csrc/rwkv6_scan.cu`` holds the kernels and says which Pallas TPU kernel
they replace, why they exponentiate only differences of cumulative
log-decays, and what bounds them on the card: r, k, v in bfloat16 or
float32 take the tensor-core kernel (``mma.sync`` on split bf16 operands;
float32 v split too).  Both are bound by bytes: for float32 at
``ssm_exact``'s 2 calls 0.00689 ms, against 0.044 ms measured (NVIDIA H100
80GB HBM3, 700.00 W; PERF.md, K7 float32).  :func:`cols_plan` chooses how
many columns of v, o and S a block takes; the C side refuses a plan that
does not match its layout for r's dtype.  :func:`rwkv6_scan_cuda` checks
its inputs, allocates the outputs, launches the kernel on PyTorch's current
stream and counts the launch in :data:`launches`.  Given CPU tensors it
runs the plain version (``ref.py``) instead; given CUDA tensors it launches
the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import note_launch
from repro_torch.kernels.flash_attention.kernel import DTYPE_CODES
from repro_torch.kernels.paged_attention.kernel import sm_count
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

# Launches of the CUDA kernel in this process; chip_smoke.py resets and reads
# it to show which path ran through the kernel.
launches = 0

MAX_HEAD = 64            # head size N the shared-memory layout takes
MAX_CHUNK = 64
COLS_PER_BLOCK = (64, 16)   # the tensor-core kernel's instances
SM_BYTES = 233_472       # shared memory of one SM (H100), 1 KB of it reserved a block
# Blocks of 256 threads an SM by registers: 65,536 at 128 a thread, which
# the chunk-32 instances' launch bounds keep (the chunk-64 ones fit one
# block an SM by shared memory alone).
BLOCKS_AT_128_REGS = 2
# The column-independent work of a chunk (the exponentials of the operands
# and of a's diagonal sub-blocks, which every column slice recomputes)
# against the column work of a 64-column block (its products and S): the
# plan's cost model.  Read on the H100 at rwkv6's prefill of 4 prompts
# (chip_smoke.py's ``cols_plan_ms``, PERF.md §6): 16 columns a block (512
# blocks, two waves of two an SM) took 2.35x the time of 64 (128 blocks),
# which is (4 p + 1) / (p + 1) at p = 0.8.  The workloads on the two sides:
# rwkv6's prefill of 4 prompts (B H = 128) takes 64 columns, of one prompt
# (B H = 32) 16 (both timed by chip_smoke.py).
PREP_OVER_COLS = 0.8


class ColsPlan(NamedTuple):
    """The grid of one tensor-core launch."""
    cols_per_block: int   # columns of v, o and S a block takes
    slices: int           # blocks a (b, h)
    blocks: int
    blocks_per_sm: int    # resident at once, by shared memory
    smem_bytes: int


def shared_bytes(chunk: int, cols: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of a block (``Layout`` in the source): the chunk
    padded to 32 or 64 rows, ``cols`` columns a block, r, k, v of
    ``dtype``.  The staged rows: r and k [cp][72] bf16 or [cp][68] float32,
    v [cp][cols + 8] bf16 or [cp][cols + 4] float32, w [cp][68] float32;
    bf16 in two stages of all four, float32 in two stages of v and one of
    r, k and w.  Then six bf16 operand tiles [cp][72] and the sub-blocks'
    factors (high and low parts), a [cp][cp + 4] float32, S0's parts
    [64][cols + 8] bf16 and u [64] float32."""
    cp = 32 if chunk <= 32 else 64
    f32 = dtype == torch.float32
    esize = 4 if f32 else 2
    nq = cp // 16 - 1
    rq_rows = nq * cp - 8 * nq * (nq + 1)
    tile = cp * 72 * 2
    rkw = 2 * cp * (68 if f32 else 72) * esize + cp * 68 * 4
    vrows = cp * (cols + (4 if f32 else 8)) * esize
    staged = rkw + 2 * vrows if f32 else 2 * (rkw + vrows)
    return (staged + 4 * tile + 2 * (rq_rows + 16 * nq) * 72 * 2 + cp * (cp + 4) * 4
            + 2 * 64 * (cols + 8) * 2 + 64 * 4)


def cols_plan(B: int, H: int, N: int, chunk: int, sms: int,
              dtype: torch.dtype = torch.bfloat16) -> ColsPlan:
    """Columns a block for r, k, v of ``dtype`` by a cost model: a block's
    chunk costs ``PREP_OVER_COLS`` plus its share of the 64 columns' work,
    the busiest SM runs its resident blocks' chunks one after another, and
    every wave pays again.  The cheapest plan wins, the widest on a tie:
    more slices only where the (b, h) blocks leave SMs idle."""
    def plan(nc):
        smem = shared_bytes(chunk, nc, dtype)
        slices = -(-N // nc)
        blocks = B * H * slices
        per_sm = max(1, min(SM_BYTES // (smem + 1024), BLOCKS_AT_128_REGS))
        return ColsPlan(nc, slices, blocks, per_sm, smem)

    def cost(p):
        waves = -(-p.blocks // (sms * p.blocks_per_sm))
        busiest = min(p.blocks_per_sm, -(-p.blocks // sms))
        return (waves * busiest * (PREP_OVER_COLS + p.cols_per_block / 64), -p.cols_per_block)

    fits = [nc for nc in COLS_PER_BLOCK if nc < N + 16] or [min(COLS_PER_BLOCK)]
    return min((plan(nc) for nc in fits), key=cost)


def design(dtype: torch.dtype) -> str:
    """The kernel r of this dtype takes: the tensor-core kernel for both."""
    return "mma.sync+split-bf16"


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
    plan = cols_plan(B, H, N, C, sm_count(dev.index), r.dtype)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cdll.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            o.data_ptr(), s.data_ptr(), B, H, T, N, C, DTYPE_CODES[r.dtype],
            plan.cols_per_block, plan.smem_bytes, stream)
    lib.check(err, "rwkv6_scan_launch")
    launches += 1
    note_launch("rwkv6_scan")
    return o, s
