"""Python wrapper of the hand-written CUDA flash-attention kernel (K5).

``csrc/flash_attention.cu`` holds the kernels and says which Pallas TPU
kernel they replace and what bounds them on the card: bfloat16 inputs take
the ``wgmma`` kernel (tiles fed by TMA), float32 inputs the 3xTF32 kernel
(``mma.sync`` on split TF32 operands, tiles fed by ``cp.async``); both run
on the tensor cores.  The float32 kernel is bound by its three TF32
products (0.0523 ms at ``serve_exact``'s 10 prefill calls) and took 0.774 ms
there (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, K5 float32).
:func:`tile_plan` computes the tiles a launch uses, and
the C side refuses a plan that differs from the one it was built with.
:func:`flash_attention_cuda` checks its inputs, allocates the output,
launches the kernel on PyTorch's current stream and counts the launch in
:data:`launches`.  Given CPU tensors it runs the plain version (``ref.py``)
instead; given CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import note_launch
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# Launches of the CUDA kernel in this process; chip_smoke.py resets and reads
# it to show which path ran through the kernel.
launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
SMEM_LIMIT = 232_448       # shared memory one block may use on the H100 (opt-in)
COPY_ALIGN = 16            # bytes: the base alignment of TMA's and cp.async's copies
WGMMA_WIDTHS = (64, 112, 128, 160, 256)   # product widths the bf16 kernel is built for
TF32_WIDTHS = (16, 32, 64, 112, 128, 160, 256)   # accumulator widths of the float32 kernel


def check_head_dim(D: int) -> None:
    if D % 8 or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D}: the kernel takes 0 < D <= {MAX_HEAD_DIM}, "
                         f"D % 8 == 0")


class TilePlan(NamedTuple):
    """The tiles of one launch, as ``csrc/flash_attention.cu`` builds them."""
    design: str          # "wgmma+tma" (bfloat16) or "mma.sync+3xtf32" (float32)
    head_dim: int        # padded in shared memory (bf16: a multiple of 64; float32: Q, K rows)
    block_q: int         # query rows per block
    block_k: int         # keys per KV tile
    stages: int          # K / V tiles in flight
    threads: int
    smem_bytes: int
    width: int           # columns the products cover (>= D; bf16 a multiple of 16)


def tile_plan(D: int, dtype: torch.dtype) -> TilePlan:
    """bfloat16: two consumer warpgroups of 64 query rows and a producer
    warpgroup; the products cover the head dim rounded up to a built width
    (112 for zamba2, 160 for stablelm), shared memory pads it to 64 columns
    (TMA's 128-byte swizzled box); 128 keys a tile up to a padded 128, 64
    above; Q once, K and V in a ring of 3 stages where they fit (2 at a
    padded 256), 1,024 bytes of alignment slack and the ring's mbarriers.
    float32: 4 warps of 16 rows, 32 keys a tile, K and V in a ring of 2
    stages, all float32 in shared memory; Q and K rows padded to 8 or 24
    floats mod 32, V rows to 4 or 12 mod 16 (the fragment loads' banks);
    accumulators the head dim rounded up to a built width."""
    check_head_dim(D)
    if dtype == torch.bfloat16:
        width = next(w for w in WGMMA_WIDTHS if w >= D)
        dp = -(-width // 64) * 64
        bq, bk = 128, (128 if dp <= 128 else 64)

        def smem(stages):
            return 1024 + 2 * (bq * dp + 2 * stages * bk * dp) + 8 * (1 + 4 * stages)

        stages = 3 if smem(3) <= SMEM_LIMIT else 2
        return TilePlan("wgmma+tma", dp, bq, bk, stages, 3 * 128, smem(stages), width)
    ld_qk, ld_v = D + (8 if D % 16 == 0 else 16), D + 4
    bq, bk, stages = 64, 32, 2
    smem = 4 * (bq * ld_qk + stages * bk * (ld_qk + ld_v))
    width = next(w for w in TF32_WIDTHS if w >= D)
    return TilePlan("mma.sync+3xtf32", ld_qk, bq, bk, stages, 128, smem, width)


def flash_attention_cuda(
    q: torch.Tensor,  # [B, Hq, Tq, D]
    k: torch.Tensor,  # [B, Hkv, Tk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention output [B, Hq, Tq, D] in q's dtype (f32 statistics)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    global launches
    dev = q.device
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D, got {q.dim()}, {k.dim()}, {v.dim()}")
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Tk, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k, v must have shape {(B, Hkv, Tk, D)}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != dev or x.dtype != q.dtype:
            raise ValueError(f"{name} must be a {q.dtype} tensor on {dev}, got "
                             f"{x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    plan = tile_plan(D, q.dtype)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % COPY_ALIGN:
            raise ValueError(f"{name} must start on a {COPY_ALIGN}-byte aligned address "
                             f"for the kernel's 16-byte copies")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    if Tk == 0:
        return o.zero_()
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cdll.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Hq, Hkv, Tq, Tk, D, float(scale), int(bool(causal)), DTYPE_CODES[q.dtype],
            *plan[1:], stream)
    lib.check(err, "flash_attention_launch")
    launches += 1
    note_launch("flash_attention")
    return o
