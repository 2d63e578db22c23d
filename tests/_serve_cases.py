"""Shared cases of the partition-explicit serve step
(:func:`repro_torch.serve.serve_step.make_serve_step`): ``input_specs``'
inputs filled from a seeded generator, a prefix written through
``write_kv_global``, and the same state in the single-partition layout that
each family's own decode path reads (``transformer.decode_step``,
``zamba2.decode_step``, ``rwkv6.decode_step``, ``whisper.decode_step``).
Used by tests/test_torch_serve_step.py on the CPU and by chip_smoke.py on
the card.

Global view: pools ``[L, B, P, pages_local, page, Hkv, hd]`` and tables
``[B, P, pages_local]`` of local slots; logical page ``l`` of a sequence
lives on partition ``l % P`` at local page ``l // P``.  Single partition:
pools ``[L, B * P * pages_local, page, Hkv, hd]`` (float32, the paged
attention kernel's pools) and a table ``[B, P * pages_local]`` whose entry
``l`` is the global slot ``(b * P + l % P) * pages_local + local slot``.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models import rwkv6, whisper, zamba2
from repro_torch.models import transformer as tfm
from repro_torch.models.paged_global import write_kv_global

SSM_STATE = ("tm_shift", "cm_shift", "wkv")
HYBRID_STATE = ("conv_state", "ssm_state")


def random_inputs(cfg, specs: Dict[str, torch.Tensor], ctx_len: torch.Tensor,
                  normal: Callable, integers: Callable) -> Dict[str, torch.Tensor]:
    """``specs`` (``input_specs``' meta tensors) filled: ``tokens`` below the
    vocab, ``ctx_len`` as given, each (sequence, partition)'s table a
    permutation of its local slots, every other input (pools, cross KV,
    recurrent states) standard normal in its spec's dtype.  ``normal(shape)``
    gives float32 normals and ``integers(high, shape)`` int32 below
    ``high``, both on the target device."""
    out = {}
    for name, spec in specs.items():
        if name == "tokens":
            out[name] = integers(cfg.vocab, tuple(spec.shape))
        elif name == "ctx_len":
            out[name] = ctx_len
        elif name == "tables":
            out[name] = torch.argsort(normal(tuple(spec.shape)), dim=-1).to(torch.int32)
        else:
            out[name] = normal(tuple(spec.shape)).to(spec.dtype)
    return out


def write_prefix(pools: torch.Tensor, tables: torch.Tensor, kv: torch.Tensor,
                 ctx0: torch.Tensor, page: int) -> None:
    """Write each sequence's first ``ctx0[b]`` rows ``kv[:, b, :ctx0[b]]``
    ([L, B, T, Hkv, hd]) into the global-view ``pools`` through
    ``write_kv_global``, one call a position with the L x B (layer,
    sequence) rows as its batch; a sequence past its length writes its own
    last row again."""
    L, B = pools.shape[:2]
    flat = pools.view(L * B, *pools.shape[2:])
    tab = tables.repeat(L, 1, 1)
    rows = torch.arange(L * B, device=pools.device)
    last = (ctx0.long() - 1).repeat(L)
    kv = kv.reshape(L * B, *kv.shape[2:])
    for t in range(int(ctx0.max())):
        pos = torch.clamp_max(torch.full_like(last, t), last)
        write_kv_global(flat, tab, kv[rows, pos], (pos + 1).to(torch.int32), page)


def single_partition(inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The global-view pools and tables of ``inputs`` in the single-partition
    layout: float32 copies of the pools and the table of global slots."""
    k = inputs["k_pools"]
    L, B, P, pl = k.shape[:4]
    tables = inputs["tables"].long()
    l = torch.arange(P * pl, device=k.device)
    part, local = l % P, l // P
    b = torch.arange(B, device=k.device)[:, None]
    slot = tables[b, part[None], local[None]]
    table = torch.where(slot >= 0, (b * P + part[None]) * pl + slot, -1).to(torch.int32)
    flat = (L, B * P * pl) + tuple(k.shape[4:])
    return {"k_pools": k.reshape(flat).to(torch.float32, copy=True),
            "v_pools": inputs["v_pools"].reshape(flat).to(torch.float32, copy=True),
            "table": table}


def decode_single(cfg, params, sp: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
                  *, kernel_mode: str):
    """One step of the family's single-partition decode path over ``sp``
    (updated in place) with the tokens, contexts, cross KV and recurrent
    state of ``inputs``: (logits [B, V], the new recurrent state as the
    serve step names it, empty for the attention-only families)."""
    tok, ctx = inputs["tokens"], inputs["ctx_len"]
    if cfg.family == "ssm":
        return rwkv6.decode_step(params, tok, cfg, {k: inputs[k] for k in SSM_STATE},
                                 kernel_mode=kernel_mode)
    if cfg.family == "hybrid":
        state = {"conv": inputs["conv_state"], "ssm": inputs["ssm_state"]}
        logits, new, _, _ = zamba2.decode_step(params, tok, cfg, state, sp["k_pools"],
                                               sp["v_pools"], sp["table"], ctx,
                                               kernel_mode=kernel_mode)
        return logits, {"conv_state": new["conv"], "ssm_state": new["ssm"]}
    if cfg.family == "encdec":
        logits = whisper.decode_step(params, tok, cfg, sp["k_pools"], sp["v_pools"],
                                     inputs["cross_k"], inputs["cross_v"], sp["table"], ctx,
                                     kernel_mode=kernel_mode)[0]
        return logits, {}
    logits = tfm.decode_step(params, tok, cfg, sp["k_pools"], sp["v_pools"], sp["table"], ctx,
                             kernel_mode=kernel_mode)[0]
    return logits, {}


def recurrent_state(cfg) -> tuple:
    """The names of the serve step's recurrent state inputs."""
    return {"ssm": SSM_STATE, "hybrid": HYBRID_STATE}.get(cfg.family, ())
