"""Architecture registry and per-(arch, shape) input specs, the port of
``src/repro/configs/registry.py``.

``input_specs`` returns tensors on the ``meta`` device (shapes and dtypes,
nothing allocated), the counterpart of the JAX package's
``jax.ShapeDtypeStruct`` stand-ins:

* train/prefill shapes -> the inputs of the family's ``forward``;
* decode/long_decode  -> the inputs of
  :func:`repro_torch.serve.serve_step.make_serve_step`: one new token per
  sequence plus the SPARTA-paged KV pools.

KV pool layout (global view): ``[L, B, P, pages_local, page, Hkv, hd]``,
``P`` the number of SPARTA partitions and ``pages_local`` the per-partition
page region of one sequence.  Block tables are ``[B, P, pages_local]``
int32 *local* slot ids (the co-located per-partition page tables).
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, cell_applicable

ARCH_IDS: Tuple[str, ...] = (
    "stablelm-12b",
    "qwen3-14b",
    "starcoder2-7b",
    "gemma-7b",
    "rwkv6-1.6b",
    "internvl2-2b",
    "qwen3-moe-30b-a3b",
    "dbrx-132b",
    "zamba2-7b",
    "whisper-medium",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; options: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()


def all_cells():
    """Yield every applicable (arch_id, ShapeConfig) cell (40 total minus
    the documented long_500k skips)."""
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES:
            ok, _ = cell_applicable(cfg, s)
            if ok:
                yield a, s


# ---------------------------------------------------------------------------
# Input specs.
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device="meta")


def pool_geometry(cfg: ModelConfig, shape: ShapeConfig, num_partitions: int):
    """(page, pages a sequence, pages a sequence holds in one partition)."""
    page = cfg.kv_page_size
    pages_per_seq = -(-shape.seq_len // page)
    pages_local = -(-pages_per_seq // num_partitions)
    return page, pages_per_seq, pages_local


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                num_partitions: int = 16) -> Dict[str, torch.Tensor]:
    """Meta-device tensors for the step function of this (arch, shape) cell:
    the JAX package's shapes and dtypes (bf16 pools and cross-KV for a bf16
    config)."""
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape.name}: {why}")
    B, S = shape.global_batch, shape.seq_len
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    i32, f32 = torch.int32, torch.float32

    if not shape.lowers_serve_step:
        if cfg.family == "vlm":
            i = cfg.num_image_tokens
            return {"patch_embeds": _spec((B, i, cfg.d_model), dt),
                    "tokens": _spec((B, S - i), i32)}
        if cfg.family == "encdec":
            return {"frames": _spec((B, S // 2, cfg.d_model), dt),
                    "tokens": _spec((B, S // 2), i32)}
        return {"tokens": _spec((B, S), i32)}

    # ---- serve_step inputs -------------------------------------------------
    P = num_partitions
    page, _, pages_local = pool_geometry(cfg, shape, P)
    specs = {"tokens": _spec((B,), i32), "ctx_len": _spec((B,), i32)}
    if cfg.family == "ssm":  # rwkv6: O(1) recurrent state, no paged KV
        N = cfg.ssm_headdim
        H = cfg.d_model // N
        L, D = cfg.num_layers, cfg.d_model
        specs.update({"tm_shift": _spec((L, B, D), f32), "cm_shift": _spec((L, B, D), f32),
                      "wkv": _spec((L, B, H, N, N), f32)})
        return specs

    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    tables = _spec((B, P, pages_local), i32)
    if cfg.family == "hybrid":
        from repro_torch.models.mamba2 import dims as m2dims
        from repro_torch.models.zamba2 import group_dims
        G, per = group_dims(cfg)
        d_inner, H, Pdim, N = m2dims(cfg)
        pools = (G, B, P, pages_local, page, Hkv, hd)
        specs.update({
            "k_pools": _spec(pools, dt), "v_pools": _spec(pools, dt), "tables": tables,
            "conv_state": _spec((G, per, B, cfg.ssm_conv_width - 1, d_inner + 2 * N), f32),
            "ssm_state": _spec((G, per, B, H, N, Pdim), f32),
        })
        return specs

    L = cfg.num_layers
    pools = (L, B, P, pages_local, page, Hkv, hd)
    specs.update({"k_pools": _spec(pools, dt), "v_pools": _spec(pools, dt), "tables": tables})
    if cfg.family == "encdec":
        s_enc = 1500  # whisper's fixed 30 s encoder grid
        specs["cross_k"] = _spec((L, B, s_enc, Hkv, hd), dt)
        specs["cross_v"] = _spec((L, B, s_enc, Hkv, hd), dt)
    return specs


def abstract_params(cfg: ModelConfig):
    """The family's parameter module on the meta device: every name, shape
    and dtype, nothing allocated."""
    from repro_torch import models
    return models.init(cfg, device="meta")
