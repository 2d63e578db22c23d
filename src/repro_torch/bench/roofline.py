"""Roofline bounds of the serving and training cells, from the dry run's
records (the port of ``benchmarks/roofline.py``).

Three terms per (arch x shape x mesh) cell, each in seconds a step a
device, on one NVIDIA H100 SXM a rank:

  compute    = FLOPs a device / PEAK_FLOPS     (989e12: dense bf16 tensor cores)
  memory     = HBM bytes a device / HBM_BW     (3.35e12 B/s: HBM3)
  collective = collective bytes a device / LINK_BW
                                               (450e9 B/s: NVLink 4, one direction)

The figures are NVIDIA's H100 SXM data sheet's: 989 TFLOP/s dense bf16,
3.35 TB/s of HBM3, and NVLink 4 at 900 GB/s a GPU (18 links of 50 GB/s,
both directions together), of which a collective's received bytes arrive
at 450 GB/s, one direction.

The closed-form FLOP and HBM-byte models (:func:`forward_flops_per_token`,
:func:`cell_flops`, :func:`cell_hbm_bytes`) are the JAX package's, over the
port's registry, and equal its values on every cell
(``tests/test_torch_roofline.py``).  Where the JAX package reads XLA's
per-device cost analysis and walks the archived HLO for loop-scaled
collective bytes, the port reads its own dry run's records
(``build/repro_torch/dryrun/*.json``, :mod:`repro_torch.launch.dryrun`):
its per-device FLOPs and collective bytes are counted op by op on the meta
device, every loop iteration included, so no HLO walker is needed.  The
compute term reads the record's per-device FLOPs (the port's own program,
remat and recompute included) and keeps the closed form beside it
(``t_compute_analytic_s``).

    PYTHONPATH=src python -m repro_torch.bench.roofline [--mesh 16x16] [--cell arch:shape]
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List, Optional

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES_BY_NAME, ModelConfig, ShapeConfig
from repro_torch.kernels._build import BUILD_DIR

CACHE = BUILD_DIR / "dryrun"

PEAK_FLOPS = 989e12   # dense bf16 FLOP/s of one H100 SXM
HBM_BW = 3.35e12      # B/s of its HBM3
LINK_BW = 450e9       # B/s into one H100 over NVLink 4 (900 GB/s both directions)


# ---------------------------------------------------------------------------
# Analytic FLOPs / bytes models.
# ---------------------------------------------------------------------------

def _attn_layer_flops_per_tok(cfg: ModelConfig, ctx: float) -> float:
    proj = 2 * cfg.d_model * (2 * cfg.q_dim + 2 * cfg.kv_dim)
    attn = 4 * ctx * cfg.head_dim * cfg.num_heads
    return proj + attn


def _ffn_flops_per_tok(cfg: ModelConfig) -> float:
    mult = 3 if cfg.activation.endswith("_glu") else 2
    if cfg.moe is not None:
        return (2 * cfg.d_model * cfg.moe.num_experts
                + 2 * cfg.d_model * cfg.moe.d_ff_expert * 3 * cfg.moe.top_k)
    return 2 * cfg.d_model * cfg.d_ff * mult


def _mamba_flops_per_tok(cfg: ModelConfig) -> float:
    from repro_torch.models.mamba2 import dims

    d_inner, H, Pd, N = dims(cfg)
    conv_dim = d_inner + 2 * N
    return (2 * cfg.d_model * (2 * d_inner + 2 * N + H)
            + 2 * conv_dim * cfg.ssm_conv_width
            + 6 * N * d_inner
            + 2 * d_inner * cfg.d_model)


def _rwkv_flops_per_tok(cfg: ModelConfig) -> float:
    D, F, N = cfg.d_model, cfg.d_ff, cfg.ssm_headdim
    tm = 2 * D * D * 5 + 2 * D * 64 * 2 + 5 * N * D
    cm = 2 * D * F * 2 + 2 * D * D
    return tm + cm


def forward_flops_per_token(cfg: ModelConfig, ctx: float) -> float:
    """Per-token forward FLOPs at average attention context ``ctx``."""
    head = 2 * cfg.d_model * cfg.vocab
    if cfg.family in ("dense", "moe", "vlm"):
        return cfg.num_layers * (_attn_layer_flops_per_tok(cfg, ctx)
                                 + _ffn_flops_per_tok(cfg)) + head
    if cfg.family == "ssm":
        return cfg.num_layers * _rwkv_flops_per_tok(cfg) + head
    if cfg.family == "hybrid":
        from repro_torch.models.zamba2 import group_dims

        G, per = group_dims(cfg)
        shared = G * (_attn_layer_flops_per_tok(cfg, ctx) + 2 * cfg.d_model * cfg.d_ff * 3)
        return cfg.num_layers * _mamba_flops_per_tok(cfg) + shared + head
    if cfg.family == "encdec":
        # Per decoder token; the encoder is accounted separately by callers.
        self_a = _attn_layer_flops_per_tok(cfg, ctx)
        cross = 2 * cfg.d_model * 2 * cfg.q_dim  # q + o proj; scores added by caller
        return cfg.num_layers * (self_a + cross + _ffn_flops_per_tok(cfg)) + head
    raise ValueError(cfg.family)


def cell_flops(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, float]:
    """{model (3x fwd, no remat), compiled (4x fwd with remat), fwd}: total
    FLOPs a step (global)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            s_enc = s_dec = S // 2
            enc_tok = _attn_layer_flops_per_tok(cfg, s_enc) + _ffn_flops_per_tok(cfg)
            fwd = B * s_enc * cfg.encoder_layers * enc_tok
            fwd += B * s_dec * forward_flops_per_token(cfg, s_dec / 2)
            fwd += B * s_dec * cfg.num_layers * 4 * s_enc * cfg.head_dim * cfg.num_heads
            fwd += B * s_enc * cfg.num_layers * 2 * cfg.d_model * 2 * cfg.kv_dim  # cross KV
        else:
            fwd = B * S * forward_flops_per_token(cfg, S / 2)
        mult = {"train": (3.0, 4.0), "prefill": (1.0, 1.0)}[shape.kind]
        return {"fwd": fwd, "model": mult[0] * fwd, "compiled": mult[1] * fwd}
    # decode: one token a sequence, full-context attention reads.
    f = B * forward_flops_per_token(cfg, S)
    if cfg.family == "encdec":
        f += B * cfg.num_layers * 4 * 1500 * cfg.head_dim * cfg.num_heads
    return {"fwd": f, "model": f, "compiled": f}


def cell_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                   param_count: int) -> float:
    """Per-device HBM bytes a step (the JAX package's analytic model)."""
    B, S = shape.global_batch, shape.seq_len
    p_bytes = param_count * 2  # bf16 compute copies
    if shape.kind == "train":
        # FSDP: full weights stream through each device 3x (fwd, remat, bwd)
        # + grads (2B) + fp32 m/v/param opt update sharded 1/chips.
        w = 3 * p_bytes + 2 * param_count
        opt = 16 * param_count / chips
        act = cfg.num_layers * (B * S // max(chips // 16, 1)) * cfg.d_model * 2 * 8 / 16
        return w + opt + act
    if shape.kind == "prefill":
        w = p_bytes
        act = cfg.num_layers * (B * S / max(chips, 1)) * cfg.d_model * 2 * 8
        return w + act
    # decode: TP-sharded weights read once + KV pool sweep.
    w = p_bytes / 16
    page = cfg.kv_page_size
    pages = -(-S // page)
    if cfg.family == "ssm":
        from repro_torch.models.rwkv6 import _heads

        H, N = _heads(cfg)
        state = cfg.num_layers * B * H * N * N * 4
        return w + 2 * state / chips
    n_att_layers = (cfg.num_layers if cfg.family != "hybrid"
                    else cfg.num_layers // max(cfg.hybrid_period, 1))
    pool = n_att_layers * B * pages * page * cfg.kv_dim * 2 * 2
    return w + pool / chips


# ---------------------------------------------------------------------------
# The dry run's records.
# ---------------------------------------------------------------------------

def load_cells(cache: pathlib.Path = CACHE) -> List[dict]:
    """Every record under ``cache`` (the dry run's ``--out``)."""
    return [json.loads(p.read_text()) for p in sorted(pathlib.Path(cache).glob("*.json"))]


def analyse_cell(rec: dict) -> Optional[dict]:
    """The three terms of one ``ok`` record, its dominant term and the
    compute term's share of the bound (None for a failed cell).  A record
    of a config cut to fewer layers (``num_layers``) is modelled at that
    depth."""
    if not rec.get("ok"):
        return None
    cfg = registry.get_config(rec["arch"])
    cut = rec.get("num_layers") not in (None, cfg.num_layers)
    if cut:
        import dataclasses

        cfg = dataclasses.replace(cfg, num_layers=rec["num_layers"])
    shape = SHAPES_BY_NAME[rec["shape"]]
    chips = rec["chips"]
    fl = cell_flops(cfg, shape)
    coll = float(sum(rec.get("collective_bytes", {}).values()))
    hbm = cell_hbm_bytes(cfg, shape, chips, rec.get("param_count", cfg.param_count()))
    traced = float(rec.get("flops", 0.0)) if rec.get("flops_scope") == "device" else 0.0
    t_analytic = fl["compiled"] / chips / PEAK_FLOPS
    t_compute = traced / PEAK_FLOPS if traced > 0 else t_analytic
    terms = {"compute": t_compute, "memory": hbm / HBM_BW, "collective": coll / LINK_BW}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"], "chips": chips,
        "num_layers": cfg.num_layers, "cut": cut,
        "t_compute_s": t_compute, "t_memory_s": terms["memory"],
        "t_collective_s": terms["collective"], "dominant": dominant,
        "roofline_fraction": t_compute / bound if bound > 0 else 0.0,
        "t_compute_analytic_s": t_analytic,
        "model_flops": fl["model"], "compiled_flops_est": fl["compiled"],
        "useful_ratio": fl["model"] / fl["compiled"],
        "flops_per_dev_traced": traced,
        "collective_bytes_per_dev": coll,
        "hbm_bytes_per_dev": hbm,
    }


def table(mesh: str = "16x16", cache: pathlib.Path = CACHE) -> List[dict]:
    """:func:`analyse_cell` of every ``ok`` record on ``mesh``."""
    rows = []
    for rec in load_cells(cache):
        if rec.get("mesh") != mesh:
            continue
        r = analyse_cell(rec)
        if r:
            rows.append(r)
    return rows


TABLE_HEADER = ("arch", "shape", "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                "roofline_fraction")


def print_table(rows: List[dict]) -> None:
    """The table as CSV on stdout, one row a cell (a cut cell's arch as
    ``arch:L<layers>``)."""
    print(",".join(TABLE_HEADER))
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"], x["num_layers"])):
        arch = f"{r['arch']}:L{r['num_layers']}" if r["cut"] else r["arch"]
        print(f"{arch},{r['shape']},{r['t_compute_s']:.4g},{r['t_memory_s']:.4g},"
              f"{r['t_collective_s']:.4g},{r['dominant']},{r['roofline_fraction']:.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--cache", type=pathlib.Path, default=CACHE,
                    help="the dry run's --out directory")
    ap.add_argument("--cell", default=None, help="arch:shape: that cell's whole analysis")
    args = ap.parse_args(argv)
    if args.cell:
        arch, shape = args.cell.split(":")
        rec = json.loads((args.cache / f"{arch}__{shape}__{args.mesh}.json").read_text())
        print(json.dumps(analyse_cell(rec), indent=1, default=float))
        return 0
    print_table(table(args.mesh, args.cache))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
