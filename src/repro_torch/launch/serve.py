"""Serving launcher: the SPARTA paged engine on a smoke config, on the card
unless ``--device cpu``; it serves the decoder-only families (dense, moe,
and vlm's backbone on text).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
      --requests 8 --max-new 16 [--device cpu]

The arguments and defaults are those of the JAX launcher
(``src/repro/launch/serve.py``): the arch's smoke config in float32 with
8-token KV pages, random weights from seed 0, prompts of 4-15 tokens from a
numpy generator seeded 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import registry
from repro_torch.kernels.common import as_device
from repro_torch.serve.engine import SpartaEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = as_device(args.device)
    cfg = dataclasses.replace(registry.get_smoke(args.arch), dtype="float32", kv_page_size=8)
    if cfg.family not in ("dense", "moe", "vlm"):
        raise SystemExit(f"the engine serves decoder-only archs, not {cfg.family}")
    params = models.init(cfg, seed=0, device=dev)
    eng = SpartaEngine(cfg, params, num_partitions=args.partitions,
                       slots_per_partition=128, max_batch=args.max_batch, device=dev)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(list(rng.integers(0, cfg.vocab, rng.integers(4, 16))),
                   max_new_tokens=args.max_new)
    t0 = time.perf_counter()
    eng.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in eng.finished.values())
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"{len(eng.finished)} requests, {toks} tokens, {dt:.1f}s "
          f"({toks / dt:.1f} tok/s on {where})")
    eng.kv.check_invariants()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
