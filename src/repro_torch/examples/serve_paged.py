"""End-to-end serving driver: SPARTA-paged KV cache with batched requests,
the port of the JAX package's ``examples/serve_paged.py``.

Continuous batching, demand page allocation, prefix sharing (fork) with
copy-on-write — the paper's VM machinery running an LM server.  On the card
the prefills run the float32 path of the ``flash_attention`` kernel and the
decode steps the ``paged_attention`` kernel.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_paged [--device cpu]

The model is the JAX example's: stablelm-12b's smoke config reshaped to 4
layers of width 128 (8 query heads, 4 KV heads of 16), float32, 8-token
pages; random weights from seed 0 (``models.init``), or the ``params`` a
caller passes (a module on the same device, e.g. the JAX package's initial
parameters carried across by ``convert.params_from_numpy``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import models
from repro_torch.configs import registry
from repro_torch.kernels.common import as_device
from repro_torch.serve.engine import SpartaEngine

PARTITIONS = 4


def config():
    """The example's model config (the JAX example's reshaped smoke config)."""
    return dataclasses.replace(
        registry.get_smoke("stablelm-12b"), dtype="float32", kv_page_size=8, num_layers=4,
        d_model=128, num_heads=8, num_kv_heads=4, head_dim=16, d_ff=256)


def main(argv=None, *, params=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = as_device(args.device)
    lines = []

    def say(text: str) -> None:
        print(text)
        lines.append(text)

    cfg = config()
    if params is None:
        params = models.init(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    say(f"model: {n_params:,} params; page={cfg.kv_page_size} tokens")

    eng = SpartaEngine(cfg, params, num_partitions=PARTITIONS, slots_per_partition=64,
                       max_batch=4, device=dev)
    rng = np.random.default_rng(0)
    rids = [eng.submit(list(rng.integers(0, cfg.vocab, rng.integers(4, 12))),
                       max_new_tokens=12) for _ in range(8)]
    t0 = time.time()
    steps = 0
    while eng.step() or eng.waiting:
        steps += 1
    dt = time.time() - t0
    done = len(eng.finished)
    toks = sum(len(r.generated) for r in eng.finished.values())
    say(f"served {done} requests / {toks} tokens in {steps} engine steps ({dt:.1f}s)")
    free = [int(eng.kv.num_free(p)) for p in range(PARTITIONS)]
    say(f"free pages per partition: {free}")

    # Prefix sharing: branch the first finished request 3 ways (zero-copy
    # fork, CoW only on the shared tail page).
    free_before = sum(free)
    branches = [eng.fork_request(rids[0], max_new_tokens=6) for _ in range(3)]
    fork_pages = free_before - sum(int(eng.kv.num_free(p)) for p in range(PARTITIONS))
    say(f"forked 3 branches: pages allocated by fork = {fork_pages} (expect 0)")
    eng.run_to_completion()
    for b in branches:
        say(f"  branch {b}: +{len(eng.finished[b].generated)} tokens")
    eng.kv.check_invariants()
    say("invariants OK")
    return {"params": n_params, "page": cfg.kv_page_size, "requests": done, "tokens": toks,
            "steps": steps, "seconds": dt, "free_pages": free, "fork_pages": fork_pages,
            "branches": {b: len(eng.finished[b].generated) for b in branches},
            "generated": {rid: list(r.generated) for rid, r in eng.finished.items()},
            "invariants": True, "lines": lines}


if __name__ == "__main__":
    main()
