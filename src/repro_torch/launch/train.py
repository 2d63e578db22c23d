"""Training launcher, the port of ``src/repro/launch/train.py``: one
device, or with ``--mesh`` a sharded run over a ``("data", "model")`` mesh
of ``torch.distributed`` ranks; on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b --smoke \\
      --steps 50 [--device cpu]
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch qwen3-14b --smoke --steps 50 \\
      --mesh 2x2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-2b --smoke \\
      --steps 3 --mesh 1x1

``--mesh 2x4`` builds the mesh ``("data", "model")[:len(shape)]`` over the
world's ranks (torchrun's, or a one-rank world started here), places the
parameters and the optimizer state by ``param_specs`` / ``opt_state_specs``
and each step's batch by ``batch_specs``
(:mod:`repro_torch.distributed.sharding`).  Every rank builds the same
global batch; only rank 0 prints and writes checkpoints (every rank joins
the gather).  NCCL on the card gives each rank its own card, so one H100
runs ``--mesh 1x1``; wider meshes run under gloo with ``--device cpu``.

The options, the optimizer's wiring (warm-up over a twentieth of the steps,
a cosine to ``--steps``), the checkpoint cadence (every fifth of the run),
the data (``batch_for_model``'s seeded stream) and the printed lines are
the JAX launcher's, except that ``--ckpt`` defaults to
``build/repro_torch/cache/train_ckpt`` in the checkout; the weights are
random from seed 0.  SIGTERM / SIGINT checkpoint and stop at the next step
boundary.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import models
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, batch_for_model
from repro_torch.distributed import sharding as shd
from repro_torch.kernels._build import BUILD_DIR
from repro_torch.kernels.common import as_device
from repro_torch.launch.mesh import destroy, make_mesh
from repro_torch.runtime.fault_tolerance import (
    HeartbeatTracker, LoopConfig, PreemptionHandler, run_training_loop,
)
from repro_torch.train.optimizer import OptimizerConfig, init_state
from repro_torch.train.train_step import make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="", help="e.g. 2x4 (data x model); default single device")
    ap.add_argument("--ckpt", default=str(BUILD_DIR / "cache" / "train_ckpt"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = as_device(args.device)
    cfg = registry.get_smoke(args.arch) if args.smoke else registry.get_config(args.arch)
    mesh, started = None, False
    if args.mesh:
        started = not torch.distributed.is_initialized()
        shape = tuple(int(x) for x in args.mesh.split("x"))
        mesh = make_mesh(shape, ("data", "model")[: len(shape)], device=dev)
        dev = torch.device(dev.type, torch.cuda.current_device()) if dev.type == "cuda" else dev
    params = models.init(cfg, seed=0, device=dev)
    opt = init_state(params)
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                              total_steps=args.steps)
    step = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
    if mesh is not None:
        shd.shard_params(params, cfg, mesh)
        opt = shd.shard_opt_state(opt, cfg, mesh)
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.global_batch)

    def batch_fn(i):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_for_model(data, cfg, i).items()}
        return batch if mesh is None else shd.shard_batch(batch, cfg, mesh)

    lead = mesh is None or torch.distributed.get_rank() == 0
    preemption = PreemptionHandler()
    try:
        _, stopped = run_training_loop(
            step, (params, opt), batch_fn, args.ckpt,
            LoopConfig(total_steps=args.steps, checkpoint_every=max(args.steps // 5, 1)),
            tracker=HeartbeatTracker(), preemption=preemption,
            on_metrics=lambda s, m: lead and (s % 10 == 0) and print(
                f"step {s}: loss {float(m['loss']):.4f} lr {float(m['lr']):.2e}"),
        )
    finally:
        preemption.uninstall()
        if started:
            destroy()
    if lead:
        print(f"done at step {stopped}; checkpoints in {args.ckpt}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
