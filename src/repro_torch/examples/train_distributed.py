"""Distributed training driver: FSDP+TP mesh, fault-tolerant loop, elastic
restart; the port of the JAX package's ``examples/train_distributed.py``.

On the CPU the mesh is 2 x 4 ``("data", "model")`` over 8 gloo ranks, which
the example starts itself (a process a rank, joined through a ``FileStore``
beside the checkpoint directory; no network port).  On the card it is 1 x 1:
NCCL gives each rank its own card, and one H100 holds one rank.  The smoke
config of ``--arch`` is placed by ``param_specs`` / ``opt_state_specs``,
trained by ``make_train_step`` under ``run_training_loop`` (a checkpoint
every ``--checkpoint-every`` steps), and the last checkpoint is restored by
``elastic_restore`` onto a smaller mesh: on the CPU three of the 8 ranks are
taken as dead, which leaves a 1 x 4 mesh and one spare; on the card the
one-card plan, 1 x 1.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_distributed [--steps 60] [--device cpu]

The weights are random from seed 0 (``models.init``), or those of
``main(init_dir=...)``: a checkpoint directory whose latest step holds
``{"params": ...}`` (e.g. the JAX package's initial parameters saved by
``checkpoint.save``).  The checkpoints go under
``build/repro_torch/cache/examples_train_ckpt``, emptied first, unless
``--ckpt`` names another directory: that one must be missing, empty, or one
this example wrote before (it holds the example's mark file), and is then
emptied; any other directory is left alone and the example refuses to start.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys

import torch

from repro_torch import models
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, batch_for_model
from repro_torch.distributed import sharding as shd
from repro_torch.kernels._build import BUILD_DIR
from repro_torch.kernels.common import as_device
from repro_torch.launch.mesh import destroy, make_mesh
from repro_torch.runtime import elastic
from repro_torch.runtime.fault_tolerance import (
    HeartbeatTracker, LoopConfig, PreemptionHandler, run_training_loop,
)
from repro_torch.train.optimizer import OptimizerConfig, init_state
from repro_torch.train.train_step import make_train_step

CPU_MESH = (2, 4)
CPU_SURVIVORS = 5          # 3 of the 8 ranks taken as dead: 1 x 4 and a spare
DEFAULT_CKPT = BUILD_DIR / "cache" / "examples_train_ckpt"
MARK = ".repro_torch_train_distributed"   # names a checkpoint directory this example wrote


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _state(params, opt) -> dict:
    """Every leaf of (params, opt) whole on the CPU (a gather every rank
    joins), keyed by name."""
    host = lambda t: shd.whole(t).detach().cpu().clone()
    out = {f"params/{n}": host(p) for n, p in params.named_parameters()}
    for k in ("m", "v"):
        out.update({f"{k}/{n}": host(t) for n, t in opt[k].items()})
    out["step"] = host(opt["step"])
    return out


def _fresh_ckpt(root: pathlib.Path) -> None:
    """Empty the checkpoint directory and mark it as this example's: the
    default one whatever it holds; a directory the caller named only when
    it is missing, empty or marked, else ``FileExistsError`` and nothing is
    touched."""
    if root.resolve() != DEFAULT_CKPT.resolve() and root.exists() \
            and any(root.iterdir()) and not (root / MARK).exists():
        raise FileExistsError(f"--ckpt {root} holds files this example did not write; "
                              "name a missing or empty directory")
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    (root / MARK).touch()


def _run(args, dev: torch.device, rank: int, store_dir=None, init_dir=None) -> dict:
    """Train on the mesh, then the elastic restart; rank 0 prints and returns
    the numbers (other ranks return ``{}``)."""
    import torch.distributed as dist

    lines = []

    def say(text: str) -> None:
        if rank == 0:
            print(text, flush=True)
            lines.append(text)

    cfg = registry.get_smoke(args.arch)
    shape = CPU_MESH if dev.type == "cpu" else (1, 1)
    mesh = make_mesh(shape, ("data", "model"), device=dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    say(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}; arch family={cfg.family}")

    params = models.init(cfg, seed=0, device=dev)
    if init_dir:
        from repro_torch.checkpoint import checkpoint as ckpt

        ckpt.restore(init_dir, template={"params": params})
    # Placed by param_specs / opt_state_specs, as the JAX example places them.
    opt = shd.shard_opt_state(init_state(params), cfg, mesh)
    shd.shard_params(params, cfg, mesh)
    step = make_train_step(cfg, OptimizerConfig(lr=3e-3, warmup_steps=5,
                                                total_steps=args.steps))
    data = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)

    def batch_fn(i):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_for_model(data, cfg, i).items()}
        return shd.shard_batch(batch, cfg, mesh)

    tracker = HeartbeatTracker()
    losses, grad_norms = [], []

    def on_metrics(s, m):
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))

    state, stopped = run_training_loop(
        step, (params, opt), batch_fn, args.ckpt,
        LoopConfig(total_steps=args.steps, checkpoint_every=args.checkpoint_every),
        tracker=tracker, preemption=PreemptionHandler(install=False), on_metrics=on_metrics)
    say(f"steps={stopped} loss {losses[0]:.3f} -> {losses[-1]:.3f} "
        f"(mean step {tracker.hosts[0].ewma:.2f}s)")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss must decrease: {losses[0]} -> {losses[-1]}")
    trained = _state(*state)
    del state, params, opt

    # Elastic restart onto the ranks left: on the CPU 3 of 8 are taken as
    # dead (5 left: 1 x 4 and a spare), on the card the one-card plan.
    if dev.type == "cpu":
        plan = elastic.plan_remesh(available_devices=CPU_SURVIVORS, model_axis=CPU_MESH[1])
        destroy()
        if rank >= plan.size:
            return {}
        dist.init_process_group("gloo", store=dist.FileStore(
            str(store_dir / "elastic.store"), plan.size), rank=rank, world_size=plan.size)
    else:
        plan = elastic.plan_remesh(available_devices=1, model_axis=1)
    template = models.init(cfg, seed=0, device=dev)
    tree, step_no, _ = elastic.elastic_restore(
        args.ckpt, cfg, plan, {"params": template, "opt_state": init_state(template)},
        device=dev)
    restored = _state(tree["params"], tree["opt_state"])
    say(f"elastic restart: restored step {step_no} onto mesh {plan.shape} "
        f"({plan.dropped_devices} spare devices)")
    last_ckpt = stopped - stopped % args.checkpoint_every
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "family": cfg.family,
            "steps": stopped, "losses": losses, "grad_norms": grad_norms,
            "mean_step_s": tracker.hosts[0].ewma, "restored_step": step_no,
            "last_checkpoint_step": last_ckpt, "plan_shape": list(plan.shape),
            "spare_devices": plan.dropped_devices,
            "restore_bit_identical": (step_no == stopped and restored.keys() == trained.keys()
                                      and all(torch.equal(restored[k], trained[k])
                                              for k in trained)),
            "lines": lines} if rank == 0 else {}


def _rank_entry(rank: int, argv, world: int, store_dir: str, init_dir) -> None:
    """One rank of the CPU world: join it through the ``FileStore``, run,
    and (rank 0) write the numbers for the parent."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    store_dir = pathlib.Path(store_dir)
    dist.init_process_group("gloo", store=dist.FileStore(str(store_dir / "train.store"), world),
                            rank=rank, world_size=world)
    try:
        out = _run(_parser().parse_args(argv), torch.device("cpu"), rank, store_dir,
                   init_dir)
    finally:
        destroy()
    if rank == 0:
        (store_dir / "result.json").write_text(json.dumps(out))


def main(argv=None, *, init_dir=None) -> dict:
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    dev = as_device(args.device)
    ckpt_dir = pathlib.Path(args.ckpt)
    if dev.type == "cpu" and dist.is_initialized():
        raise RuntimeError("on the CPU the example starts its own world of "
                           f"{CPU_MESH[0] * CPU_MESH[1]} ranks; call it with none running")
    _fresh_ckpt(ckpt_dir)
    if dev.type == "cuda":
        started = not dist.is_initialized()
        try:
            return _run(args, dev, 0, init_dir=init_dir)
        finally:
            if started:
                destroy()
    # A new directory for the world's store files: a stale one hangs the world.
    store_dir = pathlib.Path(tempfile.mkdtemp(prefix=f"{ckpt_dir.name}.world-",
                                              dir=ckpt_dir.parent))
    try:
        mp.start_processes(_rank_entry, args=(argv, CPU_MESH[0] * CPU_MESH[1],
                                              str(store_dir), init_dir),
                           nprocs=CPU_MESH[0] * CPU_MESH[1], join=True, start_method="spawn")
        return json.loads((store_dir / "result.json").read_text())
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
