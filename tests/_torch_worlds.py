"""Multi-rank ``torch.distributed`` worlds on the CPU (gloo) for the
distributed layer's tests, and the JAX package's sharded reference.

Each world is one process (``python tests/_torch_worlds.py <world> <dir>``)
that spawns its ranks with ``torch.multiprocessing`` (one thread each),
joined through a ``FileStore`` in ``<dir>`` (no network port).  Rank 0
writes the world's results to ``<dir>/<world>.pt``; the tests read them.
:func:`run_world` (:func:`start` and :func:`finish`) runs a world in a
session of its own under a time limit and kills every process of it when
the limit passes, so a hang fails a test instead of stopping the run.

* ``train`` (8 ranks): qwen3-14b's smoke config from the JAX package's
  initial parameters (``<dir>/init``), 3 steps single-device and 3 steps
  sharded on a 2x4 ``("data", "model")`` mesh, the step-2 state saved as a
  checkpoint (``<dir>/ckpt_2x4``); one step under an activation policy; then
  ``hierarchical_psum`` on a 2x2x2 ``("pod", "data", "model")`` mesh.
* ``elastic`` (4 ranks): that checkpoint restored on a 2x2 mesh through
  ``elastic_restore(plan_remesh(4, model_axis=2))`` and one more step,
  beside the single-device step from the same checkpoint; ``pipeline_apply``
  over 4 stages; then a one-rank world restoring the same checkpoint.
* ``serve`` (8 ranks): the JAX package's sharded serve test's 12 decode
  steps through ``make_serve_step``, single-device and sharded on 2x4 (one
  step's collectives traced), then zamba2's smoke config through the
  registry's decode and long-decode inputs (one sequence, partitions over
  both axes) on a 2x2 mesh of ranks 0-3; :data:`JAX_SERVE_REF`
  is that JAX test's body on an Auto-axis mesh.
* ``moe`` (4 ranks): qwen3-moe-30b-a3b's smoke config from the JAX
  package's initial parameters (``<dir>/moe_init``), 3 steps single-device
  and 3 sharded on 2x2 (one MoE block's forward and backward traced), then
  step 1 on a 1 x 1 mesh.
* ``vocab`` (8 ranks): the chunked cross-entropy on random inputs,
  single-device, on a 2x4 mesh with the head in train placements and on a
  1 x 1 mesh; then :data:`PREFILL_ARCHS`' prefill steps single-device and
  on 2x4 from the JAX package's initial parameters; :data:`JAX_VOCAB_REF`
  is the JAX package's sharded prefill on an Auto-axis mesh.
* :data:`JAX_REF`: the JAX package's sharded step, pipeline and reduction
  on meshes of Auto axes over 8 forced host devices (``jax.make_mesh``
  gives Explicit axes on jax 0.9.0, which the three tests of
  ``tests/test_distributed.py`` trip over).
"""
from __future__ import annotations

import os
import pathlib
import signal
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-14b"
SEQ, BATCH, STEPS, LR = 16, 4, 3, 1e-3
PIPE = dict(L=8, D=16, M=6, mb=4, S=4)
# The serve world: the JAX package's sharded serve test's cell
# (tests/test_distributed.py::test_serve_step_sharded_lowers_and_runs).
SERVE_ARCH, SERVE = "stablelm-12b", dict(B=4, T=12, page=4, P=4)
# zamba2 on 2x2: a decode batch (partitions over ``model``) and one long
# sequence (partitions over every axis), each with a written prefix.
HYBRID_ARCH, HYBRID_T, HYBRID_PAGE, HYBRID_STEPS = "zamba2-7b", 16, 4, 3
HYBRID = {"decode": dict(B=2, P=2, prefix=(9, 6)), "long_decode": dict(B=1, P=4, prefix=(11,))}
TRACED_STEP = 6                    # the serve step whose collectives are recorded
MOE_ARCH = "qwen3-moe-30b-a3b"
# The vocab world: the chunked loss on random float32 inputs (T not a
# multiple of the block, a vocabulary that model=4 splits unevenly), and the
# prefill step of a dense config whose 6 query heads (2 KV heads) split
# 2/2/2/0 over model=4, and of the MoE, RWKV6 and Zamba2 smoke configs.
VOCAB_LOSS = dict(B=4, T=13, D=8, V=250, block=4)
PREFILL_ARCHS = {"dense": ("qwen3-14b", {"num_heads": 6}), "moe": (MOE_ARCH, {}),
                 "ssm": ("rwkv6-1.6b", {}), "hybrid": ("zamba2-7b", {})}
PREFILL_B, PREFILL_T = 4, 16
SCAN_GRAD_KINDS = ("ssm", "hybrid")         # their loss and gradients, too
HYBRID_TRAIN_STEPS = 2                      # Zamba2's train steps on 2x4 and one device
WORLDS = {"train": 8, "elastic": 4, "serve": 8, "moe": 4, "vocab": 8}


def prefill_cfg(registry, kind: str):
    """The vocab world's prefill config of ``kind`` (either package's
    registry)."""
    import dataclasses

    arch, over = PREFILL_ARCHS[kind]
    return dataclasses.replace(registry.get_smoke(arch), **over)


def start(cmd, env=None) -> subprocess.Popen:
    """``cmd`` started in a session of its own."""
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)


def finish(proc: subprocess.Popen, timeout: float) -> subprocess.CompletedProcess:
    """Wait for ``proc``; on ``timeout`` every process of its session is
    killed and the result says so (returncode -9)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        err += f"\nkilled after {timeout} s"
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def run_world(cmd, timeout: float, env=None) -> subprocess.CompletedProcess:
    return finish(start(cmd, env), timeout)


def world_cmd(name: str, out_dir) -> list:
    return [sys.executable, str(pathlib.Path(__file__).resolve()), name, str(out_dir)]


def env() -> dict:
    e = dict(os.environ)
    e["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + e.get("PYTHONPATH", "")
    e["OMP_NUM_THREADS"] = "1"
    return e


# -- inside a world ------------------------------------------------------------

def _entry(rank: int, name: str, world: int, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out, f"{name}.store"),
                                                         world),
                            rank=rank, world_size=world)
    try:
        globals()[f"world_{name}"](rank, pathlib.Path(out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _cfg():
    from repro_torch.configs import registry

    return registry.get_smoke(ARCH)


def _batch(cfg, i: int) -> dict:
    import torch

    from repro_torch.data.pipeline import DataConfig, batch_for_model

    data = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    return {k: torch.from_numpy(v) for k, v in batch_for_model(data, cfg, i).items()}


def _initial(cfg, out: pathlib.Path):
    """The JAX package's initial parameters (``<out>/init``), as a plain
    module and optimizer state."""
    from repro_torch import models
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.train.optimizer import init_state

    params = models.init(cfg, seed=1, device="cpu")
    ckpt.restore(out / "init", template={"params": params})
    return params, init_state(params)


def _whole(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


def _params(params) -> dict:
    return {n: _whole(p) for n, p in params.named_parameters()}


def _step(cfg, taps: list):
    """``make_train_step`` whose ``compress_grads`` records each step's
    gradients, whole (a gather on every rank), and passes them on."""
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import make_train_step

    def tap(grads):
        taps.append({n: _whole(g) for n, g in grads.items()})
        return grads

    return make_train_step(cfg, OptimizerConfig(lr=LR, warmup_steps=1), compress_grads=tap)


def _metrics(m) -> dict:
    return {k: float(v) for k, v in m.items()}


def world_train(rank: int, out: pathlib.Path) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.distributed import collectives, sharding as shd
    from repro_torch.launch.mesh import make_mesh

    cfg = _cfg()
    res: dict = {}
    if rank == 0:   # the single-device port
        taps: list = []
        step = _step(cfg, taps)
        params, opt = _initial(cfg, out)
        res["single"] = {"metrics": [], "params": []}
        for i in range(STEPS):
            params, opt, m = step(params, opt, _batch(cfg, i))
            res["single"]["metrics"].append(_metrics(m))
            res["single"]["params"].append(_params(params))
        res["single"]["grads"] = taps
    dist.barrier()

    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    taps = []
    step = _step(cfg, taps)
    params, opt = _initial(cfg, out)
    shd.shard_params(params, cfg, mesh)
    opt = shd.shard_opt_state(opt, cfg, mesh)
    res["sharded"] = {"metrics": [], "params": [],
                      "placements": {n: str(tuple(p.placements))
                                     for n, p in params.named_parameters()}}
    for i in range(STEPS):
        params, opt, m = step(params, opt, shd.shard_batch(_batch(cfg, i), cfg, mesh))
        res["sharded"]["metrics"].append(_metrics(m))
        res["sharded"]["params"].append(_params(params))
        if i == 1:
            ckpt.save(out / "ckpt_2x4", 2, {"params": params, "opt_state": opt})
            res["saved"] = {"params": _params(params),
                            "m": {n: _whole(t) for n, t in opt["m"].items()},
                            "v": {n: _whole(t) for n, t in opt["v"].items()},
                            "step": _whole(opt["step"])}
    res["sharded"]["grads"] = taps

    # One step from the start under the activation policy: its values, and
    # the placements the constrained activations took.
    seen = set()
    real = shd._constrain

    def recording(x, spec):
        y = real(x, spec)
        seen.add((str(spec), str(tuple(y.placements))))
        return y

    shd._constrain = recording
    shd.set_activation_policy(dp="data", tp="model", tp_size=4)
    try:
        taps = []
        step = _step(cfg, taps)
        params, opt = _initial(cfg, out)
        shd.shard_params(params, cfg, mesh)
        opt = shd.shard_opt_state(opt, cfg, mesh)
        params, opt, m = step(params, opt, shd.shard_batch(_batch(cfg, 0), cfg, mesh))
    finally:
        shd.clear_activation_policy()
        shd._constrain = real
    res["policy"] = {"metrics": _metrics(m), "params": _params(params), "grads": taps[0],
                     "constrained": sorted(seen)}

    # The hierarchical reduction on 2x2x2, integer-valued float32 leaves
    # whose sizes do not divide the intra size.
    mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    shapes = {"a": (7, 3), "b": (5,), "nested": {"c": (2, 3, 3)}}

    def tree(seed):
        g = np.random.default_rng(seed)
        return {"a": torch.from_numpy(g.integers(-50, 50, (7, 3)).astype(np.float32)),
                "b": torch.from_numpy(g.integers(-50, 50, 5).astype(np.float32)),
                "nested": {"c": torch.from_numpy(g.integers(-50, 50, (2, 3, 3))
                                                 .astype(np.float32))}}

    mine = tree(100 + rank)
    hier = collectives.hierarchical_psum(mesh3)(mine)
    wide = collectives.hierarchical_psum(mesh3, intra_axes=("data", "model"))(mine)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    coords = mesh3.mesh.tolist()   # [pod][data][model] -> rank
    model_of = {coords[p][d][m]: m for p in range(2) for d in range(2) for m in range(2)}
    flat_group = None
    for m_ in range(2):
        ranks = [r for r, mm in sorted(model_of.items()) if mm == m_]
        g_ = dist.new_group(ranks=ranks)
        if model_of[rank] == m_:
            flat_group = g_

    def leaves(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + "/")
            else:
                yield prefix + k, v

    psum = {"hier_vs_numpy": [], "hier_vs_flat": [], "wide_vs_numpy": []}
    got_h, got_w = dict(leaves(hier)), dict(leaves(wide))
    for name, x in leaves(mine):
        want = sum(dict(leaves(everyone[r]))[name].double()
                   for r in range(len(everyone)) if model_of[r] == model_of[rank]).float()
        want_all = sum(dict(leaves(e))[name].double() for e in everyone).float()
        flat = x.clone()
        dist.all_reduce(flat, group=flat_group)
        psum["hier_vs_numpy"].append((name, torch.equal(got_h[name], want)))
        psum["hier_vs_flat"].append((name, torch.equal(got_h[name], flat)))
        psum["wide_vs_numpy"].append((name, torch.equal(got_w[name], want_all)))
    same = collectives.hierarchical_psum_shardmapped(mesh3, None)(tree(7))
    ok = torch.tensor([all(v for _, v in rows) for rows in psum.values()], dtype=torch.int32)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    res["psum"] = {**psum, "all_ranks_ok": ok.tolist(), "same_input": dict(leaves(same)),
                   "input": dict(leaves(tree(7))), "shapes": shapes}
    if rank == 0:
        torch.save(res, out / "train.pt")


def world_elastic(rank: int, out: pathlib.Path) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch import models
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.convert import stack_index
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.pipeline import pipeline_apply, split_layers_into_stages
    from repro_torch.launch.mesh import destroy, make_mesh
    from repro_torch.runtime.elastic import elastic_restore, plan_remesh
    from repro_torch.train.optimizer import init_state

    cfg = _cfg()
    root = out / "ckpt_2x4"
    flat, _ = ckpt.restore(root)

    def fresh():
        p = models.init(cfg, seed=5, device="cpu")
        return {"params": p, "opt_state": init_state(p)}

    def differing(state) -> list:
        """Leaves whose whole tensor is not the checkpoint's, bit for bit."""
        bad = []
        leaves = [(f"params::{n}", p) for n, p in state["params"].named_parameters()]
        leaves += [(f"opt_state::{k}::{n}", t) for k in ("m", "v")
                   for n, t in state["opt_state"][k].items()]
        for key, t in leaves:
            head, name = key.rsplit("::", 1)
            leaf, idx = stack_index(name)
            want = flat[f"{head}::{leaf.replace('.', '::')}"]
            want = torch.from_numpy(want[idx] if idx else want)
            if not torch.equal(_whole(t), want):
                bad.append(key)
        if int(_whole(state["opt_state"]["step"])) != int(flat["opt_state::step"]):
            bad.append("opt_state::step")
        return bad

    res: dict = {}
    plan = plan_remesh(4, model_axis=2)
    state, step_no, mesh = elastic_restore(root, cfg, plan, fresh(), device="cpu")
    res["restored_2x2"] = {"step": step_no, "mesh": tuple(mesh.mesh.shape),
                           "axes": tuple(mesh.mesh_dim_names), "differing": differing(state),
                           "placements": {n: str(tuple(p.placements))
                                          for n, p in state["params"].named_parameters()}}
    taps: list = []
    step = _step(cfg, taps)
    params, opt, m = step(state["params"], state["opt_state"],
                          shd.shard_batch(_batch(cfg, 2), cfg, mesh))
    res["mesh_step"] = {"metrics": _metrics(m), "params": _params(params), "grads": taps[0]}
    if rank == 0:
        single = fresh()
        single, _ = ckpt.restore(root, template=single)
        taps = []
        params, opt, m = _step(cfg, taps)(single["params"], single["opt_state"], _batch(cfg, 2))
        res["single_step"] = {"metrics": _metrics(m), "params": _params(params),
                              "grads": taps[0]}
    del state, params, opt

    # GPipe over 4 stages: 8 tanh layers, 6 microbatches of 4 (the JAX test's).
    import numpy as np

    g = np.random.default_rng(0)
    L, D, M, mb, S = (PIPE[k] for k in ("L", "D", "M", "mb", "S"))
    Ws = torch.from_numpy((g.standard_normal((L, D, D)) * 0.2).astype(np.float32))
    x = torch.from_numpy(g.standard_normal((M, mb, D)).astype(np.float32))

    def stage_fn(w, xx):
        for i in range(w.shape[0]):
            xx = torch.tanh(xx @ w[i])
        return xx

    smesh = make_mesh((S,), ("stage",), device="cpu")
    piped = pipeline_apply(stage_fn, split_layers_into_stages(Ws, S), x, smesh)
    stacked = shd.distribute(split_layers_into_stages(Ws, S), smesh, ("stage",))
    piped_dt = pipeline_apply(stage_fn, stacked, x, smesh)
    ref = x
    for w in Ws:
        ref = torch.tanh(ref @ w)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, piped)
    res["pipeline"] = {"out": piped, "sequential": ref,
                       "same_on_every_rank": all(torch.equal(o, piped) for o in everyone),
                       "stage_sharded_equal": torch.equal(piped_dt, piped)}
    dist.barrier()
    destroy()
    if rank != 0:
        return
    # A one-rank world restores the same checkpoint.
    state, step_no, mesh = elastic_restore(root, cfg, plan_remesh(1, model_axis=1), fresh(),
                                           device="cpu")
    res["restored_1"] = {"step": step_no, "mesh": tuple(mesh.mesh.shape),
                         "world": dist.get_world_size(), "differing": differing(state)}
    destroy()
    torch.save(res, out / "elastic.pt")


def serve_cfg(registry):
    """The serve world's config (either package's registry): stablelm-12b's
    smoke config with 4-token pages."""
    import dataclasses

    return dataclasses.replace(registry.get_smoke(SERVE_ARCH), kv_page_size=SERVE["page"])


def _serve_geometry():
    """(B, T, page, partitions, pages a partition holds of a sequence)."""
    B, T, page, Pn = (SERVE[k] for k in ("B", "T", "page", "P"))
    pages = -(-T // page)
    return B, T, page, Pn, -(-pages // Pn)


def world_serve(rank: int, out: pathlib.Path) -> None:
    """The JAX sharded serve test's 12 decode steps (stablelm-12b smoke, 4
    partitions of 4-token pages, B 4) through ``make_serve_step``:
    single-device on rank 0, then sharded on 2x4 with one step's collectives
    traced; then zamba2's smoke config through the registry's inputs on a 2x2
    mesh of ranks 0-3 beside its single-device step."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import models
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.dryrun import StepTrace
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.serve_step import make_serve_step

    cfg = serve_cfg(registry)
    B, T, page, Pn, pl = _serve_geometry()
    tokens = torch.from_numpy(np.load(out / "serve_tokens.npy")).to(torch.int32)

    def fresh():
        params = models.init(cfg, seed=1, device="cpu")
        ckpt.restore(out / "serve_init", template={"params": params})
        L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        pools = torch.zeros(L, B, Pn, pl, page, Hkv, hd)
        tables = torch.arange(pl, dtype=torch.int32).repeat(B, Pn, 1)
        return params, {"k_pools": pools, "v_pools": pools.clone(), "tables": tables}

    step = make_serve_step(cfg, kernel_mode="reference")
    res: dict = {}
    if rank == 0:
        params, state = fresh()
        logits = []
        with torch.no_grad():
            for t in range(T):
                lg, new = step(params, {**state, "tokens": tokens[:, t],
                                        "ctx_len": torch.full((B,), t + 1, dtype=torch.int32)})
                state.update(new)
                logits.append(lg)
        res["single"] = {"logits": torch.stack(logits), "k_pools": state["k_pools"],
                         "v_pools": state["v_pools"]}
    dist.barrier()

    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    shape = ShapeConfig("serve_world", T, B, "decode")
    params, state = fresh()
    shd.shard_params(params, cfg, mesh, mode="serve")
    tok0 = {"tokens": tokens[:, 0], "ctx_len": torch.ones(B, dtype=torch.int32)}
    placed = shd.shard_serve_inputs({**state, **tok0}, cfg, shape, mesh)
    res["placements"] = {k: str(tuple(v.placements)) for k, v in placed.items()}
    res["local_shapes"] = {k: tuple(v.to_local().shape) for k, v in placed.items()}
    state = {k: placed[k] for k in ("k_pools", "v_pools", "tables")}
    logits, traced = [], {}
    with torch.no_grad():
        for t in range(T):
            inputs = {**state, **shd.shard_serve_inputs(
                {"tokens": tokens[:, t], "ctx_len": torch.full((B,), t + 1, dtype=torch.int32)},
                cfg, shape, mesh)}
            if t == TRACED_STEP:
                pool = state["k_pools"].to_local()
                with CommDebugMode() as comm, StepTrace([pool]) as trace:
                    lg, new = step(params, inputs)
                traced = {"comm_counts": {str(k): v for k, v in comm.get_comm_counts().items()},
                          "comm_total": comm.get_total_counts(), "sizes": trace.sizes,
                          "pool_layer_shard_bytes": pool[0].numel() * pool.element_size()}
            else:
                lg, new = step(params, inputs)
            state.update({k: new[k] for k in ("k_pools", "v_pools")})
            logits.append(lg.full_tensor())
    res["sharded"] = {"logits": torch.stack(logits),
                      "logits_placements": str(tuple(lg.placements)),
                      "out_placements": {k: str(tuple(v.placements)) for k, v in new.items()},
                      "k_pools": state["k_pools"].full_tensor(),
                      "v_pools": state["v_pools"].full_tensor(), "traced": traced}
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    res["hybrid"] = {kind: _hybrid_2x2(rank, mesh, kind) for kind in HYBRID}
    if rank == 0:
        torch.save(res, out / "serve.pt")


def _hybrid_2x2(rank, mesh, kind: str) -> dict:
    """zamba2's smoke config, the registry's inputs for a ``kind`` cell
    with a written prefix, ``HYBRID_STEPS`` steps single-device (rank 0)
    and on ``mesh``, a 2x2 mesh of ranks 0-3 (ranks 4-7 joined its groups
    only)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "tests"))
    import _serve_cases as sc

    from repro_torch import models
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.serve.serve_step import make_serve_step

    cfg = dataclasses.replace(registry.get_smoke(HYBRID_ARCH), kv_page_size=HYBRID_PAGE)
    B, Pn = HYBRID[kind]["B"], HYBRID[kind]["P"]
    shape = ShapeConfig("hybrid_world", HYBRID_T, B, kind)
    gen = torch.Generator().manual_seed(5)
    specs = registry.input_specs(cfg, shape, num_partitions=Pn)
    ctx0 = torch.tensor(HYBRID[kind]["prefix"], dtype=torch.int32)

    def normal(shape_):
        return torch.randn(shape_, generator=gen)

    inputs = sc.random_inputs(cfg, specs, ctx0 + 1, normal,
                              lambda high, s: torch.randint(0, high, s, generator=gen,
                                                            dtype=torch.int32))
    L = inputs["k_pools"].shape[0]
    for name in ("k_pools", "v_pools"):
        inputs[name].zero_()
        sc.write_prefix(inputs[name], inputs["tables"],
                        normal((L, B, int(ctx0.max()), cfg.num_kv_heads, cfg.head_dim)), ctx0,
                        HYBRID_PAGE)
    tokens = torch.randint(0, cfg.vocab, (HYBRID_STEPS, B), generator=gen, dtype=torch.int32)
    step = make_serve_step(cfg, kernel_mode="reference")
    keys = ("conv_state", "ssm_state", "k_pools", "v_pools")
    res: dict = {}
    with torch.no_grad():
        if rank == 0:
            params = models.init(cfg, seed=3, device="cpu")
            state = {k: v.clone() for k, v in inputs.items()}
            logits = []
            for s in range(HYBRID_STEPS):
                state.update(tokens=tokens[s], ctx_len=ctx0 + 1 + s)
                lg, new = step(params, state)
                state.update(new)
                logits.append(lg)
            res["single"] = {"logits": torch.stack(logits), **{k: state[k] for k in keys}}
        if rank < 4:
            params = models.init(cfg, seed=3, device="cpu")
            shd.shard_params(params, cfg, mesh, mode="serve")
            state = shd.shard_serve_inputs(inputs, cfg, shape, mesh)
            res["placements"] = {k: str(tuple(state[k].placements)) for k in keys}
            logits = []
            for s in range(HYBRID_STEPS):
                state.update(shd.shard_serve_inputs({"tokens": tokens[s],
                                                     "ctx_len": ctx0 + 1 + s}, cfg, shape, mesh))
                lg, new = step(params, state)
                state.update(new)
                logits.append(lg.full_tensor())
            res["sharded"] = {"logits": torch.stack(logits),
                              **{k: state[k].full_tensor() for k in keys}}
    dist.barrier()
    return res


def world_moe(rank: int, out: pathlib.Path) -> None:
    """qwen3-moe-30b-a3b's smoke config from the JAX package's initial
    parameters (``<out>/moe_init``): ``STEPS`` steps single-device (rank 0)
    and on a 2x2 ``("data", "model")`` mesh; then step 1 on a 1 x 1 mesh."""
    import torch

    from repro_torch import models
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import init_state

    cfg = registry.get_smoke(MOE_ARCH)

    def initial():
        params = models.init(cfg, seed=1, device="cpu")
        ckpt.restore(out / "moe_init", template={"params": params})
        return params, init_state(params)

    res: dict = {}
    if rank == 0:
        taps: list = []
        step = _step(cfg, taps)
        params, opt = initial()
        res["single"] = {"metrics": [], "params": []}
        for i in range(STEPS):
            params, opt, m = step(params, opt, _batch(cfg, i))
            res["single"]["metrics"].append(_metrics(m))
            res["single"]["params"].append(_params(params))
        res["single"]["grads"] = taps
    import torch.distributed as dist

    dist.barrier()
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    taps = []
    step = _step(cfg, taps)
    params, opt = initial()
    shd.shard_params(params, cfg, mesh)
    opt = shd.shard_opt_state(opt, cfg, mesh)
    res["sharded"] = {"metrics": [], "params": [],
                      "placements": {n: str(tuple(p.placements))
                                     for n, p in params.named_parameters()}}
    for i in range(STEPS):
        params, opt, m = step(params, opt, shd.shard_batch(_batch(cfg, i), cfg, mesh))
        res["sharded"]["metrics"].append(_metrics(m))
        res["sharded"]["params"].append(_params(params))
    res["sharded"]["grads"] = taps
    res["sharded"]["traced_block"] = _moe_block_collectives(cfg, params.layers[0].moe, mesh)
    dist.barrier()
    # The same first step on a 1 x 1 mesh of rank 0 (the others join its
    # groups only): one rank runs the same ATen ops on the same tensors.
    from torch.distributed.device_mesh import DeviceMesh

    one = DeviceMesh("cpu", torch.zeros(1, 1, dtype=torch.int64), mesh_dim_names=("data", "model"))
    if rank == 0:
        taps = []
        params, opt = initial()
        shd.shard_params(params, cfg, one)
        opt = shd.shard_opt_state(opt, cfg, one)
        params, opt, m = _step(cfg, taps)(params, opt, shd.shard_batch(_batch(cfg, 0), cfg, one))
        res["one_rank"] = {"metrics": _metrics(m), "params": _params(params)}
        torch.save(res, out / "moe.pt")


def world_vocab(rank: int, out: pathlib.Path) -> None:
    """The chunked loss and the prefill step, single-device (rank 0) and
    sharded: the loss on a 2x4 ``("data", "model")`` mesh with the head in
    train placements (D over data, V over model) and on a 1 x 1 mesh of
    rank 0; each prefill config on 2x4 from the JAX package's initial
    parameters (``<out>/prefill_<kind>``)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import models
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.losses import chunked_cross_entropy
    from repro_torch.train.train_step import make_prefill_step

    data = np.load(out / "vocab_loss.npz")
    block = VOCAB_LOSS["block"]

    def loss_and_grads(mesh=None):
        h, w = (torch.from_numpy(data[k]) for k in ("hidden", "head"))
        y = torch.from_numpy(data["labels"])
        if mesh is not None:
            h = shd.distribute(h, mesh, ("data", None, None))
            w = shd.distribute(w, mesh, ("data", "model"))
            y = shd.distribute(y, mesh, ("data", None))
        h.requires_grad_(True)
        w.requires_grad_(True)
        loss = chunked_cross_entropy(h, w, y, block=block)
        gh, gw = torch.autograd.grad(loss, (h, w))
        return {"loss": _whole(loss), "hidden": _whole(gh), "head": _whole(gw),
                "placements": [str(tuple(t.placements)) if shd.is_dtensor(t) else None
                               for t in (loss, gh, gw)]}

    res: dict = {}
    if rank == 0:
        res["single"] = loss_and_grads()
    dist.barrier()
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    res["sharded"] = loss_and_grads(mesh)
    one = DeviceMesh("cpu", torch.zeros(1, 1, dtype=torch.int64), mesh_dim_names=("data", "model"))
    if rank == 0:
        res["one_rank"] = loss_and_grads(one)
    dist.barrier()

    tokens = torch.from_numpy(np.load(out / "prefill_tokens.npy")).to(torch.int32)
    res["prefill"] = {}
    for kind in PREFILL_ARCHS:
        cfg = prefill_cfg(registry, kind)
        step = make_prefill_step(cfg, kernel_mode="reference")

        def initial():
            params = models.init(cfg, seed=1, device="cpu")
            ckpt.restore(out / f"prefill_{kind}", template={"params": params})
            return params

        got: dict = {}
        if rank == 0:
            with torch.no_grad():
                got["single"] = step(initial(), {"tokens": tokens})
        dist.barrier()
        params = shd.shard_params(initial(), cfg, mesh, mode="train")
        with torch.no_grad():
            logits = step(params, shd.shard_batch({"tokens": tokens}, cfg, mesh))
        got["sharded"] = logits.full_tensor()
        got["placements"] = str(tuple(logits.placements))
        got["local_shape"] = tuple(logits.to_local().shape)
        res["prefill"][kind] = got

    # The scans' gradients on each rank's rows and heads: the loss and its
    # gradients of the state-space configs, single-device and on 2x4; the
    # heads of every Mamba2 scan each rank ran on 2x4 (Zamba2's).
    from repro_torch.models import mamba2 as m2

    scanned: list = []
    real_scan = m2.mamba2_scan

    def recording_scan(x, *a, **kw):
        scanned.append(int(x.shape[1]))
        return real_scan(x, *a, **kw)

    res["grads"] = {}
    for kind in SCAN_GRAD_KINDS:
        cfg = prefill_cfg(registry, kind)
        batch = {"tokens": tokens}

        def loss_and_grads(params, b):
            names, leaves = zip(*params.named_parameters())
            with torch.enable_grad():
                loss = models.loss_fn(params.requires_grad_(True), b, cfg,
                                      kernel_mode="reference")
                grads = torch.autograd.grad(loss, leaves)
            return {"loss": float(_whole(loss)), "grads": dict(zip(names, map(_whole, grads)))}

        got = {}
        if rank == 0:
            params = models.init(cfg, seed=1, device="cpu")
            ckpt.restore(out / f"prefill_{kind}", template={"params": params})
            got["single"] = loss_and_grads(params, batch)
        dist.barrier()
        params = models.init(cfg, seed=1, device="cpu")
        ckpt.restore(out / f"prefill_{kind}", template={"params": params})
        shd.shard_params(params, cfg, mesh, mode="train")
        from torch.distributed.tensor.experimental import implicit_replication

        m2.mamba2_scan = recording_scan
        try:
            with implicit_replication():
                got["sharded"] = loss_and_grads(params, shd.shard_batch(batch, cfg, mesh))
        finally:
            m2.mamba2_scan = real_scan
        res["grads"][kind] = got

    # Zamba2 trains on 2x4 as on one device: HYBRID_TRAIN_STEPS steps of
    # make_train_step from the JAX package's initial parameters.
    from repro_torch.data.pipeline import DataConfig, batch_for_model
    from repro_torch.train.optimizer import init_state

    cfg = prefill_cfg(registry, "hybrid")
    data = DataConfig(vocab=cfg.vocab, seq_len=PREFILL_T, global_batch=PREFILL_B)
    batches = [{k: torch.from_numpy(v) for k, v in batch_for_model(data, cfg, i).items()}
               for i in range(HYBRID_TRAIN_STEPS)]

    def train(sharded: bool) -> dict:
        taps: list = []
        step = _step(cfg, taps)
        params = models.init(cfg, seed=1, device="cpu")
        ckpt.restore(out / "prefill_hybrid", template={"params": params})
        opt = init_state(params)
        if sharded:
            shd.shard_params(params, cfg, mesh)
            opt = shd.shard_opt_state(opt, cfg, mesh)
        losses = []
        for b in batches:
            params, opt, m = step(params, opt, shd.shard_batch(b, cfg, mesh) if sharded else b)
            losses.append(float(_whole(m["loss"])))
        return {"losses": losses, "params": _params(params), "grads": taps}

    if rank == 0:
        res["hybrid_train"] = {"single": train(False)}
    dist.barrier()
    m2.mamba2_scan = recording_scan
    try:
        sharded_train = train(True)
    finally:
        m2.mamba2_scan = real_scan
    heads = [None] * dist.get_world_size()
    dist.all_gather_object(heads, scanned)
    if rank == 0:
        res["hybrid_train"]["sharded"] = sharded_train
        res["heads_scanned"] = heads
        torch.save(res, out / "vocab.pt")


def _moe_block_collectives(cfg, p, mesh) -> dict:
    """One MoE block's forward and backward on a [BATCH, SEQ, D] batch
    sharded over ``data``, traced below DTensor: each collective's (kind,
    result bytes), beside the bytes of the whole token batch and of the
    whole [E * C, D] dispatch buffer."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.dryrun import StepTrace
    from repro_torch.models.moe import _capacity, moe_forward

    x = torch.randn(BATCH, SEQ, cfg.d_model, generator=torch.Generator().manual_seed(5))
    x = distribute_tensor(x, mesh, (Shard(0), Replicate())).requires_grad_()
    with implicit_replication(), StepTrace() as trace:      # as the train step runs it
        out, aux = moe_forward(p, x, cfg)
        (out.float().square().sum() + aux).backward()
    tokens, E = BATCH * SEQ, cfg.moe.num_experts
    return {"sizes": trace.sizes, "batch_bytes": tokens * cfg.d_model * 4,
            "buffer_bytes": E * _capacity(tokens, cfg) * cfg.d_model * 4}


JAX_SERVE_REF = textwrap.dedent(r"""
    import sys, pathlib, dataclasses
    import jax, numpy as np, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs import registry
    from repro.models import transformer as tfm
    from repro.models.paged_global import decode_block_global

    out = pathlib.Path(sys.argv[1])
    ARCH, (B, T, page, Pn) = %(serve)r
    cfg = dataclasses.replace(registry.get_smoke(ARCH), kv_page_size=page)
    params = tfm.init(jax.random.PRNGKey(0), cfg)
    tokens = jnp.asarray(np.load(out / "serve_tokens.npy"))
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    n_pages = (T + page - 1) // page
    pl = (n_pages + Pn - 1) // Pn
    kp = jnp.zeros((cfg.num_layers, B, Pn, pl, page, cfg.num_kv_heads, cfg.head_dim),
                   jnp.float32)
    vp = jnp.zeros_like(kp)
    tables = jnp.asarray(np.tile(np.arange(pl, dtype=np.int32), (B, Pn, 1)))
    pool_sh = NamedSharding(mesh, P(None, "data", "model", None, None, None, None))
    kp = jax.device_put(kp, pool_sh); vp = jax.device_put(vp, pool_sh)

    def serve(params, tok, kp, vp, tables, ctx):
        x = tfm.embed_tokens(params, cfg, tok[:, None])
        def body(x, scanned):
            lp, kpool, vpool = scanned
            x, kpool, vpool = decode_block_global(lp, x, cfg, kpool, vpool, tables, ctx)
            return x, (kpool, vpool)
        x, (kp2, vp2) = jax.lax.scan(body, x, (params["layers"], kp, vp))
        return tfm.unembed(params, cfg, x)[:, 0], kp2, vp2

    jit = jax.jit(serve, out_shardings=(NamedSharding(mesh, P("data", "model")), pool_sh,
                                        pool_sh))
    logits = []
    for t in range(T):
        lg, kp, vp = jit(params, tokens[:, t], kp, vp, tables, jnp.full((B,), t + 1, jnp.int32))
        logits.append(np.asarray(lg))
    np.savez(out / "jax_serve.npz", logits=np.stack(logits), k_pools=np.asarray(kp),
             v_pools=np.asarray(vp))
""") % {"serve": (SERVE_ARCH, tuple(SERVE[k] for k in ("B", "T", "page", "P")))}


JAX_REF = textwrap.dedent(r"""
    import sys, pathlib
    import jax, numpy as np, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro import models
    from repro.configs import registry
    from repro.data.pipeline import DataConfig, batch_for_model
    from repro.distributed import sharding as shd
    from repro.distributed.collectives import hierarchical_psum_shardmapped
    from repro.distributed.pipeline import pipeline_apply, split_layers_into_stages
    from repro.train.optimizer import OptimizerConfig, init_state
    from repro.train.train_step import make_loss_fn, make_train_step

    out = pathlib.Path(sys.argv[1])
    ARCH, SEQ, BATCH, STEPS, LR = %(train)r
    L, D, M, mb, S = %(pipe)r

    def mesh_of(shape, axes):
        return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))

    def flat(tree):
        return {"/".join(str(k.key) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    cfg = registry.get_smoke(ARCH)
    params = models.init(jax.random.PRNGKey(0), cfg)
    opt = init_state(params)
    mesh = mesh_of((2, 4), ("data", "model"))
    named = lambda specs: jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                       is_leaf=lambda x: isinstance(x, P))
    nps = named(shd.param_specs(params, cfg, mode="train"))
    nos = named(shd.opt_state_specs(params, cfg))
    bs = NamedSharding(mesh, P("data", None))
    p = jax.tree.map(jax.device_put, params, nps)
    o = jax.tree.map(jax.device_put, opt, nos)
    step = jax.jit(make_train_step(cfg, OptimizerConfig(lr=LR, warmup_steps=1)),
                   in_shardings=(nps, nos, bs), out_shardings=(nps, nos, None))
    grad = jax.jit(jax.grad(make_loss_fn(cfg)), in_shardings=(nps, bs), out_shardings=nps)
    data = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    res = {}
    for i in range(STEPS):
        b = {k: jax.device_put(jnp.asarray(v), bs)
             for k, v in batch_for_model(data, cfg, i).items()}
        if i == 0:
            res.update({"grads1/" + k: v for k, v in flat(grad(p, b)).items()})
        p, o, m = step(p, o, b)
        res[f"loss/{i}"] = np.float32(m["loss"])
        res[f"grad_norm/{i}"] = np.float32(m["grad_norm"])
        res.update({f"params{i + 1}/" + k: v for k, v in flat(p).items()})

    g = np.random.default_rng(0)
    Ws = jnp.asarray((g.standard_normal((L, D, D)) * 0.2).astype(np.float32))
    x = jnp.asarray(g.standard_normal((M, mb, D)).astype(np.float32))
    def stage_fn(w, xx):
        for i in range(w.shape[0]):
            xx = jnp.tanh(xx @ w[i])
        return xx
    res["pipeline"] = np.asarray(pipeline_apply(stage_fn, split_layers_into_stages(Ws, S), x,
                                                mesh_of((S,), ("stage",))))

    g = np.random.default_rng(7)
    tree = {"a": jnp.asarray(g.integers(-50, 50, (7, 3)).astype(np.float32)),
            "b": jnp.asarray(g.integers(-50, 50, 5).astype(np.float32)),
            "nested": {"c": jnp.asarray(g.integers(-50, 50, (2, 3, 3)).astype(np.float32))}}
    m3 = mesh_of((2, 2, 2), ("pod", "data", "model"))
    summed = hierarchical_psum_shardmapped(m3, jax.tree.map(lambda _: P(), tree))(tree)
    res.update({"psum/" + k: v for k, v in flat(summed).items()})
    np.savez(out / "jax_ref.npz", **res)
""") % {"train": (ARCH, SEQ, BATCH, STEPS, LR),
        "pipe": tuple(PIPE[k] for k in ("L", "D", "M", "mb", "S"))}


JAX_VOCAB_REF = textwrap.dedent(r"""
    import sys, pathlib, dataclasses
    import jax, numpy as np, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro import models
    from repro.configs import registry
    from repro.distributed import sharding as shd
    from repro.train.train_step import make_prefill_step

    out = pathlib.Path(sys.argv[1])
    ARCHS = %(archs)r
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    tokens = jnp.asarray(np.load(out / "prefill_tokens.npy"))
    res = {}
    for kind, (arch, over) in ARCHS.items():
        cfg = dataclasses.replace(registry.get_smoke(arch), **over)
        params = models.init(jax.random.PRNGKey(0), cfg)
        nps = jax.tree.map(lambda s: NamedSharding(mesh, s),
                           shd.param_specs(params, cfg, mode="train"),
                           is_leaf=lambda x: isinstance(x, P))
        bs = {"tokens": NamedSharding(mesh, P("data", None))}
        step = jax.jit(make_prefill_step(cfg), in_shardings=(nps, bs),
                       out_shardings=NamedSharding(mesh, P("data", "model")))
        p = jax.tree.map(jax.device_put, params, nps)
        res[kind] = np.asarray(step(p, {"tokens": jax.device_put(tokens, bs["tokens"])}))
    np.savez(out / "jax_vocab.npz", **res)
""") % {"archs": PREFILL_ARCHS}


def jax_env() -> dict:
    e = env()
    e["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    e["JAX_PLATFORMS"] = "cpu"
    return e


if __name__ == "__main__":
    name, out_dir = sys.argv[1], sys.argv[2]
    import torch.multiprocessing as mp

    sys.path.insert(0, str(ROOT / "src"))
    pathlib.Path(out_dir, f"{name}.store").unlink(missing_ok=True)   # a stale store hangs
    mp.spawn(_entry, args=(name, WORLDS[name], out_dir), nprocs=WORLDS[name], join=True)
