"""Multi-pod dry run, the port of ``src/repro/launch/dryrun.py``: every
(arch x shape x mesh) cell's production step run once on meta-device
DTensors in a fake 256- or 512-rank world.

The JAX package AOT-compiles each cell for 512 forced host devices and reads
XLA's ``memory_analysis``, ``cost_analysis`` and the optimized HLO's
collectives.  Torch has no such compiler pass to ask, so here the step
itself runs: parameters (``registry.abstract_params``), optimizer state and
inputs (``registry.input_specs``) on the ``meta`` device (shapes and dtypes,
nothing allocated or computed), placed by the sharding rules on
``make_production_mesh`` over a process group of the ``fake`` backend (its
collectives return at once and move nothing).  Two dispatch modes watch the
step:

* :class:`StepTrace`, below DTensor, sees every rank-local op: the
  ``c10d_functional`` collectives DTensor runs, their per-device result
  bytes by the JAX package's five kinds (its "result sizes" rule over the
  HLO), and the live local tensors, whose largest total is
  ``memory.peak_live_bytes`` (an estimate: an allocator's rounding,
  fragmentation and workspaces are not in it);
* ``FlopCounterMode``, entered before it, counts the FLOPs of the same
  rank-local ops (``flops_scope: "device"``, as XLA's per-device cost
  analysis; the sharded paths multiply rank-local shards themselves, which
  a counter above DTensor would count at one rank's shapes beside
  DTensor's ops at the global ones; XLA's per-device cost analysis has no
  torch counterpart).

The mesh is ``"cpu"``-typed (``mesh_device_type``), where DTensor turns an
all-to-all into an all-gather and a chunk.  Leaves whose dims the mesh axes
do not divide are listed in ``uneven``: DTensor shards them unevenly, the
JAX package refuses them.  Every step runs with ``kernel_mode="reference"``,
as in the JAX package; the KV pools are written by scatter, the one form the
port has (the JAX package's ``REPRO_KV_WRITE_MODE`` picks among several, so
the record's ``kv_write_mode`` is a constant here).  Records go to
``build/repro_torch/dryrun/<arch>__<shape>__<mesh>.json``; no HLO exists, so
none is written.  A process holds one default group, so the dry run runs in
a process of its own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-12b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun \
      --cells qwen3-14b:train_4k:16x16,zamba2-7b:long_500k:16x16
"""
from __future__ import annotations

import argparse
import gc
import heapq
import json
import math
import pathlib
import time
import traceback
import weakref
from typing import Dict, Iterable, Mapping, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, SHAPES_BY_NAME, ShapeConfig, cell_applicable
from repro_torch.distributed import sharding as shd
from repro_torch.kernels._build import BUILD_DIR

DEFAULT_OUT = BUILD_DIR / "dryrun"
# The JAX package's five kinds, and ``broadcast``, which has none of them.
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
               "broadcast")
_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast", "broadcast_": "broadcast",
}
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def mesh_sizes(multi_pod: bool) -> Dict[str, int]:
    """{axis: size} of a production mesh, in the mesh's order."""
    shape, axes = MESHES[multi_pod]
    return dict(zip(axes, shape))
PEAK_TOP = 8            # live tensors named beside the peak
PEAK_NOTE = ("estimate: the largest total of live rank-local tensors during the step, "
             "arguments included; no allocator rounding, fragmentation or workspaces")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


# DTensor's sharding propagation runs each new op once on global-shape meta
# tensors to learn its output's shape and prices its candidate placements:
# not a rank's work, so it runs with the dispatch modes set aside.
_PROPAGATION = ("propagate_op_sharding_non_cached", "_propagate_tensor_meta_non_cached")


class StepTrace(TorchDispatchMode):
    """The rank-local ops of a step (entered inside ``FlopCounterMode``):
    each collective's per-device result bytes by kind, and the live local
    tensors.  A storage that ``args`` hold (parameters, state, inputs) counts
    in ``argument_bytes``, not again when an op writes it in place.  The ops
    of DTensor's sharding propagation are left out (``propagation_excluded``
    says whether this torch has the method that marks them)."""

    def __init__(self, args: Iterable[torch.Tensor] = ()):
        super().__init__()
        self.bytes = {k: 0 for k in COLLECTIVES}
        self.count = {k: 0 for k in COLLECTIVES}
        self.sizes: list = []                      # (kind, result bytes) of each collective
        self._args = {_storage(t) for t in args}
        self.argument_bytes = 0
        seen = set()
        for t in args:
            if _storage(t) not in seen:
                seen.add(_storage(t))
                self.argument_bytes += t.untyped_storage().nbytes()
        self.live = self.peak = self.argument_bytes
        self.peak_top: list = []                   # the largest live tensors at the peak
        self._held: Dict[int, list] = {}
        self._patched: list = []
        self.propagation_excluded = False

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        for name in _PROPAGATION:
            real = getattr(ShardingPropagator, name, None)
            if real is None:
                continue

            def quiet(*a, _real=real, **kw):
                from torch.utils._python_dispatch import _disable_current_modes

                with _disable_current_modes():
                    return _real(*a, **kw)

            setattr(ShardingPropagator, name, quiet)
            self._patched.append((name, real))
            self.propagation_excluded = True
            break
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        for name, real in self._patched:
            setattr(ShardingPropagator, name, real)
        self._patched.clear()
        return super().__exit__(*exc)

    def _drop(self, key: int) -> None:
        held = self._held.get(key)
        if held is None:
            return
        held[1] -= 1
        if held[1] == 0:
            self.live -= held[0]
            del self._held[key]

    def _hold(self, t: torch.Tensor, func) -> None:
        key = _storage(t)
        if key in self._args:
            return
        if key not in self._held:
            nb = t.untyped_storage().nbytes()
            self._held[key] = [nb, 0, (str(func), tuple(t.shape), str(t.dtype))]
            self.live += nb
            if self.live > self.peak:
                self.peak = self.live
                self._top()
        self._held[key][1] += 1
        weakref.finalize(t, self._drop, key)

    def _top(self) -> None:
        big = heapq.nlargest(PEAK_TOP, self._held.values(), key=lambda h: h[0])
        self.peak_top = [{"op": op, "shape": list(shape), "dtype": dt, "bytes": nb}
                         for nb, _, (op, shape, dt) in big]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs first and desugars into local ops
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            kind = _KINDS.get(func._overloadpacket.__name__)
            if kind is not None:
                nb = sum(_nbytes(t) for t in outs)
                self.bytes[kind] += nb
                self.count[kind] += 1
                self.sizes.append((kind, nb))
        for t in outs:
            self._hold(t, func)
        return out


# ---------------------------------------------------------------------------
# Per-device shapes.
# ---------------------------------------------------------------------------

def shard_shape(shape: Tuple[int, ...], spec: shd.Spec, mesh_shape: Mapping[str, int]):
    """(rank 0's local shape, uneven) of a tensor of ``shape`` placed by
    ``spec`` on a mesh of ``mesh_shape`` ({axis: size}, in the mesh's
    order), by DTensor's rule: each mesh dim that shards a tensor dim splits
    its current size as ``torch.chunk`` does (rank 0 takes the ceiling).
    ``uneven``: some mesh axes do not divide their dim (the JAX package
    refuses such a leaf)."""
    local, uneven = list(shape), False
    names = tuple(mesh_shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        uneven |= shape[i] % math.prod(mesh_shape[a] for a in axes) != 0
        for a in sorted(axes, key=names.index):
            local[i] = -(-local[i] // mesh_shape[a])
    return tuple(local), uneven


def cell_leaves(cfg, shape: ShapeConfig, multi_pod: bool) -> Dict[str, tuple]:
    """{leaf: (global shape, spec)} of every parameter (``params/<name>``),
    optimizer-state (``opt/m/<name>``, ``opt/v/<name>``, ``opt/step``; train
    cells) and input (``inputs/<key>``) leaf of one cell, as placed; from the
    meta-device parameters, so no world is needed."""
    params = dict(registry.abstract_params(cfg).named_parameters())
    out = {}
    if shape.lowers_serve_step:
        pspecs = shd.param_specs(params, cfg, mode="serve", multi_pod=multi_pod)
        specs = registry.input_specs(cfg, shape, num_partitions=_partitions(shape, multi_pod))
        ispecs = shd.serve_input_specs(cfg, shape, multi_pod=multi_pod)
    else:
        pspecs = shd.param_specs(params, cfg, mode="train", multi_pod=multi_pod)
        specs = registry.input_specs(cfg, shape)
        ispecs = shd.batch_specs(cfg, shape, multi_pod=multi_pod)
    for n, p in params.items():
        out[f"params/{n}"] = (tuple(p.shape), pspecs[n])
    if shape.kind == "train":
        for k in ("m", "v"):
            for n, p in params.items():
                out[f"opt/{k}/{n}"] = (tuple(p.shape), pspecs[n])
        out["opt/step"] = ((), ())
    for k, v in specs.items():
        out[f"inputs/{k}"] = (tuple(v.shape), ispecs[k])
    return out


def _partitions(shape: ShapeConfig, multi_pod: bool) -> int:
    """The SPARTA partitions of a decode cell: the partition axes' ranks."""
    axes = shd.serve_partition_axes(shape, multi_pod=multi_pod)
    sizes = mesh_sizes(multi_pod)
    return math.prod(sizes[a] for a in ((axes,) if isinstance(axes, str) else axes))


def local_shapes(cfg, shape: ShapeConfig, multi_pod: bool) -> Dict[str, tuple]:
    """{leaf: (rank 0's local shape, uneven)} of one cell (:func:`shard_shape`
    over :func:`cell_leaves`)."""
    sizes = mesh_sizes(multi_pod)
    return {k: shard_shape(s, spec, sizes)
            for k, (s, spec) in cell_leaves(cfg, shape, multi_pod).items()}


# ---------------------------------------------------------------------------
# One cell.
# ---------------------------------------------------------------------------

def fake_world(world: int) -> None:
    """A process group of the ``fake`` backend with ``world`` ranks (this
    process rank 0), replacing one of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and str(dist.get_backend()) == "fake":
            return
        dist.destroy_process_group()
        _forget_meshes()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _forget_meshes() -> None:
    """Clear DTensor's placement caches.  They key on a mesh's value, so a
    mesh of the last world equal to one of the next would bring back its
    destroyed groups ("Could not resolve the process group")."""
    from torch.distributed.tensor import _redistribute, debug

    for clear in (getattr(debug, "_clear_sharding_prop_cache", None),
                  getattr(_redistribute._gen_transform_infos, "cache_clear", None)):
        if clear is not None:
            clear()


def _local(t):
    return t.to_local() if shd.is_dtensor(t) else t


def _checked_shapes(placed: Mapping[str, torch.Tensor], want: Mapping[str, tuple]) -> int:
    """Hold each placed leaf's local shape to :func:`shard_shape`'s; the
    number held."""
    bad = [(k, tuple(_local(t).shape), want[k][0]) for k, t in placed.items()
           if tuple(_local(t).shape) != want[k][0]]
    if bad:
        raise AssertionError(f"local shapes differ from shard_shape's: {bad[:4]}")
    return len(placed)


def _place_like(x, mesh, spec):
    if not shd.is_dtensor(x):
        return x
    want = shd.placements(spec, mesh)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def _setup(cfg, shape: ShapeConfig, mesh, multi_pod: bool):
    """One cell's parameters, optimizer state and inputs placed on ``mesh``:
    (``run()``, which takes the production step once, {leaf: placed
    tensor}, the inputs' meta specs, the parameter module)."""
    from repro_torch.serve.serve_step import make_serve_step
    from repro_torch.train.optimizer import init_state
    from repro_torch.train.train_step import make_prefill_step, make_train_step

    params = registry.abstract_params(cfg)
    placed: Dict[str, torch.Tensor] = {}
    if shape.lowers_serve_step:
        specs = registry.input_specs(cfg, shape,
                                     num_partitions=_partitions(shape, multi_pod))
        shd.shard_params(params, cfg, mesh, mode="serve")
        inputs = shd.shard_serve_inputs(specs, cfg, shape, mesh)
        step = make_serve_step(cfg, kernel_mode="reference")

        def run():
            with torch.no_grad():
                return step(params, inputs)
    elif shape.kind == "prefill":
        specs = registry.input_specs(cfg, shape)
        shd.shard_params(params, cfg, mesh, mode="train")
        inputs = shd.shard_batch(specs, cfg, mesh)
        step = make_prefill_step(cfg, kernel_mode="reference")
        logits_spec = (shd.data_axes(multi_pod), "model")

        def run():
            with torch.no_grad():
                return _place_like(step(params, inputs), mesh, logits_spec)
    else:
        specs = registry.input_specs(cfg, shape)
        opt = init_state(params)
        shd.shard_params(params, cfg, mesh, mode="train")
        opt = shd.shard_opt_state(opt, cfg, mesh)
        inputs = shd.shard_batch(specs, cfg, mesh)
        step = make_train_step(cfg, kernel_mode="reference")
        for k in ("m", "v"):
            placed.update({f"opt/{k}/{n}": t for n, t in opt[k].items()})
        placed["opt/step"] = opt["step"]

        def run():
            return step(params, opt, inputs)
    placed.update({f"params/{n}": p for n, p in params.named_parameters()})
    placed.update({f"inputs/{k}": v for k, v in inputs.items()})
    return run, placed, specs, params


def lower_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: pathlib.Path,
               resume: bool = True, act_constraints: bool = False, tag: str = "") -> dict:
    """Run one cell on the meta device in a fake world and write its record
    (``ok`` false with the error and traceback when it fails)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_production_mesh

    mesh_name = ("2x16x16" if multi_pod else "16x16") + tag
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    if resume and out_path.exists():
        rec = json.loads(out_path.read_text())
        if rec.get("ok"):
            print(f"[skip] {out_path.name} (cached)")
            return rec

    cfg = registry.get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        raise SystemExit(f"inapplicable cell: {why}")

    shape_mesh = MESHES[multi_pod][0]
    fake_world(math.prod(shape_mesh))
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "chips": int(mesh.size()), "ok": False,
        "act_constraints": act_constraints, "mesh_device_type": mesh.device_type,
        "torch_version": torch.__version__,
    }
    t0 = time.time()
    if act_constraints:
        shd.set_activation_policy(dp=shd.data_axes(multi_pod), tp="model",
                                  tp_size=mesh.size(mesh.mesh_dim_names.index("model")))
    try:
        if shape.lowers_serve_step:
            rec["kv_write_mode"] = "scatter"
        want = local_shapes(cfg, shape, multi_pod)
        rec["uneven"] = sorted(k for k, (_, u) in want.items() if u)
        run, placed, specs, params = _setup(cfg, shape, mesh, multi_pod)
        rec["shard_shapes_checked"] = _checked_shapes(placed, want)
        args = [_local(t) for t in placed.values()]
        with FlopCounterMode(display=False) as flops, StepTrace(args) as trace:
            out = run()
        if not trace.propagation_excluded:
            raise RuntimeError("this torch's ShardingPropagator has none of "
                               f"{_PROPAGATION}: peak_live_bytes would count the global-shape "
                               "tensors of DTensor's sharding propagation")
        rec["trace_s"] = time.time() - t0
        outs = [_local(t) for t in _tensors(out)]
        arg_storages = {_storage(t) for t in args}
        rec["memory"] = {
            "argument_bytes": trace.argument_bytes,
            "output_bytes": sum(_nbytes(t) for t in outs),
            "alias_bytes": sum(_nbytes(t) for t in outs if _storage(t) in arg_storages),
            "peak_live_bytes": trace.peak,
            "peak_top": trace.peak_top,
            "peak_live_note": PEAK_NOTE,
            "propagation_excluded": trace.propagation_excluded,
        }
        rec["flops"] = float(flops.get_total_flops())
        rec["flops_scope"] = "device"
        rec["collective_bytes"] = trace.bytes
        rec["collective_count"] = trace.count
        rec["largest_collective_bytes"] = max((nb for _, nb in trace.sizes), default=0)
        if "inputs/k_pools" in placed:
            pool = _local(placed["inputs/k_pools"])
            layer = _nbytes(pool) // pool.shape[0]
            rec["pool_layer_shard_bytes"] = layer
            rec["pool_sized_collectives"] = sum(nb >= layer for _, nb in trace.sizes)
        rec["input_bytes"] = int(sum(_nbytes(v) for v in specs.values()))
        rec["param_count"] = int(sum(p.numel() for p in params.parameters()))
        rec["ok"] = True
        print(f"[ok] {arch} x {shape_name} x {mesh_name}: trace={rec['trace_s']:.1f}s "
              f"flops={rec['flops']:.3g} coll={sum(trace.bytes.values()) / 2**20:.1f}MiB "
              f"peak={trace.peak / 2**30:.2f}GiB")
        del out, outs, run, placed, params, args
    except Exception as e:  # noqa: BLE001 — recorded, not swallowed
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        rec["trace_s"] = time.time() - t0
        print(f"[FAIL] {arch} x {shape_name} x {mesh_name}: {rec['error']}")
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    shd.clear_activation_policy()
    gc.collect()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="16x16", choices=["16x16", "2x16x16", "both"])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--act-constraints", action="store_true",
                    help="perf iteration: explicit activation sharding")
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    ap.add_argument("--cells", default="",
                    help="comma-separated arch:shape:mesh cells, in place of the product of "
                         "--arch, --shape and --mesh")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    if args.cells:
        cells = [(a, s, m == "2x16x16") for a, s, m in
                 (c.split(":") for c in args.cells.split(","))]
    else:
        archs = registry.ARCH_IDS if args.arch == "all" else [args.arch]
        shapes = [s.name for s in SHAPES] if args.shape == "all" else [args.shape]
        meshes = [False, True] if args.mesh == "both" else [args.mesh == "2x16x16"]
        cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes
                 if cell_applicable(registry.get_config(a), SHAPES_BY_NAME[s])[0]]

    n_ok = n_fail = 0
    for arch, sname, mp in sorted(cells, key=lambda c: c[2]):   # one world after the other
        rec = lower_cell(arch, sname, mp, out_dir, resume=not args.no_resume,
                         act_constraints=args.act_constraints, tag=args.tag)
        n_ok += int(rec.get("ok", False))
        n_fail += int(not rec.get("ok", False))
    from repro_torch.launch.mesh import destroy

    destroy()
    print(f"done: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
