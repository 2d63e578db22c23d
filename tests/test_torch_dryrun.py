"""The dry run (``repro_torch.launch.dryrun``) against the JAX package's
placements and counts, on the CPU:

* every applicable (arch x shape) cell on both production meshes, no world:
  each parameter, optimizer-state and input leaf's per-device shape under
  the port's placements (DTensor's rule, :func:`dryrun.shard_shape`) equals
  ``NamedSharding(AbstractMesh(...), spec).shard_shape(...)``; where JAX
  refuses a leaf (a mesh axis does not divide its dim), the port lists it
  in ``uneven``;
* three cells at full width in one subprocess on a fake 256/512-rank world
  (qwen3-14b train_4k 16x16, qwen3-moe-30b-a3b decode_32k 2x16x16, zamba2-7b
  long_500k 16x16, whose partitions span every axis): each record ``ok``,
  the DTensor local shapes equal :func:`dryrun.shard_shape`'s,
  ``param_count`` and ``input_bytes`` equal the JAX package's, collective
  bytes and FLOPs non-zero, and the decode cells' collectives all smaller
  than one layer's local pool shard; the train cell's peak within 70 GiB
  (an H100's 79.1 GiB less ~10% for what the estimate leaves out);
* the guard of the sharded train and prefill paths at production scale:
  qwen3-14b train_4k, qwen3-moe-30b-a3b train_4k and qwen3-moe-30b-a3b
  prefill_32k on 16x16 in one subprocess, each cut to 2 layers and
  otherwise at full width, batch, sequence and vocabulary: each peak within
  10 GiB, and no tensor live at the peak holding the whole vocabulary for
  more than a data shard's rows, or the whole batch of hidden states.
"""
import functools
import json
import math

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

import _torch_worlds as W
from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.distributed import sharding as jshd
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES_BY_NAME as TSHAPES
from repro_torch.convert import stack_index
from repro_torch.launch import dryrun

CELLS = [("qwen3-14b", "train_4k", "16x16"), ("qwen3-moe-30b-a3b", "decode_32k", "2x16x16"),
         ("zamba2-7b", "long_500k", "16x16")]
CUT_CELLS = [("qwen3-14b", "train_4k", "16x16"), ("qwen3-moe-30b-a3b", "train_4k", "16x16"),
             ("qwen3-moe-30b-a3b", "prefill_32k", "16x16")]
CUT_LAYERS = 2
GiB = 2 ** 30
CARD_BOUND, CUT_BOUND = 70 * GiB, 10 * GiB
# The dry run with every config cut to CUT_LAYERS layers, widths untouched.
CUT_RUN = """
import dataclasses, sys
from repro_torch.configs import registry
from repro_torch.launch import dryrun
real = registry.get_config
registry.get_config = lambda arch: dataclasses.replace(real(arch), num_layers=%d)
sys.exit(dryrun.main(sys.argv[1:]))
"""


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    params = jreg.abstract_params(jreg.get_config(arch))
    return params, {".".join(str(k.key) for k in path): leaf
                    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _jax_mesh(multi_pod):
    shape, axes = dryrun.MESHES[multi_pod]
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


def _jax_shard(mesh, spec, shape):
    """JAX's per-device shape of a leaf, or None where JAX refuses it."""
    try:
        return tuple(NamedSharding(mesh, spec).shard_shape(tuple(shape)))
    except ValueError:
        return None


def _jax_leaves(arch, shape_name, multi_pod):
    """{leaf path: (global shape, per-device shape or None)}, JAX's."""
    cfg, shape = jreg.get_config(arch), jbase.SHAPES_BY_NAME[shape_name]
    params, flat = _jax_params(arch)
    mesh, sizes = _jax_mesh(multi_pod)
    mode = "serve" if shape.lowers_serve_step else "train"
    pspecs = jshd.param_specs(params, cfg, mode=mode, multi_pod=multi_pod)
    spec_of = {".".join(str(k.key) for k in path): spec for path, spec in
               jax.tree_util.tree_flatten_with_path(pspecs,
                                                    is_leaf=lambda x: isinstance(x, P))[0]}
    out = {f"params/{k}": (leaf.shape, _jax_shard(mesh, spec_of[k], leaf.shape))
           for k, leaf in flat.items()}
    if shape.lowers_serve_step:
        axes = jshd.serve_partition_axes(shape, multi_pod=multi_pod)
        n = math.prod(sizes[a] for a in ((axes,) if isinstance(axes, str) else axes))
        inputs = jreg.input_specs(cfg, shape, num_partitions=n)
        ispecs = jshd.serve_input_specs(cfg, shape, multi_pod=multi_pod)
    else:
        inputs = jreg.input_specs(cfg, shape)
        ispecs = jshd.batch_specs(cfg, shape, multi_pod=multi_pod)
    out.update({f"inputs/{k}": (v.shape, _jax_shard(mesh, ispecs[k], v.shape))
                for k, v in inputs.items()})
    return out


def _cells():
    return [(a, s.name, mp) for a, s in jreg.all_cells() for mp in (False, True)]


@pytest.mark.parametrize("arch,shape,multi_pod", _cells())
def test_local_shapes_equal_jax_shard_shapes(arch, shape, multi_pod):
    want = _jax_leaves(arch, shape, multi_pod)
    got = dryrun.local_shapes(treg.get_config(arch), TSHAPES[shape], multi_pod)
    checked = 0
    for key, (local, uneven) in got.items():
        kind, _, name = key.partition("/")
        if kind == "opt":
            if name == "step":
                assert local == () and not uneven
                continue
            name = name.partition("/")[2]
            kind = "params"
        if kind == "params":
            leaf, idx = stack_index(name)
            gshape, jlocal = want[f"params/{leaf}"]
        else:
            gshape, jlocal = want[key]
            idx = ()
        if jlocal is None:
            assert uneven, (key, gshape)
        else:
            assert not uneven and local == jlocal[len(idx):], (key, local, jlocal)
            checked += 1
    assert checked > 0
    # Every JAX leaf has its port leaves.
    names = {stack_index(k.partition("/")[2])[0] for k in got if k.startswith("params/")}
    assert {k.partition("/")[2] for k in want if k.startswith("params/")} == names
    assert {k for k in want if k.startswith("inputs/")} == \
        {k for k in got if k.startswith("inputs/")}


def test_shard_shape_follows_dtensor_chunks():
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert dryrun.shard_shape((5120, 17408), (("pod", "data"), "model"), sizes) == \
        ((160, 1088), False)
    assert dryrun.shard_shape((17, 4), ("model", None), sizes) == ((2, 4), True)
    assert dryrun.shard_shape((1, 8), (None, ("data", "model")), sizes) == ((1, 1), True)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    cells = ",".join(":".join(c) for c in CELLS)
    run = W.run_world([W.sys.executable, "-m", "repro_torch.launch.dryrun", "--cells", cells,
                       "--out", str(out), "--no-resume"], 420, W.env())
    recs = {}
    for arch, shape, mesh in CELLS:
        path = out / f"{arch}__{shape}__{mesh}.json"
        if path.exists():
            recs[(arch, shape, mesh)] = json.loads(path.read_text())
    return run, recs


def test_the_run_exits_0(records):
    run, recs = records
    assert run.returncode == 0 and len(recs) == len(CELLS), run.stderr[-3000:]
    assert "done: 3 ok, 0 failed" in run.stdout


def _record(records, cell):
    run, recs = records
    assert cell in recs, f"no record (rc {run.returncode}):\n{run.stdout[-2000:]}\n" \
                         f"{run.stderr[-3000:]}"
    rec = recs[cell]
    assert rec["ok"], rec.get("traceback", rec)
    return rec


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_full_width_cell_runs_on_a_fake_world(records, cell):
    rec = _record(records, cell)
    arch, shape, mesh = cell
    assert rec["chips"] == (512 if mesh == "2x16x16" else 256)
    assert rec["shard_shapes_checked"] > 0
    assert rec["flops"] > 0 and rec["flops_scope"] == "device"
    assert sum(rec["collective_bytes"].values()) > 0
    assert sum(rec["collective_count"].values()) > 0
    mem = rec["memory"]
    assert mem["peak_live_bytes"] >= mem["argument_bytes"] > 0 and mem["propagation_excluded"]


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_counts_equal_jax(records, cell):
    rec = _record(records, cell)
    arch, shape_name, mesh = cell
    cfg, shape = jreg.get_config(arch), jbase.SHAPES_BY_NAME[shape_name]
    params, _ = _jax_params(arch)
    assert rec["param_count"] == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    n = 1
    if shape.lowers_serve_step:
        _, sizes = _jax_mesh(mesh == "2x16x16")
        axes = jshd.serve_partition_axes(shape, multi_pod=mesh == "2x16x16")
        n = math.prod(sizes[a] for a in ((axes,) if isinstance(axes, str) else axes))
    specs = jreg.input_specs(cfg, shape, num_partitions=n) if shape.lowers_serve_step \
        else jreg.input_specs(cfg, shape)
    assert rec["input_bytes"] == sum(int(np.prod(v.shape)) * v.dtype.itemsize
                                     for v in jax.tree.leaves(specs))


@pytest.mark.parametrize("cell", [c for c in CELLS if c[1] != "train_4k"],
                         ids=lambda c: "-".join(c))
def test_decode_cells_move_no_pool_sized_collective(records, cell):
    rec = _record(records, cell)
    assert rec["pool_layer_shard_bytes"] > 0
    assert rec["pool_sized_collectives"] == 0
    assert rec["largest_collective_bytes"] < rec["pool_layer_shard_bytes"]


def test_step_trace_marks_propagation_excluded(monkeypatch):
    with dryrun.StepTrace() as trace:
        pass
    assert trace.propagation_excluded
    # A torch without the propagator's methods leaves the flag down, and
    # lower_cell then fails the cell rather than count propagation tensors.
    monkeypatch.setattr(dryrun, "_PROPAGATION", ("no_such_method",))
    with dryrun.StepTrace() as trace:
        pass
    assert not trace.propagation_excluded


def test_broadcast_is_a_kind_of_its_own():
    assert dryrun._KINDS["broadcast"] == "broadcast" and "broadcast" in dryrun.COLLECTIVES
    assert dryrun.COLLECTIVES[:5] == ("all-gather", "all-reduce", "reduce-scatter",
                                      "all-to-all", "collective-permute")


def test_decode_records_name_the_scatter_write(records):
    rec = _record(records, CELLS[1])
    assert rec["kv_write_mode"] == "scatter"
    assert "kv_write_mode" not in _record(records, CELLS[0])


def test_full_width_train_cell_fits_a_card(records):
    rec = _record(records, CELLS[0])
    assert rec["memory"]["peak_live_bytes"] <= CARD_BOUND, rec["memory"]["peak_top"]


@pytest.fixture(scope="module")
def cut_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_cut")
    cells = ",".join(":".join(c) for c in CUT_CELLS)
    run = W.run_world([W.sys.executable, "-c", CUT_RUN % CUT_LAYERS, "--cells", cells,
                       "--out", str(out), "--no-resume"], 300, W.env())
    recs = {}
    for arch, shape, mesh in CUT_CELLS:
        path = out / f"{arch}__{shape}__{mesh}.json"
        if path.exists():
            recs[(arch, shape, mesh)] = json.loads(path.read_text())
    return run, recs


def _cut(cut_records, cell):
    """(record, the uncut config, the shape); the record's parameters are
    the cut model's."""
    rec = _record(cut_records, cell)
    cfg = treg.get_config(cell[0])
    assert rec["param_count"] < sum(p.numel() for p in treg.abstract_params(cfg).parameters())
    return rec, cfg, TSHAPES[cell[1]]


@pytest.mark.parametrize("cell", CUT_CELLS, ids=["-".join(c) for c in CUT_CELLS])
def test_cut_cell_fits_within_10_gib(cut_records, cell):
    rec, _, _ = _cut(cut_records, cell)
    assert rec["memory"]["peak_live_bytes"] <= CUT_BOUND, rec["memory"]["peak_top"]


@pytest.mark.parametrize("cell", CUT_CELLS, ids=["-".join(c) for c in CUT_CELLS])
def test_cut_cell_keeps_the_vocabulary_sharded(cut_records, cell):
    rec, cfg, shape = _cut(cut_records, cell)
    rows = shape.global_batch // 16            # a data shard's rows
    whole = [t for t in rec["memory"]["peak_top"]
             if cfg.vocab in t["shape"] and t["shape"][0] > rows]
    assert not whole, whole


@pytest.mark.parametrize("cell", CUT_CELLS, ids=["-".join(c) for c in CUT_CELLS])
def test_cut_cell_holds_no_whole_batch_of_hidden_states(cut_records, cell):
    rec, cfg, shape = _cut(cut_records, cell)
    whole = [t for t in rec["memory"]["peak_top"]
             if t["shape"] and t["shape"][0] in (shape.global_batch,
                                                  shape.global_batch * shape.seq_len)
             and t["shape"][-1] == cfg.d_model]
    assert not whole, whole
