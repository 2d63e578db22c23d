"""The port's data pipeline, pytree checkpoints, fault-tolerant training loop
and launcher against the JAX package on the CPU: the batches byte for byte,
checkpoints restored across the two packages in both directions (float32
training states; the bf16 restore that the JAX package cannot do), the
async writer, ``run_training_loop``'s checkpoint and preemption rules, and
``python -m repro_torch.launch.train --device cpu``."""
import dataclasses
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.checkpoint import checkpoint as jckpt
from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert, models
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tpipe
from repro_torch.runtime.fault_tolerance import (
    LoopConfig, PreemptionHandler, run_training_loop,
)
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILY_ARCHS = ["qwen3-14b", "qwen3-moe-30b-a3b", "rwkv6-1.6b", "zamba2-7b",
                "whisper-medium", "internvl2-2b"]


# -- data ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_batches_are_byte_identical_to_jax(arch):
    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    for host in (0, 1):
        jd = jpipe.DataConfig(vocab=jcfg.vocab, seq_len=24, global_batch=4, num_hosts=2,
                              host_id=host, seed=3)
        td = tpipe.DataConfig(**dataclasses.asdict(jd))
        assert td.host_batch == jd.host_batch == 2
        for step in (0, 7):
            want = jpipe.batch_for_model(jd, jcfg, step)
            got = tpipe.batch_for_model(td, tcfg, step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
                assert got[k].tobytes() == want[k].tobytes(), (arch, host, step, k)
            assert tpipe.token_batch(td, step).tobytes() == jpipe.token_batch(jd, step).tobytes()


# -- checkpoints -------------------------------------------------------------------

def _tree(rng):
    return {
        "a": rng.standard_normal((8, 16)).astype(np.float32),
        "nested": {"b": rng.standard_normal((4,)).astype(np.float32),
                   "c": np.int32(7)},
    }


def test_checkpoint_roundtrip_and_keep(tmp_path, rng):
    t1 = _tree(rng)
    for step in (10, 20, 30, 40):
        ckpt.save(tmp_path, step, t1, keep=2)
    assert ckpt.latest_step(tmp_path) == 40
    kept = sorted(p.name for p in pathlib.Path(tmp_path).iterdir())
    assert kept == ["step_00000030", "step_00000040"]
    restored, step = ckpt.restore(tmp_path, template=t1)
    assert step == 40
    np.testing.assert_array_equal(restored["a"], t1["a"])
    np.testing.assert_array_equal(restored["nested"]["b"], t1["nested"]["b"])
    assert restored["nested"]["c"] == 7
    flat, _ = ckpt.restore(tmp_path, step=30)
    assert sorted(flat) == ["a", "nested::b", "nested::c"]
    jflat, _ = jckpt.restore(tmp_path, step=30)          # the JAX package reads it too
    for k, v in jflat.items():
        np.testing.assert_array_equal(flat[k], v)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "empty")


def test_checkpoint_atomic_no_partial_reads(tmp_path, rng):
    t1 = _tree(rng)
    ckpt.save(tmp_path, 1, t1)
    # A stale tmp dir from a "crashed" writer is ignored and then swept.
    junk = pathlib.Path(tmp_path) / "step_00000002.tmp-dead"
    junk.mkdir()
    (junk / "garbage.npy").write_bytes(b"xx")
    assert ckpt.latest_step(tmp_path) == 1
    ckpt.save(tmp_path, 3, t1)
    assert not junk.exists()
    assert ckpt.latest_step(tmp_path) == 3


def test_async_checkpointer_copies_before_submit_returns(tmp_path):
    t = {"w": torch.arange(6, dtype=torch.float32), "s": torch.zeros((), dtype=torch.int32)}
    ac = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    for s in (5, 10):
        ac.submit(s, t)
        t["w"].add_(100.0)        # the next step's in-place update
    ac.close()
    assert ckpt.latest_step(tmp_path) == 10
    assert [r["step"] for r in ac.records] == [5, 10]
    assert all(r["bytes"] == 28 and r["host_copy_s"] >= 0 and r["write_s"] >= 0
               for r in ac.records)
    flat, _ = ckpt.restore(tmp_path, step=5)
    np.testing.assert_array_equal(flat["w"], np.arange(6, dtype=np.float32))
    flat, _ = ckpt.restore(tmp_path, step=10)
    np.testing.assert_array_equal(flat["w"], np.arange(6, dtype=np.float32) + 100.0)


def test_async_checkpointer_surfaces_write_errors(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ac = ckpt.AsyncCheckpointer(blocker, keep=1)
    ac.submit(1, {"w": np.zeros(2, np.float32)})
    with pytest.raises(OSError):
        ac.close()


def _jax_state(arch: str, seed: int = 0):
    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    params = jmodels.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, params, jopt.init_state(params)


def _batch_fn(cfg, n: int = 2):
    data = jpipe.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=n)
    return lambda i: jpipe.batch_for_model(data, cfg, i)


@pytest.mark.parametrize("arch", ["qwen3-14b", "zamba2-7b"])
def test_jax_training_state_restores_in_the_port_and_trains_on(tmp_path, arch):
    """A float32 training state checkpointed by the JAX package after 2
    steps restores exactly into a port module and optimizer state
    (``restore(template=...)``, layers unstacked), and 2 more steps there
    equal 2 more steps in JAX; the port's checkpoint of the result restores
    in the JAX package with ``template=`` (layers stacked again)."""
    jcfg, tcfg, jparams, jstate = _jax_state(arch)
    oc = jopt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jts.make_train_step(jcfg, oc))
    batch = _batch_fn(jcfg)
    for i in range(2):
        jparams, jstate, _ = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch(i).items()})
    jckpt.save(tmp_path / "jax", 2, {"params": jparams, "opt_state": jstate})

    tparams = models.init(tcfg, seed=9, device="cpu")
    template = {"params": tparams, "opt_state": topt.init_state(tparams)}
    state, step = ckpt.restore(tmp_path / "jax", template=template)
    assert step == 2 and state["params"] is tparams
    tstate = state["opt_state"]
    assert int(tstate["step"]) == 2 and tstate["step"].dtype == torch.int32
    for want, got in ((jax.tree_util.tree_map(np.asarray, jparams),
                       convert.params_to_numpy(tparams, tcfg)),
                      (jax.tree_util.tree_map(np.asarray, jstate),
                       convert.opt_state_to_numpy(tstate))):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)

    tstep = make_train_step(tcfg, topt.OptimizerConfig(**dataclasses.asdict(oc)))
    for i in range(2, 4):
        b = batch(i)
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tparams, tstate, tm = tstep(tparams, tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    jax.tree_util.tree_map(lambda g, w: np.testing.assert_allclose(g, w, rtol=0, atol=1e-4),
                           convert.params_to_numpy(tparams, tcfg),
                           jax.tree_util.tree_map(np.asarray, jparams))

    ckpt.save(tmp_path / "port", 4, {"params": tparams, "opt_state": tstate})
    restored, step = jckpt.restore(tmp_path / "port", template={"params": jparams,
                                                                "opt_state": jstate})
    assert step == 4
    jax.tree_util.tree_map(np.testing.assert_array_equal, restored["params"],
                           convert.params_to_numpy(tparams, tcfg))
    jax.tree_util.tree_map(np.testing.assert_array_equal, restored["opt_state"],
                           convert.opt_state_to_numpy(tstate))


def test_params_and_opt_state_convert_both_ways():
    for arch in FAMILY_ARCHS:
        jcfg, tcfg, jparams, jstate = _jax_state(arch, seed=4)
        tree = jax.tree_util.tree_map(np.asarray, jparams)
        back = convert.params_to_numpy(convert.params_from_numpy(tree, tcfg, device="cpu"), tcfg)
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree), arch
        jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
        st = jax.tree_util.tree_map(np.asarray, jstate)
        st["m"] = jax.tree_util.tree_map(lambda x: x + 1.5, st["m"])
        tst = convert.opt_state_from_numpy(st, device="cpu")
        assert sorted(tst["m"]) == sorted(n for n, _ in
                                          models.init(tcfg, device="meta").named_parameters())
        jax.tree_util.tree_map(np.testing.assert_array_equal, convert.opt_state_to_numpy(tst), st)
    with pytest.raises(ValueError, match="do not make the family's tree"):
        convert.params_to_numpy(models.init(treg.get_smoke("qwen3-14b"), device="cpu"),
                                treg.get_smoke("rwkv6-1.6b"))


def test_reference_fault_jax_restore_cannot_cast_bfloat16_leaves(tmp_path):
    """The JAX package cannot restore its own bf16 checkpoints: ``save`` runs
    ``np.save`` on an ml_dtypes bfloat16 array, which writes ``<V2`` records,
    and ``restore(template=...)`` then fails to cast them.  The port reads
    the same directory by the manifest's dtype, bit for bit, and writes its
    own bf16 leaves in the same layout."""
    jcfg = dataclasses.replace(jreg.get_smoke("qwen3-14b"), dtype="bfloat16")
    tcfg = dataclasses.replace(treg.get_smoke("qwen3-14b"), dtype="bfloat16")
    jparams = jmodels.init(jax.random.PRNGKey(1), jcfg)
    jckpt.save(tmp_path / "jax", 1, {"params": jparams})
    with pytest.raises(ValueError, match="No cast function available"):
        jckpt.restore(tmp_path / "jax", template={"params": jparams})

    tparams = models.init(tcfg, seed=2, device="cpu")
    restored, step = ckpt.restore(tmp_path / "jax", template={"params": tparams})
    assert step == 1 and tparams.embed.dtype == torch.bfloat16
    want = jax.tree_util.tree_map(np.asarray, jparams)
    got = convert.params_to_numpy(tparams, tcfg)
    jax.tree_util.tree_map(lambda g, w: np.testing.assert_array_equal(
        g.view(np.uint16), w.view(np.uint16)) if w.dtype.name == "bfloat16"
        else np.testing.assert_array_equal(g, w), got, want)
    flat, _ = ckpt.restore(tmp_path / "jax")
    assert flat["params::embed"].dtype == torch.bfloat16        # no template: torch bf16
    assert torch.equal(flat["params::embed"], tparams.embed.detach())

    ckpt.save(tmp_path / "port", 1, {"params": tparams})
    manifests = [json.loads((d / "step_00000001" / "manifest.json").read_text())["leaves"]
                 for d in (tmp_path / "jax", tmp_path / "port")]
    assert manifests[0].keys() == manifests[1].keys()
    for k, meta in manifests[0].items():
        other = manifests[1][k]
        assert (meta["shape"], meta["dtype"]) == (other["shape"], other["dtype"]), k
        a = (tmp_path / "jax" / "step_00000001" / meta["file"]).read_bytes()
        b = (tmp_path / "port" / "step_00000001" / other["file"]).read_bytes()
        assert a == b, k                                   # the same .npy bytes


# -- the training loop ---------------------------------------------------------------

def test_training_loop_checkpoints_and_preempts(tmp_path):
    cfg = treg.get_smoke("stablelm-12b")
    params = models.init(cfg, seed=0, device="cpu")
    opt = topt.init_state(params)
    step_fn = make_train_step(cfg, topt.OptimizerConfig(lr=1e-3, warmup_steps=1))
    rng = np.random.default_rng(0)

    def batch_fn(step):
        return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))}

    pre = PreemptionHandler(install=False)
    losses = []

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        if step == 5:
            pre.requested = True  # simulated SIGTERM

    state, stopped = run_training_loop(
        step_fn, (params, opt), batch_fn, tmp_path,
        LoopConfig(total_steps=100, checkpoint_every=3),
        preemption=pre, on_metrics=on_metrics,
    )
    assert stopped == 6                      # checkpoint-and-exit at the boundary
    assert ckpt.latest_step(tmp_path) == 6   # the preemption checkpoint committed
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003", "step_00000006"]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert int(state[1]["step"]) == 6
    restored, _ = ckpt.restore(tmp_path, template={
        "params": models.init(cfg, seed=5, device="cpu"),
        "opt_state": topt.init_state(models.init(cfg, seed=5, device="cpu"))})
    for n, p in restored["params"].named_parameters():
        assert torch.equal(p, dict(state[0].named_parameters())[n]), n


def test_training_loop_resumes_to_the_uninterrupted_state(tmp_path):
    """Preempted at step 3 and resumed from its checkpoint to step 6, the
    run ends where an uninterrupted 6-step run ends, bit for bit."""
    cfg = treg.get_smoke("qwen3-14b")
    data = tpipe.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)

    def batch_fn(i):
        return {k: torch.from_numpy(v) for k, v in tpipe.batch_for_model(data, cfg, i).items()}

    def fresh():
        p = models.init(cfg, seed=0, device="cpu")
        return p, topt.init_state(p)

    step_fn = make_train_step(cfg, topt.OptimizerConfig(lr=1e-3, warmup_steps=1),
                              microbatches=2)
    (full, full_opt), n = run_training_loop(step_fn, fresh(), batch_fn, tmp_path / "a",
                                            LoopConfig(total_steps=6, checkpoint_every=3))
    assert n == 6
    pre = PreemptionHandler(install=False)

    def on_metrics(step, m):
        pre.requested = step == 2

    _, n = run_training_loop(step_fn, fresh(), batch_fn, tmp_path / "b",
                             LoopConfig(total_steps=6, checkpoint_every=3), preemption=pre,
                             on_metrics=on_metrics)
    assert n == 3 and ckpt.latest_step(tmp_path / "b") == 3
    params, opt = fresh()
    state, start = ckpt.restore(tmp_path / "b", template={"params": params, "opt_state": opt})
    (params, opt), n = run_training_loop(step_fn, (params, state["opt_state"]), batch_fn,
                                         tmp_path / "b", LoopConfig(total_steps=6,
                                                                    checkpoint_every=3),
                                         start_step=start)
    assert n == 6
    for (name, a), b in zip(params.named_parameters(), full.parameters()):
        assert torch.equal(a, b), name
    for k in ("m", "v"):
        for name in opt[k]:
            assert torch.equal(opt[k][name], full_opt[k][name]), (k, name)


def test_launch_train_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--smoke",
         "--arch", "qwen3-14b", "--steps", "4", "--ckpt", str(tmp_path)],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("step 0: loss ") and " lr " in lines[0]
    assert lines[-1] == f"done at step 4; checkpoints in {tmp_path}"
    assert ckpt.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003", "step_00000004"]
    manifest = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
    assert manifest["leaves"]["params::layers::attn::wq"]["shape"][0] == 2
