"""The port's serving engine and paged-KV manager against the JAX package:
``SpartaEngine`` generates the same tokens as the JAX engine on
tests/test_system.py's engine config and prompts (continuous batching and a
fork with copy-on-write included), with the JAX weights carried across by
``convert.params_from_numpy``; the port's ``SpartaKVManager`` emits the same
events and tables as the JAX one under tests/test_paged_kv.py's operations."""
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import paged_kv as jkv
from repro.models import transformer as jtfm
from repro.serve.engine import SpartaEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.core import paged_kv as tkv
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttfm
from repro_torch.serve.engine import SpartaEngine

DENSE = ["stablelm-12b", "qwen3-14b", "gemma-7b", "starcoder2-7b"]


def _engine_models(arch: str, seed: int):
    """tests/test_system.py's engine config (the smoke config, float32,
    4-token pages) in both packages, with the same weights."""
    jcfg = dataclasses.replace(jreg.get_smoke(arch), dtype="float32", kv_page_size=4)
    tcfg = dataclasses.replace(treg.get_smoke(arch), dtype="float32", kv_page_size=4)
    params = jtfm.init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                                        device="cpu")
    return jcfg, tcfg, params, tparams


def _serve(engine, fork: bool):
    """tests/test_system.py's continuous-batching traffic (three requests,
    two batch slots), then a fork of the first with copy-on-write."""
    r1 = engine.submit([1, 2, 3, 4, 5], max_new_tokens=4)
    engine.submit([7, 8, 9], max_new_tokens=4)
    engine.submit([4, 4, 4, 4], max_new_tokens=3)         # waits for a slot
    engine.run_to_completion()
    engine.kv.check_invariants()
    if fork:
        free = sum(engine.kv.num_free(p) for p in range(2))
        engine.fork_request(r1, max_new_tokens=3)
        assert sum(engine.kv.num_free(p) for p in range(2)) == free   # zero-copy fork
        engine.run_to_completion()
        engine.kv.check_invariants()
    return {rid: list(r.generated) for rid, r in engine.finished.items()}


@pytest.mark.parametrize("arch", DENSE)
def test_engine_tokens_equal_jax_engine_with_batching_and_fork(arch):
    jcfg, tcfg, params, tparams = _engine_models(arch, seed=1)
    kw = dict(num_partitions=2, slots_per_partition=32, max_batch=2)
    want = _serve(JaxEngine(jcfg, params, **kw), fork=True)
    port = SpartaEngine(tcfg, tparams, device="cpu", **kw)
    got = _serve(port, fork=True)
    assert got == want
    assert len(got) == 4 and [len(got[r]) for r in range(4)] == [4, 4, 3, 3]
    assert port.k_pool.dtype == torch.float32 and port.k_pool.shape[1] == 64


def test_engine_matches_direct_greedy_decode_and_jax():
    """tests/test_system.py's oracle: the engine's tokens equal a greedy
    decode by full forward passes, in the port, and the JAX engine's."""
    jcfg, tcfg, params, tparams = _engine_models("stablelm-12b", seed=0)
    prompt, n_new = [3, 14, 15, 9, 2, 6], 6
    toks = list(prompt)
    for _ in range(n_new):
        logits, _ = ttfm.forward(tparams, torch.tensor([toks]), tcfg, kernel_mode="reference")
        toks.append(int(torch.argmax(logits[0, -1])))
    kw = dict(num_partitions=2, slots_per_partition=32, max_batch=2)
    eng = SpartaEngine(tcfg, tparams, device="cpu", **kw)
    rid = eng.submit(prompt, max_new_tokens=n_new)
    eng.run_to_completion()
    jeng = JaxEngine(jcfg, params, **kw)
    jrid = jeng.submit(prompt, max_new_tokens=n_new)
    jeng.run_to_completion()
    assert eng.finished[rid].generated == toks[len(prompt):] == jeng.finished[jrid].generated


def test_prefill_pages_equal_the_pages_decode_writes():
    """tests/test_system.py's check in the port: the KV pages prefill emits
    equal the pages decode writes token by token (in place)."""
    _, tcfg, _, tparams = _engine_models("qwen3-14b", seed=2)
    T, page = 8, 4
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, tcfg.vocab, (1, T))
                              .astype(np.int32))
    _, kpages, _ = ttfm.prefill_with_kv(tparams, tokens, tcfg, kernel_mode="reference")
    n_pages = T // page
    shape = (tcfg.num_layers, n_pages, page, tcfg.num_kv_heads, tcfg.head_dim)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    table = torch.arange(n_pages, dtype=torch.int32)[None]
    for t in range(T):
        ttfm.decode_step(tparams, tokens[:, t], tcfg, kp, vp, table,
                         torch.full((1,), t + 1, dtype=torch.int32), kernel_mode="reference")
    got = kp.reshape(tcfg.num_layers, -1, tcfg.num_kv_heads, tcfg.head_dim)[:, :T]
    want = kpages[:, 0].reshape(tcfg.num_layers, -1, tcfg.num_kv_heads, tcfg.head_dim)[:, :T]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _kv_ops(seed: int, n_ops: int = 40):
    rnd = random.Random(seed)
    return [(rnd.choice(["new", "append", "fork", "free"]), rnd.random(), rnd.randint(1, 30))
            for _ in range(n_ops)]


def _drive(mod, ops, P=4, S=64, page=8):
    """tests/test_paged_kv.py's random operation sequence; returns what every
    call said, the tables and the free counts.  Invariants are checked until
    the pool first runs out: an append that exhausts a partition keeps the
    pages it got but not the new length, in both packages."""
    m = mod.SpartaKVManager(mod.PagedKVConfig(num_partitions=P, slots_per_partition=S,
                                              page_size=page))
    live, log, exhausted = [], [], False
    for op, r, n in ops:
        try:
            if op == "new" or not live:
                live.append(m.new_sequence())
                log.append(("new", live[-1]))
            elif op == "append":
                sid = live[int(r * len(live))]
                log.append(("append", sid, m.append_tokens(sid, n)))
            elif op == "fork":
                live.append(m.fork(live[int(r * len(live))]))
                log.append(("fork", live[-1]))
            else:
                sid = live.pop(int(r * len(live)))
                m.free_sequence(sid)
                log.append(("free", sid))
        except MemoryError:
            log.append(("exhausted",))
            exhausted = True
        if not exhausted:
            m.check_invariants()
    pages = max([len(m.seq_pages(s)) for s in live] + [1])
    return (log, m.global_block_table(live, pages).tolist(),
            m.local_block_tables(live, pages).tolist(), m.context_lengths(live).tolist(),
            [m.num_free(p) for p in range(P)])


@pytest.mark.parametrize("seed", range(6))
def test_paged_kv_manager_equals_jax(seed):
    ops = _kv_ops(seed)
    assert _drive(tkv, ops) == _drive(jkv, ops)
    small = _kv_ops(seed + 100, 80)              # a pool small enough to run out
    got = _drive(tkv, small, P=2, S=6, page=4)
    assert got == _drive(jkv, small, P=2, S=6, page=4)
    assert ("exhausted",) in got[0]


def test_launcher_serves_on_the_cpu(capsys):
    assert tserve.main(["--device", "cpu", "--requests", "3", "--max-new", "4",
                        "--arch", "gemma-7b"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("3 requests, 12 tokens") and "on CPU" in out
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--arch", "rwkv6-1.6b"])
