"""The port's ``repro_torch.core.sparta`` against the JAX package's: the
partition hash on tensors, TLB geometry, and the Fig 3 timelines."""
import dataclasses

import pytest
import torch

pytest.importorskip("jax")  # the parity tests need the JAX package (CPU only)
import jax.numpy as jnp

from repro.core import sparta as js
from repro_torch.core import sparta as ts

VPNS = (0, 1, 5, 127, 2**20 + 3, 2**25 - 1)
PARTS = (1, 2, 4, 8, 32, 128)

# The reference values, from the JAX functions on int32 scalars (the call
# pattern of tests/test_core_sparta.py), computed once per process at
# collection.  A side effect is deliberate: every xdist worker imports this
# module before it runs any test, so JAX's scalar int32 `%` and `//` are
# compiled before test_core_sparta.py's hypothesis property test runs; that
# test's first example would otherwise pay the compile (~0.15 s on an idle
# machine) inside its 200 ms deadline, and miss it on a loaded one.
JAX_HASH = {(v, p): (int(js.mem_partition_index_hash(jnp.int32(v), p)),
                     int(js.partition_local_vpn(jnp.int32(v), p)))
            for v in VPNS for p in PARTS}


@pytest.mark.parametrize("P", PARTS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_partition_hash_matches_jax(P, dtype):
    vpn = torch.tensor(VPNS, dtype=dtype)
    p = ts.mem_partition_index_hash(vpn, P)
    local = ts.partition_local_vpn(vpn, P)
    assert p.dtype == local.dtype == dtype
    assert [(int(a), int(b)) for a, b in zip(p, local)] == [JAX_HASH[(v, P)] for v in VPNS]
    assert torch.equal(local * P + p, vpn)   # (p, local) reconstructs the vpn


@pytest.mark.parametrize("entries,ways", [(128, 4), (2, 4), (4, 4), (1, 1), (2048, 16)])
def test_tlb_config_geometry_matches_jax(entries, ways):
    a, b = js.TLBConfig(entries=entries, ways=ways), ts.TLBConfig(entries=entries, ways=ways)
    assert (a.sets, a.effective_ways) == (b.sets, b.effective_ways)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for bad in [(0, 4), (4, 0), (12, 8)]:
        with pytest.raises(ValueError):
            js.TLBConfig(*bad)
        with pytest.raises(ValueError):
            ts.TLBConfig(*bad)


@pytest.mark.parametrize("kw", [{}, {"n_sockets": 2}, {"l_dram": 99.0, "l_noc": 10.0}])
def test_latencies_and_timelines_match_jax(kw):
    a, b = js.SystemLatencies(**kw), ts.SystemLatencies(**kw)
    assert a.t_net == b.t_net
    assert js.conventional_timelines(a) == ts.conventional_timelines(b)
    assert js.sparta_timelines(a) == ts.sparta_timelines(b)
    t = ts.TranslationConfig(num_partitions=8, accel_tlb=ts.TLBConfig(entries=16))
    assert t.total_entries == js.TranslationConfig(
        num_partitions=8, accel_tlb=js.TLBConfig(entries=16)).total_entries
