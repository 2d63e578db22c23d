"""The port's Fig 2, 7, 8 and 9 drivers on the CPU at a small size against
the JAX package's simulators, CPI model and timelines on the same traces.

Hit counts must be equal; MPKI, miss ratios, speedups and claim values come
from identical integer counts through identical float64 arithmetic, so they
agree to rtol 1e-12 (in practice exactly); Fig 7 is arithmetic and must be
exactly equal.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")  # the parity tests need the JAX package (CPU only)
from benchmarks import fig2_pagewalk as jfig2
from benchmarks import fig8_multiprog as jfig8
from benchmarks import fig9_accel_tlb as jfig9
from repro.core import cpi as jcpi
from repro.core import sparta as jsparta
from repro.core import tlbsim as jtlbsim
from repro.core import traces as jtraces
from repro.core.sweep import TLBSweepSpec as JSpec
from repro.core.sweep import sweep_system as jsweep_system
from repro.core.sweep import sweep_tlb as jsweep_tlb
from repro.core.tlbsim import SystemSimConfig as JSystemSimConfig
from repro_torch.bench import fig2, fig7, fig8, fig9

RTOL = 1e-12
W4 = ("bst_external", "bst_internal", "hash_table", "skip_list")


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float),
                               rtol=RTOL, atol=0, err_msg=what)


def test_tables_are_the_jax_drivers():
    def same(a, b):
        return dataclasses.astuple(a) == dataclasses.astuple(b)

    assert fig2.FOOTPRINTS_GB == jfig2.FOOTPRINTS_GB and same(fig2.TLB, jfig2.TLB)
    assert fig8.PARTS == jfig8.PARTS and same(fig8.TLB, jfig8.TLB)
    assert fig9.ENTRIES == jfig9.ENTRIES and fig9.P == jfig9.P
    assert same(fig9.MEM_TLB, jfig9.MEM_TLB) and same(fig9.CACHE, jfig9.CACHE)


def test_fig7_equals_jax_exactly():
    res = fig7.run(verbose=False)
    reductions = {}
    for row, sockets in zip(res["rows"], (2, 8)):
        lat = jsparta.SystemLatencies(n_sockets=sockets)
        conv = jsparta.conventional_timelines(lat)[3]
        sp = jsparta.sparta_timelines(lat)[3]
        reductions[sockets] = conv / sp
        assert row == [f"{sockets}-socket", float(conv), float(sp), float(sp / conv)]
        assert res["cycles"][f"{sockets}socket"] == {
            "conventional_cycles": float(conv), "sparta_cycles": float(sp),
            "normalized": float(sp / conv)}
    lat = jsparta.SystemLatencies()
    claims = res["claims"]
    assert [c.name for c in claims] == ["C5a", "C5b"]
    assert claims[0].value == float(res["rows"][1][2])
    assert claims[0].band == (0.0, lat.l_dram + 2 * lat.l_tlb + 1)
    assert claims[1].value == reductions[8] / reductions[2]
    assert all(c.ok for c in claims)


def test_fig2_small_matches_jax():
    n_ops = 30
    res = fig2.run(device="cpu", n_ops=n_ops, verbose=False)
    curves = {}
    for w in W4:
        mpki = []
        for gb in jfig2.FOOTPRINTS_GB:
            tr = jtraces.generate(w, n_ops=n_ops, footprint_bytes=gb << 30,
                                  zipf_keys=1.4 if w == "hash_table" else 0.0,
                                  max_accesses=1_400_000)
            np.testing.assert_array_equal(res["lines"][f"{w}/{gb}"], tr.lines)
            want = jtlbsim.simulate_tlb(tr.vpns(12), jfig2.TLB)
            got = res["hits"][f"{w}/{gb}"]
            np.testing.assert_array_equal(got.hits.numpy(), want.hits)
            assert got.n_warm == want.n_warm
            mpki.append(1000.0 * want.miss_ratio / tr.instr_per_access)
        curves[w] = mpki
        _close(res["curves"][w], mpki, f"{w} mpki")
    growth = [curves[w][-1] / max(curves[w][0], 1e-9) for w in W4]
    mono = float(np.mean([np.mean(np.diff(curves[w]) >= -1e-6) for w in W4]))
    assert res["monotone_frac"] == mono
    (c1,) = res["claims"]
    assert c1.name == "C1"
    _close([c1.value], [float(np.mean(growth))], "C1")


def test_fig8_mix_equals_jax_in_one_process():
    """Both drivers salt the seeds with this process's ``hash(w) % 97``, so
    their mixes agree here; given salts, the port reproduces any process's."""
    for name, spec in fig8.MIXES.items():
        if name in ("bst_e_x1", "+bsti+skip"):
            inter, who, names = fig8._mix(20, fig8.SEED, spec)
            jinter, jwho, jnames = jfig8._mix(20, fig8.SEED, spec)
            np.testing.assert_array_equal(inter, jinter)
            np.testing.assert_array_equal(who, jwho)
            assert names == jnames
    spec = fig8.MIXES["+hash_x4"]
    shifted = {w: s + 1 for w, s in fig8.default_salts().items()}
    a = fig8._mix(20, fig8.SEED, spec, shifted)[0]
    b = fig8._mix(20, fig8.SEED + 1, spec)[0]   # seed + (salt + 1) == (seed + 1) + salt
    np.testing.assert_array_equal(a, b)


def test_fig8_small_matches_jax():
    n_ops = 24
    salts = {w: (7 * i + 3) % 97 for i, w in enumerate(W4)}
    res = fig8.run(device="cpu", n_ops=n_ops, salts=salts, verbose=False)
    assert res["salts"] == salts
    results = {}
    for name, spec in fig8.MIXES.items():
        streams = []
        for w, t, fp, off in spec:
            for i in range(t):
                tr = jtraces.generate(w, n_ops=n_ops, seed=11 + 31 * i + salts[w],
                                      footprint_bytes=fp,
                                      thread_slice=(i / t, (i + 1) / t) if t > 1 else (0.0, 1.0),
                                      scatter_nodes=True)
                streams.append((w, tr.lines + (off * (1 << 30) >> 6)))
        n = min(s.shape[0] for _, s in streams)
        inter = jtraces.interleave([s[:n] for _, s in streams])[:2_400_000]
        who = np.tile(np.arange(len(streams)), n)[:inter.shape[0]]
        np.testing.assert_array_equal(res["lines"][name], inter)
        batched = jsweep_tlb(inter >> 6, [JSpec(jfig8.TLB, num_partitions=p)
                                          for p in jfig8.PARTS], kernel_mode="reference")
        np.testing.assert_array_equal(res["hits"][name].hits.numpy(), batched.hits)
        n0 = batched.hits.shape[1] - batched.n_warm
        is_bste = np.array([w == "bst_external" for w, _ in streams])[who[n0:]]
        line, counts = [], []
        for i_p in range(len(jfig8.PARTS)):
            hits = batched.hits[i_p][n0:][is_bste]
            counts.append([int(hits.sum()), int(hits.size)])
            line.append(float(1.0 - hits.mean()) if hits.size else 1.0)
        assert res["bste"][name] == counts
        _close(res["results"][name], line, name)
        results[name] = line
    full = results["+bsti+skip"]
    _close([c.value for c in res["claims"]],
           [results["+bsti+skip"][0] - results["bst_e_x4"][0],
            (full[0] - full[-1]) / max(full[0], 1e-9)], "claims")
    assert [c.name for c in res["claims"]] == ["C3c", "C3d"]


def test_fig9_small_matches_jax():
    n_ops = 30
    res = fig9.run(device="cpu", n_ops=n_ops, verbose=False)
    lat = jsparta.SystemLatencies()
    cfgs = [JSystemSimConfig(cache=jfig9.CACHE, accel_tlb=jsparta.TLBConfig(entries=128, ways=4),
                             mem_tlb=jfig9.MEM_TLB, num_partitions=1,
                             accel_probe_on_miss_only=True)]
    cfgs += [JSystemSimConfig(cache=jfig9.CACHE, accel_tlb=jsparta.TLBConfig(entries=e, ways=4),
                              mem_tlb=jfig9.MEM_TLB, num_partitions=jfig9.P,
                              accel_probe_on_miss_only=False) for e in jfig9.ENTRIES]
    cfgs.append(JSystemSimConfig(cache=jfig9.CACHE, accel_tlb=None, mem_tlb=jfig9.MEM_TLB,
                                 num_partitions=jfig9.P))
    assert [repr(c) for c in fig9.system_configs()] == [
        repr(c).replace("repro.core", "repro_torch.core") for c in cfgs]
    results = {}
    for w in W4:
        tr = jtraces.generate(w, n_ops=n_ops, seed=0, footprint_bytes=128 << 30,
                              max_accesses=1_400_000)
        evs = jsweep_system(tr.lines, cfgs, kernel_mode="reference")
        got = res["events"][w]
        for f in ("cache_hit", "accel_tlb_hit", "mem_tlb_hit"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(evs, f), f"{w} {f}")
        ipa = tr.instr_per_access
        base = jcpi.evaluate_design("conventional", evs[0], lat, instr_per_access=ipa)
        line = [float(jcpi.evaluate_design("sparta", evs[1 + i], lat, instr_per_access=ipa,
                                           physical_cache=True).speedup_over(base))
                for i in range(len(jfig9.ENTRIES))]
        line.append(float(jcpi.evaluate_design("sparta", evs[len(cfgs) - 1], lat,
                                               instr_per_access=ipa).speedup_over(base)))
        _close(res["results"][w], line, w)
        results[w] = line
    idx8 = jfig9.ENTRIES.index(8)
    _close([c.value for c in res["claims"]],
           [sum(results[w][idx8] >= 1.0 for w in W4),
            np.mean([results[w][-2] - results[w][idx8] for w in W4])], "claims")
    assert [c.name for c in res["claims"]] == ["C7a", "C7b"]
