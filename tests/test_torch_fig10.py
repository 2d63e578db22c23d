"""The slice as a whole: the port's Fig 10 and Fig 4 drivers on the CPU at a
small size against the JAX package's sweeps and CPI model on the same traces.

Speedups, translation overheads, miss ratios and claim values come from
identical integer hit counts through identical float64 arithmetic, so they
agree to rtol 1e-12 (in practice exactly).
"""
import numpy as np
import pytest

pytest.importorskip("jax")  # the parity tests need the JAX package (CPU only)
from benchmarks import fig4_tlb_sensitivity as jfig4
from benchmarks import fig10_performance as jfig10
from repro.core import cpi as jcpi
from repro.core import traces as jtraces
from repro.core.sparta import SystemLatencies as JSystemLatencies
from repro.core.sweep import TLBSweepSpec as JSpec
from repro.core.sweep import sweep_system as jsweep_system
from repro.core.sweep import sweep_tlb as jsweep_tlb
from repro.core.tlbsim import SystemSimConfig as JSystemSimConfig
from repro_torch.bench import fig4, fig10

RTOL = 1e-12
W4 = ("bst_external", "bst_internal", "hash_table", "skip_list")


def _jax_lines(w, n_ops):
    return jtraces.generate(w, n_ops=n_ops, seed=0, footprint_bytes=128 << 30,
                            max_accesses=1_400_000).lines


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float),
                               rtol=RTOL, atol=0, err_msg=what)


@pytest.fixture(scope="module")
def fig10_small():
    return fig10.run(device="cpu", n_ops=30, verbose=False)


def test_fig10_small_matches_jax(fig10_small):
    n_ops = 30
    lat = JSystemLatencies(n_sockets=8)
    cfgs = [JSystemSimConfig(cache=jfig10.CACHE,
                             accel_tlb=jfig10.ACCEL_TLB if d == "conventional" else None,
                             mem_tlb=jfig10.MEM_TLB, num_partitions=p, page_shift=s,
                             accel_probe_on_miss_only=True)
            for _, p, s, d in jfig10.CONFIGS]
    speedups = {c[0]: [] for c in jfig10.CONFIGS}
    red, red2m = [], []
    for w, row in zip(W4, fig10_small["rows"]):
        lines = _jax_lines(w, n_ops)
        evs = jsweep_system(lines, cfgs, kernel_mode="reference")
        ipa = jtraces.INSTR_PER_ACCESS[w]
        perfs = {label: jcpi.evaluate_design(d, evs[i], lat, instr_per_access=ipa, workload=w)
                 for i, (label, _, _, d) in enumerate(jfig10.CONFIGS)}
        got = fig10_small["perfs"][w]
        tev = fig10_small["events"][w]
        for i, (label, *_) in enumerate(jfig10.CONFIGS):
            a, b = got[label], perfs[label]
            _close(a.cycles_per_instr, b.cycles_per_instr, f"{w}/{label} cpi")
            _close(a.access.translation_overhead, b.access.translation_overhead,
                   f"{w}/{label} overhead")
            _close(tev[i].cache_hit_ratio, evs[i].cache_hit_ratio, f"{w}/{label} cache")
            _close(tev[i].mem_tlb_hit_ratio_given_cache_miss(),
                   evs[i].mem_tlb_hit_ratio_given_cache_miss(), f"{w}/{label} mem")
            speedups[label].append(b.speedup_over(perfs["conv-4K"]))
        assert row[0] == w
        _close(row[1:], [speedups[c[0]][-1] for c in jfig10.CONFIGS], f"{w} speedups")
        red.append(perfs["conv-4K"].access.translation_overhead
                   / max(perfs["sparta128-2M"].access.translation_overhead, 1e-9))
        red2m.append(perfs["conv-2M"].access.translation_overhead
                     / max(perfs["sparta128-2M"].access.translation_overhead, 1e-9))
    _close(fig10_small["overhead_reduction"], red, "overhead reduction")
    _close(fig10_small["overhead_reduction_2m"], red2m, "overhead reduction over 2M")
    mean = {k: float(np.mean(v)) for k, v in speedups.items()}
    want_claims = [mean["conv-2M"], mean["sparta32-4K"], mean["sparta32-4K"] / mean["ideal"],
                   np.mean(red), np.max(red), np.mean(red2m),
                   sum(a >= b for a, b in zip(speedups["sparta32-4K"], speedups["dipta"]))]
    claims = fig10_small["claims"]
    assert [c.name for c in claims] == ["C6a", "C6b", "C6c", "C6d", "C6e", "C6f", "C8"]
    _close([c.value for c in claims], want_claims, "claims")


def test_fig4_small_matches_jax():
    n_ops, sizes = 12, (4, 16, 64, 256)
    res = fig4.run(device="cpu", n_ops=n_ops, sizes=sizes, verbose=False)
    specs = [JSpec(jfig4.TLBConfig(entries=s, ways=4), num_partitions=p, page_shift=sh)
             for _, p, sh in jfig4.CONFIGS for s in sizes]
    for w in W4:
        mr = jsweep_tlb(_jax_lines(w, n_ops), specs, kernel_mode="reference").miss_ratios
        mr = mr.reshape(len(jfig4.CONFIGS), len(sizes))
        for (label, _, _), curve in zip(jfig4.CONFIGS, mr):
            _close(res["results"][f"{w}/{label}"], curve, f"{w}/{label}")
    # The claims follow from the curves by the JAX driver's own rules.
    ratios, wins = [], 0
    for w in W4:
        conv, sp = res["results"][f"{w}/conv-4K"], res["results"][f"{w}/sparta4-4K"]
        for s, m in zip(sizes, conv):
            match = jfig4._match_size(sizes, sp, m)
            if match and match < s:
                ratios.append(s / match)
        best = min(res["results"][f"{w}/conv-4K"][-1], res["results"][f"{w}/conv-2M"][-1])
        wins += res["results"][f"{w}/sparta128-2M"][0] <= best + 1e-9
    _close([c.value for c in res["claims"]],
           [float(np.mean(ratios)) if ratios else 0.0, float(wins)], "claims")
