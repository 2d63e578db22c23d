"""The port's sweep engine (``repro_torch.core.sweep``) against the JAX
package's: batched sweeps, chunked streams, the state grouping, and a stream
state exported by JAX resuming in the port."""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import assert_same, random_lines

pytest.importorskip("jax")  # the parity tests need the JAX package (CPU only)
from repro.core import sweep as jsweep
from repro.core import tlbsim as jsim
from repro.core.sparta import SystemLatencies as JSystemLatencies
from repro.core.sparta import TLBConfig as JTLBConfig
from repro_torch import convert
from repro_torch.core import sweep as tsweep
from repro_torch.core import tlbsim as tsim
from repro_torch.core.sparta import TLBConfig

HIT_KEYS = ("cache_hit", "accel_tlb_hit", "mem_tlb_hit")


def _tlb_specs(Spec, T, page_shift=12):
    return [
        Spec(T(entries=64, ways=4), 1, page_shift),
        Spec(T(entries=16, ways=2), 4, page_shift),
        Spec(T(entries=2, ways=4), 128, page_shift),   # entries < ways
        Spec(T(entries=128, ways=8), 32, page_shift),
        Spec(T(entries=512, ways=4), 4, page_shift),
        Spec(T(entries=32, ways=1), 8, page_shift),
    ]


def _both_specs(page_shift=12):
    return (_tlb_specs(jsweep.TLBSweepSpec, JTLBConfig, page_shift),
            _tlb_specs(tsweep.TLBSweepSpec, TLBConfig, page_shift))


def _sys_cfgs(C, T):
    return [C(), C(cache=None, num_partitions=8),
            C(accel_tlb=T(entries=8, ways=4), num_partitions=4,
              accel_probe_on_miss_only=False),
            C(cache=T(entries=512, ways=8), page_shift=21, num_partitions=16)]


def _both_sys():
    return (_sys_cfgs(jsim.SystemSimConfig, JTLBConfig),
            _sys_cfgs(tsim.SystemSimConfig, TLBConfig))


@pytest.mark.parametrize("page_shift", [12, 21, None])
def test_sweep_tlb_matches_jax(page_shift):
    addrs = random_lines(1) if page_shift else random_lines(1) >> 6
    jspecs, tspecs = _both_specs(page_shift)
    want = jsweep.sweep_tlb(addrs, jspecs, kernel_mode="reference")
    got = tsweep.sweep_tlb(addrs, tspecs, device="cpu")
    assert got.n_warm == want.n_warm and len(got) == len(want)
    assert_same(got.hits, want.hits)
    assert got.miss_ratios.dtype == np.float64
    assert np.array_equal(got.miss_ratios, want.miss_ratios)  # exact
    assert got[2].miss_ratio == want[2].miss_ratio


def test_grouping_matches_jax_and_is_invisible(monkeypatch):
    from benchmarks import fig4_tlb_sensitivity as jfig4
    from benchmarks import fig10_performance as jfig10
    from repro_torch.bench import fig4, fig10

    geoms = [sp.geometry for sp in fig4.specs()]
    assert tsweep._state_groups(geoms, block=512) == jsweep._vmem_chunks(geoms, block=512)
    assert fig4.CONFIGS == jfig4.CONFIGS and fig4.SIZES == jfig4.SIZES
    assert fig10.CONFIGS == jfig10.CONFIGS
    _, dims = tsweep._system_layout(fig10.system_configs())
    assert (tsweep._system_state_groups(dims, block=300)
            == jsweep._system_vmem_chunks(dims, block=300))
    # A tight budget splits a stream's batch; the hit bits do not change.
    addrs = random_lines(4, n=700)
    jspecs, tspecs = _both_specs()
    monkeypatch.setattr(tsweep, "_STATE_GROUP_BUDGET_BYTES", 16 * 1024)
    stream = tsweep.TLBSweepStream(tspecs, device="cpu")
    assert len(stream.groups) > 1
    want = jsweep.sweep_tlb(addrs, jspecs, kernel_mode="reference")
    assert_same(stream.run_chunk(addrs), want.hits)
    jcfgs, tcfgs = _both_sys()
    sstream = tsweep.SystemSweepStream(tcfgs, block=256, device="cpu")
    assert len(sstream.groups) > 1
    want = jsweep.sweep_system(addrs, jcfgs, kernel_mode="reference")
    got = sstream.run_chunk(addrs)
    for k, key in enumerate(HIT_KEYS):
        assert_same(got[k], getattr(want, key), key)


def test_tlb_stream_chunked_matches_monolithic_and_jax_state():
    addrs = random_lines(2, n=1500)
    jspecs, tspecs = _both_specs()
    mono = tsweep.sweep_tlb(addrs, tspecs, device="cpu").hits
    js = jsweep.TLBSweepStream(jspecs, block=128)
    ts = tsweep.TLBSweepStream(tspecs, block=128, device="cpu")
    assert ts.fingerprint() == js.fingerprint()
    parts = []
    for lo, hi in ((0, 333), (333, 1024), (1024, 1500)):
        js.run_chunk(addrs[lo:hi], kernel_mode="reference")
        parts.append(ts.run_chunk(addrs[lo:hi]))
        jstate, tstate = js.export_state(), ts.export_state()
        assert jstate.keys() == tstate.keys()
        for k in jstate:
            assert_same(tstate[k], jstate[k], k)
    assert_same(torch.cat(parts, 1), mono)


def test_system_stream_chunked_matches_monolithic_and_jax_state():
    lines = random_lines(3, n=1200)
    jcfgs, tcfgs = _both_sys()
    mono = tsweep.sweep_system(lines, tcfgs, device="cpu")
    js, ts = jsweep.SystemSweepStream(jcfgs), tsweep.SystemSweepStream(tcfgs, device="cpu")
    assert ts.fingerprint() == js.fingerprint()
    parts = []
    for lo, hi in ((0, 401), (401, 1200)):
        js.run_chunk(lines[lo:hi], kernel_mode="reference")
        parts.append(ts.run_chunk(lines[lo:hi]))
        jstate, tstate = js.export_state(), ts.export_state()
        assert jstate.keys() == tstate.keys()
        for k in jstate:
            assert_same(tstate[k], jstate[k], k)
    for k, key in enumerate(HIT_KEYS):
        assert_same(torch.cat([p[k] for p in parts], 1), getattr(mono, key), key)


def test_tlb_stream_resumes_jax_exported_state():
    """Half the trace in a JAX stream, export, import into the port's stream
    through convert.stream_state_from_numpy, finish in the port: the hit
    bits are the JAX monolithic sweep's."""
    addrs = random_lines(6, n=1400)
    jspecs, tspecs = _both_specs()
    want = jsweep.sweep_tlb(addrs, jspecs, kernel_mode="reference").hits
    js = jsweep.TLBSweepStream(jspecs)
    first = js.run_chunk(addrs[:700], kernel_mode="reference")
    ts = tsweep.TLBSweepStream(tspecs, device="cpu")
    ts.import_state(convert.stream_state_from_numpy(js.export_state(), device="cpu"))
    assert ts.now == 700
    rest = ts.run_chunk(addrs[700:])
    assert_same(np.concatenate([first, rest.numpy()], 1), want)


def test_system_stream_resumes_jax_exported_state():
    lines = random_lines(8, n=1100)
    jcfgs, tcfgs = _both_sys()
    want = jsweep.sweep_system(lines, jcfgs, kernel_mode="reference")
    js = jsweep.SystemSweepStream(jcfgs)
    first = js.run_chunk(lines[:555], kernel_mode="reference")
    ts = tsweep.SystemSweepStream(tcfgs, device="cpu")
    ts.import_state(convert.stream_state_from_numpy(js.export_state(), device="cpu"))
    rest = ts.run_chunk(lines[555:])
    for k, key in enumerate(HIT_KEYS):
        assert_same(np.concatenate([first[k], rest[k].numpy()], 1), getattr(want, key), key)


def test_import_state_rejects_bad_arrays():
    ts = tsweep.TLBSweepStream(_both_specs()[1], device="cpu")
    good = ts.export_state()
    with pytest.raises(ValueError, match="missing"):
        ts.import_state({k: v for k, v in good.items() if k != "g0_last"})
    with pytest.raises(ValueError, match="shape"):
        ts.import_state({**good, "g0_tags": good["g0_tags"][:, :-1]})
    ss = tsweep.SystemSweepStream(_both_sys()[1], device="cpu")
    with pytest.raises(ValueError, match="missing"):
        ss.import_state({"now": np.array([0])})


def test_sweep_mode_errors():
    lines = random_lines(0, n=64)
    _, tspecs = _both_specs()
    _, tcfgs = _both_sys()
    with pytest.raises(ValueError, match="stack-inclusion"):
        tsweep.sweep_system(lines, tcfgs, kernel_mode="stackdist", device="cpu")
    with pytest.raises(ValueError, match="stack-inclusion"):
        tsweep.SystemSweepStream(tcfgs, device="cpu").run_chunk(lines, kernel_mode="stackdist")
    wide = [tsweep.TLBSweepSpec(TLBConfig(entries=512, ways=512), 1, 12)]
    with pytest.raises(ValueError, match="MAX_CAP"):
        tsweep.sweep_tlb(lines, wide, kernel_mode="stackdist", device="cpu")
    with pytest.raises(ValueError, match="kernel_mode"):
        tsweep.TLBSweepStream(tspecs, device="cpu").run_chunk(lines, kernel_mode="stackdist")
    with pytest.raises(ValueError, match="at least one"):
        tsweep.sweep_tlb(lines, [], device="cpu")
    with pytest.raises(ValueError, match="mixes"):
        tsweep.sweep_tlb(lines, tspecs[:1] + _tlb_specs(tsweep.TLBSweepSpec, TLBConfig, None)[:1],
                         device="cpu")


@pytest.mark.parametrize("page_shift", [12, None])
def test_sweep_tlb_modes_agree_with_jax_stackdist(page_shift):
    """The stack-distance engine and the sequential plain version give the
    JAX stack-distance sweep's hits; "auto" takes the engine exactly when
    every spec has at most 16 ways, as the JAX cold start does."""
    addrs = random_lines(9, n=1500) if page_shift else random_lines(9, n=1500) >> 6
    jspecs, tspecs = _both_specs(page_shift)
    want = jsweep.sweep_tlb(addrs, jspecs, kernel_mode="stackdist")
    for mode in ("auto", "stackdist", "reference"):
        got = tsweep.sweep_tlb(addrs, tspecs, kernel_mode=mode, device="cpu")
        assert_same(got.hits, want.hits, mode)
        assert np.array_equal(got.miss_ratios, want.miss_ratios)
    assert tsweep._tlb_mode("auto", tspecs, "cpu") == "stackdist"
    wide = tspecs + [tsweep.TLBSweepSpec(TLBConfig(entries=64, ways=32), 1, page_shift)]
    assert tsweep._tlb_mode("auto", wide, "cpu") == "reference"
    assert tsweep._tlb_mode("stackdist", wide, "cpu") == "stackdist"


def test_tag_overflow_raises_in_sweeps():
    vpns = np.array([0, 5, 1 << 42], np.int64)
    spec = [tsweep.TLBSweepSpec(TLBConfig(entries=4, ways=4))]
    with pytest.raises(ValueError, match="tag overflow"):
        jsweep.sweep_tlb(vpns, [jsweep.TLBSweepSpec(JTLBConfig(entries=4, ways=4))],
                         kernel_mode="reference")
    with pytest.raises(ValueError, match="tag overflow"):
        tsweep.sweep_tlb(vpns, spec, device="cpu")


def test_convert_configs_from_jax_fields():
    jcfgs, tcfgs = _both_sys()
    for j, t in zip(jcfgs, tcfgs):
        assert convert.system_config_from_fields(dataclasses.asdict(j)) == t
    j = JTLBConfig(entries=32, ways=8, page_shift=21)
    assert convert.tlb_config_from_fields(dataclasses.asdict(j)) == TLBConfig(32, 8, 21)
    lat = JSystemLatencies(n_sockets=4, l_dram=99.0)
    got = convert.latencies_from_fields(dataclasses.asdict(lat))
    assert dataclasses.asdict(got) == dataclasses.asdict(lat)
    assert got.t_net == lat.t_net
