"""The port's timeline engine (``repro_torch.core.timeline`` and the plain
version of kernel K4, ``repro_torch.kernels.timeline.ref``) against the JAX
package on the CPU.

Inputs come from seeded traces and numpy; JAX runs its ``reference`` mode.
Latency, overhead, done and the carried queueing state are integral cycle
counts in float32 and must be bit-identical (tolerance 0); the reductions
are numpy float64 on the same arrays, so they are equal too.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import assert_same, t_of

pytest.importorskip("jax")  # the parity tests need the JAX package (CPU only)
import jax.numpy as jnp

from repro.core import timeline as jtl
from repro.core import traces as jtraces
from repro.core.sparta import SystemLatencies as JLatencies
from repro.core.sparta import TLBConfig as JTLBConfig
from repro.core.sweep import sweep_system as jsweep_system
from repro.core.tlbsim import SystemSimConfig as JSystemSimConfig
from repro.kernels.timeline import ref as jref
from repro_torch import convert
from repro_torch.core import cpi as tcpi
from repro_torch.core import sweep as tsweep
from repro_torch.core import timeline as ttl
from repro_torch.core import tlbsim as tsim
from repro_torch.core.sparta import SystemLatencies, TLBConfig
from repro_torch.kernels import timeline as tops
from repro_torch.kernels.timeline import ref as tref

LAT = SystemLatencies()
JLAT = JLatencies()
CACHE = JTLBConfig(entries=256, ways=4)
MEM_TLB = JTLBConfig(entries=128, ways=4)
OUTS = ("latency", "overhead", "done")


def _jevents(lines, num_partitions=32, accel_tlb=None, page_shift=12):
    return jsweep_system(lines, [JSystemSimConfig(
        cache=CACHE, accel_tlb=accel_tlb, mem_tlb=MEM_TLB,
        num_partitions=num_partitions, page_shift=page_shift)],
        kernel_mode="reference")[0]


def _tevents(jev) -> tsim.SystemEvents:
    """The port's SystemEvents holding the same bits as a JAX one."""
    return tsim.SystemEvents(*(t_of(np.asarray(x)) for x in jev[:3]), n_warm=jev.n_warm)


def _cfg(jcfg) -> ttl.TimelineConfig:
    return convert.timeline_config_from_fields(dataclasses.asdict(jcfg))


def _pair(lines, jev, design, jcfg, **kw):
    """The same timeline cell as a JAX spec and a port spec."""
    return (jtl.TimelineSpec(lines, jev, design, cfg=jcfg, **kw),
            ttl.TimelineSpec(lines, _tevents(jev), design, cfg=_cfg(jcfg), **kw))


@pytest.fixture(scope="module")
def hetero():
    return hetero_specs()


def hetero_specs():
    """Ten cells mixing every design, 1-16 accelerators, 0 or 8 MSHRs, 0, 1
    or 3 ports, 0 or 16 banks, 1-32 partitions and three trace lengths
    (2,600, 1,700 and 900 accesses): (JAX specs, port specs)."""
    rng = np.random.default_rng(0)
    a = jtraces.generate("bst_external", n_ops=350, max_accesses=2600).lines
    b = jtraces.generate("hash_table", n_ops=250, max_accesses=1700).lines
    c = rng.integers(0, 1 << 26, 900).astype(np.int64)
    ev_conv = _jevents(a, num_partitions=1, accel_tlb=JTLBConfig(entries=128, ways=4))
    ev_a, ev_b = _jevents(a, 32), _jevents(b, 8)
    ev_c = _jevents(c, 4, page_shift=21)
    Q = jtl.TimelineConfig
    cells = [
        (a, ev_conv, "conventional", Q(8, 1, 16), dict(num_accelerators=4)),
        (a, ev_a, "sparta", Q(8, 3, 16), dict(num_partitions=32, num_accelerators=16)),
        (b, ev_b, "sparta", Q.unbounded(), dict(num_partitions=8, num_accelerators=16)),
        (b, ev_b, "dipta", Q(0, 0, 16), dict(workload="hash_table")),
        (c, ev_c, "ideal", Q(8, 0, 0), dict(page_shift=21, num_accelerators=8)),
        (b, ev_b, "conventional", Q(0, 3, 0), dict()),
        (a, ev_a, "sparta", Q(0, 1, 0), dict(num_partitions=32, num_accelerators=2)),
        (a, ev_conv, "dipta", Q(8, 1, 16), dict(way_accuracy=0.6, num_accelerators=2)),
        (c, ev_c, "sparta", Q(8, 3, 16), dict(num_partitions=4, page_shift=21)),
        (b, ev_b, "ideal", Q.unbounded(), dict(num_accelerators=16)),
    ]
    pairs = [_pair(lines, ev, d, q, **kw) for lines, ev, d, q, kw in cells]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _jax_inputs(sp):
    return jtl._timeline_inputs(
        sp.lines, sp.events, sp.design, sp.lat or JLAT, sp.cfg, sp.num_partitions,
        sp.page_shift, sp.num_accelerators, sp.accel_ids, sp.workload, sp.way_accuracy)


def _same_results(got, want, what=""):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in OUTS:
            assert_same(getattr(g, k), getattr(w, k), f"{what} spec {i} {k}")
        assert_same(g.cache_hit, w.cache_hit, f"{what} spec {i} cache_hit")
        assert g.n_warm == w.n_warm


# ---------------------------------------------------------------------------
# Inputs and packed parameters.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("design,kw", [
    ("conventional", {}), ("sparta", {"num_partitions": 32}),
    ("dipta", {"workload": "skip_list"}), ("dipta", {"way_accuracy": 0.83}),
    ("ideal", {"page_shift": 21}),
])
def test_timeline_inputs_and_params_match_jax(design, kw):
    rng = np.random.default_rng(1)
    lines = rng.integers(0, 1 << 34, 777).astype(np.int64)
    jev = _jevents(lines, kw.get("num_partitions", 1), JTLBConfig(entries=64, ways=4),
                   kw.get("page_shift", 12))
    for jcfg in (jtl.TimelineConfig(), jtl.TimelineConfig(mshrs=3, tlb_ports=2, dram_banks=7,
                                                          tlb_service=3.0, dram_service=90.0,
                                                          issue_interval=2.0)):
        ids = rng.integers(0, 5, 777).astype(np.int32)
        args = (design, jcfg, kw.get("num_partitions", 1), kw.get("page_shift", 12), 5, ids,
                kw.get("workload", ""), kw.get("way_accuracy"))
        want, wparams = jtl._timeline_inputs(lines, jev, args[0], JLAT, *args[1:])
        got, params = ttl._timeline_inputs(lines, _tevents(jev), design, LAT, _cfg(jcfg),
                                           *args[2:])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
        assert tuple(params) == tuple(wparams)
        for g, w in zip(tops.pack_params(params), jref.pack_params(wparams)):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_pte_banks_and_accel_ids_match_jax():
    rng = np.random.default_rng(2)
    vpns = rng.integers(0, 1 << 46, 5000).astype(np.int64)
    for banks in (1, 3, 16, 1024):
        assert ttl._pte_banks(vpns, banks).tobytes() == jtl._pte_banks(vpns, banks).tobytes()
    for n, a, g in ((10, 3, 1), (17, 4, 2), (0, 2, 1)):
        assert_same(ttl.round_robin_accel_ids(n, a, g), jtl.round_robin_accel_ids(n, a, g))


def test_init_state_and_packing_match_jax():
    p = jref.TimelineParams(serial_walk=True, num_accels=3, mshrs=5, num_partitions=7,
                            tlb_ports=2, dram_banks=9, l_cache=2.0, l_tlb=3.0,
                            l_dram=111.0, t_net=390.5, tlb_occ=4.0, dram_occ=100.0,
                            issue_interval=2.0)
    tp = tref.TimelineParams(*p)
    for g, w in zip(tref.pack_params(tp), jref.pack_params(p)):
        assert g.tobytes() == w.tobytes()
    for g, w in zip(tref.timeline_init_state(tp, device="cpu"), jref.timeline_init_state(p)):
        assert_same(g, w)
    ports = np.array([0, 1, 3, 2], np.int32)
    env = (5, 2, 3, 3, 4)
    want = jref.timeline_init_state_batched(4, env, jnp.asarray(ports))
    for g, w in zip(tref.timeline_init_state_batched(4, env, ports, device="cpu"), want):
        assert_same(g, w)
    assert tref.FP_COLS == jref.FP_COLS and tref.IP_COLS == jref.IP_COLS
    assert tref.PORT_POISON == jref.PORT_POISON


# ---------------------------------------------------------------------------
# The plain scans against the reference's.
# ---------------------------------------------------------------------------

def test_batched_scan_matches_jax_on_heterogeneous_batch(hetero):
    jspecs, tspecs = hetero
    stacked, fp, ip, lens = ttl._prepare(tspecs, LAT, "test")
    assert lens == [sp.lines.shape[0] for sp in jspecs]
    for sp, i in zip(jspecs, range(len(jspecs))):
        for s, x in zip(stacked, _jax_inputs(sp)[0]):
            assert s[i, :lens[i]].tobytes() == x.tobytes()
    env = tops.envelope_of(ip)
    assert env == (16, 8, 32, 3, 16)
    want = jref.timeline_scan_batched_ref(*(jnp.asarray(s) for s in stacked),
                                          jnp.asarray(fp), jnp.asarray(ip), env)
    got = tref.timeline_scan_batched_ref(*(t_of(s) for s in stacked), t_of(fp), t_of(ip), env)
    for g, w, k in zip(got, want, OUTS):
        assert_same(g, w, k)


def test_carry_split_matches_jax_and_monolithic(hetero):
    """The carry form from the zero state, split at odd points: every chunk's
    outputs and the carried state equal JAX's, and the joined outputs equal
    the monolithic scan."""
    _, tspecs = hetero
    stacked, fp, ip, _ = ttl._prepare(tspecs, LAT, "test")
    env, n, B = tops.envelope_of(ip), stacked[0].shape[1], len(tspecs)
    jst = jref.timeline_init_state_batched(B, env, jnp.asarray(ip[:, 5]))
    tst = tref.timeline_init_state_batched(B, env, ip[:, 5], device="cpu")
    outs = []
    for lo, hi in zip([0, 701, 1999], [701, 1999, n]):
        cols = [s[:, lo:hi] for s in stacked]
        (jys, jst) = jref.timeline_scan_batched_carry_ref(
            *(jnp.asarray(c) for c in cols), jnp.asarray(fp), jnp.asarray(ip), jst)
        tys, tst = tops.timeline_sim_batched_carry(
            *(t_of(c) for c in cols), fp, ip, tst, kernel_mode="reference")
        for g, w, k in zip(tys, jys, OUTS):
            assert_same(g, w, f"[{lo}, {hi}) {k}")
        for g, w, k in zip(tst, jst, tref.STATE_NAMES):
            assert_same(g, w, f"[{lo}, {hi}) state {k}")
        outs.append(tys)
    mono = tops.timeline_sim_batched(*(t_of(s) for s in stacked), fp, ip,
                                     kernel_mode="reference")
    for k in range(3):
        assert torch.equal(torch.cat([o[k] for o in outs], 1), mono[k])


@pytest.mark.parametrize("design", ttl.DESIGNS)
@pytest.mark.parametrize("queues", [(8, 1, 16), (0, 0, 0), (2, 3, 5)])
def test_simulate_timeline_matches_jax(design, queues):
    """The static-parameter oracle (``timeline_scan_ref``) per design."""
    lines = jtraces.generate("skip_list", n_ops=200, max_accesses=1500).lines
    P = 32 if design == "sparta" else 1
    acc = JTLBConfig(entries=64, ways=4) if design == "conventional" else None
    jev = _jevents(lines, P, acc)
    kw = dict(num_partitions=P, num_accelerators=3, workload="skip_list")
    jcfg = jtl.TimelineConfig(*queues)
    want = jtl.simulate_timeline(lines, jev, design, JLAT, cfg=jcfg, kernel_mode="reference",
                                 **kw)
    got = ttl.simulate_timeline(lines, _tevents(jev), design, LAT, cfg=_cfg(jcfg),
                                device="cpu", **kw)
    _same_results([got], [want], design)
    assert got.summary() == want.summary()


def test_sweep_timeline_matches_jax_and_simulate(hetero):
    jspecs, tspecs = hetero
    got = ttl.sweep_timeline(tspecs, LAT, device="cpu")
    want = jtl.sweep_timeline(jspecs, JLAT, kernel_mode="reference")
    _same_results(got, want, "sweep")
    for g, w in zip(got, want):
        assert g.summary() == w.summary()
        assert g.overhead_percentile(95, misses_only=False) == \
            w.overhead_percentile(95, misses_only=False)
    # The per-sim path agrees with its batch-mates' padded run.
    sp = tspecs[3]
    solo = ttl.simulate_timeline(sp.lines, sp.events, sp.design, LAT, cfg=sp.cfg,
                                 workload=sp.workload, device="cpu")
    _same_results([solo], [got[3]], "solo")


# ---------------------------------------------------------------------------
# The resumable stream.
# ---------------------------------------------------------------------------

def _stream_chunks(stream, bounds):
    outs = [stream.run_chunk(lo, hi) for lo, hi in zip(bounds, bounds[1:])]
    return [np.concatenate([o[k] for o in outs], 1) for k in range(3)]


def test_stream_in_block_chunks_equals_sweep(hetero):
    _, tspecs = hetero
    specs = tspecs[:6]
    stream = ttl.TimelineSweepStream(specs, LAT, block=256, device="cpu")
    bounds = [0, 256, 1024, 1280, 2048, stream.n]
    res = stream.finalize(*_stream_chunks(stream, bounds))
    _same_results(res, ttl.sweep_timeline(specs, LAT, device="cpu"), "stream")
    assert stream.now == stream.n
    assert stream.fingerprint()["lens"] == stream.lens


def test_stream_resumes_jax_exported_state(hetero, monkeypatch):
    """Half the trace in a JAX stream, export, import into the port's stream
    through convert.stream_state_from_numpy, finish in the port: outputs and
    state equal the JAX stream's.  A tight budget splits the sims into
    several state groups, and mixed port counts put PORT_POISON in the state
    (an int32 cast would destroy it)."""
    jspecs, tspecs = hetero
    monkeypatch.setattr(jtl, "_VMEM_STATE_BUDGET_BYTES", 48 * 1024)
    monkeypatch.setattr(ttl, "_STATE_GROUP_BUDGET_BYTES", 48 * 1024)
    js = jtl.TimelineSweepStream(jspecs, JLAT, block=128)
    ts = ttl.TimelineSweepStream(tspecs, LAT, block=128, device="cpu")
    assert ts.groups == js.groups and len(ts.groups) > 1
    assert ts.fingerprint() == js.fingerprint()
    js.run_chunk(0, 1024, kernel_mode="reference")
    exported = js.export_state()
    state = convert.stream_state_from_numpy(exported, device="cpu")
    for k, v in exported.items():
        assert state[k].dtype == t_of(v).dtype, k
        assert_same(state[k], v, k)
    assert any((v == np.float32(jref.PORT_POISON)).any() for k, v in exported.items()
               if k.endswith("port_free"))
    ts.import_state(state)
    for lo, hi in ((1024, 1536), (1536, js.n)):
        want = js.run_chunk(lo, hi, kernel_mode="reference")
        got = ts.run_chunk(lo, hi)
        for g, w, k in zip(got, want, OUTS):
            assert_same(g, w, f"[{lo}, {hi}) {k}")
    for k, v in js.export_state().items():
        assert_same(ts.export_state()[k], v, k)


def test_stream_import_rejects_bad_arrays(hetero):
    _, tspecs = hetero
    ts = ttl.TimelineSweepStream(tspecs[:2], LAT, device="cpu")
    good = ts.export_state()
    with pytest.raises(ValueError, match="missing"):
        ts.import_state({k: v for k, v in good.items() if k != "g0_bank_free"})
    with pytest.raises(ValueError, match="shape"):
        ts.import_state({**good, "g0_port_free": good["g0_port_free"][:, :, :0]})


def test_convert_keeps_dtypes_and_timeline_config():
    arrays = {"now": np.array([3], np.int32), "g0_tags": np.arange(6, dtype=np.int32),
              "g0_acc_next": np.array([1.5, 3.0e38], np.float32)}
    got = convert.stream_state_from_numpy(arrays, device="cpu")
    assert got["now"].dtype == torch.int64 and got["g0_tags"].dtype == torch.int32
    assert got["g0_acc_next"].dtype == torch.float32
    assert_same(got["g0_acc_next"], arrays["g0_acc_next"])
    j = jtl.TimelineConfig(mshrs=3, tlb_ports=0, dram_banks=5, tlb_service=1.0)
    assert convert.timeline_config_from_fields(dataclasses.asdict(j)) == \
        ttl.TimelineConfig(3, 0, 5, 1.0)
    assert dataclasses.asdict(ttl.TimelineConfig.unbounded()) == \
        dataclasses.asdict(jtl.TimelineConfig.unbounded())


def test_state_groups_match_jax(monkeypatch):
    rng = np.random.default_rng(4)
    dims = [tuple(int(x) for x in rng.integers(1, 40, 5)) for _ in range(30)]
    for budget in (8 * 1024 * 1024, 96 * 1024, 20 * 1024):
        monkeypatch.setattr(jtl, "_VMEM_STATE_BUDGET_BYTES", budget)
        monkeypatch.setattr(ttl, "_STATE_GROUP_BUDGET_BYTES", budget)
        assert ttl._timeline_state_groups(dims, block=256) == \
            jtl._timeline_vmem_chunks(dims, block=256)


# ---------------------------------------------------------------------------
# The oracle property and the errors.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload", jtraces.WORKLOADS)
def test_unbounded_timeline_mean_matches_cpi(workload):
    """With no queueing anywhere, the post-warm-up mean latency and overhead
    reproduce the port's CPI model (<= 1e-6 relative), as in the reference."""
    lines = jtraces.generate(workload, n_ops=1200, max_accesses=3000).lines
    cfgs = [tsim.SystemSimConfig(cache=TLBConfig(256, 4), accel_tlb=TLBConfig(128, 4),
                                 mem_tlb=TLBConfig(128, 4)),
            tsim.SystemSimConfig(cache=TLBConfig(256, 4), accel_tlb=None,
                                 mem_tlb=TLBConfig(128, 4), num_partitions=32)]
    evs = tsweep.sweep_system(lines, cfgs, device="cpu")
    specs = [ttl.TimelineSpec(lines, evs[0 if d == "conventional" else 1], d,
                              cfg=ttl.TimelineConfig.unbounded(),
                              num_partitions=32 if d == "sparta" else 1, workload=workload)
             for d in ttl.DESIGNS]
    for d, res in zip(ttl.DESIGNS, ttl.sweep_timeline(specs, LAT, device="cpu")):
        ev = evs[0 if d == "conventional" else 1]
        perf = tcpi.evaluate_design(d, ev, LAT, instr_per_access=5.0, workload=workload)
        rel = abs(res.mean_latency - perf.access.total) / perf.access.total
        assert rel <= 1e-6, (d, res.mean_latency, perf.access.total)
        ov = perf.access.translation_overhead
        assert abs(res.mean_overhead - ov) / max(ov, 1e-9) <= 1e-6, (d, res.mean_overhead, ov)


def test_errors_match_jax(hetero):
    jspecs, tspecs = hetero
    lines = np.arange(128, dtype=np.int64)
    jev = _jevents(lines)
    tev = _tevents(jev)
    for call in (lambda: ttl.sweep_timeline(tspecs[:1], LAT, kernel_mode="stackdist",
                                            device="cpu"),
                 lambda: ttl.simulate_timeline(lines, tev, "ideal", LAT,
                                               kernel_mode="stackdist", device="cpu"),
                 lambda: tops.resolve_timeline_mode("stackdist", "cpu")):
        with pytest.raises(ValueError, match="stackdist.*timeline"):
            call()
    with pytest.raises(ValueError):
        tops.resolve_timeline_mode("bogus", "cpu")
    with pytest.raises(ValueError, match="at least one"):
        ttl.sweep_timeline([], LAT, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        ttl.TimelineSweepStream([], LAT, device="cpu")
    with pytest.raises(ValueError, match="lat"):
        ttl.sweep_timeline([ttl.TimelineSpec(lines, tev, "ideal")], device="cpu")
    ttl.sweep_timeline([ttl.TimelineSpec(lines, tev, "ideal", lat=LAT)], device="cpu")
    with pytest.raises(ValueError, match="unknown design"):
        ttl.simulate_timeline(lines, tev, "bogus", LAT, device="cpu")
    with pytest.raises(ValueError, match="kernel_mode='cuda'"):
        ttl.sweep_timeline(tspecs[:1], LAT, kernel_mode="cuda", device="cpu")
    with pytest.raises(ValueError, match="kernel_mode='cuda'"):
        ttl.simulate_timeline(lines, tev, "ideal", LAT, kernel_mode="cuda", device="cpu")

    # Stream chunk rules, message for message against the reference's.
    js = jtl.TimelineSweepStream(jspecs[:2], JLAT, block=256)
    ts = ttl.TimelineSweepStream(tspecs[:2], LAT, block=256, device="cpu")
    for lo, hi in ((0, 300), (5, 10), (0, ts.n + 1)):
        with pytest.raises(ValueError) as jerr:
            js.run_chunk(lo, hi, kernel_mode="reference")
        with pytest.raises(ValueError) as terr:
            ts.run_chunk(lo, hi)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="kernel_mode='cuda'"):
        ts.run_chunk(0, 256, kernel_mode="cuda")


def test_default_device_raises_without_a_card(hetero):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    _, tspecs = hetero
    with pytest.raises(RuntimeError, match="cuda"):
        ttl.sweep_timeline(tspecs[:1], LAT)
    with pytest.raises(RuntimeError, match="cuda"):
        ttl.TimelineSweepStream(tspecs[:1], LAT)
    sp = tspecs[0]
    with pytest.raises(RuntimeError, match="cuda"):
        ttl.simulate_timeline(sp.lines, sp.events, sp.design, LAT)
