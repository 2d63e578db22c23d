"""The port's figure drivers go through the shard scheduler
(``repro_torch.core.scheduler``), as the JAX drivers do: on the CPU at a
small ``n_ops``, every routed sweep (Figs 5, 8, 9, 10 and 11), unsharded and
sharded (the serial executor, 3 shards a call), gives exactly what the
unrouted ``sweep_*`` gives on the same traces, and the result carries its
``crash_safety`` record."""
import numpy as np
import pytest
import torch

from repro_torch.core.scheduler import ScheduleConfig
from repro_torch.core.sweep import sweep_system, sweep_tlb
from repro_torch.core.timeline import sweep_timeline


def _assert_bits(got, want, ctx=""):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} output {i}")


def _sched():
    return ScheduleConfig(shards=3, workers=1, executor="serial", poll_s=0.01)



def _bits(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("sched", [None, "serial"])
def test_fig10_and_fig9_routed_equal_their_sweeps(sched):
    from repro_torch.bench import fig9, fig10
    from repro_torch.bench.common import W4, trace

    sc = _sched() if sched else None
    for fig, n_ops in ((fig10, 30), (fig9, 30)):
        res = fig.run(device="cpu", n_ops=n_ops, verbose=False, sched=sc)
        for w in W4:
            want = sweep_system(trace(w, n_ops=n_ops).lines, fig.system_configs(),
                                device="cpu")
            got = res["events"][w]
            for f in ("cache_hit", "accel_tlb_hit", "mem_tlb_hit"):
                np.testing.assert_array_equal(_bits(getattr(got, f)), _bits(getattr(want, f)))
        cs = res["crash_safety"]
        assert cs["quarantined_shards"] == {}
        assert set(cs) == {f"system-{w}" for w in W4} | {"quarantined_shards"}
        assert all(("scheduler" in cs[f"system-{w}"]) == bool(sched) for w in W4)


@pytest.mark.parametrize("sched", [None, "serial"])
def test_fig11_fig5_fig8_routed_equal_their_sweeps(sched):
    from repro_torch.bench import fig5, fig8, fig11
    from repro_torch.core.sparta import SystemLatencies

    sc = _sched() if sched else None
    lat = SystemLatencies(n_sockets=8)
    res = fig11.run(device="cpu", n_ops=20, cap=400, accels=(1, 4), verbose=False, sched=sc)
    want = sweep_timeline(res["specs"], lat, device="cpu")
    _assert_bits([a for r in res["results"] for a in (r.latency, r.overhead, r.done)],
                 [a for r in want for a in (r.latency, r.overhead, r.done)], "fig11")
    for w, lines in res["lines"].items():
        ev = sweep_system(lines, fig11.system_configs(), device="cpu")
        got = [sp.events for sp in res["specs"] if sp.lines is lines]
        np.testing.assert_array_equal(_bits(got[0].cache_hit), _bits(ev[0].cache_hit))
        np.testing.assert_array_equal(_bits(got[1].mem_tlb_hit), _bits(ev[1].mem_tlb_hit))

    res = fig5.run(device="cpu", n_ops=8, tl_cap=300, verbose=False, sched=sc)
    for key, hits in res["hits"].items():
        want = sweep_tlb(res["lines"][key], fig5.specs(), device="cpu")
        np.testing.assert_array_equal(_bits(hits.hits), _bits(want.hits))
    want = sweep_timeline(res["timeline_specs"], lat, device="cpu")
    _assert_bits([r.done for r in res["timeline"]], [r.done for r in want], "fig5 timeline")

    res = fig8.run(device="cpu", n_ops=40, salts={w: 0 for w in fig8.default_salts()},
                   verbose=False, sched=sc)
    for name, hits in res["hits"].items():
        want = sweep_tlb(res["lines"][name] >> 6, fig8.specs(), device="cpu")
        np.testing.assert_array_equal(_bits(hits.hits), _bits(want.hits))
    assert res["crash_safety"]["quarantined_shards"] == {}
