"""The CUDA kernels K1, K2, K3 and K4 on a card against their plain PyTorch
versions on the same inputs: hits, depths, timeline latency / overhead / done
and carried state bit-identical (tolerance 0).  The attention kernels K5
(flash attention) and K6 (paged attention) within 2e-5 in float32 and 2e-2
in bfloat16 (the JAX package's own tolerances, tests/test_kernels.py), and
the serving engine at its default mode through both.  The state-space scans
K7 (rwkv6) and K8 (mamba2) within 5e-4 in float32 (the JAX package's scan
tolerance) and 2e-2 for bfloat16 outputs (one bfloat16 rounding, 2^-8 of
the value, after float32 sums taken in another order), zamba2's decays
included, and both state-space models at their default mode through them.

These tests need a card and skip without one (``-m cuda`` selects them):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*.py

They import nothing of JAX, so they run on a machine without it.
"""
import dataclasses

import _timeline_cases
import numpy as np
import pytest
import torch
from _lru_cases import chunks, k1_cases, k2_cases
from _paged_cases import EDGE_CASES, FLOAT64_EDGES, edge_inputs
from _stack_cases import CASES as STACK_CASES
from _stack_cases import case_inputs as stack_case_inputs

from repro_torch.core import stackdist, sweep, tlbsim
from repro_torch.core.sparta import TLBConfig
from repro_torch.kernels import system_sim, tlb_sim
from repro_torch.kernels.stackdist import kernel as k3
from repro_torch.kernels.stackdist import stack_scan

pytestmark = pytest.mark.cuda


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _lines(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 1 << 28, n).astype(np.int64)


def _system_cfgs():
    C, T = tlbsim.SystemSimConfig, TLBConfig
    return [C(), C(cache=None, num_partitions=8),
            C(accel_tlb=T(entries=8, ways=4), num_partitions=4,
              accel_probe_on_miss_only=False),
            C(accel_tlb=T(entries=2, ways=4), page_shift=21, num_partitions=32),
            C(mem_tlb=T(entries=64, ways=8)),
            C(cache=T(entries=512, ways=8), num_partitions=16),
            C(cache=None, accel_tlb=T(entries=16, ways=2), num_partitions=2,
              accel_probe_on_miss_only=False),
            C(page_shift=21, num_partitions=128)]


def _hetero_k1_case() -> dict:
    rng = np.random.default_rng(0)
    TS, N, valid = 37, 3001, (8, 4, 1, 3, 6)
    return {"name": "hetero", "set": rng.integers(0, TS, (len(valid), N)).astype(np.int32),
            "tag": rng.integers(0, 400, (len(valid), N)).astype(np.int32),
            "TS": TS + 1, "W": 8, "valid": valid, "now0": 17, "cuts": []}


def _hetero_k2_case() -> dict:
    cfgs = _system_cfgs()
    lines = tlbsim.as_tensor(_lines(7, 2001), "cpu")
    geos, _ = sweep._system_layout(cfgs)
    envs = [sweep._envelope(geo, range(len(cfgs))) for geo in geos]
    return {"name": "hetero",
            "streams": [x.numpy() for x in sweep._system_streams(lines, cfgs)],
            "flags": tlbsim.system_flags(cfgs, "cpu").numpy(),
            "geom": [(e[0] + 1, e[1], e[2]) for e in envs], "now0": 3, "cuts": []}


_K1_CASES = [_hetero_k1_case(), *k1_cases()]
_K2_CASES = [_hetero_k2_case(), *k2_cases()]


@pytest.mark.parametrize("case", _K1_CASES, ids=[c["name"] for c in _K1_CASES])
def test_tlb_sim_kernel_matches_plain_on_card(case):
    """The set-parallel K1 against its plain version, chunk by chunk with the
    state carried: skewed streams (one set; a set per access over 65,537
    rows), every way class (registers up to 32, device memory at 33), an
    empty chunk and stamps up to 2**31 - 2.  One launch counted per call
    that has accesses."""
    dev = _card()
    s, t = (torch.from_numpy(case[k]).to(dev) for k in ("set", "tag"))
    B, L = s.shape
    state = tlbsim.padded_tlb_state(B, case["TS"], case["W"], case["valid"], device=dev)
    got_state, want_state = state, state
    for lo, hi in chunks(L, case["cuts"]):
        args = (s[:, lo:hi].contiguous(), t[:, lo:hi].contiguous())
        n0 = tlb_sim.kernel.launches
        got = tlb_sim.tlb_sim_batched_carry(*args, *got_state, case["now0"] + lo,
                                            kernel_mode="cuda")
        assert tlb_sim.kernel.launches == n0 + (hi > lo)
        want = tlb_sim.tlb_sim_batched_carry(*args, *want_state, case["now0"] + lo,
                                             kernel_mode="reference")
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x, y), f"chunk {lo}:{hi}"
        got_state, want_state = got[1:], want[1:]
    if L == 0:
        return
    tags, last = state
    with pytest.raises(ValueError, match="contiguous"):
        tlb_sim.kernel.tlb_sim_carry_cuda(s[:, ::2], t[:, ::2], tags, last, 0)
    with pytest.raises(ValueError, match="set index"):
        tlb_sim.kernel.tlb_sim_carry_cuda(s + case["TS"], t, tags, last, 0)
    with pytest.raises(ValueError, match="int32"):
        tlb_sim.kernel.tlb_sim_carry_cuda(s.long(), t, tags, last, 0)


@pytest.mark.parametrize("case", _K2_CASES, ids=[c["name"] for c in _K2_CASES])
def test_system_sim_kernel_matches_plain_on_card(case):
    """The set-parallel K2 (cache pass, gated TLB pass) against its plain
    version, chunk by chunk with the state carried, on the heterogeneous
    8-config batch and the skewed and edge cases of K1 in all three
    structures, with every combination of the three flags."""
    dev = _card()
    streams = [torch.from_numpy(x).to(dev) for x in case["streams"]]
    flags = torch.from_numpy(case["flags"]).to(dev)
    B, L = streams[0].shape
    state = tuple(x for S, W, v in case["geom"]
                  for x in tlbsim.padded_tlb_state(B, S, W, v, device=dev))
    got_state, want_state = state, state
    for lo, hi in chunks(L, case["cuts"]):
        args = [x[:, lo:hi].contiguous() for x in streams]
        n0 = system_sim.kernel.launches
        got = system_sim.system_sim_batched_carry(*args, flags, got_state,
                                                  case["now0"] + lo, kernel_mode="cuda")
        assert system_sim.kernel.launches == n0 + (hi > lo)
        want = system_sim.system_sim_batched_carry(*args, flags, want_state,
                                                   case["now0"] + lo, kernel_mode="reference")
        torch.cuda.synchronize()
        for x, y in zip(got[0] + got[1], want[0] + want[1]):
            assert torch.equal(x, y), f"chunk {lo}:{hi}"
        got_state, want_state = got[1], want[1]


@pytest.mark.parametrize("case", STACK_CASES, ids=[c[0] for c in STACK_CASES])
def test_stack_scan_kernel_matches_plain_on_card(case, monkeypatch):
    """The edge cases of ``tests/_stack_cases.py``: every stack width the
    launcher dispatches on (registers up to 32 slots, device memory above),
    both designs of the plan and the P each case forces, segment starts on
    parts' first steps and at every step, padding, ragged parts and tiles,
    C = 1 to 16,384.  One launch counted per call."""
    dev = _card()
    if case[4] is not None:
        monkeypatch.setattr(k3, "stack_plan",
                            lambda L, C, W, sms: k3.plan_for_parts(L, C, W, sms, case[4]))
    tags, seg, init = (torch.from_numpy(x).to(dev) for x in stack_case_inputs(case))
    n0 = k3.launches
    got = stack_scan(tags, seg, init, kernel_mode="cuda")
    assert k3.launches == n0 + 1
    want = stack_scan(tags, seg, init, kernel_mode="reference")
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="bool"):
        k3.stack_scan_cuda(tags, seg.to(torch.uint8), init)
    with pytest.raises(ValueError, match="int32"):
        k3.stack_scan_cuda(tags.long(), seg, init)


def test_stack_depths_on_card_match_the_cpu():
    dev = _card()
    rng = np.random.default_rng(11)
    s = torch.from_numpy(rng.integers(0, 16, (3, 5000)))
    t = torch.from_numpy(rng.integers(0, 90, (3, 5000)))
    cpu = stackdist.stack_depths_batched(s, t, cap=8, block=64)
    card = stackdist.stack_depths_batched(s.to(dev), t.to(dev), cap=8, block=64)
    assert torch.equal(card.cpu(), cpu)


def test_sweeps_and_streams_on_card_match_the_cpu():
    dev = _card()
    lines = _lines(3, 1500)
    cfgs = _system_cfgs()
    specs = [sweep.TLBSweepSpec(TLBConfig(entries=e, ways=4), p, 12)
             for e in (4, 64, 1024) for p in (1, 4, 128)]
    cpu = sweep.sweep_system(lines, cfgs, device="cpu")
    card = sweep.sweep_system(lines, cfgs, device=dev)
    stream = sweep.SystemSweepStream(cfgs, device=dev)
    parts = [stream.run_chunk(lines[i:i + 601]) for i in range(0, len(lines), 601)]
    for k, key in enumerate(("cache_hit", "accel_tlb_hit", "mem_tlb_hit")):
        assert torch.equal(getattr(card, key).cpu(), getattr(cpu, key))
        assert torch.equal(torch.cat([p[k] for p in parts], 1).cpu(), getattr(cpu, key))
    tcpu = sweep.sweep_tlb(lines, specs, device="cpu")
    for mode in ("auto", "stackdist", "cuda"):
        tcard = sweep.sweep_tlb(lines, specs, kernel_mode=mode, device=dev)
        assert torch.equal(tcard.hits.cpu(), tcpu.hits), mode
        assert np.array_equal(tcard.miss_ratios, tcpu.miss_ratios)


def _timeline_batch(dev, n: int, params):
    """Seeded per-access columns ([B, n], ids within each sim's own counts)
    and the packed rows of a heterogeneous batch of sims."""
    from repro_torch.kernels.timeline import pack_params

    rng = np.random.default_rng(len(params) * n)
    B = len(params)
    cols = [np.zeros((B, n), np.int32) for _ in range(7)] + [np.zeros((B, n), np.float32)]
    for i, p in enumerate(params):
        for k, hi in enumerate((p.num_accels, p.num_partitions, max(p.dram_banks, 1),
                                max(p.dram_banks, 1))):
            cols[k][i] = rng.integers(0, hi, n)
        for k, frac in zip((4, 5, 6), (0.4, 0.6, 0.7)):
            cols[k][i] = rng.random(n) < frac
        if not (p.serial_walk or p.mem_tlb):
            cols[7][i] = 24.0 * (i % 2)
    fp = np.stack([pack_params(p)[0] for p in params])
    ip = np.stack([pack_params(p)[1] for p in params])
    return [torch.from_numpy(c).to(dev) for c in cols], fp, ip


def _timeline_params():
    from repro_torch.kernels.timeline import TimelineParams as P

    return [P(True, False, 4, 8, 1, 1, 16), P(False, True, 16, 8, 32, 3, 16),
            P(False, True, 2, 0, 8, 0, 0), P(False, False, 1, 0, 1, 0, 16),
            P(False, False, 8, 8, 1, 0, 0), P(True, False, 1, 0, 1, 3, 0),
            P(False, True, 2, 0, 32, 1, 0), P(False, True, 1, 8, 4, 3, 16)]


def test_timeline_kernel_matches_plain_on_card():
    """K4's three op entry points: the batched op, the carry op split at odd
    points (outputs and state), and the single-sim op against the
    static-parameter oracle."""
    from repro_torch.kernels import timeline as tl
    from repro_torch.kernels.timeline import kernel as k4

    dev = _card()
    params = _timeline_params()
    cols, fp, ip = _timeline_batch(dev, 2003, params)
    n0 = k4.launches
    got = tl.timeline_sim_batched(*cols, fp, ip, kernel_mode="cuda")
    assert k4.launches == n0 + 1
    want = tl.timeline_sim_batched(*cols, fp, ip, kernel_mode="reference")
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)

    env = tl.envelope_of(ip)
    runs = {}
    for mode in ("cuda", "reference"):
        st = tl.timeline_init_state_batched(len(params), env, ip[:, 5], device=dev)
        outs = []
        for lo, hi in ((0, 701), (701, 1999), (1999, 2003)):
            ys, st = tl.timeline_sim_batched_carry(
                *(c[:, lo:hi].contiguous() for c in cols), fp, ip, st, kernel_mode=mode)
            outs.append(ys)
        runs[mode] = [torch.cat([o[k] for o in outs], 1) for k in range(3)] + list(st)
    for x, y in zip(runs["cuda"], runs["reference"]):
        assert torch.equal(x, y)
    for x, y in zip(runs["cuda"], want):
        assert torch.equal(x, y)

    for i in (0, 1, 3):
        one = [c[i].contiguous() for c in cols]
        for x, y in zip(tl.timeline_sim(*one, params[i], kernel_mode="cuda"),
                        tl.timeline_sim(*one, params[i], kernel_mode="reference")):
            assert torch.equal(x, y)

    with pytest.raises(ValueError, match="contiguous"):
        k4.timeline_carry_cuda([c[:, ::2] for c in cols], *(
            torch.from_numpy(x).to(dev) for x in (fp, ip)),
            tl.timeline_init_state_batched(len(params), env, ip[:, 5], device=dev))
    bad = [c.clone() for c in cols]
    bad[2][0, 5] = env[4]
    with pytest.raises(ValueError, match="bank_data"):
        tl.timeline_sim_batched(*bad, fp, ip, kernel_mode="cuda")
    with pytest.raises(ValueError, match="int32"):
        tl.timeline_sim_batched(cols[0].long(), *cols[1:], fp, ip, kernel_mode="cuda")


def test_timeline_kernel_device_memory_state_on_card():
    """A state envelope above the kernel's 48 KB of shared memory per sim
    (1,024 partitions x 16 ports) takes its device-memory variant."""
    from repro_torch.kernels import timeline as tl
    from repro_torch.kernels.timeline import TimelineParams as P

    dev = _card()
    params = [P(False, True, 16, 8, 1024, 16, 64), P(False, True, 3, 2, 900, 5, 7),
              P(True, False, 2, 4, 1, 1, 16)]
    cols, fp, ip = _timeline_batch(dev, 1500, params)
    got = tl.timeline_sim_batched(*cols, fp, ip, kernel_mode="cuda")
    want = tl.timeline_sim_batched(*cols, fp, ip, kernel_mode="reference")
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _misaligned(x: np.ndarray, offset: int, dev) -> torch.Tensor:
    """``x`` on the card as a contiguous view whose base sits ``offset``
    elements past a fresh allocation's (16-byte aligned) start."""
    flat = torch.empty(x.size + offset, dtype=getattr(torch, x.dtype.name), device=dev)
    out = flat[offset:].view(x.shape)
    out.copy_(torch.from_numpy(x))
    return out


@pytest.mark.parametrize("name", list(_timeline_cases.EDGE_CASES))
def test_timeline_kernel_edges_on_card(name):
    """K4's order of work at its edges (``tests/_timeline_cases.py``): bd ==
    bp, all hits, all misses, unbounded queues, T = 1 and T > 1, L below and
    not a multiple of the staging tile, one access, columns misaligned
    against 16 bytes, the device-memory state, and a resume from a state
    whose MSHR counts sit mid-ring, chunk by chunk: outputs and the carried
    state bit-identical to the plain version (tolerance 0)."""
    from repro_torch.kernels import timeline as tl
    from repro_torch.kernels.timeline import kernel as k4

    dev = _card()
    params, n, override, cuts, prefix, offsets = _timeline_cases.EDGE_CASES[name]
    cols_np, fp, ip = _timeline_cases.edge_columns(params, n, override, seed=len(name))
    offsets = offsets or (0,) * 8
    cols = [_misaligned(c, o, dev) for c, o in zip(cols_np, offsets)]
    state = tl.timeline_init_state_batched(len(params), _timeline_cases.envelope(params),
                                           ip[:, 5], device=dev)
    if prefix:
        state = tl.timeline_sim_batched_carry(*(c[:, :prefix].contiguous() for c in cols),
                                              fp, ip, state, kernel_mode="reference")[1]
        assert bool((state[2] % torch.from_numpy(np.maximum(ip[:, 3], 1)).to(dev)[:, None]
                     != 0).any())                       # counts mid-ring
    got_state, want_state = state, state
    bounds = [prefix, *cuts, n]
    for lo, hi in zip(bounds, bounds[1:]):
        part = [c[:, lo:hi] if lo == prefix and hi == n else c[:, lo:hi].contiguous()
                for c in cols]
        n0 = k4.launches
        got, got_state = tl.timeline_sim_batched_carry(*part, fp, ip, got_state,
                                                       kernel_mode="cuda")
        assert k4.launches == n0 + 1
        want, want_state = tl.timeline_sim_batched_carry(*part, fp, ip, want_state,
                                                         kernel_mode="reference")
        torch.cuda.synchronize()
        for x, y in zip(list(got) + list(got_state), list(want) + list(want_state)):
            assert torch.equal(x, y), f"[{lo}, {hi})"


def test_timeline_sweeps_on_card_match_the_cpu():
    from repro_torch.core import timeline as ttl
    from repro_torch.core.sparta import SystemLatencies

    dev = _card()
    lat = SystemLatencies()
    lines = _lines(9, 1800)
    cfgs = [tlbsim.SystemSimConfig(cache=TLBConfig(256, 4), accel_tlb=TLBConfig(128, 4)),
            tlbsim.SystemSimConfig(cache=TLBConfig(256, 4), num_partitions=32)]
    for device in ("cpu", dev):
        evs = sweep.sweep_system(lines, cfgs, device=device)
        specs = [ttl.TimelineSpec(lines[:n], tlbsim.SystemEvents(
                     *(x[:n] for x in evs[k][:3]), n_warm=evs[k].n_warm - (1800 - n)),
                     d, num_partitions=32 if d == "sparta" else 1, num_accelerators=a)
                 for n, k, d, a in ((1800, 0, "conventional", 4), (1800, 1, "sparta", 16),
                                    (1100, 1, "dipta", 2), (1799, 1, "ideal", 1))]
        res = ttl.sweep_timeline(specs, lat, device=device)
        stream = ttl.TimelineSweepStream(specs, lat, block=256, device=device)
        parts = [stream.run_chunk(lo, min(lo + 768, stream.n)) for lo in range(0, 1800, 768)]
        got = stream.finalize(*(np.concatenate([p[k] for p in parts], 1) for k in range(3)))
        single = ttl.simulate_timeline(lines, specs[1].events, "sparta", lat,
                                       num_partitions=32, num_accelerators=16, device=device)
        if device == "cpu":
            cpu = (res, got, single)
            continue
        for a, b in zip(res + got + [single], cpu[0] + cpu[1] + [cpu[2]]):
            for k in ("latency", "overhead", "done"):
                assert np.array_equal(getattr(a, k), getattr(b, k))


# ---------------------------------------------------------------------------
# K5 and K6: the attention kernels.
# ---------------------------------------------------------------------------

_ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# (B, Hq, Hkv, Tq, Tk, D, causal, dtype): the JAX test shapes, then the head
# dims of qwen3 / starcoder2 (128), stablelm (160) and gemma (256) with
# ragged lengths, Tq < Tk and Tq = 1.
_FLASH_CASES = [
    (1, 4, 2, 64, 64, 32, True, torch.float32),
    (2, 8, 8, 96, 96, 64, True, torch.float32),
    (1, 4, 1, 33, 80, 64, False, torch.float32),
    (2, 2, 2, 128, 128, 128, True, torch.bfloat16),
    (1, 4, 2, 1, 96, 32, True, torch.float32),
    (1, 8, 2, 77, 77, 64, True, torch.bfloat16),
    (1, 10, 2, 130, 130, 128, True, torch.float32),
    (1, 8, 2, 45, 45, 160, True, torch.bfloat16),
    (2, 4, 4, 50, 50, 256, True, torch.float32),
    (1, 5, 1, 20, 70, 128, True, torch.float32),
    (1, 4, 2, 1, 300, 256, True, torch.bfloat16),
    (1, 9, 1, 37, 37, 128, False, torch.bfloat16),
    (1, 32, 32, 200, 200, 112, True, torch.bfloat16),     # zamba2: head_dim 112, group 1
    (2, 8, 8, 96, 96, 112, True, torch.float32),
    # The bf16 tensor-core kernel's tile edges (64-row warpgroups, 128-row
    # blocks, 128- or 64-key tiles, head dims padded to 64 columns).
    (1, 8, 2, 63, 63, 128, True, torch.bfloat16),
    (1, 8, 2, 64, 64, 128, True, torch.bfloat16),
    (1, 8, 2, 65, 65, 128, True, torch.bfloat16),
    (1, 8, 2, 129, 129, 128, True, torch.bfloat16),
    (1, 8, 2, 1, 4096, 128, True, torch.bfloat16),
    (1, 10, 2, 100, 300, 128, True, torch.bfloat16),      # Tq < Tk, group 5
    (1, 4, 2, 200, 70, 64, True, torch.bfloat16),         # Tq > Tk: rows that see no key
    (1, 4, 2, 70, 70, 32, True, torch.bfloat16),
    (1, 4, 2, 70, 70, 32, False, torch.bfloat16),
    (1, 4, 4, 90, 90, 64, False, torch.bfloat16),
    (1, 8, 2, 130, 130, 160, False, torch.bfloat16),
    (1, 4, 2, 200, 200, 256, True, torch.bfloat16),
    (1, 4, 4, 75, 75, 256, False, torch.bfloat16),
    (2, 8, 2, 150, 150, 128, True, torch.bfloat16),
    (1, 40, 8, 4096, 4096, 128, True, torch.bfloat16),    # qwen3-14b's heads, one long call
    # whisper-medium (head_dim 64, group 1): the encoder's 1,500 frames, the
    # decode step's cross-attention (one query row, TMA reads past Tq fill
    # zeros) and the decoder's causal self-attention.
    (4, 16, 16, 1500, 1500, 64, False, torch.bfloat16),
    (4, 16, 16, 1, 1500, 64, False, torch.bfloat16),
    (4, 16, 16, 32, 32, 64, True, torch.bfloat16),
]


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,dtype", _FLASH_CASES)
def test_flash_attention_kernel_matches_plain_on_card(B, Hq, Hkv, Tq, Tk, D, causal, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import kernel as k5

    dev = _card()
    rng = np.random.default_rng(Tq * 1000 + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
               for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D)))
    n0 = k5.launches
    got = fa.flash_attention(q, k, v, causal=causal, kernel_mode="cuda")
    assert k5.launches == n0 + 1
    want = fa.flash_attention(q, k, v, causal=causal, kernel_mode="reference")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = _ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_bf16_refuses_an_unaligned_base():
    """TMA reads from 16-byte-aligned bases only: a bf16 input one element
    into its storage raises before any launch."""
    from repro_torch.kernels.flash_attention import kernel as k5

    dev = _card()
    shape = (1, 4, 64, 64)
    buf = torch.zeros(1 + 4 * 64 * 64, device=dev, dtype=torch.bfloat16)
    q = buf[1:].view(shape)
    kv = torch.zeros((1, 2, 64, 64), device=dev, dtype=torch.bfloat16)
    assert q.is_contiguous() and q.data_ptr() % 16
    n0 = k5.launches
    aligned = kv.new_zeros(shape)
    for args in ((q, kv, kv), (aligned, q[:, :2], kv), (aligned, kv, q[:, :2])):
        with pytest.raises(ValueError, match="aligned"):
            k5.flash_attention_cuda(*args)
    assert k5.launches == n0


def _paged_inputs(rng, dev, B, Hq, Hkv, D, page, pages, slots, q_dtype):
    """Tables with unmapped holes, a sequence with ctx 0 and contexts that end
    mid-page."""
    q = torch.from_numpy(rng.standard_normal((B, Hq, D)).astype(np.float32)).to(dev, q_dtype)
    kp, vp = (torch.from_numpy(rng.standard_normal((slots, page, Hkv, D)).astype(np.float32))
              .to(dev) for _ in range(2))
    tbl = np.full((B, pages), -1, np.int32)
    ctx = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(1, pages + 1))
        tbl[b, :n] = rng.choice(slots, n, replace=False)
        ctx[b] = (n - 1) * page + int(rng.integers(1, page + 1))
        if n > 2 and b % 2:
            tbl[b, 1] = -1                       # an unmapped page inside the context
    ctx[-1] = 0 if B > 1 else ctx[-1]
    return q, kp, vp, torch.from_numpy(tbl).to(dev), torch.from_numpy(ctx).to(dev)


# (B, Hq, Hkv, D, page, pages, slots, q dtype, edge): the JAX test shapes,
# then qwen3-14b's serving shape and the other dense head dims and groups
# (random tables with holes, a context of 0); then the split kernel's edges
# of tests/_paged_cases.py (contexts on and past the splits' boundaries, a
# split of unmapped pages, one page, B = 1 at 4,096 and 1,900 keys).
_PAGED_CASES = [(*c, None) for c in [
    (2, 8, 2, 64, 16, 4, 32, torch.float32),
    (3, 4, 4, 32, 8, 6, 64, torch.float32),
    (1, 16, 8, 128, 32, 3, 16, torch.float32),
    (4, 40, 8, 128, 256, 9, 40, torch.bfloat16),
    (4, 40, 8, 128, 256, 9, 40, torch.float32),
    (3, 32, 8, 160, 64, 5, 32, torch.bfloat16),
    (2, 16, 16, 256, 16, 4, 32, torch.float32),
    (3, 36, 4, 128, 32, 4, 32, torch.float32),
    (2, 8, 1, 64, 4, 7, 32, torch.bfloat16),
    (4, 32, 32, 112, 64, 5, 32, torch.bfloat16),          # zamba2: head_dim 112, group 1
    (4, 32, 32, 112, 64, 5, 32, torch.float32),
]] + [(*c[:7], getattr(torch, c[7]), c[8]) for c in EDGE_CASES]


@pytest.mark.parametrize("B,Hq,Hkv,D,page,pages,slots,q_dtype,edge", _PAGED_CASES)
def test_paged_attention_kernel_matches_plain_on_card(B, Hq, Hkv, D, page, pages, slots, q_dtype,
                                                      edge):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.paged_attention import kernel as k6

    dev = _card()
    rng = np.random.default_rng(D + page)
    if edge is None:
        args = _paged_inputs(rng, dev, B, Hq, Hkv, D, page, pages, slots, q_dtype)
    else:
        plan = k6.split_plan(B, Hkv, pages, page, k6.sm_count(dev.index or 0), D, Hq // Hkv)
        arrs = edge_inputs(rng, B, Hq, Hkv, D, page, pages, slots, edge,
                           plan.tiles_per_split * k6.TILE)
        args = [torch.from_numpy(a).to(dev) for a in arrs]
        args[0] = args[0].to(q_dtype)
    n0 = k6.launches
    got = pa.paged_attention_partial(*args, kernel_mode="cuda")
    assert k6.launches == n0 + 1
    assert all(g.dtype == torch.float32 for g in got)
    if edge in FLOAT64_EDGES:
        want = pa.paged_attention_partial(args[0].double(), args[1].double(), args[2].double(),
                                          *args[3:], kernel_mode="reference")
        got = [g.double() for g in got]
    else:
        want = pa.paged_attention_partial(*args, kernel_mode="reference")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)
    # A sequence with no valid position keeps the initial residuals.
    for b in np.flatnonzero(args[4].cpu().numpy() == 0) if edge else [B - 1] if B > 1 else []:
        assert float(got[1][b].max()) == float(np.float32(-1e30)) and float(got[2][b].abs().max()) == 0.0
    out = pa.paged_attention(*args, kernel_mode="cuda")
    torch.testing.assert_close(out.float(), pa.paged_attention(*args, kernel_mode="reference")
                               .float(), atol=_ATTN_TOL[q_dtype], rtol=_ATTN_TOL[q_dtype])


def test_attention_kernels_refuse_what_they_do_not_take():
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda

    dev = _card()
    q = torch.zeros((1, 4, 8, 64), device=dev)
    kv = torch.zeros((1, 2, 8, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(2, 3).contiguous().transpose(2, 3), kv, kv)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_cuda(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(q[..., :60].contiguous(), kv[..., :60].contiguous(),
                             kv[..., :60].contiguous())
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_cuda(q[:, :3].contiguous(), kv, kv)
    pool = torch.zeros((4, 8, 2, 64), device=dev)
    tbl = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    ctx = torch.ones(1, dtype=torch.int32, device=dev)
    qd = torch.zeros((1, 4, 64), device=dev)
    with pytest.raises(ValueError, match="float32"):
        paged_attention_cuda(qd, pool.bfloat16(), pool, tbl, ctx)
    with pytest.raises(ValueError, match="int32"):
        paged_attention_cuda(qd, pool, pool, tbl.long(), ctx)
    with pytest.raises(ValueError, match="query heads per KV head"):
        paged_attention_cuda(torch.zeros((1, 34, 64), device=dev),
                             torch.zeros((4, 8, 2, 64), device=dev)[:, :, :1].contiguous(),
                             torch.zeros((4, 8, 1, 64), device=dev), tbl, ctx)


def test_engine_default_mode_launches_both_kernels():
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import kernel as k5
    from repro_torch.kernels.paged_attention import kernel as k6
    from repro_torch.serve.engine import SpartaEngine

    dev = _card()
    cfg = dataclasses.replace(registry.get_smoke("qwen3-14b"), kv_page_size=4)
    params = models.init(cfg, seed=3, device=dev)
    out = {}
    for mode in ("auto", "reference"):
        kw = {} if mode == "auto" else {"kernel_mode": mode}
        eng = SpartaEngine(cfg, params, num_partitions=2, slots_per_partition=32,
                           max_batch=2, device=dev, **kw)
        n5, n6 = k5.launches, k6.launches
        rids = [eng.submit(p, max_new_tokens=5) for p in ([1, 2, 3, 4, 5], [7, 8, 9], [4] * 9)]
        eng.run_to_completion()
        eng.fork_request(rids[0], max_new_tokens=3)
        steps = 0
        while eng.step():
            steps += 1
        eng.kv.check_invariants()
        out[mode] = ({r: q.generated for r, q in eng.finished.items()},
                     k5.launches - n5, k6.launches - n6)
    tokens, n5, n6 = out["auto"]
    assert tokens == out["reference"][0]
    assert n5 == cfg.num_layers * 3 and n6 > 0 and n6 % cfg.num_layers == 0
    assert out["reference"][1:] == (0, 0)


_SCAN_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# (B, H, T, N, chunk, dtype, w range): the JAX test shapes, rwkv6-1.6b's head
# shape, T < chunk, and decays fast enough that the TPU kernel's
# k exp(-logd) form would overflow (w in [1e-3, 0.05] over 32 tokens).
_RWKV6_CASES = [
    (2, 2, 64, 32, 32, torch.float32, (0.75, 0.999)),
    (1, 4, 96, 16, 16, torch.float32, (0.75, 0.999)),
    (2, 32, 256, 64, 32, torch.bfloat16, (0.75, 0.999)),
    (1, 2, 20, 16, 32, torch.float32, (0.75, 0.999)),
    (2, 4, 64, 64, 32, torch.float32, (1e-3, 0.05)),
    # The bf16 tensor-core kernel's edges: T < 16, T equal to the chunk,
    # C = 64, N = 32 (a plan that cannot fill the card), N = 40 (no 16-byte
    # copies, a partial slice), w near 0 (log w at its floor, zeros
    # included), strong decays, and a batch of (b, h) that fills the card.
    (1, 2, 8, 64, 32, torch.bfloat16, (0.75, 0.999)),
    (2, 4, 32, 64, 32, torch.bfloat16, (0.75, 0.999)),
    (1, 4, 128, 64, 64, torch.bfloat16, (0.75, 0.999)),
    (2, 2, 64, 32, 32, torch.bfloat16, (0.75, 0.999)),
    (1, 2, 64, 40, 32, torch.bfloat16, (0.75, 0.999)),
    (1, 2, 64, 64, 32, torch.bfloat16, (0.0, 1e-44)),
    (2, 4, 96, 64, 32, torch.bfloat16, (1e-3, 0.05)),
    (4, 34, 64, 64, 32, torch.bfloat16, (0.75, 0.999)),
]


@pytest.mark.parametrize("B,H,T,N,chunk,dtype,wr", _RWKV6_CASES)
def test_rwkv6_scan_kernel_matches_plain_on_card(B, H, T, N, chunk, dtype, wr):
    from repro_torch.kernels import rwkv6_scan as k7ops
    from repro_torch.kernels.rwkv6_scan import kernel as k7

    dev = _card()
    rng = np.random.default_rng(T * 100 + N)
    r, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, N)).astype(np.float32) * 0.5)
               .to(dev, dtype) for _ in range(3))
    w = torch.from_numpy(rng.uniform(*wr, (B, H, T, N)).astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.standard_normal((H, N)).astype(np.float32) * 0.5).to(dev)
    n0 = k7.launches
    o, s = k7ops.rwkv6_scan(r, k, v, w, u, chunk=chunk, kernel_mode="cuda")
    assert k7.launches == n0 + 1
    o_ref, s_ref = k7ops.rwkv6_scan(r, k, v, w, u, kernel_mode="reference")
    torch.cuda.synchronize()
    assert o.dtype == dtype and s.dtype == torch.float32
    assert bool(torch.isfinite(o.float()).all()) and bool(torch.isfinite(s).all())
    _close(o, o_ref, _SCAN_TOL[dtype])
    _close(s, s_ref, _SCAN_TOL[torch.float32])


# (B, H, T, P, N, chunk, dtype, zamba2 decays): the JAX test shapes, then
# zamba2-7b's head shape at its decays, A = -linspace(1, 8, H) and
# dt = softplus(N(0, 0.63^2)), where the TPU kernel gives NaN.
_MAMBA2_CASES = [
    (2, 2, 64, 32, 16, 32, torch.float32, False),
    (1, 4, 96, 16, 32, 16, torch.float32, False),
    (2, 112, 256, 64, 64, 64, torch.bfloat16, True),
    (1, 8, 128, 16, 16, 64, torch.float32, True),
    (1, 3, 40, 16, 16, 64, torch.float32, True),
    # The tensor-core kernel's edges: H not a multiple of the heads a block
    # (2 at these shapes), T < chunk, N and P below its 64-wide tiles, and
    # zamba2's P = N = 64 in float32 and bf16.
    (2, 7, 128, 64, 64, 64, torch.bfloat16, True),
    (1, 5, 40, 64, 64, 64, torch.bfloat16, True),
    (2, 3, 96, 16, 32, 32, torch.bfloat16, False),
    (2, 6, 256, 64, 64, 64, torch.float32, True),
    (2, 6, 256, 64, 64, 64, torch.bfloat16, True),
]


@pytest.mark.parametrize("B,H,T,P,N,chunk,dtype,zamba2", _MAMBA2_CASES)
def test_mamba2_scan_kernel_matches_plain_on_card(B, H, T, P, N, chunk, dtype, zamba2):
    from repro_torch.kernels import mamba2_scan as k8ops
    from repro_torch.kernels.mamba2_scan import kernel as k8

    dev = _card()
    rng = np.random.default_rng(T * 100 + P)
    x = torch.from_numpy(rng.standard_normal((B, H, T, P)).astype(np.float32) * 0.5).to(dev, dtype)
    if zamba2:
        dt = torch.nn.functional.softplus(torch.from_numpy(
            rng.normal(0.0, 0.63, (B, H, T)).astype(np.float32)))
        A = -torch.linspace(1.0, 8.0, H)
    else:
        dt = torch.from_numpy(rng.uniform(0.001, 0.1, (B, H, T)).astype(np.float32))
        A = torch.from_numpy(-rng.uniform(0.5, 4.0, H).astype(np.float32))
    Bm, C = (torch.from_numpy(rng.standard_normal((B, T, N)).astype(np.float32) * 0.5)
             for _ in range(2))
    D = torch.from_numpy(rng.standard_normal(H).astype(np.float32))
    dt, A, Bm, C, D = (t.to(dev) for t in (dt, A, Bm, C, D))
    n0 = k8.launches
    y, s = k8ops.mamba2_scan(x, dt, A, Bm, C, D, chunk=chunk, kernel_mode="cuda")
    assert k8.launches == n0 + 1
    y_ref, s_ref = k8ops.mamba2_scan(x, dt, A, Bm, C, D, kernel_mode="reference")
    torch.cuda.synchronize()
    assert y.dtype == dtype and s.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(s).all())
    _close(y, y_ref, _SCAN_TOL[dtype])
    _close(s, s_ref, _SCAN_TOL[torch.float32])


@pytest.mark.parametrize("B,H,hb", [(1, 7, 1), (1, 201, 2), (4, 111, 4)])
def test_mamba2_tensor_core_kernel_takes_any_heads_per_block_on_card(B, H, hb):
    """Each instance of the bf16 tensor-core kernel, as heads_plan picks it
    (heads that do not fill the last block of a batch row leave its
    warpgroups masked), at zamba2's head shape and decays, against the plain
    version."""
    from repro_torch.kernels.mamba2_scan import kernel as k8

    dev = _card()
    assert k8.heads_plan(B, H, k8.sm_count(dev.index or 0)).heads_per_block == hb
    rng = np.random.default_rng(17 + hb)
    T, P, N = 128, 64, 64
    x = torch.from_numpy(rng.standard_normal((B, H, T, P)).astype(np.float32) * 0.5).to(
        dev, torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.normal(0.0, 0.63, (B, H, T)).astype(np.float32))).to(dev)
    A = -torch.linspace(1.0, 8.0, H, device=dev)
    Bm, C = (torch.from_numpy(rng.standard_normal((B, T, N)).astype(np.float32) * 0.5).to(dev)
             for _ in range(2))
    D = torch.from_numpy(rng.standard_normal(H).astype(np.float32)).to(dev)
    y, s = k8.mamba2_scan_cuda(x, dt, A, Bm, C, D, chunk=64)
    y_ref, s_ref = k8.mamba2_scan_ref(x, dt, A, Bm, C, D)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(s).all())
    _close(y, y_ref, _SCAN_TOL[torch.bfloat16])
    _close(s, s_ref, _SCAN_TOL[torch.float32])


@pytest.mark.parametrize("cols", [16, 64])
@pytest.mark.parametrize("chunk", [32, 64])
def test_rwkv6_tensor_core_kernel_takes_any_cols_per_block_on_card(cols, chunk, monkeypatch):
    """Each instance of the bf16 tensor-core kernel (16 or 64 columns a
    block; chunks padded to 32 or 64 rows) at rwkv6's head shape, against
    the plain version: the plan is forced, every slice must cover its
    columns."""
    from repro_torch.kernels.rwkv6_scan import kernel as k7

    dev = _card()
    real = k7.cols_plan
    forced = []

    def plan(B, H, N, C, sms):
        p = real(B, H, N, C, sms)
        slices = -(-N // cols)
        forced.append(cols)
        return p._replace(cols_per_block=cols, slices=slices, blocks=B * H * slices,
                          smem_bytes=k7.shared_bytes(C, cols))

    monkeypatch.setattr(k7, "cols_plan", plan)
    rng = np.random.default_rng(cols + chunk)
    B, H, T, N = 2, 3, 2 * chunk, 64
    r, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, N)).astype(np.float32) * 0.5)
               .to(dev, torch.bfloat16) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 0.999, (B, H, T, N)).astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.standard_normal((H, N)).astype(np.float32) * 0.5).to(dev)
    o, s = k7.rwkv6_scan_cuda(r, k, v, w, u, chunk=chunk)
    o_ref, s_ref = k7.rwkv6_scan_ref(r, k, v, w, u)
    torch.cuda.synchronize()
    assert forced == [cols]
    assert bool(torch.isfinite(o.float()).all()) and bool(torch.isfinite(s).all())
    _close(o, o_ref, _SCAN_TOL[torch.bfloat16])
    _close(s, s_ref, _SCAN_TOL[torch.float32])


def test_scan_kernels_refuse_what_they_do_not_take():
    from repro_torch.kernels.mamba2_scan import mamba2_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_cuda

    dev = _card()
    r = torch.zeros((1, 2, 48, 16), device=dev)
    u = torch.zeros((2, 16), device=dev)
    with pytest.raises(ValueError, match="multiple of chunk"):
        rwkv6_scan(r, r, r, r + 0.5, u, chunk=32, kernel_mode="cuda")
    with pytest.raises(ValueError, match="float32"):
        rwkv6_scan_cuda(r, r, r, (r + 0.5).bfloat16(), u)
    with pytest.raises(ValueError, match="head size"):
        big = torch.zeros((1, 1, 32, 128), device=dev)
        rwkv6_scan_cuda(big, big, big, big + 0.5, torch.zeros((1, 128), device=dev))
    x = torch.zeros((1, 2, 48, 16), device=dev)
    dt = torch.full((1, 2, 48), 0.1, device=dev)
    bc = torch.zeros((1, 48, 16), device=dev)
    h = torch.ones(2, device=dev)
    with pytest.raises(ValueError, match="multiple of chunk"):
        mamba2_scan(x, dt, -h, bc, bc, h, chunk=32, kernel_mode="cuda")
    y, s = mamba2_scan(x, dt, -h, bc, bc, h, chunk=64, kernel_mode="cuda")   # T < chunk
    assert y.shape == x.shape and s.shape == (1, 2, 16, 16)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_ssm_models_default_mode_launch_their_kernels(arch):
    """The smoke configs on the card: the prefill step at its default mode
    launches K7 (rwkv6) or K8 and K5 (zamba2) once per layer and agrees
    with the plain versions; a zamba2 decode step launches K6 per group."""
    from repro_torch import models
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import kernel as k5
    from repro_torch.kernels.mamba2_scan import kernel as k8
    from repro_torch.kernels.paged_attention import kernel as k6
    from repro_torch.kernels.rwkv6_scan import kernel as k7
    from repro_torch.train.train_step import make_prefill_step

    dev = _card()
    cfg = dataclasses.replace(registry.get_smoke(arch), kv_page_size=16)
    params = models.init(cfg, seed=4, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 64))
                              .astype(np.int32)).to(dev)
    counters = (k5, k6, k7, k8)
    n0 = [c.launches for c in counters]
    got = make_prefill_step(cfg)(params, {"tokens": tokens})
    n1 = [c.launches - n for c, n in zip(counters, n0)]
    want = make_prefill_step(cfg, kernel_mode="reference")(params, {"tokens": tokens})
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    if arch == "rwkv6-1.6b":
        assert n1 == [0, 0, cfg.num_layers, 0]
        return
    from repro_torch.models import zamba2

    G, per = zamba2.group_dims(cfg)
    assert n1 == [G, 0, 0, G * per]
    page, B = cfg.kv_page_size, 2
    pools = torch.zeros((2, G, 8, page, cfg.num_kv_heads, cfg.head_dim), device=dev)
    table = torch.arange(8, dtype=torch.int32, device=dev).reshape(B, 4)
    state = zamba2.init_decode_state(cfg, B, device=dev)
    outs = {}
    for mode in ("auto", "reference"):
        kp, vp, st = pools[0].clone(), pools[1].clone(), state
        n6 = k6.launches
        for t in range(20):
            ctx = torch.full((B,), t + 1, dtype=torch.int32, device=dev)
            lg, st, kp, vp = zamba2.decode_step(params, tokens[:, t], cfg, st, kp, vp, table,
                                                ctx, **({} if mode == "auto" else
                                                        {"kernel_mode": mode}))
        outs[mode] = (lg, k6.launches - n6)
    torch.testing.assert_close(outs["auto"][0], outs["reference"][0], atol=1e-4, rtol=1e-4)
    assert outs["auto"][1] == 20 * G and outs["reference"][1] == 0


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-1.6b", "zamba2-7b", "whisper-medium",
                                  "internvl2-2b", "qwen3-moe-30b-a3b"])
def test_train_step_on_card_matches_the_cpu(arch):
    """Three float32 smoke train steps (two microbatches, lr 1e-3) on the
    card against the same steps on the CPU, within the tolerances the CPU
    tests hold the port's steps to the JAX package's (chip_smoke.py's
    ``TRAIN_EXACT_TOL``): loss 1e-5 relative at each step; step 1's gradient
    norm within 1e-4 and its moments (the clipped gradient) within 1e-4 (m)
    and 2e-4 (v) of each leaf's scale; after step 3 the parameters within
    1e-4 absolute, steps 2-3's gradient norms within 1e-3 and the moments
    within 1e-2 / 2e-2 (those steps start from parameters that differ by
    up to 1e-4, and rwkv6's u follows them by ~1.5e-3).  rwkv6 runs with a random bonus
    u: at its initial u = 0 the gradients are ill-conditioned
    (tests/test_torch_train.py, ``GRAD_TOL``).  The step at
    ``kernel_mode="auto"`` on the card raises the kernels' autograd refusal
    (dense: K5, ssm: K7, hybrid: K8)."""
    from repro_torch import models
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, batch_for_model
    from repro_torch.train.optimizer import OptimizerConfig, init_state
    from repro_torch.train.train_step import make_train_step

    dev = _card()
    cfg = registry.get_smoke(arch)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    runs = {}
    for d in ("cpu", dev):
        params = models.init(cfg, seed=6, device="cpu")
        if cfg.family == "ssm":
            gen = torch.Generator().manual_seed(6)
            for lp in params.layers:
                lp.tm.u.copy_(torch.randn(lp.tm.u.shape, generator=gen) * 0.5)
        params = params.to(d)
        state = init_state(params)
        step = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=1), microbatches=2)
        ms, first = [], None
        for i in range(3):
            b = {k: torch.from_numpy(v).to(d) for k, v in batch_for_model(data, cfg, i).items()}
            params, state, m = step(params, state, b)
            ms.append({k: float(v) for k, v in m.items()})
            if i == 0:
                first = {k: {n: t.clone() for n, t in state[k].items()} for k in ("m", "v")}
        runs[str(d)] = (params, state, ms, first)
    (pc, sc, mc, fc), (pg, sg, mg, fg) = runs["cpu"], runs[str(dev)]

    def rel(got, want):
        return (got.cpu() - want).abs().max().item() / max(want.abs().max().item(), 1e-30)

    for i, (a, b) in enumerate(zip(mg, mc)):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]), (i, a, b)
        tol = 1e-4 if i == 0 else 1e-3
        assert abs(a["grad_norm"] - b["grad_norm"]) <= tol * abs(b["grad_norm"]), (i, a, b)
    for k, tol1, tol3 in (("m", 1e-4, 1e-2), ("v", 2e-4, 2e-2)):
        for n in sc[k]:
            assert rel(fg[k][n], fc[k][n]) <= tol1, (k, "step 1", n, rel(fg[k][n], fc[k][n]))
            assert rel(sg[k][n], sc[k][n]) <= tol3, (k, "step 3", n, rel(sg[k][n], sc[k][n]))
    for (n, want), got in zip(pc.named_parameters(), pg.parameters()):
        gap = (got.detach().cpu() - want.detach()).abs().max().item()
        assert gap <= 1e-4, (n, gap)
    if cfg.family in ("dense", "ssm", "hybrid"):
        step = make_train_step(cfg, kernel_mode="auto")
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch_for_model(data, cfg, 0).items()}
        with pytest.raises(RuntimeError, match="no backward pass"):
            step(pg, sg, b)
