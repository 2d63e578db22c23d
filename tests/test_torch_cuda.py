"""The CUDA kernels K1, K2 and K3 on a card against their plain PyTorch versions
on the same inputs: hits and carried state bit-identical (tolerance 0).

These tests need a card and skip without one (``-m cuda`` selects them):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*.py

They import nothing of JAX, so they run on a machine without it.
"""
import numpy as np
import pytest
import torch

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


def test_tlb_sim_kernel_matches_plain_on_card():
    dev = _card()
    rng = np.random.default_rng(0)
    TS, W, N, valid = 37, 8, 3001, (8, 4, 1, 3, 6)
    s = torch.from_numpy(rng.integers(0, TS, (len(valid), N)).astype(np.int32)).to(dev)
    t = torch.from_numpy(rng.integers(0, 400, (len(valid), N)).astype(np.int32)).to(dev)
    tags, last = tlbsim.padded_tlb_state(len(valid), TS + 1, W, valid, device=dev)
    n0 = tlb_sim.kernel.launches
    got = tlb_sim.tlb_sim_batched_carry(s, t, tags, last, 17, kernel_mode="cuda")
    assert tlb_sim.kernel.launches == n0 + 1
    want = tlb_sim.tlb_sim_batched_carry(s, t, tags, last, 17, kernel_mode="reference")
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="contiguous"):
        tlb_sim.kernel.tlb_sim_carry_cuda(s[:, ::2], t[:, ::2], tags, last, 0)
    with pytest.raises(ValueError, match="set index"):
        tlb_sim.kernel.tlb_sim_carry_cuda(s + TS + 1, t, tags, last, 0)
    with pytest.raises(ValueError, match="int32"):
        tlb_sim.kernel.tlb_sim_carry_cuda(s.long(), t, tags, last, 0)


def test_system_sim_kernel_matches_plain_on_card():
    dev = _card()
    cfgs = _system_cfgs()
    lines = tlbsim.as_tensor(_lines(7, 2001), dev)
    streams = sweep._system_streams(lines, cfgs)
    geos, _ = sweep._system_layout(cfgs)
    envs = [sweep._envelope(geo, range(len(cfgs))) for geo in geos]
    state = tuple(x for e in envs
                  for x in tlbsim.padded_tlb_state(len(cfgs), e[0] + 1, e[1], e[2], device=dev))
    flags = tlbsim.system_flags(cfgs, dev)
    n0 = system_sim.kernel.launches
    got = system_sim.system_sim_batched_carry(*streams, flags, state, 3, kernel_mode="cuda")
    assert system_sim.kernel.launches == n0 + 1
    want = system_sim.system_sim_batched_carry(*streams, flags, state, 3,
                                               kernel_mode="reference")
    torch.cuda.synchronize()
    for x, y in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("W", [1, 4, 16, 32, 40])
def test_stack_scan_kernel_matches_plain_on_card(W):
    """Every stack width the launcher dispatches on: registers up to 32
    slots, device memory above."""
    dev = _card()
    rng = np.random.default_rng(W)
    L, C = 300, 257
    tags = torch.from_numpy(rng.integers(0, 3 * W, (L, C)).astype(np.int32)).to(dev)
    seg = torch.from_numpy(rng.random((L, C)) < 0.05).to(dev)
    init = torch.from_numpy(rng.integers(-1, 3 * W, (L, W)).astype(np.int32)).to(dev)
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
