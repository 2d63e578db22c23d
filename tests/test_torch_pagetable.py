"""The port's page tables and demand-paging model (``core/pagetable.py``) and
its Fig 6 driver against the JAX package on the CPU.

Stack distances are exact integers: the port's whole-array formulation
must equal JAX's Fenwick scan access for access, including the batch's cold
value ``n_max + 1`` in every stream; fault rates are exact integer ratios
and must be equal; Fig 6's claims follow from them within rtol 1e-12.
"""
import numpy as np
import pytest

pytest.importorskip("jax")  # the parity tests need the JAX package (CPU only)
from repro.core import pagetable as jpt
from repro_torch.bench import fig6
from repro_torch.core import pagetable as pt

RTOL = 1e-12


def _streams():
    """(name, pages): n = 1, one page, all-distinct pages, lengths at powers
    of two +- 1, skewed and uniform reuse."""
    rng = np.random.default_rng(20)
    out = [("n1", np.array([7])), ("one_page", np.full(33, 5)),
           ("distinct", rng.permutation(65) * 3), ("stride", np.arange(40) % 7)]
    for n in (15, 16, 17, 63, 64, 65, 255, 256, 257):
        out.append((f"uniform{n}", rng.integers(0, max(2, n // 4), n)))
    out.append(("zipf1000", rng.zipf(1.3, 1000) % 300))
    out.append(("wide", rng.integers(0, 1 << 40, 200)))
    return out


@pytest.mark.parametrize("name,pages", _streams(), ids=[s[0] for s in _streams()])
def test_stack_distances_equal_jax(name, pages):
    want = jpt.stack_distances(pages)
    got = pt.stack_distances(pages, device="cpu")
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pt.fenwick_stack_distances(pages), want)


def test_stack_distances_of_nothing():
    assert pt.stack_distances(np.zeros(0, np.int64), device="cpu").shape == (0,)
    assert pt.stack_distances_batch([], device="cpu") == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stack_distances_batch_equal_jax_on_ragged_streams(seed):
    rng = np.random.default_rng(seed)
    lens = [0, 1, 2, 31, 32, 33, 100, 129][seed:] + [int(rng.integers(1, 300))]
    streams = [rng.integers(0, 1 + int(rng.integers(1, 40)), n) for n in lens]
    want = jpt.stack_distances_batch(streams)
    got = pt.stack_distances_batch(streams, device="cpu")
    n_max = max(lens)
    assert len(got) == len(want)
    for s, g, w in zip(streams, got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
        # The padded batch's cold value is n_max + 1 in every stream.
        if s.size:
            assert g[0] == n_max + 1
        plain = pt.fenwick_stack_distances(s)
        np.testing.assert_array_equal(g, np.where(plain == s.size + 1, n_max + 1, plain))


def test_fault_rate_is_exact_and_zero_on_nothing():
    d = np.array([1, 5, 9, 2, 11], np.int64)
    for f in (0, 1, 4, 9, 20):
        assert pt.fault_rate(d, f) == jpt.fault_rate(d, f)
    assert pt.fault_rate(np.zeros(0, np.int64), 3) == jpt.fault_rate(np.zeros(0, np.int64), 3)


@pytest.fixture(scope="module")
def rocksdb_pages():
    return fig6.page_stream(400)


@pytest.mark.parametrize("parts", [1, 32])
def test_page_fault_curve_equals_jax(rocksdb_pages, parts):
    vpns = rocksdb_pages
    unique = int(np.unique(vpns).size)
    frames = [max(32, int(fr * unique)) for fr in fig6.MEM_FRACS]
    kw = {} if parts == 1 else {"num_partitions": parts, "node_overhead_frames": 3,
                                "node_capacity_jitter": fig6.JITTER}
    want = jpt.page_fault_curve(vpns, frames, **kw)
    got = pt.page_fault_curve(vpns, frames, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    faults, n = pt.page_fault_counts(vpns, frames, device="cpu", **kw)
    assert n == vpns.shape[0]
    np.testing.assert_array_equal(faults / n, want)


def test_fig6_small_matches_jax(rocksdb_pages):
    from benchmarks import fig6_pagefault as jfig6
    from repro.core import traces as jtraces

    assert (fig6.MEM_FRACS, fig6.NODE_OVERHEAD_FRAC, fig6.JITTER) == (
        jfig6.MEM_FRACS, jfig6.NODE_OVERHEAD_FRAC, jfig6.JITTER)
    res = fig6.run(device="cpu", n_ops=400, verbose=False)
    tr = jtraces.generate("rocksdb", n_ops=400, seed=0, footprint_bytes=16 << 30,
                          max_accesses=2_000_000)
    vpns = tr.vpns(12)
    vpns = vpns[np.concatenate([[True], vpns[1:] != vpns[:-1]])]
    np.testing.assert_array_equal(res["vpns"], vpns)
    unique = int(np.unique(vpns).size)
    frames = [max(32, int(fr * unique)) for fr in jfig6.MEM_FRACS]
    overhead = max(1, int(jfig6.NODE_OVERHEAD_FRAC * unique))
    c1 = jpt.page_fault_curve(vpns, frames)
    c32 = jpt.page_fault_curve(vpns, frames, num_partitions=32, node_overhead_frames=overhead,
                               node_capacity_jitter=jfig6.JITTER)
    assert (res["unique"], res["frames"], res["overhead_frames"]) == (unique, frames, overhead)
    np.testing.assert_array_equal(res["curve_1"], c1)
    np.testing.assert_array_equal(res["curve_32"], c32)
    ref_idx = jfig6.MEM_FRACS.index(0.94)
    need = next((fr for fr, f in zip(jfig6.MEM_FRACS, c32) if f <= c1[ref_idx]), None)
    offset = (need - jfig6.MEM_FRACS[ref_idx]) * 16.0 if need else float("nan")
    np.testing.assert_allclose([c.value for c in res["claims"]],
                               [float(c32[0] - c32[-1]), offset], rtol=RTOL, atol=0)
    assert [c.name for c in res["claims"]] == ["C4a", "C4b"]


def test_worked_example_and_inverted_table_match_jax():
    """Paper §5 worked example: [V5..V9] with partitions (3,0,1,2,3), P=4 -> V7;
    allocation, lookup and invalidation on the port's objects."""
    assert pt.adjust_virtual_region(5, [3, 0, 1, 2, 3], 4) == 7
    assert pt.adjust_virtual_region(5, [3, 0, 1, 2, 3], 4) == jpt.adjust_virtual_region(
        5, [3, 0, 1, 2, 3], 4)
    with pytest.raises(ValueError):
        pt.adjust_virtual_region(5, [3, 1], 4)
    parts = pt.make_partitions(4, frames_per_partition=8)
    p, frame = pt.alloc_page_vma(vaddr_vpn=6, asid=1, partitions=parts)
    assert p == 6 % 4
    assert parts[p].page_table.lookup(1, 6) == frame
    assert parts[p].page_table.invalidate(1, 6)
    assert parts[p].page_table.lookup(1, 6) is None
    assert not parts[p].page_table.invalidate(1, 6)


def test_allocation_sequence_equals_jax():
    """The same faults through both packages' Algorithm 1 land in the same
    partitions and frames, and exhaust a partition at the same fault."""
    jparts = jpt.make_partitions(4, frames_per_partition=3)
    parts = pt.make_partitions(4, frames_per_partition=3)
    rng = np.random.default_rng(5)
    for vpn in rng.permutation(40)[:16]:
        try:
            want = jpt.alloc_page_vma(int(vpn), 2, jparts)
        except MemoryError:
            with pytest.raises(MemoryError):
                pt.alloc_page_vma(int(vpn), 2, parts)
            continue
        assert pt.alloc_page_vma(int(vpn), 2, parts) == want
    for jp, p in zip(jparts, parts):
        t, jt = p.page_table, jp.page_table
        assert t.size == jt.size and p.frames == jp.frames
        np.testing.assert_array_equal(t.keys_vpn, jt.keys_vpn)
        np.testing.assert_array_equal(t.frames, jt.frames)
        np.testing.assert_array_equal(t.valid, jt.valid)
