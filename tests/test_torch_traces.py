"""The port's trace generators (``repro_torch.core.traces``) against the JAX
package's: byte-identical traces for every workload and seed."""
import dataclasses

import numpy as np
import pytest

from repro.core import traces as jt
from repro_torch.core import traces as tt


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("workload", jt.WORKLOADS)
def test_generate_byte_identical(workload, seed):
    kw = dict(n_ops=64, seed=seed, footprint_bytes=1 << 34)
    a, b = jt.generate(workload, **kw), tt.generate(workload, **kw)
    assert a.lines.dtype == b.lines.dtype == np.int64
    assert a.lines.tobytes() == b.lines.tobytes()
    for f in dataclasses.fields(a):
        if f.name != "lines":
            assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert a.num_accesses == b.num_accesses
    assert a.instr_per_access == b.instr_per_access
    for shift in (12, 21):
        assert a.vpns(shift).tobytes() == b.vpns(shift).tobytes()


@pytest.mark.parametrize("kw", [
    dict(zipf_keys=1.3, thread_slice=(0.25, 0.5)),
    dict(scatter_nodes=True, thread_slice=(0.5, 0.75), max_accesses=500),
])
@pytest.mark.parametrize("workload", ["hash_table", "bst_internal", "bst_external", "skip_list"])
def test_generate_options_byte_identical(workload, kw):
    a = jt.generate(workload, n_ops=80, seed=3, **kw)
    b = tt.generate(workload, n_ops=80, seed=3, **kw)
    assert a.lines.tobytes() == b.lines.tobytes()


def test_thread_traces_and_tables_identical():
    a = jt.thread_traces("skip_list", 3, n_ops=40, seed=5)
    b = tt.thread_traces("skip_list", 3, n_ops=40, seed=5)
    assert [x.tobytes() for x in a] == [x.tobytes() for x in b]
    assert jt.interleave(a, 8).tobytes() == tt.interleave(b, 8).tobytes()
    assert jt.INSTR_PER_ACCESS == tt.INSTR_PER_ACCESS
    assert jt.WORKLOADS == tt.WORKLOADS
    assert (jt.LINE_SHIFT, jt.MAX_LINE_ADDR) == (tt.LINE_SHIFT, tt.MAX_LINE_ADDR)


@pytest.mark.parametrize("bad", [np.zeros(0, np.int64), np.array([1.5]),
                                 np.array([-1]), np.array([1 << 53])])
def test_validate_lines_rejects_the_same_inputs(bad):
    with pytest.raises(ValueError) as ja:
        jt.validate_lines(bad)
    with pytest.raises(ValueError) as ta:
        tt.validate_lines(bad)
    assert str(ja.value) == str(ta.value)


# The port's Zipf draws (the hash table's Fig 2 keys, a=1.4; rocksdb's
# blocks, a=1.2) from default_rng(0): numpy 2.0's values, pinned so that a
# run on another numpy, whose Generator.zipf draws differently, is held to
# them too; then the next uniform draw, which shows the generator's state.
_ZIPF_PINNED = {
    1.2: ("1f9e165994050771ca46b5ea894b9518f169ce4e660b175202f47713c5ee96a2", 0.19865283495255392),
    1.4: ("74a973005f5dbe368245b2407227b9e9639fae582549f3b032b11640bcbf79f1", 0.7312023704777155),
}


@pytest.mark.parametrize("a", [1.05, 1.2, 1.4, 3.0])
def test_zipf_draws_are_numpy_2_0s(a):
    """Equal to ``Generator.zipf`` on this numpy (2.0, the reference's
    draw), generator state included, and to the pinned values anywhere."""
    import hashlib

    for seed in (0, 1):
        for n in (0, 1, 1000):
            want_rng, got_rng = np.random.default_rng(seed), np.random.default_rng(seed)
            np.testing.assert_array_equal(tt._zipf(got_rng, a, n), want_rng.zipf(a, size=n))
            assert got_rng.bit_generator.state == want_rng.bit_generator.state
    if a in _ZIPF_PINNED:
        rng = np.random.default_rng(0)
        x = tt._zipf(rng, a, 20000)
        assert (hashlib.sha256(x.tobytes()).hexdigest(), rng.random()) == _ZIPF_PINNED[a]
