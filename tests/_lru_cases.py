"""Skewed and edge-case inputs for the set-parallel LRU kernels K1 and K2,
made with numpy from fixed seeds.  The CPU tests hold the plain model of the
kernels' order of work to the JAX package on them
(``tests/test_torch_lru_sets.py``), and the card tests and ``chip_smoke.py``
hold the CUDA kernels to their plain versions on them.

A K1 case: ``set``, ``tag`` int32 [B, L]; the state geometry ``TS`` (rows,
one more than the sets used: the streams' parked row), ``W`` and ``valid``
(ways per config); ``now0``; ``cuts``, where the chunks of a carried run
end.  A K2 case: the six key streams, ``flags`` int32 [B, 3], one ``geom``
(rows, ways, valid ways) per structure, ``now0`` and ``cuts``.
"""
from __future__ import annotations

import numpy as np

STAMP_LIMIT = 2**31 - 1   # the poisoned-way stamp: a chunk's stamps stay below it
K2_FLAGS = ((1, 1, 1), (0, 1, 0), (1, 0, 1), (1, 1, 0))  # has_c, has_a, on_miss_only


def _valid(W: int, B: int) -> tuple:
    return tuple([W, max(1, W // 2), 1, max(1, W - 1)][:B])


def _sets(rng, kind: str, B: int, L: int, used: int) -> np.ndarray:
    """[B, L] set indices below ``used``: uniform, all in set 0, every
    access in a set of its own, or 90% in one hot set."""
    if kind == "one_set":
        return np.zeros((B, L), np.int32)
    if kind == "own_sets":
        return np.stack([rng.permutation(used)[:L] for _ in range(B)]).astype(np.int32)
    s = rng.integers(0, used, (B, L))
    if kind == "hot_set":
        s = np.where(rng.random((B, L)) < 0.9, used // 3, s)
    return s.astype(np.int32)


def _k1(name, seed, B, L, used, W, *, kind="uniform", tags=None, now0=0, cuts=()):
    rng = np.random.default_rng(seed)
    return {"name": name, "set": _sets(rng, kind, B, L, used),
            "tag": rng.integers(0, tags or 3 * W + 2, (B, L)).astype(np.int32),
            "TS": used + 1, "W": W, "valid": _valid(W, B), "now0": now0,
            "cuts": list(cuts)}


def k1_cases() -> list:
    """The K1 cases: skewed streams, every way class of the kernel (1-32 in
    registers, 33 in device memory), an empty chunk and a chunk whose last
    stamp is 2**31 - 2."""
    n = 4_099
    return [
        _k1("one_set", 1, 3, 6_007, 1, 4, kind="one_set", tags=9, cuts=(2_999,)),
        _k1("own_sets_65537_rows", 2, 1, 32_768, 65_536, 4, kind="own_sets",
            cuts=(20_001,)),
        _k1("hot_set", 3, 4, 8_009, 256, 4, kind="hot_set", tags=12, cuts=(3_001, 5_003)),
        *(_k1(f"ways_{W}", 10 + W, 3, 3_001, 32, W, cuts=(1_499,)) for W in (1, 4, 16, 32, 33)),
        _k1("empty_chunk", 4, 2, 0, 8, 4),
        _k1("stamp_limit", 5, 2, n, 16, 4, now0=STAMP_LIMIT - 1 - n, cuts=(2_001,)),
    ]


def _k2(name, seed, L, used, ways, *, kind="uniform", B=4, tags=6, now0=0, cuts=()):
    """``used`` and ``ways``: (cache, accel, mem) sets used and ways;
    ``kind``: the skew of all three structures, or one per structure."""
    rng = np.random.default_rng(seed)
    kinds = (kind,) * 3 if isinstance(kind, str) else kind
    streams = []
    for u, kd in zip(used, kinds):
        streams += [_sets(rng, kd, B, L, u),
                    rng.integers(0, tags, (B, L)).astype(np.int32)]
    return {"name": name, "streams": streams,
            "flags": np.asarray(K2_FLAGS[:B], np.int32),
            "geom": [(u + 1, W, _valid(W, B)) for u, W in zip(used, ways)],
            "now0": now0, "cuts": list(cuts)}


def k2_cases() -> list:
    """The K2 cases: the same skews (every access in a set of its own in the
    mem TLB only, whose 65,536 sets allow it), way classes in
    each pass (the cache's in registers or memory, the TLB pass's the wider
    of its two), an empty chunk and the stamp limit."""
    n = 4_001
    return [
        _k2("one_set", 21, 4_001, (1, 1, 1), (4, 2, 4), kind="one_set", cuts=(1_777,)),
        _k2("own_sets_65537_rows", 22, 16_384, (64, 32, 65_536), (4, 4, 4), B=1,
            kind=("uniform", "uniform", "own_sets"), tags=40, cuts=(9_001,)),
        _k2("hot_set", 23, 6_007, (64, 32, 256), (4, 4, 8), kind="hot_set", cuts=(2_503,)),
        _k2("ways_1_1_1", 24, 3_001, (16, 8, 32), (1, 1, 1), cuts=(1_201,)),
        _k2("ways_16_4_33", 25, 3_001, (16, 8, 32), (16, 4, 33), tags=40, cuts=(1_201,)),
        _k2("ways_32_16_2", 26, 3_001, (16, 8, 32), (32, 16, 2), tags=70, cuts=(1_201,)),
        _k2("ways_33_2_32", 27, 3_001, (16, 8, 32), (33, 2, 32), tags=70, cuts=(1_201,)),
        _k2("empty_chunk", 28, 0, (8, 8, 8), (4, 4, 4)),
        _k2("stamp_limit", 29, n, (16, 8, 32), (4, 4, 4), now0=STAMP_LIMIT - 1 - n,
            cuts=(2_001,)),
    ]


def chunks(L: int, cuts) -> list:
    """(lo, hi) of the chunks of a carried run over L accesses."""
    bounds = [0, *cuts, L]
    return list(zip(bounds, bounds[1:]))
