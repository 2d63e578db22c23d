"""Edge cases of the stack scan kernel K3, made with numpy from fixed seeds.

``kernel.py:stack_plan`` splits each lane across P threads: P = 1 walks the
lane through tiles of 64 steps ("streamed"), P > 1 walks parts of
Q = ceil(C / P) steps twice, composing the parts' effects in between
("resident").  These cases put segment starts, padding and ragged ends
where the parts and tiles begin and end.  The CPU tests
(``tests/test_torch_stack_parts.py``) hold the plain model of that order of
work to the JAX package on them; the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` hold the CUDA kernel to
its plain version on them (tolerance 0).

A case: ``(name, L, C, W, parts)``; ``parts`` forces P, ``None`` takes the
plan's choice on an H100 (132 SMs).  The name also picks the inputs:

* ``part_first_step``: a segment starts on every part's first step;
* ``every_step_starts``: every access starts a segment;
* ``no_start_full_init``: no segment start, full carry-in stacks;
* ``padding_tags``: the engine's padding (tag -2 from a segment start to
  the end of a lane) and a lane of padding alone, with no start in it;
* ``ragged_parts``: C not a multiple of P; ``c_below_p``: C < P;
* ``arbitrary_init``: carry-in stacks with repeated tags and -1 between
  tags (the op takes any int32 stack);
* ``random_w*``: random tags and 5% starts at every register width
  class and at 40 slots (the device-memory walk);
* the rest: set-sorted streams as the engine lays them out (segments of
  1-300 accesses, a hot set of few tags, a padded tail) at C = 1, the
  engine's C = 1,024, C = 1,025 (a ragged last tile, the 4-byte copies),
  one lane (the largest P), enough lanes for P = 1, and one lane of
  16,384 steps (the engine's largest ``block``), resident and streamed.
"""
from __future__ import annotations

import numpy as np

PAD_TAG = -2   # the engine's padding tag (core/stackdist.py)

CASES = [
    ("part_first_step", 6, 70, 4, 8),
    ("every_step_starts", 5, 64, 4, 8),
    ("no_start_full_init", 7, 96, 4, 4),
    ("padding_tags", 9, 100, 4, 8),
    ("ragged_parts", 9, 70, 16, 8),
    ("c_below_p", 7, 5, 4, 32),
    ("arbitrary_init", 8, 77, 8, 2),
    ("random_w1", 300, 257, 1, None),
    ("random_w4", 300, 257, 4, None),
    ("random_w16", 300, 257, 16, None),
    ("random_w32", 300, 257, 32, None),
    ("random_w40", 300, 257, 40, None),
    ("engine_c1", 40, 1, 4, None),
    ("engine_one_lane", 1, 1024, 4, None),
    ("engine_c1024", 300, 1024, 4, None),
    ("engine_c1025", 300, 1025, 4, None),
    ("engine_streamed_c1024", 17000, 1024, 4, None),
    ("engine_streamed_c1025", 17000, 1025, 4, None),
    ("engine_c16384", 1, 16384, 4, None),
    ("engine_c16384_streamed", 2, 16384, 4, 1),
]

# The cases the CPU model test runs at their own P (the large ones are the
# card's: their plain version walks C steps in Python).
MODEL_CASES = [c for c in CASES if c[1] * c[2] <= 400_000 and c[3] <= 32]


def _stacks(rng, L: int, W: int, n_tags: int, full: bool) -> np.ndarray:
    """Capped LRU stacks: distinct tags first, then -1 (empty)."""
    out = np.full((L, W), -1, np.int32)
    for i in range(L):
        k = W if full else int(rng.integers(0, W + 1))
        out[i, :k] = rng.choice(max(n_tags, W), k, replace=False)
    return out


def _engine(rng, L: int, C: int, W: int):
    """Set-sorted lanes: segments of 1-300 accesses over 2-3W tags each
    (some over one hot tag), a padded tail from a segment start."""
    n = L * C
    tags = np.empty(n, np.int32)
    seg = np.zeros(n, bool)
    i = 0
    while i < n:
        length = int(rng.integers(1, 301))
        hot = rng.random() < 0.2
        alphabet = 1 if hot else int(rng.integers(2, 3 * W + 1))
        base = int(rng.integers(0, 1 << 20))
        tags[i:i + length] = base + rng.integers(0, alphabet, min(length, n - i))
        seg[i] = True
        i += length
    pad = int(rng.integers(0, min(C, 700) + 1))
    if pad:
        tags[n - pad:] = PAD_TAG
        seg[n - pad] = True
    init = _stacks(rng, L, W, 3 * W, full=False)
    return tags.reshape(L, C), seg.reshape(L, C), init


def case_inputs(case, seed: int = 0):
    """``(tags int32 [L, C], seg bool [L, C], init int32 [L, W])`` of a case."""
    name, L, C, W, parts = case
    rng = np.random.default_rng(seed + 1000 * L + C)
    if name.startswith("engine"):
        return _engine(rng, L, C, W)
    tags = rng.integers(0, 3 * W, (L, C)).astype(np.int32)
    seg = rng.random((L, C)) < 0.05
    init = _stacks(rng, L, W, 3 * W, full=False)
    if name == "part_first_step":
        q = -(-C // parts)
        seg[:, ::q] = True
    elif name == "every_step_starts":
        seg[:] = True
    elif name == "no_start_full_init":
        seg[:] = False
        init = _stacks(rng, L, W, 3 * W, full=True)
    elif name == "padding_tags":
        for lane in range(L - 1):
            cut = int(rng.integers(0, C))
            tags[lane, cut:] = PAD_TAG
            seg[lane, cut] = True
        tags[-1] = PAD_TAG            # a lane of padding with no start in it
        seg[-1] = False
    elif name.startswith("random") or name == "arbitrary_init":
        init = rng.integers(-1, 3 * W, (L, W)).astype(np.int32)
    return tags, seg, init


def case_parts(case, plan) -> int:
    """The P a case runs at: its own, else ``plan(L, C, W, 132).parts``."""
    name, L, C, W, parts = case
    return parts if parts is not None else plan(L, C, W, 132).parts
