"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: data passes
between the JAX package and the port as numpy arrays, and "equal" means
bit-identical (tolerance 0)."""
from __future__ import annotations

import numpy as np
import torch


def np_of(x) -> np.ndarray:
    """A JAX array, torch tensor or numpy array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t_of(x: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype (a copy)."""
    return torch.from_numpy(np.array(x))


def assert_same(got, want, what: str = "") -> None:
    """Bit-identical: same shape, same dtype kind, same values."""
    g, w = np_of(got), np_of(want)
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    assert g.dtype.kind == w.dtype.kind, f"{what}: dtype {g.dtype} != {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=what)


def random_lines(seed: int, n: int = 1111) -> np.ndarray:
    """Random 64-byte line addresses; 1,111 is a multiple of no block size."""
    return np.random.default_rng(seed).integers(0, 1 << 28, n).astype(np.int64)


def split_points(rng: np.random.Generator, n: int, chunks: int = 3) -> list:
    """Sorted distinct interior cut points splitting ``n`` into ``chunks``."""
    return sorted(rng.choice(np.arange(1, n), chunks - 1, replace=False).tolist())
