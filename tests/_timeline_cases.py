"""Edge cases of the timeline kernel K4's order of work, shared by the card
tests (``tests/test_torch_cuda.py``) and the CPU model of that order
(``tests/test_torch_kernel_orders.py``).  Numpy only: no JAX, no card.

Each case is a batch of sims (``TimelineParams`` fields as tuples, so that
both packages can build their own), a length, overrides of the per-access
columns, the cut points of a chunked run, an optional prefix run first to
carry a state whose MSHR counts sit mid-ring, and per-column element offsets
that misalign each column's base against 16 bytes.
"""
import numpy as np

# TimelineParams fields: serial_walk, mem_tlb, num_accels, mshrs,
# num_partitions, tlb_ports, dram_banks.
_MIXED = [(True, False, 4, 8, 1, 1, 16), (False, True, 16, 8, 32, 3, 16),
          (False, True, 2, 0, 8, 0, 0), (False, False, 1, 0, 1, 0, 16),
          (False, False, 8, 8, 1, 0, 0), (True, False, 1, 0, 1, 3, 0),
          (False, True, 2, 0, 32, 1, 0), (False, True, 1, 8, 4, 3, 16)]
_ONE_PORT = [(False, True, 16, 8, 32, 1, 16), (True, False, 4, 3, 1, 1, 16),
             (False, True, 3, 1, 4, 1, 5), (False, False, 2, 2, 1, 1, 7)]
_UNBOUNDED = [(False, True, 4, 0, 8, 0, 0), (True, False, 2, 0, 1, 0, 0),
              (False, False, 3, 0, 1, 0, 0), (False, True, 1, 0, 1, 0, 0)]
_PORTS = [(False, True, 8, 4, 16, 3, 8), (False, True, 4, 2, 4, 4, 4),
          (False, True, 2, 1, 2, 2, 16)]
# Above the kernel's 48 KB of shared state per sim (1,024 partitions x 16
# ports): the device-memory variant.
# Both design flags at once (a conventional walk that also queues at a port).
_BOTH_FLAGS = [(True, True, 4, 8, 8, 2, 16), (True, True, 2, 0, 4, 1, 0)]
_BIG = [(False, True, 16, 8, 1024, 16, 64), (False, True, 3, 2, 900, 5, 7),
        (True, False, 2, 4, 1, 1, 16)]

TILE = 512        # accesses a staged tile (timeline.cu's kTile)

# name -> (params, L, overrides, cuts, prefix, offsets).  overrides: "hits"
# (every access a cache hit), "misses" (none), "bd_eq_bp" (the PTE bank is
# the data bank, misses 90%).  prefix: accesses run through the plain
# version first; the kernel resumes from its state.
EDGE_CASES = {
    "mixed_ragged": (_MIXED + _BOTH_FLAGS, 3 * TILE + 77, None, [], 0, None),
    "bd_eq_bp": (_MIXED, 1400, "bd_eq_bp", [], 0, None),
    "all_hits": (_MIXED, 1100, "hits", [], 0, None),
    "all_misses": (_MIXED, 1100, "misses", [], 0, None),
    "unbounded": (_UNBOUNDED, 900, None, [], 0, None),
    "one_port": (_ONE_PORT, 2 * TILE, "misses", [], 0, None),
    "ports_gt_1": (_PORTS, 1300, None, [], 0, None),
    "below_one_tile": (_MIXED, 100, None, [], 0, None),
    "one_access": (_ONE_PORT, 1, "misses", [], 0, None),
    "misaligned_columns": (_MIXED, TILE + 6, None, [], 0, (1, 2, 3, 0, 3, 1, 2, 1)),
    "device_memory_state": (_BIG, 1500, None, [601], 0, None),
    "resume_mid_ring": (_ONE_PORT + _MIXED, 1800, "misses", [337, 851, 1365], 333, None),
}


def edge_columns(params, n: int, override, seed: int):
    """Seeded per-access columns [B, n] (ids within each sim's own counts)
    and the packed parameter rows (fp float32 [B, 8], ip int32 [B, 7]) of
    ``params`` (tuples of the seven fields above, default latencies)."""
    rng = np.random.default_rng(seed)
    B = len(params)
    cols = [np.zeros((B, n), np.int32) for _ in range(7)] + [np.zeros((B, n), np.float32)]
    for i, (serial, memtlb, accels, _, parts, _, banks) in enumerate(params):
        for k, hi in enumerate((accels, parts, max(banks, 1), max(banks, 1))):
            cols[k][i] = rng.integers(0, hi, n)
        for k, frac in zip((4, 5, 6), (0.4, 0.6, 0.7)):
            cols[k][i] = rng.random(n) < frac
        if not (serial or memtlb):
            cols[7][i] = 24.0 * (i % 2)
    if override == "hits":
        cols[4][:] = 1
    elif override == "misses":
        cols[4][:] = 0
    elif override == "bd_eq_bp":
        cols[3][:] = cols[2]
        cols[4][:] = rng.random((B, n)) < 0.1
    fp = np.array([[2.0, 2.0, 120.0, 390.0, np.float32(2.0 * 390.0), 2.0, 120.0, 1.0]] * B,
                  np.float32)
    ip = np.array([[int(p[0]), int(p[1]), *p[2:]] for p in params], np.int32)
    return cols, fp, ip


def envelope(params):
    """The batch's (A, M, P, T, D) state envelope, each floored at 1."""
    return tuple(max(max(p[k] for p in params), 1) for k in (2, 3, 4, 5, 6))
