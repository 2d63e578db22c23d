"""Edge cases of the split paged-attention kernel K6, made with numpy from
fixed seeds.  ``kernel.py:split_plan`` cuts each sequence's table into
ranges of ``span`` keys (whole 32-key tiles), one block each; these cases
put contexts and unmapped pages where the ranges begin and end.  The card
tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` hold the CUDA
kernel to its plain version on them.

A case: (B, Hq, Hkv, D, page, pages, slots, q dtype, edge), where edge is

* ``split_edge``: contexts of one range exactly, one key more, one key
  less, and two ranges;
* ``past_ctx``: short contexts in a wide table, so most ranges lie wholly
  past ``ctx_len``;
* ``unmapped_split``: full contexts, the pages of sequence 0 that hold its
  second range unmapped (so that range's keys are all invalid);
* ``one_page``: a table of one page;
* ``long``: B = 1 at 4,096 keys with qwen3-14b's heads;
* ``fork``: the serving path's fork, B = 1 at 1,900 keys.

``long`` and ``fork`` are held to the plain version computed in float64:
over ~2,000 keys the float32 plain version is itself outside 2e-5 of it.
"""
from __future__ import annotations

import numpy as np

EDGE_CASES = [
    (4, 40, 8, 128, 256, 9, 40, "bfloat16", "split_edge"),
    (3, 8, 2, 64, 16, 12, 48, "float32", "split_edge"),
    (3, 40, 8, 128, 256, 9, 40, "float32", "past_ctx"),
    (4, 32, 32, 112, 64, 8, 40, "bfloat16", "past_ctx"),
    (2, 40, 8, 128, 256, 9, 40, "bfloat16", "unmapped_split"),
    (2, 8, 2, 64, 16, 12, 48, "float32", "unmapped_split"),
    (3, 40, 8, 128, 256, 1, 8, "bfloat16", "one_page"),
    (4, 32, 32, 112, 64, 1, 8, "float32", "one_page"),
    (1, 40, 8, 128, 256, 16, 20, "bfloat16", "long"),
    (1, 40, 8, 128, 256, 8, 20, "bfloat16", "fork"),
]
FLOAT64_EDGES = ("long", "fork")


def edge_inputs(rng, B, Hq, Hkv, D, page, pages, slots, edge: str, span: int):
    """(q, k_pool, v_pool, table, ctx) as float32 / int32 numpy arrays; the
    table maps distinct slots; ``span``: the keys of one range of the plan."""
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((slots, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((slots, page, Hkv, D)).astype(np.float32)
    tbl = rng.permutation(slots)[:B * pages].reshape(B, pages).astype(np.int32)
    keys = pages * page
    if edge == "split_edge":
        ctx = [span, span + 1, span - 1, 2 * span][:B]
    elif edge == "past_ctx":
        ctx = [5, 40, 300, 1][:B]
    elif edge == "unmapped_split":
        ctx = [keys, keys - 7][:B]
        tbl[0, span // page:(2 * span - 1) // page + 1] = -1
    elif edge == "one_page":
        ctx = [page, 17, 0, 1][:B]
    elif edge == "long":
        ctx = [4096]
    elif edge == "fork":
        ctx = [1900]
    else:
        raise ValueError(f"unknown edge {edge!r}")
    ctx = np.minimum(np.asarray(ctx, np.int32), keys)
    return q, kp, vp, tbl, ctx
