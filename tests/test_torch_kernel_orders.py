"""Plain models of the orders of work of K4 (the timeline chain) and K7 (the
RWKV6 tensor-core scan), and K7's column plan, held to the JAX package on
the CPU.

* K4: a model of the kernel's step order (inputs staged in tiles the way
  the staging warp copies them: a 16-byte aligned middle and up to three
  elements at either end; a hit touching acc[a] alone; a miss reading its
  accelerator's (acc, head, slot, cnt) with a wrapping MSHR slot index set
  up from the carried cnt, and bank[bd] forwarded from the freshly written
  bank[bp] when bd == bp) equals JAX's ``timeline_scan_batched_carry_ref``
  bit for bit: on the heterogeneous batch of ``tests/test_torch_timeline.py``
  in ragged tiles, on a resume from JAX-exported state whose MSHR counts sit
  mid-ring, and on the edge cases the card tests run
  (``tests/_timeline_cases.py``).
* K7: a model of the tensor-core kernel's chunked form (16-token
  sub-blocks; the off-diagonal ones as products of factors through the
  sub-block's last token, the diagonal ones per channel; every float32
  operand of a tensor-core product split into a bf16 high part and a bf16
  residual, one rounding each; r, k, v exact in bf16) equals JAX's
  ``rwkv6_scan`` within 5e-4 (the JAX package's scan tolerance): at
  rwkv6-1.6b's initial decays against the reference and the interpreted
  Pallas kernel, and at strong decays, where the Pallas kernel's
  k exp(-logd) overflows, against the reference.
* K7's :func:`cols_plan` covers every column of every (b, h) exactly once.
"""
import _timeline_cases
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_timeline import LAT, hetero_specs

from repro.kernels.rwkv6_scan.ops import rwkv6_scan as jax_rwkv6_scan
from repro.kernels.timeline import ref as jref
from repro_torch.core import timeline as ttl
from repro_torch.kernels.flash_attention.kernel import SMEM_LIMIT
from repro_torch.kernels.rwkv6_scan.kernel import COLS_PER_BLOCK, cols_plan, shared_bytes

H100_SMS = 132
SCAN_TOL = 5e-4     # the JAX package's scan tolerance
BF16_TOL = 2e-2     # one bf16 rounding of the output
LOG2E = 1.4426950408889634

f32 = np.float32


# ---------------------------------------------------------------------------
# K4: the chain's order of work.
# ---------------------------------------------------------------------------

def _stage(col: np.ndarray, base: int, g0: int, n: int, tile: int):
    """Elements [g0, g0 + n) of the flat column ``col`` (its element 0 at
    word address ``base``) staged as the kernel's warp stages them: element
    g0 + j at word shift + j of the buffer, shift = (base + g0) mod 4; one
    bulk copy of the 16-byte aligned middle, the ends element by element.
    Returns (buffer, shift); unwritten words are None."""
    buf = [None] * (tile + 4)
    shift = (base + g0) & 3
    e0 = min((4 - shift) & 3, n)
    e1 = e0 + ((n - e0) & ~3)
    if e1 > e0:                                                   # a copy to issue
        assert (shift + e0) % 4 == 0 and (base + g0 + e0) % 4 == 0 and (e1 - e0) % 4 == 0
    buf[shift + e0:shift + e1] = list(col[g0 + e0:g0 + e1])      # the bulk copy
    for j in [*range(e0), *range(e1, n)]:                         # the ends
        buf[shift + j] = col[g0 + j]
    return buf, shift


def _add(x, y):
    return f32(f32(x) + f32(y))


def _wait(free_at, arrive):
    return max(f32(f32(free_at) - f32(arrive)), f32(0.0))


def _k4_model(cols, fp, ip, state, tile, bases=(0,) * 8):
    """The kernel's order of work over [B, L] ``cols`` from ``state`` (numpy,
    copied); returns ((latency, overhead, done), state')."""
    acc, mshr, cnt, port, bank = (np.array(x, copy=True) for x in state)
    B, L = cols[0].shape
    A, M = mshr.shape[1:]
    outs = [np.zeros((B, L), np.float32) for _ in range(3)]
    flat = [c.reshape(-1) for c in cols]
    for b in range(B):
        l_cache, l_tlb, l_dram, t_net, walk2, tlb_occ, dram_occ, iv = (f32(x) for x in fp[b])
        serial, memtlb, _, mshrs, _, ports, banks = (int(x) for x in ip[b])
        slot = cnt[b] % max(mshrs, 1)                 # the wrapping index, from cnt
        head = mshr[b, np.arange(A), slot].copy()
        for k0 in range(0, L, tile):
            n = min(tile, L - k0)
            staged = [_stage(flat[c], bases[c], b * L + k0, n, tile) for c in range(8)]
            for j in range(n):
                x = [s[0][s[1] + j] for s in staged]
                assert all(v is not None for v in x), "read a word the staging never wrote"
                a, part, bd, bp, c_hit, th, mh = (int(v) for v in x[:7])
                pen = f32(x[7])
                if c_hit:                                 # a hit touches acc[a] alone
                    issue = _add(acc[b, a], 0.0)
                    lat, ov, done = l_cache, f32(0.0), _add(issue, l_cache)
                    acc[b, a] = _add(issue, iv)
                else:
                    nominal, hd, sl = acc[b, a], head[a], int(slot[a])
                    ns = 0 if sl + 1 >= mshrs else sl + 1
                    next_head = mshr[b, a, ns]            # read before this step's store
                    row = port[b, part]
                    pslot = 0
                    for q in range(1, row.shape[0]):
                        if row[q] < row[pslot]:
                            pslot = q
                    pmin = row[pslot]
                    bank_p, bank_d = bank[b, bp], bank[b, bd]
                    w_mshr = _wait(hd, nominal)
                    issue = _add(nominal, w_mshr if mshrs > 0 else 0.0)
                    t0 = _add(issue, l_cache)
                    arr = _add(t0, t_net)
                    w_port = _wait(pmin, arr) if ports > 0 else f32(0.0)
                    if memtlb and ports > 0:
                        port[b, part, pslot] = _add(_add(arr, w_port), tlb_occ)
                    probe_done = _add(_add(arr, w_port), l_tlb)
                    walk_arr = _add(_add(t0, l_tlb), t_net)
                    trans_arr = walk_arr if serial else probe_done
                    w_tr = _wait(bank_p, trans_arr) if banks > 0 else f32(0.0)
                    do_tr = banks > 0 and (th == 0 if serial else (memtlb and mh == 0))
                    bank_p_new = _add(_add(trans_arr, w_tr), dram_occ)
                    if do_tr:
                        bank[b, bp] = bank_p_new
                    walk = _add(_add(walk2, w_tr), l_dram)
                    trans_conv = _add(l_tlb, 0.0 if th != 0 else walk)
                    trans_sparta = _add(_add(w_port, l_tlb), 0.0 if mh != 0 else _add(w_tr, l_dram))
                    trans = trans_conv if serial else (trans_sparta if memtlb else pen)
                    data_arr = (_add(_add(t0, trans_conv), t_net) if serial
                                else (_add(arr, trans_sparta) if memtlb else arr))
                    pen_eff = f32(0.0) if (serial or memtlb) else pen
                    bank_d_now = bank_p_new if (do_tr and bd == bp) else bank_d   # forwarded
                    w_data = _wait(bank_d_now, data_arr) if banks > 0 else f32(0.0)
                    if banks > 0:
                        bank[b, bd] = _add(_add(_add(data_arr, w_data), dram_occ), pen_eff)
                    if serial:
                        terms = (l_cache, trans_conv, t_net, w_data, l_dram, t_net)
                    elif memtlb:
                        terms = (l_cache, t_net, trans_sparta, w_data, l_dram, t_net)
                    else:
                        terms = (l_cache, t_net, w_data, l_dram, pen_eff, t_net)
                    lat = terms[0]
                    for term in terms[1:]:
                        lat = _add(lat, term)
                    ov, done = trans, _add(issue, lat)
                    if mshrs > 0:
                        mshr[b, a, sl] = done
                        slot[a], head[a] = ns, (done if mshrs == 1 else next_head)
                        cnt[b, a] += 1
                    acc[b, a] = _add(issue, iv)
                outs[0][b, k0 + j], outs[1][b, k0 + j], outs[2][b, k0 + j] = lat, ov, done
    return tuple(outs), (acc, mshr, cnt, port, bank)


def _jax_carry(cols, fp, ip, state):
    ys, st = jref.timeline_scan_batched_carry_ref(
        *(jnp.asarray(c) for c in cols), jnp.asarray(fp), jnp.asarray(ip),
        tuple(jnp.asarray(s) for s in state))
    return tuple(np.asarray(y) for y in ys), tuple(np.asarray(s) for s in st)


def _same(got, want, what):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), what


@pytest.fixture(scope="module")
def hetero_batch():
    _, tspecs = hetero_specs()
    stacked, fp, ip, _ = ttl._prepare(tspecs, LAT, "test")
    return [np.ascontiguousarray(s) for s in stacked], fp, ip


@pytest.mark.parametrize("tile", [512, 61])
def test_k4_model_matches_jax_on_heterogeneous_batch(hetero_batch, tile):
    """The heterogeneous batch (every design, 0 / 8 MSHRs, 0 / 1 / 3 ports,
    0 / 16 banks) in the kernel's tiles and in 61-access tiles (a ragged
    last tile, shifts of every residue), chunked at odd points."""
    cols, fp, ip = hetero_batch
    B, n = cols[0].shape
    env = tuple(max(int(ip[:, c].max()), 1) for c in (2, 3, 4, 5, 6))
    jst = tuple(np.asarray(s) for s in jref.timeline_init_state_batched(
        B, env, jnp.asarray(ip[:, 5])))
    mst = jst
    for lo, hi in zip([0, 701, 1999], [701, 1999, n]):
        part = [c[:, lo:hi] for c in cols]
        want, jst = _jax_carry(part, fp, ip, jst)
        got, mst = _k4_model(part, fp, ip, mst, tile, bases=(0, 1, 2, 3, 3, 2, 1, 0))
        _same(got, want, f"[{lo}, {hi}) outputs")
        _same(mst, jst, f"[{lo}, {hi}) state")


def test_k4_model_resumes_jax_exported_state_mid_ring(hetero_batch):
    """JAX runs the first 333 accesses; the model resumes from its exported
    state, whose MSHR counts are not multiples of the rings (the wrapping
    slot starts mid-ring), and matches JAX's continuation."""
    cols, fp, ip = hetero_batch
    B, n = cols[0].shape
    env = tuple(max(int(ip[:, c].max()), 1) for c in (2, 3, 4, 5, 6))
    st0 = jref.timeline_init_state_batched(B, env, jnp.asarray(ip[:, 5]))
    _, exported = _jax_carry([c[:, :333] for c in cols], fp, ip, st0)
    mshrs = np.maximum(ip[:, 3], 1)[:, None]
    assert ((exported[2] % mshrs != 0) & (ip[:, 3:4] > 1)).any()
    rest = [c[:, 333:] for c in cols]
    want = _jax_carry(rest, fp, ip, exported)
    got = _k4_model(rest, fp, ip, exported, 512)
    _same(got[0], want[0], "outputs")
    _same(got[1], want[1], "state")


@pytest.mark.parametrize("name", [n for n in _timeline_cases.EDGE_CASES
                                  if n != "device_memory_state"])
def test_k4_model_matches_jax_on_the_card_tests_edges(name):
    """The card tests' edge cases: bd == bp, all hits, all misses, unbounded
    queues, one port and several, both design flags, L below and not a
    multiple of the tile, one access, misaligned columns, and the resume."""
    params, n, override, cuts, prefix, offsets = _timeline_cases.EDGE_CASES[name]
    cols, fp, ip = _timeline_cases.edge_columns(params, n, override, seed=len(name))
    B = len(params)
    jst = tuple(np.asarray(s) for s in jref.timeline_init_state_batched(
        B, _timeline_cases.envelope(params), jnp.asarray(ip[:, 5])))
    if prefix:
        _, jst = _jax_carry([c[:, :prefix] for c in cols], fp, ip, jst)
    mst = jst
    bounds = [prefix, *cuts, n]
    for lo, hi in zip(bounds, bounds[1:]):
        part = [c[:, lo:hi] for c in cols]
        want, jst = _jax_carry(part, fp, ip, jst)
        got, mst = _k4_model(part, fp, ip, mst, _timeline_cases.TILE,
                             bases=offsets or (0,) * 8)
        _same(got, want, f"{name} [{lo}, {hi}) outputs")
        _same(mst, jst, f"{name} [{lo}, {hi}) state")


# ---------------------------------------------------------------------------
# K7: the column plan and the tensor-core kernel's chunked form.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,N,chunk", [
    (4, 32, 64, 32),     # rwkv6-1.6b's prefill
    (1, 4, 64, 32), (2, 2, 32, 32), (1, 2, 16, 16), (2, 32, 64, 64), (1, 1, 40, 32),
    (3, 5, 24, 20), (8, 32, 64, 32), (1, 3, 8, 32),
])
def test_cols_plan_covers_every_column_once(B, H, N, chunk):
    plan = cols_plan(B, H, N, chunk, H100_SMS)
    nc = plan.cols_per_block
    assert nc in COLS_PER_BLOCK and plan.blocks == B * H * plan.slices
    cols = [j for s in range(plan.slices) for j in range(s * nc, min((s + 1) * nc, N))]
    assert cols == list(range(N))                       # each column once, in order
    assert all(s * nc < N for s in range(plan.slices))   # no empty slice
    assert plan.smem_bytes == shared_bytes(chunk, nc) <= SMEM_LIMIT
    assert plan == cols_plan(B, H, N, chunk, H100_SMS)


def test_cols_plan_fills_the_card_only_where_it_is_empty():
    """One slice where the (b, h) blocks already cover the SMs (rwkv6's
    prefill of 4 prompts, 128 blocks), more where they leave most SMs idle
    (rwkv6's prefill of one prompt, 32 (b, h))."""
    assert cols_plan(4, 32, 64, 32, H100_SMS).slices == 1
    assert cols_plan(1, 32, 64, 32, H100_SMS).slices == 4
    assert cols_plan(1, 4, 64, 32, H100_SMS).slices == 4


def _bf16(x):
    return x.bfloat16().float()


def _split_mm(x, y):
    """x @ y with both operands split into bf16 high parts and residuals:
    hi hi + hi lo + lo hi, float32 sums."""
    xh, yh = _bf16(x), _bf16(y)
    xl, yl = _bf16(x - xh), _bf16(y - yh)
    return xh @ yh + xh @ yl + xl @ yh


def _split_exact_mm(x, v):
    """x @ v, x split, v exact in bf16: hi v + lo v."""
    xh = _bf16(x)
    return xh @ v + _bf16(x - xh) @ v


def _k7_model(r, k, v, w, u, chunk):
    """The tensor-core kernel's chunked form in float32 on [B, H, T, N]
    inputs (r, k, v exact in bf16): log2 w floored at -104 log2(e), its
    prefix down the chunk; per 16-token sub-block q the factors through its
    last token e_q; a's diagonal sub-blocks per channel (exponentials of
    differences, s < t) and the bonus on its diagonal; the products split
    as on the tensor cores."""
    B, H, T, N = r.shape
    C = min(chunk, T)
    CP = 32 if C <= 32 else 64
    S = torch.zeros((B, H, N, N))
    outs = []
    for t0 in range(0, T, C):
        pad = (0, 0, 0, CP - C)
        rc, kc, vc = (torch.nn.functional.pad(x[:, :, t0:t0 + C], pad) for x in (r, k, v))
        lw = torch.clamp(torch.log2(w[:, :, t0:t0 + C]), min=-104 * LOG2E)
        ld = torch.cumsum(torch.nn.functional.pad(lw, pad), 2)          # [B, H, CP, N]
        ldp = torch.nn.functional.pad(ld[:, :, :-1], (0, 0, 1, 0))       # logd[t-1]
        last = ld[:, :, -1:]
        a = torch.zeros((B, H, CP, CP))
        for q in range(CP // 16 - 1):
            e, lo = 16 * q + 15, 16 * (q + 1)
            Rq = rc[:, :, lo:] * torch.exp2(ldp[:, :, lo:] - ld[:, :, e:e + 1])
            Kq = kc[:, :, 16 * q:lo] * torch.exp2(ld[:, :, e:e + 1] - ld[:, :, 16 * q:lo])
            a[:, :, lo:, 16 * q:lo] = _split_mm(Rq, Kq.transpose(2, 3))
        for d in range(CP // 16):
            blk = slice(16 * d, 16 * d + 16)
            dec = torch.exp2(ldp[:, :, blk, None, :] - ld[:, :, None, blk, :])   # [.., t, s, i]
            diag = (rc[:, :, blk, None, :] * kc[:, :, None, blk, :] * dec).sum(-1)
            a[:, :, blk, blk] = torch.tril(diag, -1)
        a = a + torch.diag_embed((rc * u[None, :, None, :] * kc).sum(-1))
        rd = rc * torch.exp2(ldp)
        o = _split_mm(rd, S) + _split_exact_mm(torch.tril(a), vc)
        kd = kc * torch.exp2(last - ld)
        S = S * torch.exp2(last).transpose(2, 3) + _split_exact_mm(kd.transpose(2, 3), vc)
        outs.append(o[:, :, :C])
    return torch.cat(outs, 2), S


def _rwkv6_inputs(seed, B, H, T, N, strong):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, N)).astype(np.float32) * 0.5)
               .bfloat16().float().numpy() for _ in range(3))
    if strong:                  # the TPU kernel's k exp(-logd) overflows within a chunk
        w = rng.uniform(1e-3, 0.05, (B, H, T, N)).astype(np.float32)
    else:                       # rwkv6-1.6b at init: exp(-exp(w_base + LoRA)), w_base = -1
        w = np.exp(-np.exp(-1.0 + 0.5 * rng.standard_normal((B, H, T, N)))).astype(np.float32)
    u = (rng.standard_normal((H, N)) * 0.5).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("B,H,T,N,chunk,strong", [
    (1, 2, 64, 64, 32, False),      # rwkv6's head and chunk, two chunks
    (1, 2, 128, 64, 64, False),     # C = 64: four sub-blocks, six factored pairs
    (2, 1, 20, 32, 32, False),      # T < chunk: one short chunk, padded
    (1, 2, 64, 64, 32, True),       # strong decays
    (1, 1, 96, 40, 48, True),       # C = 48 in a 64-row tile, N = 40
])
def test_k7_model_matches_jax(B, H, T, N, chunk, strong):
    ins = _rwkv6_inputs(T + N, B, H, T, N, strong)
    o, s = _k7_model(*(torch.from_numpy(x) for x in ins), chunk)
    jo, js = jax_rwkv6_scan(*(jnp.asarray(x) for x in ins), kernel_mode="reference")
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(_bf16(o).numpy(), np.asarray(jo), atol=BF16_TOL, rtol=BF16_TOL)
    if not strong and T % chunk == 0:   # the interpreted Pallas kernel agrees at these decays
        po, ps = jax_rwkv6_scan(*(jnp.asarray(x) for x in ins), chunk=chunk,
                                kernel_mode="pallas_interpret")
        np.testing.assert_allclose(o.numpy(), np.asarray(po), atol=SCAN_TOL, rtol=SCAN_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(ps), atol=SCAN_TOL, rtol=SCAN_TOL)
