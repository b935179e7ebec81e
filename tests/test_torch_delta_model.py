"""A numpy model of the gee_delta_renorm kernel
(``src/repro_torch/kernels/csrc/query_fused.cu``, `delta_renorm_kernel`),
which cannot run here.

The model follows the kernel step by step: the launcher's plan (rows a
tile R from K, ring depth, floats a stage, the squares' pitch KP, shared
memory, the grid of persistent blocks, and for a row too wide for three
stages its chunks of DELTA_CHUNK columns), each block's static walk over
its tiles (a chunked row twice: the norm pass, then the Zn pass), the
producer's range search for each tile (`tile_range`, the warp's 32-way
`lower_bound_warp` from the previous tile's end, or from a chunked
row's first entry), the bulk copy of the 16-byte-aligned span around
the tile into its stage, each row's run added in list order (a chunk's
columns only), the squares into rows of pitch KP, each row's norm chain
in column order (carried from chunk to chunk), Zn, and Z_new from the
stage's whole 16-byte groups (the bulk store) and the tile's first and
last groups.
The kernel's constants are read from its source, so the two cannot drift
apart.

Held bit-equal to `gee_delta_renorm_plain` (Z_new and Zn), Zn to
`normalize_rows(Z_new)`, and to the JAX reference
(`repro.kernels.query_fused.gee_delta_renorm`, interpret mode) at atol
1e-5 / 1e-6.  Then the shared-memory reads' banks, and the ring's
mbarrier and bulk-group protocol under random interleavings (a wait that
can never be met hangs here, a stage loaded too early is caught)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro.kernels.query_fused import gee_delta_renorm as j_delta
from repro_torch.kernels import query_fused as QF

_SRC = (Path(QF.__file__).parent / "csrc" / "query_fused.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


CONSUMERS = _const("DELTA_CONSUMERS")
TILE_FLOATS = _const("DELTA_TILE_FLOATS")
STAGES = _const("DELTA_STAGES")
MIN_STAGES = _const("DELTA_MIN_STAGES")
BLOCKS_PER_SM = _const("DELTA_BLOCKS_PER_SM")
CHUNK = _const("DELTA_CHUNK")
GROUPS = TILE_FLOATS // (4 * CONSUMERS)   # a thread's groups of a tile
WARPS = CONSUMERS // 32
OPTIN = 232448           # an H100's shared memory a block (opt-in)
WIDTHS = [1, 3, 5, 16, 127, 128, 129, 172, 200, 256, 512]
F32 = np.float32


# -- the launcher's plan -----------------------------------------------------

def pitch(K):
    """The squares' row pitch: the least KP >= K with KP % 8 == 4."""
    return K + (12 - K % 8) % 8


def geometry(K, R, S):
    """(rows, stages, stage floats, KP, shared memory bytes, columns a
    tile, chunks a row)."""
    sf = ((R * K + 3) & ~3) + 4
    kp = pitch(K)
    smem = 4 * (S * sf + R * kp + ((R + 3) & ~3) + 8) + S * (8 + 24)
    return R, S, sf, kp, smem, K, 1


def plan(K, max_smem=OPTIN):
    if K < 1:
        return None
    R = TILE_FLOATS // K
    R = R & ~3 if R >= 4 else 4
    if K * 4 > max_smem:
        R = 0
    while R >= 1:
        for S in range(STAGES, MIN_STAGES - 1, -1):
            g = geometry(K, R, S)
            if g[4] <= max_smem:
                return g
        R = 4 if R > 4 else R - 1
    for S in range(STAGES, MIN_STAGES - 1, -1):
        g = geometry(CHUNK, 1, S)
        if g[4] <= max_smem:
            return g[:6] + ((K - 1) // CHUNK + 1,)
    return None


def units(n_local, p):
    """What the grid spreads: row tiles, or rows of a chunked plan."""
    return -(-n_local // p[0]) if p[6] == 1 else n_local


def fits(smem, blocks=2):
    """Blocks of `smem` bytes an H100 SM holds (228 KB, 1 KB reserved a
    block), at most `blocks`."""
    return min(blocks, (228 * 1024) // (smem + 1024))


def grid(n_local, p, sms, per_sm=BLOCKS_PER_SM):
    return max(1, min(units(n_local, p), sms * per_sm))


def test_model_mirrors_the_source():
    """The formulas the model copies stand in the kernel's source as
    written (a change there must change the model)."""
    for line in ("return K + (12 - K % 8) % 8;",
                 "constexpr int DELTA_GROUPS = DELTA_TILE_FLOATS / (4 * "
                 "DELTA_CONSUMERS);",
                 "p.stage_floats = ((R * K + 3) & ~3) + 4;",
                 "R = R >= 4 ? R & ~3 : 4;",
                 "for (; R >= 1; R = R > 4 ? 4 : R - 1)",
                 "for (int S = DELTA_STAGES; S >= DELTA_MIN_STAGES; --S) {",
                 "if ((size_t)K * sizeof(float) > max_smem) R = 0;",
                 "DeltaPlan p = delta_geometry(DELTA_CHUNK, 1, S);",
                 "p.nch = (K - 1) / DELTA_CHUNK + 1;",
                 "*grid = max(1, min(units, sms * *per_sm));",
                 "*per_sm = max(1, min(DELTA_BLOCKS_PER_SM, fit));",
                 "t.t0 = ((int)blockIdx.x + i * (int)gridDim.x) * R;",
                 "t.t0 = (int)blockIdx.x + (i / (2 * nch)) * (int)gridDim.x;",
                 "t.c0 = (w % nch) * cw;",
                 "t.ph = w < nch ? DELTA_PASS_NORM : DELTA_PASS_ZN;",
                 "t.x0 = (long long)t.t0 * K + t.c0;",
                 "t.sh = (int)(t.x0 & 3);",
                 "from = nch == 1 ? r2.y : r2.x;",
                 "const int c = __ldg(cls + q) - c0;",
                 "float ss = t.c0 == 0 ? x.x : __fadd_rn(carry, x.x);",
                 "if (t.c0 + t.nc == K)",
                 "const uint32_t bytes = (uint32_t)((t.sh + t.n_el + 3) & ~3)"
                 " * 4u;",
                 "const long long a0 = (t.x0 + 3) & ~3LL, a1 = (t.x0 + "
                 "t.n_el) & ~3LL;",
                 "dn[r] = fmaxf(__fsqrt_rn(ss), eps);",
                 "const float q = __fdiv_rn(z != 0.f ? z : 1.f, d);",
                 "return z != 0.f ? q : z;",
                 "zr[c] = __fadd_rn(zr[c], __ldg(val + q));"):
        assert line in _SRC, line
    assert "delta_renorm_wide_kernel" not in _SRC
    assert "DELTA_SMEM_K" not in _SRC
    assert CHUNK % 4 == 0 and CHUNK + 3 <= 4 * GROUPS * CONSUMERS
    assert STAGES >= 3 and MIN_STAGES >= 3
    assert _SRC.count("__global__ void __launch_bounds__(DELTA_THREADS)") == 1


@pytest.mark.parametrize("K", WIDTHS + [2, 4, 1024, 1025, 3000])
def test_plan(K):
    """R a multiple of 4 near a 16 KB tile (4 rows at least), KP / 4 odd,
    the ring at DELTA_STAGES where it fits and never below three, every
    stage on 16 bytes, two blocks an SM at the sweep's widths, and up to
    K = 1,024 a tile that a thread holds in DELTA_GROUPS groups."""
    R, S, sf, kp, smem, cw, nch = plan(K)
    assert R % 4 == 0 and R >= 4 and (cw, nch) == (K, 1)
    if K <= TILE_FLOATS // 4:
        assert R * K <= TILE_FLOATS < (R + 4) * K
        assert R * K <= 4 * GROUPS * CONSUMERS
    assert kp >= K and kp % 8 == 4 and (kp // 4) % 2 == 1
    assert sf % 4 == 0 and sf >= R * K + 4
    assert S >= 3 and smem <= OPTIN
    if K in (16, 64, 128, 129, 172, 200, 256, 512):
        assert S == STAGES and fits(smem) == 2
    if 4 <= K <= 1024:
        assert S == STAGES


def test_plan_at_the_widest_rows():
    """Fewer than 4 rows a tile only where 4 do not fit three stages;
    where one row does not, one row a tile in chunks of DELTA_CHUNK
    columns, a ring of four small stages, for any K."""
    R, S, *_ = plan(4000)
    assert (R, S) == (3, 3)
    assert plan(3000)[:2] == (4, 3)
    assert plan(14000)[0] == 1 and plan(14000)[6] == 1
    for K in (15000, 20000, 1 << 20, 1 << 30):
        R, S, sf, kp, smem, cw, nch = plan(K)
        assert (R, S, cw) == (1, STAGES, CHUNK) and nch == -(-K // CHUNK)
        assert sf >= CHUNK + 4 and kp >= CHUNK and fits(smem) == 2
    assert plan(0) is None


# -- the producer's range search -----------------------------------------

def lower_bound_warp(rows, m, lo, key, log=None):
    """`lower_bound_warp`: 32 probes a round, then one look at <= 32."""
    lanes = np.arange(32)
    n = m - lo
    while n > 32:
        step = (n + 31) >> 5
        p = lo + step * (lanes + 1) - 1
        below = (p < lo + n) & (rows[np.minimum(p, m - 1)] < key)
        nlo = lo + step * int(below.sum())
        n = min(step - 1, lo + n - nlo)
        lo = nlo
        if log is not None:
            log["rounds"] += 1
    p = lo + lanes
    below = (lanes < n) & (rows[np.minimum(p, max(m - 1, 0))] < key
                           if m else False)
    if log is not None:
        log["rounds"] += 1
    return lo + int(np.sum(below))


def tile_range(rows, m, frm, t0, t1, log=None):
    """`tile_range`: the 32 entries from `frm`, the search beyond."""
    p = frm + np.arange(32)
    v = np.where(p < m, rows[np.minimum(p, max(m - 1, 0))] if m else 0,
                 np.iinfo(np.int32).max)
    n0, n1 = int(np.sum(v < t0)), int(np.sum(v < t1))
    if log is not None:
        log["rounds"] += 1
        log["searches"] += n1 == 32
    lo = frm + n0 if n0 < 32 else lower_bound_warp(rows, m, frm + 32, t0,
                                                   log)
    hi = frm + n1 if n1 < 32 else lower_bound_warp(rows, m,
                                                   max(lo, frm + 32), t1, log)
    return lo, hi


@pytest.mark.parametrize("m", [0, 1, 31, 32, 33, 400, 1025, 70_000])
def test_lower_bound_warp(rng, m):
    rows = np.sort(rng.integers(0, 5000, m)).astype(np.int32)
    for key in list(rng.integers(-5, 5010, 40)) + [0, 5000, 5001]:
        for lo in (0, int(np.searchsorted(rows, key // 2))):
            lo = min(lo, int(np.searchsorted(rows, key)))
            assert lower_bound_warp(rows, m, lo, key) == \
                np.searchsorted(rows, key, side="left")


# -- the kernel's arithmetic ---------------------------------------------

def model(Z, rows, cls, val, eps=QF.EPS, *, sms=4, max_smem=OPTIN,
          log=None):
    """The kernel on numpy arrays: (Z_new, Zn), each element written
    exactly once (NaN where none is).  `log` counts tiles, tiles with
    entries, search rounds and bulk-stored elements."""
    n, K = Z.shape
    m = rows.shape[0]
    p = plan(K, max_smem)
    R, S, sf, kp, _, cw, nch = p
    G = grid(n, p, sms)
    # Z's memory (on 16 bytes): 16 floats of garbage after it
    mem = np.concatenate([Z.ravel().astype(F32), np.full(16, 7e7, F32)])
    znew = np.full(n * K, np.nan, F32)
    zn = np.full(n * K, np.nan, F32)
    written = np.zeros(n * K, np.int32)
    stored = np.zeros(n * K, np.int32)
    log = log if log is not None else {}
    for key in ("tiles", "busy", "searches", "rounds", "bulk"):
        log.setdefault(key, 0)
    for b in range(G):
        frm = 0
        n_mine = (units(n, p) - b + G - 1) // G * (1 if nch == 1 else 2 * nch)
        carry = F32(0)
        dn = None
        for i in range(n_mine):
            if nch == 1:                             # `delta_tile`
                t0 = (b + i * G) * R
                nr, c0, nc, ph = min(R, n - t0), 0, K, 3
            else:
                w = i % (2 * nch)
                t0, nr = b + (i // (2 * nch)) * G, 1
                c0 = (w % nch) * cw
                nc = min(cw, K - c0)
                ph = 1 if w < nch else 2
            x0, n_el = t0 * K + c0, nr * nc
            sh = x0 & 3
            lo, hi = tile_range(rows, m, frm, t0, t0 + nr, log)
            frm = hi if nch == 1 else lo
            log["tiles"] += 1
            # the copy: the 16-byte-aligned span around the tile
            nbytes = ((sh + n_el + 3) & ~3) * 4
            assert nbytes % 16 == 0 and nbytes <= sf * 4
            src = x0 - sh
            assert src % 4 == 0
            st = np.full(sf, 9e9, F32)
            st[:nbytes // 4] = mem[src:src + nbytes // 4]
            if lo < hi:
                log["busy"] += 1
                for q0 in range(lo, hi):             # one thread a run
                    r = rows[q0]
                    if q0 > lo and rows[q0 - 1] == r:
                        continue
                    q = q0
                    while q < hi and rows[q] == r:
                        c = cls[q] - c0
                        if 0 <= c < nc:
                            at = sh + (r - t0) * K + c
                            st[at] = F32(st[at] + val[q])
                        q += 1
            # the groups of four global elements that meet the tile
            g0 = x0 & ~3
            e = np.arange(g0, x0 + n_el)
            e = e[e >= x0] - x0                      # the tile's elements
            v = st[e + sh]
            r_, c_ = e // nc, e % nc
            if ph & 1:
                sq = np.full(R * kp, np.nan, F32)
                sq[r_ * kp + c_] = v * v
                sq = sq.reshape(R, kp)[:nr, :nc]
                if c0 == 0:                          # each row's chain
                    ss = np.add.accumulate(sq, axis=1, dtype=F32)[:, -1]
                else:
                    ss = np.add.accumulate(
                        np.concatenate([[carry], sq[0]]), dtype=F32)[-1:]
                assert not np.isnan(ss).any()
                if c0 + nc == K:
                    dn = np.maximum(np.sqrt(ss), F32(eps)).astype(F32)
                else:
                    carry = ss[0]
                a0, a1 = (x0 + 3) & ~3, (x0 + n_el) & ~3
                if a1 > a0:                          # the bulk store
                    znew[a0:a1] = st[a0 - src:a1 - src]
                    stored[a0:a1] += 1
                    log["bulk"] += a1 - a0
            if ph & 2:
                zn[x0 + e] = np.where(v == 0, v, v / dn[r_])  # `quotient`
                written[x0 + e] += 1
                ends = (x0 + e < ((x0 + 3) & ~3)) | \
                    (x0 + e >= ((x0 + n_el) & ~3))
                znew[x0 + e[ends]] = v[ends]         # the partial groups
                stored[x0 + e[ends]] += 1
    assert (written == 1).all() and (stored == 1).all()
    return znew.reshape(n, K), zn.reshape(n, K)


def _delta(rng, n, K, m, *, first_last=False, straddle=None, repeat=False):
    rows = rng.integers(0, n, m)
    if first_last:
        rows = np.concatenate([rows, [0, 0, n - 1, n - 1]])
    if straddle is not None:                         # R - 1, R: two tiles
        rows = np.concatenate([rows, [straddle - 1] * 3 + [straddle] * 3])
    rows = np.sort(rows).astype(np.int32)
    cls = rng.integers(0, min(K, 3) if repeat else K,
                       rows.shape[0]).astype(np.int32)
    val = ((rng.random(rows.shape[0], dtype=F32) - F32(0.3))
           / F32(16)).astype(F32)
    return rows, cls, val


def _cases(K):
    R = plan(K)[0]
    return {
        "zeros": dict(n=2 * R + 1, m=60, zeros=True),
        "empty": dict(n=3 * R + 1, m=0),
        "first_last": dict(n=2 * R + 3, m=40, first_last=True),
        "straddle": dict(n=3 * R, m=30, straddle=R),
        "repeated": dict(n=2 * R + 5, m=300, repeat=True),
        "ragged": dict(n=5 * R + 3, m=200),
        "few_tiles": dict(n=R // 2 + 1, m=20),
    }


def _plain(Z, rows, cls, val):
    zt, znt = QF.gee_delta_renorm_plain(torch.as_tensor(Z),
                                        *(torch.as_tensor(x) for x in
                                          (rows, cls, val)))
    return zt.numpy(), znt.numpy()


def _same(a, b):
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


@pytest.mark.parametrize("K", WIDTHS)
@pytest.mark.parametrize("case", ["empty", "first_last", "straddle",
                                  "repeated", "ragged", "few_tiles",
                                  "zeros"])
def test_model_bit_equal_to_plain(rng, K, case):
    """Z_new and Zn bit-equal to the plain version, Zn ==
    normalize_rows(Z_new) bit for bit; 'few_tiles' runs one tile on
    eight blocks' grid, 'straddle' puts runs on both sides of a tile
    boundary, 'repeated' repeats (row, class) pairs, 'zeros' fills Z
    mostly with +0 and -0 and whole rows of zeros (a zero's quotient is
    itself: the kernel skips its division)."""
    kw = _cases(K)[case]
    n, m = kw.pop("n"), kw.pop("m")
    zeros = kw.pop("zeros", False)
    Z = rng.normal(size=(n, K)).astype(F32)
    if zeros:
        Z[rng.random((n, K)) < 0.8] = F32(0)
        Z[rng.random((n, K)) < 0.1] = F32(-0.0)
        Z[::3] = F32(0)
    rows, cls, val = _delta(rng, n, K, m, **kw)
    log = {}
    zn_, zn2 = model(Z, rows, cls, val, log=log)
    pz, pzn = _plain(Z, rows, cls, val)
    assert _same(zn_, pz) and _same(zn2, pzn)
    assert _same(zn2, QF.normalize_rows(torch.as_tensor(zn_)).numpy())
    R = plan(K)[0]
    assert log["tiles"] == -(-n // R)
    if case == "empty":
        assert log["busy"] == 0 and _same(zn_, Z)
    if case == "few_tiles":
        assert grid(n, plan(K), 4) == 1
    if K % 4 == 0:                       # every element by the bulk store
        assert log["bulk"] == n * K


@pytest.mark.parametrize("K,max_smem", [
    (5000, 80_000), (8184, 80_000), (8191, 80_000), (12_277, 80_000),
    (15_000, OPTIN), (20_000, OPTIN)])
@pytest.mark.parametrize("case", ["empty", "first_last", "repeated",
                                  "few_tiles", "zeros"])
def test_model_chunked_rows(rng, K, max_smem, case):
    """Rows too wide for three stages (at the card's shared memory, or at
    a smaller one so that narrower rows take the same path): chunks of
    DELTA_CHUNK columns, the norm chain carried from chunk to chunk, the
    same entries added again in the Zn pass; the plain version's bits,
    every element written once, two passes of tiles a row."""
    p = plan(K, max_smem)
    assert p[0] == 1 and p[5] == CHUNK and p[6] == -(-K // CHUNK) >= 2
    n = {"few_tiles": 1, "empty": 3}.get(case, 9)
    Z = rng.normal(size=(n, K)).astype(F32)
    if case == "zeros":
        Z[rng.random((n, K)) < 0.9] = F32(0)
        Z[1] = F32(0)
    m = {"empty": 0, "repeated": 900}.get(case, 150)
    rows, cls, val = _delta(rng, n, K, m, first_last=case == "first_last",
                            repeat=case == "repeated")
    if case == "first_last":                   # both ends of every chunk
        cuts = np.arange(0, K, CHUNK)
        extra = np.unique(np.concatenate([cuts, cuts - 1, [K - 1]]))
        extra = extra[extra >= 0].astype(np.int32)
        r_all = np.concatenate([rows, np.full(extra.size, n - 1, np.int32)])
        order = np.argsort(r_all, kind="stable")
        rows = r_all[order]
        cls = np.concatenate([cls, extra])[order]
        val = np.concatenate([val, np.full(extra.size, F32(0.25))])[order]
    log = {}
    a, b = model(Z, rows, cls, val, sms=2, max_smem=max_smem, log=log)
    pz, pzn = _plain(Z, rows, cls, val)
    assert _same(a, pz) and _same(b, pzn)
    assert _same(b, QF.normalize_rows(torch.as_tensor(a)).numpy())
    assert log["tiles"] == n * 2 * p[6]
    if K % 4 == 0:                   # every element by the bulk store
        assert log["bulk"] == n * K


@pytest.mark.parametrize("sms", [1, 3, 132])
def test_model_any_grid(rng, sms):
    """The same bits on any grid, at the shapes of the sweep's widths."""
    for K in (16, 172):
        R = plan(K)[0]
        n = 7 * R + 5
        Z = rng.random((n, K), dtype=F32)
        rows, cls, val = _delta(rng, n, K, 120)
        a, b = model(Z, rows, cls, val, sms=sms)
        pz, pzn = _plain(Z, rows, cls, val)
        assert _same(a, pz) and _same(b, pzn)


def test_search_rounds_on_a_short_delta(rng):
    """A 200-entry delta over many tiles: one coalesced read of 32
    entries settles each tile's range (a block's next tile lies a grid
    of tiles on, past a few entries), no 32-way search."""
    K, n, sms = 16, 256 * 1600, 8
    Z = rng.random((n, K), dtype=F32)
    rows, cls, val = _delta(rng, n, K, 200)
    log = {}
    model(Z, rows, cls, val, sms=sms, log=log)
    assert log["tiles"] == 1600 and log["busy"] > 100
    assert log["searches"] == 0 and log["rounds"] == log["tiles"]


@pytest.mark.parametrize("m", [0, 5, 40, 3000])
def test_tile_range(rng, m):
    """Each tile's [lo, hi) is the searchsorted range, from any `from`
    at or before it, also where more than 32 entries lie between."""
    rows = np.sort(rng.integers(0, 2000, m)).astype(np.int32)
    for t0 in range(0, 2100, 37):
        t1 = t0 + int(rng.integers(1, 90))
        want = (int(np.searchsorted(rows, t0)), int(np.searchsorted(rows,
                                                                    t1)))
        for frm in (0, want[0] // 2, want[0]):
            assert tile_range(rows, m, frm, t0, t1) == want


@pytest.mark.parametrize("K", [1, 5, 16, 172, 512])
def test_model_within_tolerance_of_jax(rng, K):
    """Held to the JAX reference's Pallas kernel in interpret mode, as
    `tests/test_torch_kernels.py::TestDeltaRenorm` runs it."""
    R = plan(K)[0]
    n = min(2 * R + 3, 600)
    Z = rng.random((n, K), dtype=F32)
    rows, cls, val = _delta(rng, n, K, 80)
    a, b = model(Z, rows, cls, val)
    rb, cb, vb, _ = JO.pack_edges(rows, cls, val, n, 64, 128)
    zj, znj = j_delta(Z, rb, cb, vb, tile_n=64, interpret=True)
    np.testing.assert_allclose(a, np.asarray(zj), atol=1e-5)
    np.testing.assert_allclose(b, np.asarray(znj), atol=1e-6)


# -- shared-memory banks -------------------------------------------------

def _degree_128(units):
    """Wavefronts of one 16-byte access by a warp: per quarter-warp, the
    most distinct units on one 16-byte bank group (8 of them)."""
    worst = 1
    for qw in range(4):
        u = set(units[8 * qw:8 * qw + 8])
        per = {}
        for x in u:
            per[x % 8] = per.get(x % 8, 0) + 1
        worst = max(worst, max(per.values()) if per else 1)
    return worst


def _degree_32(words):
    """Wavefronts of one 4-byte access by a warp: the most distinct words
    on one bank (equal words are one broadcast)."""
    per = {}
    for x in set(words):
        per[x % 32] = per.get(x % 32, 0) + 1
    return max(per.values()) if per else 1


def read_degrees(K):
    """The worst bank-conflict degree of each shared-memory read of a
    full tile with Z on 16 bytes: the stage's 16-byte reads (thread t
    takes groups t, t + DELTA_CONSUMERS, ...), the chain's 16-byte reads
    of the squares (thread t takes rows t, t + DELTA_CONSUMERS, ...), the
    norms' reads (rows r and r + 1 of each group, or 16-byte pairs for
    K < 4)."""
    R, S, sf, kp, _, cw, nch = plan(K)
    out = {"stage": 1, "chain": 1, "dn": 1}
    K = cw                           # a chunk's columns are its row
    n_el = R * K
    for j in range(-(-n_el // (4 * CONSUMERS))):
        for w in range(WARPS):
            g = [4 * (w * 32 + l + CONSUMERS * j) for l in range(32)]
            g = [x for x in g if x < n_el]
            if not g:
                continue
            out["stage"] = max(out["stage"], _degree_128([x // 4 for x in g]))
            r = [x // K for x in g]
            if K >= 4:
                for rr in (r, [x + 1 for x in r]):
                    out["dn"] = max(out["dn"], _degree_32(rr))
            else:
                b = [x & ~3 for x in r]
                for off in (0, 1):
                    out["dn"] = max(out["dn"],
                                    _degree_128([x // 4 + off for x in b]))
    for k in range(-(-R // CONSUMERS)):
        for w in range(WARPS):
            rr = [k * CONSUMERS + w * 32 + l for l in range(32)]
            rr = [x for x in rr if x < R]
            for c in range(0, K, 4):
                units = [(x * kp + c) // 4 for x in rr]
                out["chain"] = max(out["chain"], _degree_128(units))
    return out


@pytest.mark.parametrize("K", WIDTHS + [20_000])
def test_reads_are_free_of_bank_conflicts(K):
    """Every read instruction of a tile's passes hits distinct banks: the
    stage's 16-byte reads (consecutive), the chain's 16-byte reads of
    8 consecutive rows at pitch KP (KP / 4 odd), the norms (at most 32
    consecutive rows, or 16-byte pairs for K < 4)."""
    assert read_degrees(K) == {"stage": 1, "chain": 1, "dn": 1}


def test_a_pitch_of_k_would_conflict():
    """The check sees conflicts: rows at pitch K (no padding) conflict
    16-way at K = 16 and 32-way at K = 256, as a thread-per-row walk of
    the stage would."""
    for K, want in ((16, 16), (256, 32)):
        rows = range(32)
        assert _degree_32([r * K for r in rows]) == want


# -- the ring's protocol -------------------------------------------------

class _Mbar:
    """An mbarrier: a phase completes when `count` arrivals are in; a
    wait on parity P passes once the phase of that parity has
    completed."""

    def __init__(self, count):
        self.count, self.pending, self.phases = count, 0, 0

    def arrive(self):
        self.pending += 1
        assert self.pending <= self.count, "more arrivals than the phase"
        if self.pending == self.count:
            self.phases, self.pending = self.phases + 1, 0

    def done(self, parity):
        return (self.phases & 1) != parity


def _simulate(n_mine, S, busy, rng, *, held=True, nch=1, mutate=None):
    """One block's ring: the producer warp, the consumer warps (with their
    named barriers), and the copy engine that completes bulk loads (the
    full barrier's transaction bytes) and the bulk stores' reads at
    random times.  Asserts that a store leaves only once its tile's runs
    are added, that a stage is loaded only once no consumer reads it and
    its store has read it, that consumers see their tile, and that each
    store reads its own tile; a state where no agent can move is a hang.
    `held`: the consumers let the stage go after their squares (values in
    registers), else after Zn.  `nch` > 1: the tiles of chunked rows,
    whose Zn pass stores nothing.  `mutate` breaks one wait."""
    stores = [nch == 1 or j % (2 * nch) < nch for j in range(n_mine)]
    full = [_Mbar(2) for _ in range(S)]        # expect_tx arrive + bytes
    added = [_Mbar(WARPS) for _ in range(S)]
    empty = [_Mbar(WARPS) for _ in range(S)]
    content = [None] * S                       # the tile a stage holds
    readers = [set() for _ in range(S)]
    added_by = [set() for _ in range(n_mine)]
    loads, store_reads = [], []                # in flight: (stage, tile)
    stored = []
    bar = {"gen": 0, "n": 0}

    def wait(cond):
        while not cond():
            yield

    def engine():
        while True:
            inflight = [("l", x) for x in loads] + [("s", x)
                                                    for x in store_reads]
            if inflight and rng.random() < 0.2:     # copies take a while
                kind, (s, tile) = inflight[int(rng.integers(len(inflight)))]
                if kind == "l":
                    loads.remove((s, tile))
                    content[s] = tile
                    full[s].arrive()
                else:
                    store_reads.remove((s, tile))
                    assert content[s] == tile, "a store read another tile"
                    stored.append(tile)
            yield

    def load(i):
        s = i % S
        assert not readers[s], "a stage loaded while it is read"
        assert all(x[0] != s for x in store_reads), \
            "a stage loaded before its store read it"
        content[s] = None
        full[s].arrive()
        loads.append((s, i))

    def producer():
        for i in range(min(S, n_mine)):
            yield
            load(i)
        for j in range(n_mine):
            s, i = j % S, j + S
            yield
            if mutate != "no_added_wait":
                yield from wait(lambda: added[s].done((j // S) & 1))
            assert len(added_by[j]) == WARPS, \
                "a store before the runs were added"
            if stores[j]:
                store_reads.append((s, j))
            if i < n_mine:
                if mutate != "no_empty_wait":
                    yield from wait(lambda: empty[s].done((j // S) & 1))
                if mutate != "no_read_wait":
                    yield from wait(lambda: not store_reads)
                load(i)
        yield from wait(lambda: not store_reads)

    def sync():
        gen = bar["gen"]
        bar["n"] += 1
        if bar["n"] == WARPS:
            bar["gen"], bar["n"] = gen + 1, 0
        while bar["gen"] == gen:
            yield

    def consumer(w):
        for i in range(n_mine):
            s = i % S
            parity = (i // S) & 1
            if mutate == "wrong_parity":
                parity ^= 1
            yield from wait(lambda: full[s].done(parity))
            assert content[s] == i, "a consumer saw another tile"
            readers[s].add(w)
            if busy[i]:
                yield                               # the adds
                yield from sync()
            added_by[i].add(w)
            added[s].arrive()
            yield                                   # the squares
            if held:                # values in registers: the stage is free
                readers[s].discard(w)
                empty[s].arrive()
            yield from sync()                       # squares, then chains
            yield from sync()                       # chains, then Zn
            yield
            if not held:
                readers[s].discard(w)
                empty[s].arrive()

    agents = [producer()] + [consumer(w) for w in range(WARPS)]
    eng = engine()
    stuck = 0
    while agents:
        next(eng)
        i = int(rng.integers(len(agents)))
        try:
            next(agents[i])
            stuck += 1
        except StopIteration:
            agents.pop(i)
            stuck = 0
            continue
        if stuck > 200 * len(agents) + 10 ** 4:
            raise AssertionError("the ring's protocol hangs")
    assert not loads and not store_reads
    assert sorted(stored) == [j for j in range(n_mine) if stores[j]]


@pytest.mark.parametrize("n_mine,S", [(1, 4), (3, 4), (4, 4), (11, 4),
                                      (11, 3), (25, 4), (9, 3), (7, 2)])
@pytest.mark.parametrize("held", [True, False])
@pytest.mark.parametrize("nch", [1, 2, 3])
def test_ring_protocol_completes(rng, n_mine, S, held, nch):
    """The waits and arrivals as the kernel has them end under random
    interleavings, every tile is stored once, no store leaves before its
    runs are added, no stage is loaded while a consumer or a store still
    reads it; with the stage let go after the squares (a tile that fits
    the registers) or after Zn (wider tiles), and with chunked rows'
    passes (no store in the Zn pass)."""
    for _ in range(4):
        busy = rng.random(n_mine) < 0.3
        _simulate(n_mine, S, busy, rng, held=held, nch=nch)


@pytest.mark.parametrize("mutate,match", [
    ("no_empty_wait", "loaded while|another tile|before its store"),
    ("no_read_wait", "before its store|another tile"),
    ("no_added_wait", "before the runs"),
    ("wrong_parity", "hangs|another tile")])
def test_ring_protocol_catches_a_broken_wait(rng, mutate, match):
    """Without the empty wait or the store's read wait a stage is loaded
    too early, without the added wait a store leaves too early; with a
    consumer's parity flipped the ring hangs (or reads a stale tile): the
    simulation fails in each case."""
    with pytest.raises(AssertionError, match=match):
        for _ in range(20):
            _simulate(12, 4, rng.random(12) < 0.3, rng, mutate=mutate)


def test_protocol_statements_in_the_source():
    """The waits the simulation models stand in the kernel."""
    for line in ("mbar_wait(smem_addr(added + s), (j / S) & 1);",
                 "if (tj.ph & DELTA_PASS_NORM)",
                 "mbar_wait(smem_addr(empty + s), (j / S) & 1);",
                 "bulk_wait_read();                  // the store has read "
                 "the stage",
                 '"cp.async.bulk.wait_group.read 0;"',
                 "const int s = j % S, i = j + S;",
                 "const bool held = end - g0 <= 4LL * DELTA_GROUPS * "
                 "DELTA_CONSUMERS;",
                 "if (held) {                              // the stage is no "
                 "longer read",
                 "for (int i = 0; i < min(S, n_mine); ++i) {",
                 "mbar_wait(smem_addr(full + s), (i / S) & 1);",
                 "mbar_init(smem_addr(full + s), 1);",
                 "mbar_init(smem_addr(added + s), DELTA_CONSUMERS / 32);",
                 "mbar_init(smem_addr(empty + s), DELTA_CONSUMERS / 32);",
                 "if (lane == 0) mbar_arrive(smem_addr(added + s));",
                 "if (lane == 0) mbar_arrive(smem_addr(empty + s));",
                 "if (lane == 0) bulk_wait_all();"):
        assert line in _SRC, line


def test_delta_ablate_patches_apply():
    """Every variant of `launch.delta_ablate` patches the source exactly
    once where it changes it, and the exact variants' list holds the
    variants that keep the arithmetic."""
    from repro_torch.launch import delta_ablate as DA
    for name in DA.PATCHES:
        src = DA.variant_source(name)
        assert (src == _SRC) == (name == "base")
    assert set(DA.EXACT) - {"parent"} <= set(DA.PATCHES)
    assert not {"copy_only", "no_delta"} & set(DA.EXACT)
