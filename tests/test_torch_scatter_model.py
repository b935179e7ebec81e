"""A numpy model of the gee_scatter kernel's algorithm
(``src/repro_torch/kernels/csrc/gee_scatter.cu``), which cannot run here.

The model follows the kernel step by step: the sub-tiles the wrapper
chooses (`gee_scatter.subtile`), the split of a pass's rows among the
block's warps, each warp's walk over 16-byte-aligned stages in 32-wide
batches, the row of each lane from a window of 32 row ends (the 5-step
shuffle search), lanes with value 0 or a class outside the pass sitting
out, the grouping of equal (row, class) keys, and each group's values
added into the sub-tile in ascending lane order (a member at a time, or,
for a large group in a dense batch, all 32 lanes' values with +0.0 for
the lanes outside it).  The kernel's constants are read from its
source, so the two cannot drift apart.

Held to the JAX reference (`repro.kernels.ref.gee_scatter_ref`) at atol
1e-5, the port's Z tolerance, and bit-equal to a serial float32 sum in
packed order, which is what the kernel's order of additions is."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import gee_scatter_ref
from repro_torch.graph.generators import powerlaw
from repro_torch.kernels import gee_scatter as GS
from repro_torch.kernels.ops import pack_edges

_SRC = (Path(GS.__file__).parent / "csrc" / "gee_scatter.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


WARPS, STAGE = _const("WARPS"), _const("STAGE")
LANES = np.arange(32)
INF = np.iinfo(np.int64).max


def new_log():
    """What a model run counts: lanes that sat out, batches reduced, each
    warp's rows, batches folded from registers, and queue drains."""
    return {"sat_out": 0, "batches": 0, "owned": [], "fold32": 0,
            "drains": 0}


def split_rows(rp, nr):
    """Each warp's rows [ra, rb) of a pass: a warp's rows start at the
    first row whose offset reaches its share of the contributions."""
    p0, span = int(rp[0]), int(rp[nr] - rp[0])
    starts = [int(np.searchsorted(rp[:nr + 1], p0 + span * w // WARPS,
                                  side="left")) for w in range(WARPS)]
    return list(zip(starts, starts[1:] + [nr]))


def lane_rows(ends, e):
    """The kernel's row search: per lane, how many of the 32 window rows
    end at or before its contribution e."""
    cnt = np.zeros(32, np.int64)
    for step in (16, 8, 4, 2, 1):
        cnt = np.where(ends[cnt + step - 1] <= e, cnt + step, cnt)
    return np.where(ends[31] <= e, 32, cnt)


def match_key(act, key):
    """__match_any_sync over the active lanes: per lane, the mask of the
    active lanes holding its key."""
    return np.array([np.sum((act & (key == key[lane])) << LANES)
                     for lane in range(32)])


class Warp:
    """One warp's walk over its rows [ra, rb) of a pass (rows local to
    it), with its row window and its queue of sparse batches."""

    def __init__(self, rp, ra, rb, zt, nc, log):
        self.rp, self.rb, self.zt, self.nc, self.log = rp, rb, zt, nc, log
        self.base = ra
        self.queue = []                   # (e, class, value), in order

    def window(self):
        r = self.base + LANES
        return np.where(r < self.rb,
                        self.rp[np.minimum(r + 1, len(self.rp) - 1)], INF)

    def reduce32(self, e, c, x, act):
        """One batch: lane l holds contribution e[l] (ascending over the
        active lanes), class c[l] and value x[l]."""
        rp, zt, nc, log = self.rp, self.zt, self.nc, self.log
        row = np.zeros(32, np.int64)
        need = act.copy()
        while True:
            cnt = lane_rows(self.window(), e)
            row = np.where(need & (cnt < 32), self.base + cnt, row)
            need &= cnt == 32
            if not need.any():
                break
            self.base += 32
        # the search agrees with a plain search over the offsets
        want = np.searchsorted(rp, e[act], side="right") - 1
        assert np.array_equal(row[act], want)
        key = row * nc + c
        masks = match_key(act, key)
        groups = [np.flatnonzero((masks[lane] >> LANES) & 1)
                  for lane in range(32)]
        # a dense batch with a group of more than 8 folds every lane's
        # value, +0.0 for lanes outside the group
        fold32 = act.sum() > 16 and max(map(len, groups)) > 8
        log["fold32"] += int(fold32)
        for lane in np.flatnonzero(act):
            grp = groups[lane]
            if grp[0] != lane:
                continue                 # not the group's lowest lane
            z = zt[key[lane]]
            for m in (range(32) if fold32 else grp):
                z = np.float32(z + (x[m] if m in grp else np.float32(0)))
            zt[key[lane]] = z
        log["batches"] += 1

    def drain(self, k):
        """The queue's first k entries as one batch."""
        head, self.queue = self.queue[:k], self.queue[k:]
        e, c, x = (np.array([t[i] for t in head] + [0] * (32 - k))
                   for i in range(3))
        self.reduce32(e, c, x.astype(np.float32), LANES < k)
        self.log["drains"] += 1

    def walk(self, cls, val, c0):
        """Stages of 128 from the 16-byte vector holding the first
        contribution, 32-wide batches: a batch with more than 16 active
        lanes is reduced as it stands (after draining the queue), the
        active lanes of a sparser one are queued and drained 32 at a
        time."""
        S = cls.shape[0]
        a, b = int(self.rp[self.base]), int(self.rp[self.rb])
        if a >= b:
            return
        v0, v1 = a >> 2, (b + 3) >> 2
        for s in range((v1 - v0 + 31) >> 5):
            sbase = 4 * (v0 + 32 * s)
            for j in range(STAGE // 32):
                e0 = sbase + 32 * j
                if e0 >= b:
                    break
                if e0 + 32 <= a:
                    continue
                e = e0 + LANES
                inside = e < S           # the stage's zero-filled tail
                x = np.where(inside, val[np.minimum(e, S - 1)],
                             np.float32(0))
                c = np.where(inside, cls[np.minimum(e, S - 1)], 0) - c0
                act = (e >= a) & (e < b) & (x != 0) & (c >= 0) & (c < self.nc)
                self.log["sat_out"] += int(((e >= a) & (e < b) & ~act).sum())
                if not act.any():
                    continue
                if act.sum() > 16:
                    if self.queue:
                        self.drain(len(self.queue))
                    self.reduce32(e, c, x, act)
                else:
                    self.queue += [(e[i], c[i], x[i])
                                   for i in np.flatnonzero(act)]
                    if len(self.queue) >= 32:
                        self.drain(32)
        if self.queue:
            self.drain(len(self.queue))


def model_scatter(row_ptr, cls, val, *, num_tiles, tile_n, kdim,
                  tile_order=None, warp_order=None, log=None):
    """Z (num_tiles * tile_n, kdim) as the kernel computes it.  Tiles and
    warps run in the given orders (the card runs them in any)."""
    row_ptr, cls, val = (np.asarray(x) for x in (row_ptr, cls, val))
    S = cls.shape[0]
    log = new_log() if log is None else log
    sub_rows, sub_cols = GS.subtile(tile_n, kdim)
    Z = np.full((num_tiles * tile_n, kdim), np.nan, np.float32)
    zt = np.zeros(sub_rows * sub_cols, np.float32)
    for t in (range(num_tiles) if tile_order is None else tile_order):
        row0 = t * tile_n
        for r0 in range(0, tile_n, sub_rows):
            nr = min(sub_rows, tile_n - r0)
            for c0 in range(0, kdim, sub_cols):
                nc = min(sub_cols, kdim - c0)
                rp = np.clip(row_ptr[row0 + r0:row0 + r0 + nr + 1], 0, S)
                splits = split_rows(rp, nr)
                for w in (range(WARPS) if warp_order is None
                          else warp_order):
                    ra, rb = splits[w]
                    log["owned"].append((row0 + r0, c0, ra, rb))
                    Warp(rp, ra, rb, zt, nc, log).walk(cls, val, c0)
                Z[row0 + r0:row0 + r0 + nr, c0:c0 + nc] = \
                    zt[:nr * nc].reshape(nr, nc)
                zt[:] = 0
    return Z


def serial_sum(row_ptr, cls, val, rows_total, kdim):
    """float32 sum of each (row, class) in packed order, one add each."""
    rows = np.repeat(np.arange(rows_total), np.diff(row_ptr))
    Z = np.zeros((rows_total, kdim), np.float32)
    np.add.at(Z, (rows, cls), val)
    return Z


def _case(rng, name):
    """(dst, cls, val, n, K, tile_n): GEE-sized values (Wv * w <= 1),
    90 % of them 0 as at the main fit (10 % of nodes labelled)."""
    if name == "skewed":
        n, K, tile_n = 700, 16, 64
        g = powerlaw(n, 6000, alpha=0.5, seed=3)
        dst = np.concatenate([g.u, g.v])
    elif name == "k256":
        n, K, tile_n = 300, 256, 64
        dst = rng.integers(0, n, 5000)
    elif name == "giant_row":
        n, K, tile_n = 500, 8, 64
        dst = np.concatenate([np.full(3000, 70), rng.integers(0, n, 1500)])
        dst = rng.permutation(dst)
    elif name == "homophilous":           # a refine round on an SBM
        n, K, tile_n = 400, 16, 64
        dst = rng.integers(0, n, 6000)
        cls = np.where(rng.random(6000) < 0.9, dst % K,
                       rng.integers(0, K, 6000))
        val = (rng.random(6000, dtype=np.float32) + 0.5) / 64
        return dst.astype(np.int32), cls.astype(np.int32), val, n, K, tile_n
    else:                                 # "uniform", with empty rows
        n, K, tile_n = 1000, 5, 256
        dst = rng.integers(0, n // 3, 4000) * 3
    cls = rng.integers(0, K, dst.shape[0])
    val = (rng.random(dst.shape[0], dtype=np.float32) + 0.5) / 64
    val[rng.random(dst.shape[0]) < 0.9] = 0
    val[::7] = np.where(val[::7] == 0, np.float32(-0.0), val[::7])
    return dst.astype(np.int32), cls.astype(np.int32), val, n, K, tile_n


def _packed(dst, cls, val, n, tile_n):
    row_ptr, c, v, T = pack_edges(torch.as_tensor(dst), torch.as_tensor(cls),
                                  torch.as_tensor(val), n, tile_n)
    return row_ptr.numpy(), c.numpy(), v.numpy(), T


CASES = ["skewed", "k256", "giant_row", "uniform", "homophilous"]


@pytest.mark.parametrize("name", CASES)
def test_model_matches_reference(rng, name):
    dst, cls, val, n, K, tile_n = _case(rng, name)
    row_ptr, c, v, T = _packed(dst, cls, val, n, tile_n)
    log = new_log()
    Z = model_scatter(row_ptr, c, v, num_tiles=T, tile_n=tile_n, kdim=K,
                      log=log)
    ref = np.asarray(gee_scatter_ref(jnp.asarray(dst), jnp.asarray(cls),
                                     jnp.asarray(val), n, K))
    np.testing.assert_allclose(Z[:n], ref, atol=1e-5)
    assert not Z[n:].any()
    # the kernel's order of additions is the serial one: the same bits
    # as a float32 sum in packed order, zeros included
    assert np.array_equal(Z, serial_sum(row_ptr, c, v, T * tile_n, K))
    # zeros sit out, and dropping them from the input changes no bit
    assert log["sat_out"] >= int((v == 0).sum())
    if name == "homophilous":     # dense batches, large groups
        assert log["fold32"] > 0
    else:                         # 90 % zeros: sparse batches are queued
        assert log["drains"] > 0
    nz = val != 0
    row_ptr2, c2, v2, _ = _packed(dst[nz], cls[nz], val[nz], n, tile_n)
    assert np.array_equal(Z, model_scatter(row_ptr2, c2, v2, num_tiles=T,
                                           tile_n=tile_n, kdim=K))


@pytest.mark.parametrize("name", CASES)
def test_any_order_same_bits(rng, name):
    """Tiles and warps in any order give the same Z bits (each warp owns
    its rows, so nothing depends on when it runs)."""
    dst, cls, val, n, K, tile_n = _case(rng, name)
    row_ptr, c, v, T = _packed(dst, cls, val, n, tile_n)
    kw = dict(num_tiles=T, tile_n=tile_n, kdim=K)
    Z = model_scatter(row_ptr, c, v, **kw)
    for _ in range(2):
        Zp = model_scatter(row_ptr, c, v, tile_order=rng.permutation(T),
                           warp_order=rng.permutation(WARPS), **kw)
        assert np.array_equal(Z, Zp)


@pytest.mark.parametrize("name", CASES)
def test_split_covers_every_row_once(rng, name):
    """Under any order of tiles and warps, the warps' rows cover every row
    of every pass exactly once, and a warp's contributions exceed an even
    share by less than one row."""
    dst, cls, val, n, K, tile_n = _case(rng, name)
    row_ptr, c, v, T = _packed(dst, cls, val, n, tile_n)
    log = new_log()
    model_scatter(row_ptr, c, v, num_tiles=T, tile_n=tile_n, kdim=K,
                  tile_order=rng.permutation(T),
                  warp_order=rng.permutation(WARPS), log=log)
    sub_rows, sub_cols = GS.subtile(tile_n, K)
    seen = {}
    for r0, c0, ra, rb in log["owned"]:
        seen.setdefault((r0, c0), []).append((ra, rb))
    assert len(seen) == T * -(-tile_n // sub_rows) * -(-K // sub_cols)
    longest = int(np.diff(row_ptr).max(initial=0))
    for (r0, _), parts in seen.items():
        nr = min(sub_rows, T * tile_n - r0, tile_n - r0 % tile_n)
        covered = np.zeros(nr, np.int64)
        for ra, rb in parts:
            covered[ra:rb] += 1
        assert (covered == 1).all()
        rp = row_ptr[r0:r0 + nr + 1]
        share = -(-(rp[-1] - rp[0]) // WARPS)
        for ra, rb in parts:
            assert rp[rb] - rp[ra] < share + longest + 1


@pytest.mark.parametrize("z_floats,want", [(1024, (4, 256)),
                                           (100, (1, 100))])
def test_sub_tiles_for_wide_k(rng, monkeypatch, z_floats, want):
    """K = 256 with a smaller shared-memory budget: row sub-ranges (4
    rows a pass), and column ranges (100 classes a pass, the last one
    56), give the same bits as the whole tile."""
    dst, cls, val, n, K, tile_n = _case(rng, "k256")
    val[val == 0] = np.float32(0.25)      # every lane active
    row_ptr, c, v, T = _packed(dst, cls, val, n, tile_n)
    kw = dict(num_tiles=T, tile_n=tile_n, kdim=K)
    Z = model_scatter(row_ptr, c, v, **kw)
    monkeypatch.setattr(GS, "Z_FLOATS", z_floats)
    assert GS.subtile(tile_n, K) == want
    assert np.array_equal(model_scatter(row_ptr, c, v, **kw), Z)
    assert np.array_equal(Z, serial_sum(row_ptr, c, v, T * tile_n, K))


def test_giant_row_walked_32_wide(rng):
    """One row of 50,000 contributions, every one labelled: the warp that
    owns it walks it in 32-wide batches (about 50,000 / 32 of them), never
    one contribution at a time, and the other warps own the rest."""
    n, K, tile_n = 128, 16, 64
    dst = np.concatenate([np.full(50_000, 5), rng.integers(0, n, 2000)])
    dst = rng.permutation(dst).astype(np.int32)
    cls = rng.integers(0, K, dst.shape[0]).astype(np.int32)
    val = (rng.random(dst.shape[0], dtype=np.float32) + 0.5) / 64
    row_ptr, c, v, T = _packed(dst, cls, val, n, tile_n)
    log = new_log()
    Z = model_scatter(row_ptr, c, v, num_tiles=T, tile_n=tile_n, kdim=K,
                      log=log)
    assert log["batches"] <= dst.shape[0] // 32 + 4 * WARPS * T
    owner = [(ra, rb) for r0, _, ra, rb in log["owned"] if r0 == 0
             and ra <= 5 < rb]
    assert len(owner) == 1
    assert np.array_equal(Z, serial_sum(row_ptr, c, v, T * tile_n, K))
    ref = np.asarray(gee_scatter_ref(jnp.asarray(dst), jnp.asarray(cls),
                                     jnp.asarray(val), n, K))
    np.testing.assert_allclose(Z, ref, atol=1e-5)
