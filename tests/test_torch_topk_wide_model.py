"""A Python model of `topk_fused`'s long-list bodies on the CPU
(``csrc/query_fused.cu``: `topk_select_chunked_kernel`,
`merge_batch_long`, `topk_merge_long_kernel`), held bit-equal to
`topk_fused_plain` and, under `conftest.topk_equivalent`, to the JAX
package's fused Pallas scan (interpret mode on the CPU).

The model follows the kernel step for step:

* a group of G queries (a power of two) and the group's geometry from
  `chunking(G)`: tiles of `tile` rows, streamed in chunks of `kch`
  columns; each (row, query) sum carried across the chunks in column
  order from -0.0, and with normalize=True a first pass over the chunks
  for the row norms, then each element divided by its row's norm;
* a block's first tile seeding each list with the best of each lane's
  rows before its first pass;
* blocks that own contiguous tile ranges, run interleaved tile by tile
  in a shuffled order, so each sees the thresholds the others published
  as they stood (stale ones included); a tile's threshold for a query is
  the better of the block's own and the one published when the tile
  began (gkey);
* each tile's survivors, visited in a shuffled order (the card's
  threads and atomics), filtered against the threshold as it stood when
  the pass began, kept in a buffer of cap = max(2k, CAP_MIN) slots, the
  rest dropped; the buffers wait across tiles until one holds MERGE_AT
  survivors (or overflowed), and are merged at the block's end; merged
  32 at a time by `merge_batch_long` (binary-search rank, held rows
  skipped, entries moved down in 32-wide chunks from the end of the
  list, each chunk read whole before it is written); an overflowed
  buffer rescans the tile's scores against its new threshold;
* the merge pass: THREADS candidates a batch over the blocks' lists,
  filtered against the list's k-th slot, placed by rank into a new copy
  of the list.

The kernel's constants are read from its source, so the two cannot
drift apart."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import topk_equivalent
from repro.serving import queries as JQ
from repro_torch.kernels import query_fused as QF

_SRC = (Path(QF.__file__).parent / "csrc" / "query_fused.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int (?:\w+ = \d+, )*{name} = (\d+)",
                         _SRC).group(1))


THREADS, KMAX, KLIST_MAX, GROUP = (_const(n) for n in (
    "THREADS", "KMAX", "KLIST_MAX", "GROUP"))
CAP_MIN, CQ, RC, CHUNK_FLOATS, RING, MERGE_AT = (_const(n) for n in (
    "CAP_MIN", "CQ", "RC", "CHUNK_FLOATS", "RING", "MERGE_AT"))
KCH_MIN, KCH_MAX = _const("KCH_MIN"), _const("KCH_MAX")
WARPS = THREADS // 32
INT_MAX = 2**31 - 1
SENTINEL = (float("-inf"), INT_MAX)


def chunking(G):
    """`chunking` of the source: (queries a thread, warps across the
    group, rows a tile, columns a chunk)."""
    q = min(G, CQ)
    wq = G // q
    tile = 32 * RC * (WARPS // wq)
    return q, wq, tile, min(max(CHUNK_FLOATS // tile, KCH_MIN), KCH_MAX)


def _better(a, b):
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _rank(lst, c):
    """The binary search of merge_batch_long: list entries better than c
    (the list is sorted under the total order)."""
    k, r = len(lst), 0
    step = 1 << (k.bit_length() - 1)
    while step:
        if r + step <= k and _better(lst[r + step - 1], c):
            r += step
        step >>= 1
    return r


def merge_batch_long(lst, batch):
    """One warp's step on `lst` (k entries, in place): `batch` holds up
    to 32 candidates, one a lane."""
    k = len(lst)
    cands = []
    for c in batch:
        if not _better(c, lst[k - 1]):
            continue
        r = _rank(lst, c)
        if r < k and lst[r][1] == c[1]:         # held already
            continue
        cands.append((c, r))
    if not cands:
        return
    slots = [r + sum(_better(o, c) for o, _ in cands) for c, r in cands]
    lo = min(r for _, r in cands)
    for b in range(((k - 1) // 32) * 32, (lo // 32) * 32 - 1, -32):
        chunk = [(t, lst[t]) for t in range(max(b, lo), min(b + 32, k))]
        moves = [(t + sum(r <= t for _, r in cands), e) for t, e in chunk]
        for p, e in moves:                      # read whole, then written
            if p < k:
                lst[p] = e
    for (c, _), p in zip(cands, slots):
        if p < k:
            lst[p] = c


def merge_long(cands, k):
    """The merge pass for one query: THREADS candidates a batch."""
    lst = [SENTINEL] * k
    for b in range(0, len(cands), THREADS):
        surv = []
        for c in cands[b:b + THREADS]:
            if _better(c, lst[k - 1]):
                r = _rank(lst, c)
                if not (r < k and lst[r][1] == c[1]):
                    surv.append((c, r))
        if not surv:
            continue
        new = [None] * k
        for c, r in surv:
            p = r + sum(_better(o, c) for o, _ in surv)
            if p < k:
                new[p] = c
        for t, e in enumerate(lst):
            p = t + sum(r <= t for _, r in surv)
            if p < k:
                new[p] = e
        assert all(e is not None for e in new)
        lst = new
    return lst


def tile_scores(rows, q, K, kch, normalize, eps=QF.EPS):
    """One tile through its chunks: (scores (nq, rows) float32, the rows
    as scored).  Sums start at -0.0 and take the chunks' columns in
    order; with normalize the norms come from a first pass."""
    z = rows.clone()
    if normalize:
        ss = torch.full((z.shape[0],), -0.0)
        for c0 in range(0, K, kch):
            for c in range(c0, min(c0 + kch, K)):
                ss = ss + z[:, c] * z[:, c]
        d = torch.sqrt(ss.double()).float().clamp_min(eps)
        z = z / d[:, None]
    acc = torch.full((q.shape[0], z.shape[0]), -0.0)
    for c0 in range(0, K, kch):
        for c in range(c0, min(c0 + kch, K)):
            acc = acc + q[:, None, c] * z[None, :, c]
    return acc, z


def wide_model(Z_rows, q, qnodes, *, k, G, blocks, row_offset,
               exclude_self, normalize, rng, log):
    """Both passes of the long-list kernels.  Returns (vals, idxs, Zn);
    counts merges and rescans in `log`."""
    m, K = Z_rows.shape
    nq = q.shape[0]
    _, _, tile, kch = chunking(G)
    cap = max(2 * k, CAP_MIN)
    nt = -(-m // tile)
    zn = torch.empty_like(Z_rows)
    cand = [[None] * blocks for _ in range(nq)]
    for g0 in range(0, nq, G):
        gq = min(G, nq - g0)
        shared = [SENTINEL] * gq      # best k-th slot published (gkey)
        lists = [[[SENTINEL] * k for _ in range(gq)] for _ in range(blocks)]
        thrs = [[SENTINEL] * gq for _ in range(blocks)]     # each S.ts
        # each block's survivor buffers and counts, kept across tiles
        bufs = [[[] for _ in range(gq)] for _ in range(blocks)]
        count = [[0] * gq for _ in range(blocks)]

        def merge(b):
            """merge_tile: every buffer into its list (32 at a time, in
            arrival order), then every query publishes its k-th slot and
            takes the best any block published (set_threshold).  Returns
            the queries whose buffer overflowed."""
            ls, thr = lists[b], thrs[b]
            over = [j for j in range(gq) if count[b][j] > cap]
            for j in range(gq):
                for e in range(0, len(bufs[b][j]), 32):
                    merge_batch_long(ls[j], bufs[b][j][e:e + 32])
                bufs[b][j], count[b][j] = [], 0
                if ls[j][-1][1] != INT_MAX and _better(ls[j][-1],
                                                       shared[j]):
                    shared[j] = ls[j][-1]
                thr[j] = shared[j]
            log["merges"] += 1
            return over

        todo = [list(range(b * nt // blocks, (b + 1) * nt // blocks))
                for b in range(blocks)]
        order = [b for b in range(blocks) for _ in todo[b]]
        for b in rng.permutation(order):
            t = todo[b].pop(0)
            r0 = t * tile
            rows = Z_rows[r0:min(r0 + tile, m)]
            S, z = tile_scores(rows, q[g0:g0 + gq], K, kch, normalize)
            zn[r0:r0 + rows.shape[0]] = z
            if t == b * nt // blocks:
                # the block's first tile seeds each list with the best of
                # each lane's rows (lane l: rows l + 32 r, r < RC); the
                # pass offers them again, and the merge skips them as held
                for j in range(gq):
                    seeds = []
                    for lane in range(32):
                        best = SENTINEL
                        for r in range(lane, min(32 * RC, z.shape[0]), 32):
                            c = (float(S[j, r]), row_offset + r0 + r)
                            if not (exclude_self and
                                    c[1] == int(qnodes[g0 + j])) and \
                                    _better(c, best):
                                best = c
                        if best != SENTINEL:
                            seeds.append(best)
                    merge_batch_long(lists[b][j], seeds)
                    if lists[b][j][-1][1] != INT_MAX and _better(
                            lists[b][j][-1], shared[j]):
                        shared[j] = lists[b][j][-1]
                    thrs[b][j] = max(thrs[b][j], shared[j],
                                     key=lambda e: (e[0], -e[1]))
            gk = list(shared)           # gkey as the tile's filter began
            redo = list(range(gq))
            while redo:
                pairs = [(j, r) for j in redo for r in range(z.shape[0])]
                eff = [max(thrs[b][j], gk[j], key=lambda e: (e[0], -e[1]))
                       for j in range(gq)]
                for n in rng.permutation(len(pairs)):
                    j, r = pairs[n]
                    c = (float(S[j, r]), row_offset + r0 + r)
                    if exclude_self and c[1] == int(qnodes[g0 + j]):
                        continue
                    if _better(c, eff[j]):
                        count[b][j] += 1
                        if len(bufs[b][j]) < cap:
                            bufs[b][j].append(c)
                # a merge once a buffer holds MERGE_AT (or overflowed);
                # until then the survivors wait across tiles
                if max(count[b]) < MERGE_AT:
                    break
                redo = merge(b)
                log["rescans"] += len(redo)
            if not todo[b]:
                merge(b)                # what still waits at the block's end
        for b in range(blocks):
            for j in range(gq):
                cand[g0 + j][b] = lists[b][j]
    vals = np.full((nq, k), -np.inf, np.float32)
    idxs = np.full((nq, k), -1, np.int32)
    for j in range(nq):
        final = merge_long([e for lst in cand[j] for e in lst], k)
        for slot, (s, i) in enumerate(final):
            vals[j, slot] = s
            idxs[j, slot] = -1 if i == INT_MAX or not np.isfinite(s) else i
    return torch.as_tensor(vals), torch.as_tensor(idxs), zn


def test_constants_read_from_the_source():
    assert (THREADS, KMAX, KLIST_MAX, GROUP) == (256, 64, 4096, 64)
    assert QF.KLIST_MAX == KLIST_MAX
    # every group's geometry: the warps cover the group and the tile,
    # and a chunk's columns are a power of two
    for G in (1, 2, 4, 8, 16, 32, 64):
        q, wq, tile, kch = chunking(G)
        assert q * wq == G and wq <= WARPS and tile % 32 == 0
        assert KCH_MIN <= kch <= KCH_MAX and kch & (kch - 1) == 0


@pytest.mark.parametrize("K", [257, 300, 512, 1024])
def test_chunked_sums_are_row_dots(rng, K):
    """Sums carried across chunks from -0.0, in column order, have
    `row_scores`' bits (and so the plain scan's), zeros' signs included."""
    Z = rng.normal(size=(70, K)).astype(np.float32)
    Z[:5] = 0.0
    Z[5:10] = -0.0
    q = rng.normal(size=(4, K)).astype(np.float32)
    q[0] = -0.0
    Zt, qt = torch.as_tensor(Z), torch.as_tensor(q)
    for G in (64, 8, 1):
        got, _ = tile_scores(Zt, qt, K, chunking(G)[3], False)
        want = QF.row_scores(qt, Zt)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# (K, m, nq, k, G, blocks, run, exclude_self, normalize): runs of `run`
# equal rows give exact ties across tiles and blocks; k past the rows
WIDE_CASES = [
    (257, 1500, 5, 65, 8, 3, 7, True, False),
    (300, 1300, 4, 100, 4, 2, 3, False, True),
    (512, 1100, 3, 256, 2, 2, 5, True, True),
    (1024, 1400, 2, 1024, 1, 2, 2, False, False),
    (300, 900, 9, 65, 64, 4, 3, True, True),
    (257, 700, 3, 1024, 4, 1, 1, True, False),
    (512, 1200, 17, 100, 16, 3, 4, False, False),
    (1024, 600, 3, 256, 2, 1, 2, True, True),
    (300, 1200, 6, 256, 1, 3, 6, False, True),
    (257, 2100, 2, 100, 2, 5, 2, True, True),
    (257, 3000, 6, 10, 8, 4, 5, True, False),
    (300, 2000, 4, 65, 4, 3, 3, False, True),
    (1024, 1600, 2, 100, 2, 2, 2, True, False),
    (512, 1800, 3, 256, 1, 2, 3, False, True),
]


@pytest.mark.parametrize("K,m,nq,k,G,blocks,run,exclude_self,normalize",
                         WIDE_CASES)
def test_wide_model_equals_plain_and_reference(rng, K, m, nq, k, G, blocks,
                                               run, exclude_self,
                                               normalize):
    base = rng.normal(size=(-(-m // run), K)).astype(np.float32)
    Z = torch.as_tensor(np.repeat(base, run, axis=0)[:m])
    Zn = QF.normalize_rows(Z)
    qnodes = rng.integers(0, m, nq).astype(np.int32)
    q = Zn[torch.as_tensor(qnodes).long()]
    off = 30
    qn = torch.as_tensor(qnodes + off)
    rows = Z if normalize else Zn
    log = {"merges": 0, "rescans": 0}
    vals, idxs, zn = wide_model(rows, q, qn, k=k, G=G, blocks=blocks,
                                row_offset=off, exclude_self=exclude_self,
                                normalize=normalize, rng=rng, log=log)
    # a tile wider than the buffer overflowed it and rescanned
    if chunking(G)[2] > max(2 * k, CAP_MIN):
        assert log["rescans"] > 0, log
    plain = QF.topk_fused_plain(rows, q, qn, k=k, row_offset=off,
                                exclude_self=exclude_self,
                                normalize=normalize)
    assert torch.equal(vals, plain[0]) and torch.equal(idxs, plain[1])
    if normalize:
        assert torch.equal(zn.view(torch.int32), plain[2].view(torch.int32))
    fused = JQ.topk_cosine_fused_norm if normalize else JQ.topk_cosine_fused
    ji, jv = fused(jnp.asarray(rows.numpy()), jnp.asarray(q.numpy()),
                   qnodes + off, k=k, block_rows=256,
                   exclude_self=exclude_self, row_offset=off)[:2]
    topk_equivalent(idxs.numpy(), vals.numpy(), ji, jv)


@pytest.mark.parametrize("k", [65, 100, 256, 1024])
def test_merge_batch_long_is_the_top_k_of_the_union(rng, k):
    """Batches of up to 32 candidates, with ties on score and rows the
    list holds already, into lists of any fill: the list is always the
    top k of everything offered, sorted, sentinels after."""
    lst = [SENTINEL] * k
    seen = set()
    pool = []
    for step in range(3 * k // 32 + 8):
        n = int(rng.integers(1, 33))
        batch = []
        for _ in range(n):
            if pool and rng.random() < 0.2:
                batch.append(pool[int(rng.integers(len(pool)))])
            else:
                i = int(rng.integers(0, 10 * k))
                s = float(np.float32(rng.integers(0, 40) / 8))
                c = (s, i)
                if i in {e[1] for e in batch}:
                    continue
                batch.append(c)
        batch = list({c[1]: c for c in batch}.values())
        # a row keeps its score, as an exact score does
        batch = [c for c in batch if c[1] not in seen or c in pool]
        merge_batch_long(lst, batch)
        for c in batch:
            if c[1] not in seen:
                seen.add(c[1])
                pool.append(c)
        want = sorted(pool, key=lambda e: (-e[0], e[1]))[:k]
        assert lst[:len(want)] == want
        assert all(e == SENTINEL for e in lst[len(want):])


@pytest.mark.parametrize("name", ["base", "rows_2", "copy_4", "eager_merge",
                                  "no_seed", "no_filter"])
def test_topk_ablate_patches_apply(name):
    """`launch.topk_ablate`'s source variants still find the lines they
    patch in csrc/query_fused.cu, once each; base is the source."""
    from repro_torch.launch import topk_ablate as TA
    assert set(TA.PATCHES) == {"base", "rows_2", "copy_4", "eager_merge",
                               "no_seed", "no_filter"}
    out = TA.variant_source(name)
    assert (out == _SRC) == (name == "base")
