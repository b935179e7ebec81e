"""A model of the `topk_fused` kernel's algorithm on the CPU.

``csrc/query_fused.cu`` cannot run here, so this file holds a small
Python model of what its two passes do, and shows that the algorithm
gives the plain scan's answer bit for bit whatever the split:

* rows split into B contiguous blocks of whole tiles, run one after the
  other; a block's first tile seeds each query's list from a share of
  its rows;
* each tile's (row, query) scores from `row_scores` (the kernel's
  fixed-order arithmetic), visited in a shuffled order, as the card's
  threads and atomics deliver them;
* survivors filtered against the threshold as it stood when the pass
  over the tile began: the better, under (score desc, id asc), of the
  block's running k-th best and the best k-th any block published,
  kept in a buffer of `cap` slots per query and merged into the query's
  list after the pass, in arrival order; a query whose buffer overflowed
  rescans the tile against its new threshold (rows held already are
  skipped);
* then the blocks' lists merged, in a shuffled order.

The model must equal `topk_fused_plain` exactly, and agree with the JAX
package's fused Pallas scan (`repro.serving.queries.topk_cosine_fused`,
interpret mode on the CPU) under `conftest.topk_equivalent`: the two
packages sum scores in different orders."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import topk_equivalent
from repro.serving import queries as JQ
from repro_torch.kernels import query_fused as QF

SENTINEL = (float("-inf"), 2**31 - 1)      # (-inf, INT_MAX)


def _better(a, b):
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _insert(lst, cand):
    """A row held already is skipped (a rescanned or seeding tile offers
    it again); else rank = slots better than cand, then shift."""
    if cand in lst:
        return
    p = sum(_better(e, cand) for e in lst)
    lst[p:] = [cand] + lst[p:-1]


def _offer(lst, cands):
    for c in cands:
        if _better(c, lst[-1]):      # re-checked against the moving k-th
            _insert(lst, c)


def select_model(Z_rows, q, qnodes, *, k, row_offset, exclude_self,
                 normalize, blocks, tile, cap, rng):
    """Both passes of the kernel, in Python.  Returns (vals, idxs)."""
    Zn = QF.normalize_rows(Z_rows) if normalize else Z_rows
    m, nq = Zn.shape[0], q.shape[0]
    nt = -(-m // tile)
    block_lists = []
    shared = [SENTINEL] * nq       # best k-th slot any block published

    def threshold(lists, j):
        """The better of the list's k-th slot and the shared one; the
        list's is published first."""
        if _better(lists[j][-1], shared[j]):
            shared[j] = lists[j][-1]
        return shared[j]

    for b in range(blocks):
        lists = [[SENTINEL] * k for _ in range(nq)]
        for t in range(b * nt // blocks, (b + 1) * nt // blocks):
            r0 = t * tile
            rows = Zn[r0:min(r0 + tile, m)]
            S = QF.row_scores(q, rows).numpy()
            if t == b * nt // blocks:
                # the block's first tile seeds each list from a share of
                # its rows; the pass below offers them again
                for j in range(nq):
                    _offer(lists[j], [
                        (float(S[j, r]), row_offset + r0 + r)
                        for r in range(j % 3, rows.shape[0], 3)
                        if not (exclude_self
                                and row_offset + r0 + r == int(qnodes[j]))])
                    threshold(lists, j)
            todo = range(nq)
            while todo:
                # thresholds as they stood when the pass began
                thr = {j: threshold(lists, j) for j in todo}
                pairs = [(j, r) for j in todo for r in range(rows.shape[0])]
                buf = {j: [] for j in todo}
                count = dict.fromkeys(todo, 0)
                for n in rng.permutation(len(pairs)):
                    j, r = pairs[n]
                    cand = (float(S[j, r]), row_offset + r0 + r)
                    if exclude_self and cand[1] == int(qnodes[j]):
                        continue
                    if _better(cand, thr[j]):
                        count[j] += 1
                        if len(buf[j]) < cap:      # the rest is dropped
                            buf[j].append(cand)
                for j in todo:
                    _offer(lists[j], buf[j])
                # an overflowed buffer rescans the tile, new threshold
                todo = [j for j in todo if count[j] > cap]
        block_lists.append(lists)
    vals = np.full((nq, k), -np.inf, np.float32)
    idxs = np.full((nq, k), -1, np.int32)
    for j in range(nq):
        cands = [e for lists in block_lists for e in lists[j]]
        final = [SENTINEL] * k
        _offer(final, [cands[n] for n in rng.permutation(len(cands))])
        for slot, (s, i) in enumerate(final):
            vals[j, slot] = s
            idxs[j, slot] = -1 if i == SENTINEL[1] or not np.isfinite(s) \
                else i
    return torch.as_tensor(vals), torch.as_tensor(idxs)


def _data(rng, m, nq, K, ties):
    """Rows (runs of 7 equal rows when `ties`, so equal scores straddle
    tiles and blocks) and queries taken from them."""
    if ties:
        base = rng.normal(size=(-(-m // 7), K)).astype(np.float32)
        Z = np.repeat(base, 7, axis=0)[:m]
    else:
        Z = rng.normal(size=(m, K)).astype(np.float32)
    Zn = QF.normalize_rows(torch.as_tensor(Z))
    qnodes = rng.integers(0, m, nq).astype(np.int32)
    return torch.as_tensor(Z), Zn, Zn[torch.as_tensor(qnodes).long()], \
        qnodes


# (m, nq, k, blocks B, tile, buffer slots per query): tiles wider than
# the buffer overflow it and rescan
SPLITS = [(257, 9, 10, 1, 64, 20), (257, 9, 10, 3, 16, 20),
          (257, 9, 10, 7, 1, 20), (200, 5, 64, 2, 200, 128),
          (130, 6, 1, 5, 8, 2), (6, 4, 10, 2, 4, 20)]


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("m,nq,k,blocks,tile,cap", SPLITS)
def test_model_equals_plain_and_reference(rng, m, nq, k, blocks, tile, cap,
                                          ties, exclude_self, normalize):
    K, off = 6, 40
    Z, Zn, q, qnodes = _data(rng, m, nq, K, ties)
    rows = Z if normalize else Zn
    qn = torch.as_tensor(qnodes + off)
    got = select_model(rows, q, qn, k=k, row_offset=off,
                       exclude_self=exclude_self, normalize=normalize,
                       blocks=blocks, tile=tile, cap=cap, rng=rng)
    plain = QF.topk_fused_plain(rows, q, qn, k=k, row_offset=off,
                                exclude_self=exclude_self,
                                normalize=normalize)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    fused = JQ.topk_cosine_fused_norm if normalize else JQ.topk_cosine_fused
    ji, jv = fused(jnp.asarray(rows.numpy()), jnp.asarray(q.numpy()),
                   qnodes + off, k=k, block_rows=32,
                   exclude_self=exclude_self, row_offset=off)[:2]
    topk_equivalent(got[1].numpy(), got[0].numpy(), ji, jv)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_model_answer_does_not_depend_on_the_split(seed):
    """Tie-heavy rows at K = 16 (the main path's width): every split and
    arrival order gives the same bits."""
    rng = np.random.default_rng(seed)
    Z, Zn, q, qnodes = _data(rng, 300, 8, 16, ties=True)
    qn = torch.as_tensor(qnodes)
    ref = QF.topk_fused_plain(Zn, q, qn, k=10)
    for blocks, tile, cap in ((1, 300, 20), (2, 64, 20), (6, 16, 20),
                              (9, 7, 30)):
        got = select_model(Zn, q, qn, k=10, row_offset=0, exclude_self=True,
                           normalize=False, blocks=blocks, tile=tile,
                           cap=cap, rng=rng)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _fma_dot(q, Z):
    """(nq, m) dots with one rounding to float32 a step, as an FMA chain:
    each product is exact in float64 before the step's rounding (the
    float64 sum may round once more, well inside the margin's slack)."""
    q64, Z64 = q.double(), Z.double()
    a = (q64[:, None, 0] * Z64[None, :, 0]).float()
    for c in range(1, q.shape[1]):
        a = (q64[:, None, c] * Z64[None, :, c] + a.double()).float()
    return a


@pytest.mark.parametrize("K", [8, 16, 32])
@pytest.mark.parametrize("kind", ["unit", "cancelling", "wide"])
def test_prefilter_margin_covers_the_rounding(rng, K, kind):
    """The register body skips the exact score of a (row, query) when its
    FMA dot plus (4K + 16) 2^-24 ||q|| ||z|| is below the threshold: that
    margin must cover |FMA dot - fixed-order score| (it is twice the
    2 gamma_K ||q|| ||z|| bound)."""
    m, nq = 4000, 16
    Z = rng.normal(size=(m, K)).astype(np.float32)
    q = rng.normal(size=(nq, K)).astype(np.float32)
    if kind == "cancelling":       # q . z near 0 from large terms
        Z[:, K // 2:] = -Z[:, :K // 2] * np.float32(1 + 1e-4)
        q[:, K // 2:] = q[:, :K // 2]
    elif kind == "wide":           # magnitudes over 2^-20 .. 2^20
        Z *= np.exp2(rng.integers(-20, 21, (m, K))).astype(np.float32)
        q *= np.exp2(rng.integers(-20, 21, (nq, K))).astype(np.float32)
    Zt, qt = torch.as_tensor(Z), torch.as_tensor(q)
    if kind == "unit":
        Zt, qt = QF.normalize_rows(Zt), QF.normalize_rows(qt)
    s = QF.row_scores(qt, Zt).double()
    a = _fma_dot(qt, Zt).double()
    margin = (4 * K + 16) * 2.0**-24 * (
        qt.double().norm(dim=1)[:, None] * Zt.double().norm(dim=1)[None, :])
    assert bool(((a - s).abs() <= margin / 2).all())
