"""A Python model of `topk_fused`'s general path (K > 256 or k > 64;
`csrc/query_fused.cu`: `topk_select_general_kernel`,
`topk_merge_general_kernel`, `merge_batch_any`), held bit-equal to
`topk_fused_plain`.

The model follows the kernel step for step: every warp is a selector of
one query over a contiguous row range, a lane per row, 32 rows a batch;
each batch goes into the selector's sorted list of k by rank, the list
entries moving down in 32-wide chunks taken from the end of the list
(each chunk read whole before any of it is written); the merge pass is
one warp per query over its selectors' lists in (selector, slot) order.
Unfilled slots are (-inf, INT_MAX) until the merge writes -1."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import query_fused as QF

INT_MAX = 2**31 - 1
GEN_WARPS = 8


def _better(sa, ia, sb, ib):
    return sa > sb or (sa == sb and ia < ib)


def merge_batch_any(ls, li, k, batch):
    """One warp's step: `batch` is 32 (score, id, valid) lane tuples."""
    s = [b[0] for b in batch]
    i = [b[1] for b in batch]
    v = [b[2] and _better(b[0], b[1], ls[k - 1], li[k - 1]) for b in batch]
    if not any(v):
        return
    rank = [0] * 32
    for lane in range(32):
        for t in range(k):
            rank[lane] += _better(ls[t], li[t], s[lane], i[lane])
            v[lane] = v[lane] and li[t] != i[lane]
    cand = [lane for lane in range(32) if v[lane]]
    for b in range(((k - 1) // 32) * 32, -1, -32):
        chunk = [(t, ls[t], li[t]) for t in range(b, min(b + 32, k))]
        moves = []
        for t, e, f in chunk:           # every lane reads before writing
            p = t + sum(_better(s[c], i[c], e, f) for c in cand)
            moves.append((p, e, f))
        for p, e, f in moves:
            if p < k:
                ls[p], li[p] = e, f
    for lane in cand:
        r = rank[lane] + sum(_better(s[c], i[c], s[lane], i[lane])
                             for c in cand)
        if r < k:
            ls[r], li[r] = s[lane], i[lane]


def model(Zn, q, qnodes, *, k, row_offset, exclude_self, nsel):
    m = Zn.shape[0]
    scores = QF.row_scores(q, Zn).numpy()      # the kernel's exact dots
    nq = q.shape[0]
    vals = np.empty((nq, k), np.float32)
    idxs = np.empty((nq, k), np.int32)
    for j in range(nq):
        self_ = int(qnodes[j]) if exclude_self else -1
        lists = []
        for x in range(nsel):
            ls, li = [-np.inf] * k, [INT_MAX] * k
            lo, hi = x * m // nsel, (x + 1) * m // nsel
            for b in range(lo, hi, 32):
                batch = []
                for lane in range(32):
                    r = b + lane
                    ok = r < hi
                    sid = row_offset + r if ok else 0
                    batch.append((np.float32(scores[j, r]) if ok else 0.0,
                                  sid, ok and sid != self_))
                merge_batch_any(ls, li, k, batch)
            lists.append((ls, li))
        cs = [x for ls, _ in lists for x in ls]
        ci = [x for _, li in lists for x in li]
        ls, li = [-np.inf] * k, [INT_MAX] * k
        for b in range(0, len(cs), 32):
            merge_batch_any(ls, li, k, [
                (cs[e], ci[e], True) if e < len(cs) else (0.0, 0, False)
                for e in range(b, b + 32)])
        vals[j] = ls
        idxs[j] = [-1 if (t == INT_MAX or not np.isfinite(s)) else t
                   for s, t in zip(ls, li)]
    return vals, idxs


@pytest.mark.parametrize("K,m,nq,k,run,nsel", [
    (300, 700, 3, 10, 3, 8), (16, 900, 4, 65, 7, 16), (8, 500, 2, 100, 4, 8),
    (12, 300, 3, 256, 2, 8), (300, 40, 2, 70, 1, 8), (5, 2000, 2, 33, 50, 24)])
@pytest.mark.parametrize("exclude_self", [True, False])
def test_general_path_model_equals_plain(rng, K, m, nq, k, run, nsel,
                                         exclude_self):
    """Rows in runs of equal rows (exact ties across batches, selectors
    and list chunks), k beyond the candidates included."""
    base = rng.normal(size=(-(-m // run), K)).astype(np.float32)
    Zn = QF.normalize_rows(torch.as_tensor(np.repeat(base, run, 0)[:m]))
    qn = rng.integers(0, m, nq).astype(np.int32)
    q = Zn[torch.as_tensor(qn).long()]
    vals, idxs = model(Zn, q, qn + 50, k=k, row_offset=50,
                       exclude_self=exclude_self, nsel=nsel)
    pv, pi = QF.topk_fused_plain(Zn, q, torch.as_tensor(qn + 50), k=k,
                                 row_offset=50, exclude_self=exclude_self)
    assert np.array_equal(vals, pv.numpy())
    assert np.array_equal(idxs, pi.numpy())
