"""A CPU model of the bfloat16 flash forward's persistent schedule
(``csrc/flash_attention.cu``: `bf16body::Fwd`, `flash_fwd_bf16_kernel`,
`bf16body::launch`).

The model follows the kernel:

* a work item is (batch x head, query tile of BQ = 64 x CONSUMERS rows);
  the list holds the last query tiles (the most keys) first and, inside a
  tile, the heads in order, so a GQA group's query heads sit next to each
  other; blocks take items in list order from one counter (the ticket
  past the last item ends a block, and the launch's last ticket puts the
  counter back to zero);
* the grid is one block per SM, fewer if there are fewer items;
* consumer w of an item owns rows row0 = q0 + 64 w .. + 63 and walks the
  key tiles of BK keys from 0 to the last one any of its rows below S
  sees, only that tile masked; P V of the last tile goes out in the next
  item's first turn, the tiles past it are released unread, and every
  consumer takes the item's n_kv turns;
* each row's online softmax runs in float32 over those tiles in order, P
  rounded to bfloat16 before P V.

The kernel's constants are read from its source, so the two cannot drift
apart."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA

_SRC = (Path(FA.__file__).parent / "csrc" / "flash_attention.cu").read_text()
_FWD = _SRC[_SRC.index("struct Fwd {"):_SRC.index("static_assert(SMEM")]


def _fwd_const(name):
    return re.search(rf"static constexpr int {name} = ([^;]+);", _FWD)[1]


BK = int(re.search(r"constexpr int BK = (\d+);",
                    _SRC[_SRC.index("namespace bf16body {"):])[1])
QSLOTS = int(_fwd_const("QSLOTS"))
SMS = 132                                   # an H100 SXM


def _rule(name, D):
    """Evaluate `cond ? a : b` chains of D from the source's Fwd<D>."""
    text = _fwd_const(name)
    m = re.fullmatch(r"D (==|<=) (\d+) \? (\d+) : (\d+)", text)
    if m is None:
        return int(text)
    op, x, a, b = m[1], int(m[2]), int(m[3]), int(m[4])
    return a if (D == x if op == "==" else D <= x) else b


def consumers(D):
    return _rule("CONSUMERS", D)


def stages(D):
    return _rule("STAGES", D)


def bq(D):
    return 64 * consumers(D)


def work_list(B, H, S, D):
    """The items (bh, qt) in list order, as the kernel decodes ticket i."""
    BH, n_qt = B * H, -(-S // bq(D))
    return [(i % BH, n_qt - 1 - i // BH) for i in range(BH * n_qt)]


def grid(n_items, sms=SMS):
    return min(n_items, sms)


def walk(q0, w, S):
    """Consumer w's walk of the item at query row q0: the key tiles it
    takes, in order, and its last tile's first key's offset from its
    first row (0 or 64)."""
    row0 = q0 + 64 * w
    if row0 >= S:
        return [], 0
    last = min(S - 1, row0 + 63) // BK
    return list(range(last + 1)), row0 - last * BK


MODEL_SHAPES = {
    "yi": (4, 32, 4, 2048, 128), "zamba2": (4, 32, 32, 2048, 64),
    "danube": (4, 32, 8, 2048, 120), "whisper": (4, 16, 16, 2048, 64),
    "ragged": (2, 8, 2, 1000, 64), "ragged_128": (1, 8, 1, 2049, 128),
    "fewer_items_than_sms": (1, 2, 2, 256, 64)}


def test_constants_match_the_wrapper():
    """The source's tiling is the one the wrapper's table holds, and the
    grid rule and the counter's reset are where the model expects them."""
    for D in (16, 32, 64, 120, 128):
        assert FA.TILES[torch.bfloat16][FA._pad(D)] == (bq(FA._pad(D)), BK)
    assert consumers(64) == 3 and consumers(128) == 2
    assert "const int grid = n_items < sms ? n_items : sms;" in _SRC
    assert "if (item == n_items + (int)gridDim.x - 1) atomicExch(work, 0);" \
        in _SRC
    assert ("  const int bh = item % (B * H);\n"
            "  qt = n_qt - 1 - item / (B * H);\n"
            "  b = bh / H;\n"
            "  h = bh % H;\n") in _SRC
    assert _SRC.count("work_item(item, B, H, n_qt, b, h, qt);") == 2


@pytest.mark.parametrize("shape", list(MODEL_SHAPES))
def test_work_list(shape):
    """Every (batch x head, query tile) item once, heaviest first, a GQA
    group's query heads next to each other; the grid."""
    B, H, KV, S, D = MODEL_SHAPES[shape]
    Dp = FA._pad(D)
    items = work_list(B, H, S, Dp)
    n_qt = -(-S // bq(Dp))
    assert sorted(items) == [(bh, qt) for bh in range(B * H)
                             for qt in range(n_qt)]
    keys = [min(S, (qt + 1) * bq(Dp)) for _, qt in items]
    assert keys == sorted(keys, reverse=True)
    G = H // KV
    pos = {it: i for i, it in enumerate(items)}
    for qt in range(n_qt):
        for b in range(B):
            for kvh in range(KV):
                at = [pos[(b * H + kvh * G + g, qt)] for g in range(G)]
                assert at == list(range(at[0], at[0] + G))
    assert grid(len(items)) == min(len(items), SMS)
    if shape == "fewer_items_than_sms":
        assert grid(len(items)) == len(items) < SMS


@pytest.mark.parametrize("seed", [0, 1])
def test_tickets_hand_out_each_item_once(seed):
    """Blocks of uneven speed take tickets in list order; each item is
    taken once, every block ends on one ticket past the list, and the
    last ticket is the one that puts the counter back to zero."""
    rng = np.random.default_rng(seed)
    B, H, KV, S, D = MODEL_SHAPES["zamba2"]
    n_items = len(work_list(B, H, S, D))
    g = grid(n_items)
    counter, taken, ended, reset = 0, [], set(), None
    clock = rng.random(g)
    while len(ended) < g:
        blk = int(np.argmin(clock))
        ticket, counter = counter, counter + 1
        if ticket >= n_items:
            ended.add(blk)
            clock[blk] = np.inf
            if ticket == n_items + g - 1:
                reset = ticket
                counter = 0
            continue
        taken.append(ticket)
        clock[blk] += 0.5 + rng.random()
    assert sorted(taken) == list(range(n_items))
    assert reset == n_items + g - 1 and counter == 0


@pytest.mark.parametrize("S,D", [(2048, 64), (2048, 128), (1000, 64),
                                 (2049, 128), (193, 64), (64, 16),
                                 (130, 120), (1, 64), (385, 32)])
def test_causal_pairs_covered_once(S, D):
    """Over every item of one head, the consumers' walks take each causal
    (query, key <= query) pair below S exactly once, and every pair they
    take unmasked is causal: only the last tile of a walk is masked, and
    it starts at the consumer's first row or 64 rows before it."""
    Dp = FA._pad(D)
    count = np.zeros((S, S), np.int32)
    for _, qt in work_list(1, 1, S, Dp):
        q0 = qt * bq(Dp)
        n_kv = -(-min(S, q0 + bq(Dp)) // BK)
        for w in range(consumers(Dp)):
            tiles_, dq = walk(q0, w, S)
            assert len(tiles_) <= n_kv and dq in (0, 64)
            rows = np.arange(q0 + 64 * w, min(S, q0 + 64 * w + 64))
            for i, t in enumerate(tiles_):
                keys = np.arange(t * BK, min(S, t * BK + BK))
                sub = keys[None, :] <= rows[:, None]
                if i < len(tiles_) - 1:
                    assert sub.all()            # unmasked: all causal
                count[np.ix_(rows, keys)] += sub
    assert np.array_equal(count, np.tril(np.ones((S, S), np.int32)))


def _walk_item(q, k, v, q0, S, Dp):
    """The kernel's arithmetic for one item of one head, in float32: per
    consumer, the online softmax in the log2 domain over its tiles in
    order (the last one masked), P rounded to bfloat16 before P V,
    out = acc / max(l, 1e-30)."""
    D = q.shape[-1]
    scale_log2 = np.float32(D ** -0.5 * 1.4426950408889634)
    out = {}
    for w in range(consumers(Dp)):
        tiles_, _ = walk(q0, w, S)
        if not tiles_:
            continue
        rows = np.arange(q0 + 64 * w, min(S, q0 + 64 * w + 64))
        qr = q[rows]
        m = np.full(len(rows), -1e30, np.float32)
        l = np.zeros(len(rows), np.float32)
        acc = np.zeros((len(rows), D), np.float32)
        for i, t in enumerate(tiles_):
            keys = np.arange(t * BK, min(S, t * BK + BK))
            s = qr @ k[keys].T
            if i == len(tiles_) - 1:
                s = np.where(keys[None, :] > rows[:, None], np.float32(-1e30),
                             s)
            m_new = np.maximum(m, s.max(1) * scale_log2)
            alpha = np.exp2(m - m_new)
            p = np.exp2(s * scale_log2 - m_new[:, None]).astype(np.float32)
            l = l * alpha + p.sum(1)
            pb = torch.as_tensor(p).bfloat16().float().numpy()
            acc = acc * alpha[:, None] + pb @ v[keys]
            m = m_new
        out.update(zip(rows.tolist(), acc / np.maximum(l, 1e-30)[:, None]))
    return out


@pytest.mark.parametrize("B,H,KV,S,D", [(1, 2, 2, 256, 64),
                                        (1, 4, 1, 130, 128),
                                        (1, 2, 1, 200, 120),
                                        (1, 2, 2, 385, 64)])
def test_item_walk_within_tolerance_of_plain(rng, B, H, KV, S, D):
    """Every item's walk, put together, is the attention: within the
    bfloat16 body's 2e-2 (atol and rtol) of `flash_attention_plain`."""
    q, k, v = (torch.as_tensor(rng.normal(size=(B, h, S, D)).astype(
        np.float32)).bfloat16() for h in (H, KV, KV))
    want = FA.flash_attention_plain(q, k, v).float().numpy()
    Dp = FA._pad(D)
    got = np.zeros((B, H, S, D), np.float32)
    G = H // KV
    for bh, qt in work_list(B, H, S, Dp):
        b, h = divmod(bh, H)
        rows = _walk_item(q[b, h].float().numpy(),
                          k[b, h // G].float().numpy(),
                          v[b, h // G].float().numpy(), qt * bq(Dp), S, Dp)
        for r, o in rows.items():
            got[b, h, r] = o
    got = torch.as_tensor(got).bfloat16().float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


class _Mbar:
    """An mbarrier: a phase completes when `count` arrivals are in (a TMA
    load's bytes count as landing at once); a wait on parity P passes
    once the phase of that parity has completed."""

    def __init__(self, count):
        self.count, self.pending, self.phases = count, 0, 0

    def arrive(self, n=1):
        self.pending += n
        assert self.pending <= self.count, "more arrivals than the phase"
        if self.pending == self.count:
            self.phases, self.pending = self.phases + 1, 0

    def done(self, parity):
        return (self.phases & 1) != parity


class _Named:
    """A named barrier of two warpgroups (bar.sync / bar.arrive, 256)."""

    def __init__(self):
        self.gen, self.units = 0, 0

    def arrive(self):
        self.units += 1
        if self.units == 2:
            self.gen, self.units = self.gen + 1, 0


def _simulate(B, H, S, D, blocks, rng):
    """One block's barrier protocol per block (`flash_fwd_bf16_kernel`:
    Q slots, the K / V ring, the turns), blocks sharing the ticket
    counter, run by a random scheduler until every agent ends; a state
    where no agent can move is a hang.  Returns the items each block
    took and the counter at the end."""
    nc, st, qsl = consumers(D), stages(D), QSLOTS
    BQ = bq(D)
    n_qt, BH = -(-S // BQ), B * H
    n_items = BH * n_qt
    counter = [0]
    taken = []

    def block(bi):
        full_q = [_Mbar(1) for _ in range(qsl)]
        empty_q = [_Mbar(nc) for _ in range(qsl)]
        full_k, full_v = ([_Mbar(1) for _ in range(st)] for _ in range(2))
        empty_k, empty_v = ([_Mbar(nc) for _ in range(st)]
                            for _ in range(2))
        turns = [_Named() for _ in range(nc)]
        items = [None] * qsl

        def wait(bar, parity):
            while not bar.done(parity):
                yield

        def producer():
            j = 0
            for n in range(10 ** 9):
                item = counter[0]
                counter[0] += 1
                qs = n % qsl
                yield from wait(empty_q[qs], ((n // qsl) & 1) ^ 1)
                if item >= n_items:
                    if item == n_items + blocks - 1:
                        counter[0] = 0
                    items[qs] = -1
                    full_q[qs].arrive()
                    return
                taken.append((bi, item))
                qt = n_qt - 1 - item // BH
                n_kv = -(-min(S, qt * BQ + BQ) // BK)
                items[qs] = item
                full_q[qs].arrive()
                for _ in range(n_kv):
                    s, par = j % st, ((j // st) & 1) ^ 1
                    yield from wait(empty_k[s], par)
                    full_k[s].arrive()
                    yield from wait(empty_v[s], par)
                    full_v[s].arrive()
                    j += 1

        def consumer(w):
            def turn():
                bar = turns[w]
                gen = bar.gen
                bar.arrive()
                while bar.gen == gen:
                    yield
                turns[(w + 1) % nc].arrive()

            if w == nc - 1:
                turns[0].arrive()
            j = 0

            def slot(t):
                return (j + t) % st

            def phase(t):
                return ((j + t) // st) & 1

            pv_slot, pv_phase, pv_real = 0, 0, False
            for n in range(10 ** 9):
                qs = n % qsl
                yield from wait(full_q[qs], (n // qsl) & 1)
                item = items[qs]
                if item < 0:
                    break
                qt = n_qt - 1 - item // BH
                q0 = qt * BQ
                n_kv = -(-min(S, q0 + BQ) // BK)
                row0 = q0 + 64 * w
                walks = row0 < S
                last = min(S - 1, row0 + 63) // BK if walks else 0
                # turn 0: the pending P V and S of tile 0
                yield from wait(full_k[slot(0)], phase(0))
                if pv_real:
                    yield from wait(full_v[pv_slot], pv_phase)
                yield from turn()
                if pv_real:
                    empty_v[pv_slot].arrive()
                empty_k[slot(0)].arrive()
                if last == 0:
                    empty_q[qs].arrive()
                if not walks:
                    yield from wait(full_v[slot(0)], phase(0))
                    empty_v[slot(0)].arrive()
                for t in range(1, last + 1):
                    yield from wait(full_k[slot(t)], phase(t))
                    yield from wait(full_v[slot(t - 1)], phase(t - 1))
                    yield from turn()
                    empty_k[slot(t)].arrive()
                    if t == last:
                        empty_q[qs].arrive()
                    empty_v[slot(t - 1)].arrive()
                for t in range(last + 1, n_kv):
                    yield from wait(full_k[slot(t)], phase(t))
                    empty_k[slot(t)].arrive()
                    yield from turn()
                    yield from wait(full_v[slot(t)], phase(t))
                    empty_v[slot(t)].arrive()
                pv_real, pv_slot, pv_phase = walks, slot(last), phase(last)
                j += n_kv
            if pv_real:
                yield from wait(full_v[pv_slot], pv_phase)
            yield from turn()
            if pv_real:
                empty_v[pv_slot].arrive()
            if w == 0:                  # the last turn's hand-over
                bar = turns[0]
                gen = bar.gen
                bar.arrive()
                while bar.gen == gen:
                    yield

        return [producer()] + [consumer(w) for w in range(nc)]

    agents = [a for bi in range(blocks) for a in block(bi)]
    stuck = 0
    while agents:
        i = int(rng.integers(len(agents)))
        try:
            next(agents[i])
            stuck += 1
        except StopIteration:
            agents.pop(i)
            stuck = 0
            continue
        # a full sweep of every agent without one ending: test for a hang
        if stuck > 50 * len(agents) + 10 ** 5:
            raise AssertionError("the barrier protocol hangs")
    return taken, counter[0]


@pytest.mark.parametrize("B,H,S,D,blocks", [
    (1, 2, 64, 16, 1), (1, 2, 257, 128, 2), (1, 2, 257, 120, 1),
    (1, 2, 1000, 64, 3), (2, 2, 193, 64, 2), (1, 1, 385, 64, 1),
    (1, 4, 600, 128, 3), (1, 2, 256, 64, 8)])
def test_barrier_protocol_completes(rng, B, H, S, D, blocks):
    """The kernel's waits and arrivals, as `_simulate` mirrors them, end
    under random interleavings: no block hangs, every item is taken once
    and the counter is back at zero (more blocks than items included)."""
    Dp = FA._pad(D)
    for _ in range(3):
        taken, counter = _simulate(B, H, S, Dp, blocks, rng)
        assert sorted(i for _, i in taken) == list(
            range(len(work_list(B, H, S, Dp))))
        assert counter == 0
