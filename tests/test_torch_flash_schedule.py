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

The wide body for 128 < D <= 256 (`bf16body::Fwd<256>`,
`flash_fwd_bf16_kernel_d256`) shares the work list, the tickets and the
grid, and has its own walk and protocol: items of 128 rows against key
tiles of BK (80, where two tiles of a walk can be masked; the `wide_bk64`
variant's 64), one Q slot that the producer refills once the item has
released it (its first K and V tiles already in flight), P V of the last
tile outside the turns, and O staged in the slot (released once the
store has read it) or, in the `wide_o_regs` variant, written from
registers (the slot released after the consumers' last S).

The kernel's constants are read from its source, so the two cannot drift
apart."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import fwd_ablate as FWA

_SRC = (Path(FA.__file__).parent / "csrc" / "flash_attention.cu").read_text()
_FWD = _SRC[_SRC.index("struct Fwd {"):_SRC.index("static_assert(SMEM")]


def _fwd_const(name):
    return re.search(rf"static constexpr int {name} = ([^;]+);", _FWD)[1]


BK = int(re.search(r"constexpr int BK = (\d+);",
                    _SRC[_SRC.index("namespace bf16body {"):])[1])
QSLOTS = int(_fwd_const("QSLOTS"))
SMS = 132                                   # an H100 SXM


def _wide_const(name, src=_SRC):
    """An int constant of the wide body's Fwd<256> in `src`."""
    return int(re.search(rf"static constexpr int {name} = (\d+);",
                         src[src.index("struct Fwd<256> {"):])[1])


def _wide_protocol(src):
    """What the simulation needs of a source's D = 256 kernel: its key
    tile, whether O is staged in the Q slot (a TMA store of the slot's
    rows) and whether the consumers take turns."""
    body = src[src.index("flash_fwd_bf16_kernel_d256(const"):
               src.index("int launch_wide(")]
    return dict(bk=_wide_const("BK", src),
                staged="tma_store(&to, qa" in body,
                turns="bar_sync(1 + w);" in body)


WIDE = {n: _wide_const(n) for n in ("BK", "CONSUMERS", "STAGES")}


def _rule(name, D):
    """Evaluate `cond ? a : b` chains of D from the source's Fwd<D>."""
    text = _fwd_const(name)
    m = re.fullmatch(r"D (==|<=) (\d+) \? (\d+) : (\d+)", text)
    if m is None:
        return int(text)
    op, x, a, b = m[1], int(m[2]), int(m[3]), int(m[4])
    return a if (D == x if op == "==" else D <= x) else b


def consumers(D):
    return WIDE["CONSUMERS"] if D == 256 else _rule("CONSUMERS", D)


def stages(D):
    return WIDE["STAGES"] if D == 256 else _rule("STAGES", D)


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
    body = _SRC[_SRC.index("flash_fwd_bf16_kernel(const"):
                _SRC.index("// cuTensorMapEncodeTiled")]
    assert body.count("work_item(item, B, H, n_qt, b, h, qt);") == 2


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



# -- the wide body (128 < D <= 256): Fwd<256>, flash_fwd_bf16_kernel_d256 --

def wide_walk(q0, w, S, bk):
    """Consumer w's walk of a wide item at query row q0 with key tiles of
    bk: [(tile, masked, off)] in order, `off` the consumer's first row
    less the tile's first key; a tile is masked when a key of it lies past
    the first row."""
    row0 = q0 + 64 * w
    if row0 >= S:
        return []
    last = min(S - 1, row0 + 63) // bk
    return [(t, t * bk + bk - 1 > row0, row0 - t * bk)
            for t in range(last + 1)]


def test_wide_constants_match_the_wrapper():
    """The wide body's tiling in the source is the wrapper's, its
    registers and shared memory fit, and it shares the other bodies'
    schedule, work list and counter reset."""
    assert FA.TILES[torch.bfloat16][256] == (bq(256), WIDE["BK"])
    assert FA.HEAD_DIMS[torch.bfloat16][-1] == 256
    assert WIDE["CONSUMERS"] == 2 and WIDE["STAGES"] == 2
    assert WIDE["BK"] in (64, 80)
    assert "err = schedule<256>(B, H, S, &n_items, &grid);" in _SRC
    body = _SRC[_SRC.index("flash_fwd_bf16_kernel_d256(const"):
                _SRC.index("int launch_wide(")]
    # the producer's and the consumers', in the walks' loops and in the
    # one-walk loops
    assert body.count("work_item(item, B, H, n_qt, b, h, qt);") == 4
    assert "if (item == n_items + (int)gridDim.x - 1) atomicExch(work, 0);" \
        in body
    # 64 KB of Q, two 80-key (64-key) K and V tiles of 256 bf16 columns
    for bk in (64, 80):
        smem = 128 * 256 * 2 + 2 * 2 * bk * 256 * 2 + 16 + 8 * 10 + 1024
        assert smem <= 232_448
    # setmaxnreg moves registers only inside the block's launch
    # allocation, 168 a thread at 384 threads: consumers that ask for more
    # than the producer gives back wait for ever
    regs = (int(_wide_const("PRODUCER_REGS")) * 128
            + int(_wide_const("CONSUMER_REGS")) * 256)
    assert regs <= 65_536 // 384 // 8 * 8 * 384 == 168 * 384


WIDE_SHAPES = {"wide": (4, 8, 2, 2048, 256), "gemma7b": (4, 16, 16, 2048, 256),
               "ragged_160": (2, 4, 1, 1000, 160), "short": (1, 2, 2, 1, 192),
               "fewer_items_than_sms": (1, 8, 2, 300, 256)}


@pytest.mark.parametrize("shape", list(WIDE_SHAPES))
def test_wide_work_list(shape):
    """The wide body's items: every (batch x head, 128-row query tile)
    once, heaviest first, a GQA group's heads next to each other; the
    grid one block an SM at most."""
    B, H, KV, S, D = WIDE_SHAPES[shape]
    assert FA._forward_route(torch.bfloat16, D) == ("in place", 256)
    items = work_list(B, H, S, 256)
    n_qt = -(-S // 128)
    assert sorted(items) == [(bh, qt) for bh in range(B * H)
                             for qt in range(n_qt)]
    keys = [min(S, (qt + 1) * 128) for _, qt in items]
    assert keys == sorted(keys, reverse=True)
    G = H // KV
    pos = {it: i for i, it in enumerate(items)}
    for qt in range(n_qt):
        for b in range(B):
            for kvh in range(KV):
                at = [pos[(b * H + kvh * G + g, qt)] for g in range(G)]
                assert at == list(range(at[0], at[0] + G))
    assert grid(len(items)) == min(len(items), SMS)


@pytest.mark.parametrize("bk", [64, 80])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 128, 200, 257, 640, 1000])
def test_wide_causal_pairs_covered_once(S, bk):
    """Over every item of one head, the wide consumers' walks take each
    causal pair below S exactly once; tiles not marked masked hold only
    causal pairs; at 64-key tiles only a walk's last tile is masked, and
    it starts at the consumer's first row."""
    count = np.zeros((S, S), np.int32)
    for _, qt in work_list(1, 1, S, 256):
        q0 = qt * 128
        n_kv = -(-min(S, q0 + 128) // bk)
        for w in range(2):
            tiles_ = wide_walk(q0, w, S, bk)
            assert len(tiles_) <= n_kv
            rows = np.arange(q0 + 64 * w, min(S, q0 + 64 * w + 64))
            for i, (t, masked, off) in enumerate(tiles_):
                keys = np.arange(t * bk, min(S, t * bk + bk))
                sub = keys[None, :] <= rows[:, None]
                if not masked:
                    assert sub.all()
                if bk == 64:
                    assert masked == (i == len(tiles_) - 1)
                    assert not masked or off == 0
                count[np.ix_(rows, keys)] += sub
    assert np.array_equal(count, np.tril(np.ones((S, S), np.int32)))


def _wide_walk_item(q, k, v, q0, S, bk):
    """The wide body's arithmetic for one item of one head in float32:
    per consumer the online softmax over its tiles (log2 domain, the
    masked tiles' keys past a row at -1e30), P rounded to bfloat16 before
    P V, out = acc / max(l, 1e-30)."""
    D = q.shape[-1]
    scale_log2 = np.float32(D ** -0.5 * 1.4426950408889634)
    out = {}
    for w in range(2):
        tiles_ = wide_walk(q0, w, S, bk)
        if not tiles_:
            continue
        rows = np.arange(q0 + 64 * w, min(S, q0 + 64 * w + 64))
        m = np.full(len(rows), -1e30, np.float32)
        l = np.zeros(len(rows), np.float32)
        acc = np.zeros((len(rows), D), np.float32)
        for t, masked, _ in tiles_:
            keys = np.arange(t * bk, min(S, t * bk + bk))
            s = q[rows] @ k[keys].T
            if masked:
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


@pytest.mark.parametrize("bk", [64, 80])
@pytest.mark.parametrize("B,H,KV,S,D", [(1, 2, 1, 200, 256),
                                        (1, 4, 2, 130, 160),
                                        (1, 2, 2, 257, 192)])
def test_wide_item_walk_within_tolerance_of_plain(rng, B, H, KV, S, D, bk):
    """The wide body's walks, put together (the zero columns past D add
    nothing), are the attention within the bfloat16 2e-2 of
    `flash_attention_plain`."""
    q, k, v = (torch.as_tensor(rng.normal(size=(B, h, S, D)).astype(
        np.float32)).bfloat16() for h in (H, KV, KV))
    want = FA.flash_attention_plain(q, k, v).float().numpy()
    got = np.zeros((B, H, S, D), np.float32)
    G = H // KV
    for bh, qt in work_list(B, H, S, 256):
        b, h = divmod(bh, H)
        for r, o in _wide_walk_item(q[b, h].float().numpy(),
                                    k[b, h // G].float().numpy(),
                                    v[b, h // G].float().numpy(), qt * 128,
                                    S, bk).items():
            got[b, h, r] = o
    got = torch.as_tensor(got).bfloat16().float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


class _PMbar(_Mbar):
    """An mbarrier that also counts its arrivals in `progress` (shared by a
    simulation's barriers), so that a hang is a run of steps with none."""

    def __init__(self, count, progress):
        super().__init__(count)
        self.progress = progress

    def arrive(self, n=1):
        self.progress[0] += 1
        super().arrive(n)


def _simulate_wide(B, H, S, blocks, rng, *, bk, staged, turns,
                   epilogue_after_next_q=False):
    """`flash_fwd_bf16_kernel_d256`'s waits and arrivals per block, blocks
    sharing the ticket counter, under a random scheduler; a long run of
    steps with no arrival and no agent ending is a hang.  The producer
    starts an item's first min(n_kv, STAGES) K and V tiles, then waits for
    the Q slot; a consumer releases the slot after its last S (O from
    registers) or in its epilogue once the store has read it (`staged`).
    `epilogue_after_next_q` moves the epilogue behind the next item's Q
    wait, as the D <= 128 bodies run it: with O staged in the one Q slot
    that wait is never met."""
    nc, st, BQ = WIDE["CONSUMERS"], WIDE["STAGES"], 128
    n_qt, BH = -(-S // BQ), B * H
    n_items = BH * n_qt
    counter = [0]
    taken = []
    progress = [0]

    def block(bi):
        full_q, empty_q = _PMbar(1, progress), _PMbar(nc, progress)
        full_k, full_v, empty_k, empty_v = (
            [_PMbar(c, progress) for _ in range(st)] for c in (1, 1, nc, nc))
        turn_bars = [_Named() for _ in range(nc)]
        items = [None]

        def wait(bar, parity):
            while not bar.done(parity):
                yield

        def producer():
            j = 0
            for n in range(10 ** 9):
                item = counter[0]
                counter[0] += 1
                if item >= n_items:
                    if item == n_items + blocks - 1:
                        counter[0] = 0
                    yield from wait(empty_q, (n & 1) ^ 1)
                    items[0] = -1
                    full_q.arrive()
                    return
                taken.append((bi, item))
                qt = n_qt - 1 - item // BH
                n_kv = -(-min(S, qt * BQ + BQ) // bk)
                pre = min(n_kv, st)
                for t in range(n_kv):
                    if t == pre:
                        yield from wait(empty_q, (n & 1) ^ 1)
                        items[0] = item
                        full_q.arrive()
                    s_, par = j % st, ((j // st) & 1) ^ 1
                    yield from wait(empty_k[s_], par)
                    full_k[s_].arrive()
                    yield from wait(empty_v[s_], par)
                    full_v[s_].arrive()
                    j += 1
                if pre == n_kv:
                    yield from wait(empty_q, (n & 1) ^ 1)
                    items[0] = item
                    full_q.arrive()

        def consumer(w):
            def turn():
                if not turns:
                    return
                bar = turn_bars[w]
                gen = bar.gen
                bar.arrive()
                progress[0] += 1
                while bar.gen == gen:
                    yield
                turn_bars[(w + 1) % nc].arrive()

            if turns and w == nc - 1:
                turn_bars[0].arrive()
            j = 0

            def slot(t):
                return (j + t) % st

            def phase(t):
                return ((j + t) // st) & 1

            pending = None                  # a deferred epilogue's release
            for n in range(10 ** 9):
                yield from wait(full_q, n & 1)
                if pending is not None:     # the fault, when asked for
                    pending.arrive()
                    pending = None
                item = items[0]
                if item < 0:
                    break
                qt = n_qt - 1 - item // BH
                q0 = qt * BQ
                n_kv = -(-min(S, q0 + BQ) // bk)
                row0 = q0 + 64 * w
                walks = row0 < S
                last = min(S - 1, row0 + 63) // bk if walks else 0
                yield from wait(full_k[slot(0)], phase(0))
                yield from turn()
                empty_k[slot(0)].arrive()
                if not staged and last == 0:
                    empty_q.arrive()
                if not walks:
                    yield from wait(full_v[slot(0)], phase(0))
                    empty_v[slot(0)].arrive()
                for t in range(1, last + 1):
                    yield from wait(full_k[slot(t)], phase(t))
                    yield from wait(full_v[slot(t - 1)], phase(t - 1))
                    yield from turn()
                    empty_k[slot(t)].arrive()
                    if not staged and t == last:
                        empty_q.arrive()
                    empty_v[slot(t - 1)].arrive()
                if walks:                   # P V of the last tile
                    yield from wait(full_v[slot(last)], phase(last))
                    empty_v[slot(last)].arrive()
                for t in range(last + 1, n_kv):
                    yield from wait(full_k[slot(t)], phase(t))
                    empty_k[slot(t)].arrive()
                    yield from turn()
                    yield from wait(full_v[slot(t)], phase(t))
                    empty_v[slot(t)].arrive()
                if staged:                  # the epilogue's store has read
                    if epilogue_after_next_q:
                        pending = empty_q
                    else:
                        empty_q.arrive()
                j += n_kv
            if turns and w == 0:            # the other's last hand-over
                bar = turn_bars[0]
                gen = bar.gen
                bar.arrive()
                while bar.gen == gen:
                    yield

        return [producer()] + [consumer(w) for w in range(nc)]

    agents = [a for bi in range(blocks) for a in block(bi)]
    idle, seen = 0, progress[0]
    while agents:
        i = int(rng.integers(len(agents)))
        try:
            next(agents[i])
        except StopIteration:
            agents.pop(i)
            idle = 0
            continue
        if progress[0] != seen:
            seen, idle = progress[0], 0
        else:
            idle += 1
        if idle > 200 * len(agents) + 2000:
            raise AssertionError("the barrier protocol hangs")
    return taken, counter[0]


# the kernel and `launch.fwd_ablate`'s variants of it, read from their
# sources
_WIDE_VARIANTS = ["base", "wide_bk64", "wide_o_regs", "wide_no_turns"]
_WIDE_PROTOCOLS = [_wide_protocol(FWA.variant_source(n))
                   for n in _WIDE_VARIANTS]
KERNEL = _WIDE_PROTOCOLS[0]


def test_wide_variants_differ_from_the_kernel_in_one_thing():
    """The kernel stages O and takes turns at 80-key tiles; each variant
    the simulation runs changes one of these, as `fwd_ablate` builds it."""
    assert KERNEL == dict(bk=80, staged=True, turns=True)
    for proto, key in zip(_WIDE_PROTOCOLS[1:], ("bk", "staged", "turns")):
        assert {k for k in proto if proto[k] != KERNEL[k]} == {key}


@pytest.mark.parametrize("proto", range(len(_WIDE_PROTOCOLS)),
                         ids=["kernel", "key_tile", "o_path", "turns"])
@pytest.mark.parametrize("B,H,S,blocks", [
    (1, 2, 64, 1), (1, 2, 257, 2), (1, 2, 600, 3), (2, 2, 193, 2),
    (1, 1, 385, 1), (1, 2, 256, 8)])
def test_wide_barrier_protocol_completes(rng, B, H, S, blocks, proto):
    """The wide body's waits and arrivals end under random interleavings,
    as the kernel is and in each `fwd_ablate` variant (the other key tile,
    the other O path, turns off): no block hangs, every item is taken once and
    the counter is back at zero."""
    kw = _WIDE_PROTOCOLS[proto]
    for _ in range(3):
        taken, counter = _simulate_wide(B, H, S, blocks, rng, **kw)
        assert sorted(i for _, i in taken) == list(
            range(len(work_list(B, H, S, 256))))
        assert counter == 0


@pytest.mark.parametrize("B,H,S,blocks", [(1, 2, 257, 1), (1, 2, 600, 2)])
def test_wide_protocol_hangs_with_the_epilogue_behind_the_next_q(
        rng, B, H, S, blocks):
    """The simulation sees the fault the one Q slot invites: with O staged
    in the slot, an epilogue run after the next item's Q wait (where the
    D <= 128 bodies run it) waits for a Q that waits for its store."""
    with pytest.raises(AssertionError, match="hangs"):
        _simulate_wide(B, H, S, blocks, rng, **KERNEL,
                       epilogue_after_next_q=True)
    # the same epilogue with O from registers waits for nothing
    _simulate_wide(B, H, S, blocks, rng, **{**KERNEL, "staged": False},
                   epilogue_after_next_q=True)
