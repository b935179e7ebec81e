"""A CPU model of the flash backward's float32 body (``csrc/flash_attention.cu``:
namespace `f32bwd`, `flash_bwd_f32_kernel<D>`), the float32 body for D <=
128, and of the wrapper's float32 routes.

The model follows the kernel, whose constants it reads from the source:

* a work item is (batch x KV head, key tile of KT = 64 keys); the list is
  key-tile-major (key tile 0 of every (batch, KV head) first) and blocks
  take items in list order from one counter; the grid is one block per SM,
  fewer if there are fewer items;
* an item walks its steps, (query head, 64-query tile), the query tiles
  from the last one down to the diagonal, the group's heads inner;
* a step computes S and dP (each dot over D in column order, fmaf),
  P = exp(S D^-0.5 - lse) (masked), dS = P (dP - Delta), the step's
  P^T dO and dS^T Q (each summed over the step's 64 queries in order, fmaf)
  added to the item's dv and dk, and dq's share dS K (summed over the
  item's 64 keys in order), which the producer warp adds to a float32
  accumulator per (batch x head, query tile), stored by key tile 0 and
  added by the later ones in key-tile order under a counter per tile; the
  diagonal tile, the last, adds the sum to its own share and scales it
  into dq; Delta comes from the Delta pass (32 lanes' column sums, then a
  butterfly of xor shuffles).

Tolerances: the emulated arithmetic within 1e-5 x max|grad| of
`flash_attention_bwd_plain` and of jax.vjp of the reference (float32, as
`test_torch_flash_bwd.py` holds float32 gradients: the sides sum in
different orders)."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JRef
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import bwd_ablate as BA

_SRC = (Path(FA.__file__).parent / "csrc" / "flash_attention.cu").read_text()
F32 = np.float32


def _span(src=_SRC, ns="f32bwd"):
    return src[src.index(f"namespace {ns} {{"):
               src.index(f"}}  // namespace {ns}")]


def _const(name, src=_SRC):
    """An int constant of the float32 backward body in `src`: a number,
    or a sum of the body's constants and numbers."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", _span(src))[1]
    return sum(int(t) if t.isdigit() else _const(t, src)
               for t in (t.strip() for t in expr.split("+")))


KT, QT, CONSUMERS, NTHREADS, PS, TS = (_const(n) for n in (
    "KT", "QT", "CONSUMERS", "NTHREADS", "PS", "TS"))


def _frag(D):
    """The body's per-thread tilings at head dim D (`Frag<D>`): column
    units a dv / dk thread, its column groups, keys, keys a load; dq's
    column groups and queries a thread."""
    uc = 2 if D == 128 else 1
    cg = D // (4 * uc)
    kj = 64 * cg // 128
    return dict(UC=uc, CG=cg, KJ=kj, KW=min(kj, 4), DCG=D // 4,
                QI=64 * (D // 4) // 256)


def _smem(D):
    """`Smem<D>::SMEM`: K, V, Q and dO tiles, P and dS tiles, the dS^T
    tile, the share, lse and Delta, the item, six mbarriers, alignment."""
    tile = 64 * D * 4
    return (4 * tile + 2 * QT * PS * 4 + KT * TS * 4 + QT * D * 4
            + 2 * QT * 4 + 16 + 8 * 6 + 1024)


def test_constants_match_the_wrapper():
    """The source's tiling is the one the wrapper's tables hold; the
    layout fits a block's shared memory and the register split fits the
    launch's registers; each thread of a product owns its share of every
    output once."""
    assert (KT, QT, CONSUMERS, NTHREADS) == (64, 64, 256, 384)
    assert FA.BWD_F32_TILES == (KT, QT)
    assert FA.BWD_F32_HEAD_DIMS == (16, 32, 64, 128, 256)
    assert FA.BWD_QT == QT
    assert _smem(128) == 219_712 <= 232_448
    assert "static_assert(SMEM <= 232448" in _span()
    regs = [_const(n) for n in ("PRODUCER_REGS", "CONSUMER_REGS")]
    assert regs[0] * 128 + regs[1] * CONSUMERS <= \
        65536 // NTHREADS // 8 * 8 * NTHREADS
    # padded rows: the scalar P / dS stores (rows qa + 4 r, keys ka + 8 c)
    # and dS^T stores hit 32 banks; 16-byte aligned rows for LDS.128
    assert PS % 32 == 8 and TS % 32 == 4 and PS % 4 == TS % 4 == 0
    for D in (16, 32, 64, 128):         # f32bwd's (256 is f32widebwd's)
        f = _frag(D)
        assert f["KJ"] * 4 * f["UC"] * 128 == 64 * D
        assert f["QI"] * 4 * 256 == 64 * D
        assert f["KJ"] % f["KW"] == 0


def test_shared_stores_are_conflict_free():
    """The bank of each lane's store, for every (r, c) of a warp, at the
    fragment the source gives S and dP (queries 32 (warp >> 1) + lane / 8
    + 4 r, keys 32 (warp & 1) + lane % 8 + 8 c): 32 different banks into
    the P / dS tiles (row stride PS) and into the dS^T tile (TS)."""
    assert "const int qa = 32 * (warp >> 1) + lane / 8;" in _span()
    assert "const int ka = 32 * (warp & 1) + lane % 8;" in _span()
    lane = np.arange(32)
    for warp in range(4):
        qa = 32 * (warp >> 1) + lane // 8
        ka = 32 * (warp & 1) + lane % 8
        for r in range(8):
            for c in range(4):
                i, j = qa + 4 * r, ka + 8 * c
                assert len(set((i * PS + j) % 32)) == 32
                assert len(set((j * TS + i) % 32)) == 32


# ---------------------------------------------------------------------------
# the wrapper's float32 routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D,route", [
    (16, ("in place", 16)), (24, ("padded", 32)), (32, ("in place", 32)),
    (64, ("in place", 64)), (96, ("padded", 128)), (120, ("padded", 128)),
    (128, ("in place", 128)), (160, ("in place", 256)),
    (256, ("in place", 256))])
def test_float32_backward_route(D, route):
    """float32 at D in {16, 32, 64, 128} runs the f32bwd body in place,
    other D <= 128 zero-padded to the next of those, 160 and 256 the
    f32widebwd body in place (tests/test_torch_flash_f32_wide.py holds
    its routes); the operands of both bodies need 16-byte starts and
    strides (TMA), as every backward body's."""
    assert FA._backward_route(torch.float32, D) == route
    q = torch.zeros((1, 1, 1, D))
    assert FA._align(q, route[1], FA.BWD_HEAD_DIMS,
                     FA.BWD_F32_HEAD_DIMS) == 16


# ---------------------------------------------------------------------------
# the work list and dq's add order
# ---------------------------------------------------------------------------


def _steps(item, B, H, KV, S):
    """The kernel's walk of one item: its (batch x head, query tile) steps
    in order."""
    BKV, G, nQ = B * KV, H // KV, -(-S // QT)
    kt, bkv = divmod(item, BKV)
    b, kvh = divmod(bkv, KV)
    return [(b * H + kvh * G + s % G, nQ - 1 - s // G)
            for s in range(G * (nQ - kt))]


def _simulate_adds(B, H, KV, S, blocks):
    """The work list on `blocks` persistent blocks, one step a tick, items
    handed out in list order as blocks free up; a step of key tile kt
    whose share is not its tile's first waits until the tile's counter
    reads kt.  Returns (adds per (bh, qi) in order, steps that waited a
    tick, and whether every wait pointed at an item already handed
    out)."""
    BKV = B * KV
    n_items = BKV * -(-S // KT)
    nxt, count, adds = 0, {}, {}
    cur = [None] * blocks
    waited, earlier = 0, True
    while True:
        for i in range(blocks):
            if cur[i] is None and nxt < n_items:
                cur[i] = (nxt, _steps(nxt, B, H, KV, S), 0)
                nxt += 1
        if all(c is None for c in cur):
            return adds, waited, earlier
        moved = False
        for i, c in enumerate(cur):
            if c is None:
                continue
            item, steps, pos = c
            kt = item // BKV
            bh, qi = steps[pos]
            if count.get((bh, qi), 0) < kt:
                waited += 1
                earlier = earlier and 0 <= item - BKV < nxt
                continue
            count[(bh, qi)] = count.get((bh, qi), 0) + 1
            adds.setdefault((bh, qi), []).append(kt)
            moved = True
            cur[i] = None if pos + 1 == len(steps) else (item, steps, pos + 1)
        assert moved, "no block could move: a wait that never ends"


@pytest.mark.parametrize("B,H,KV,S,blocks", [
    (4, 32, 4, 2048, 132),       # yi's shape (B 4, KV 4, S 2048), 132 SMs
    (2, 4, 4, 64, 132),          # phase 8e's reduced archs: D 16, S 64
    (1, 4, 4, 1, 132), (1, 8, 1, 257, 3), (2, 8, 2, 100, 132),
    (2, 16, 8, 1100, 132), (1, 4, 2, 700, 1), (3, 6, 3, 513, 7)])
def test_work_list_and_dq_add_order(B, H, KV, S, blocks):
    """Every (batch x head, 64-query tile) receives each key tile that has
    a causal pair with it exactly once, in ascending order (the last the
    diagonal tile); every wait points at an item earlier in the list (so
    taken earlier, by a running block); no wait lasts for ever; at yi's
    shape the steps that wait are under 2 % of all steps."""
    assert "const int n_items = BKV * nQ;" in _span()
    assert "const int bkv = item % BKV, kt = item / BKV;" in _span()
    adds, waited, earlier = _simulate_adds(B, H, KV, S, blocks)
    nQ = -(-S // QT)
    assert sorted(adds) == [(bh, qi) for bh in range(B * H)
                            for qi in range(nQ)]
    for (bh, qi), kts in adds.items():
        causal = [kt for kt in range(-(-S // KT))
                  if kt * KT <= min(qi * QT + QT - 1, S - 1)]
        assert kts == causal, ((bh, qi), kts)
        assert kts[-1] == qi            # the diagonal key tile adds last
    assert earlier
    n_steps = sum(len(v) for v in adds.values())
    if (B, H, KV, S, blocks) == (4, 32, 4, 2048, 132):
        assert n_steps == B * H * nQ * (nQ + 1) // 2
        assert waited < 0.02 * n_steps, (waited, n_steps)


# ---------------------------------------------------------------------------
# the body's arithmetic
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """fmaf, elementwise: the product exact in float64, one rounding of
    the sum to float64 and one to float32 (a double rounding that can
    differ from the card's in the last bit, rarely)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def _delta(o, do):
    """The Delta pass: lane l of a row's warp sums columns l, l + 32, ...
    in order with fmaf, then x += shfl_xor(x, off) for off = 16 .. 1;
    lane 0's value."""
    lanes = np.zeros(o.shape[:-1] + (32,), F32)
    for c in range(o.shape[-1]):
        lanes[..., c % 32] = _fma(o[..., c], do[..., c], lanes[..., c % 32])
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ off]
    return lanes[..., 0]


def emulate(q, k, v, o, lse, do):
    """dq, dk, dv as the f32bwd body computes them from float32 q, k, v,
    o, dO (B, H|KV, S, D) and lse: the operands zero-filled to the body's
    head dim (the wrapper's padded route) and to whole 64-row tiles, each
    item's steps in the kernel's order and each sum in the kernel's
    order."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    route, Dp = FA._backward_route(torch.float32, D)
    assert route in ("in place", "padded")
    G, nQ = H // KV, -(-S // QT)
    Sp = nQ * QT

    def fill(x):
        return np.pad(x.numpy().astype(F32),
                      [(0, 0), (0, 0), (0, Sp - S), (0, Dp - D)])

    qn, kn, vn, on, don = (fill(x) for x in (q, k, v, o, do))
    delta = _delta(on, don)
    ls = np.pad(lse.numpy().astype(F32), [(0, 0), (0, 0), (0, Sp - S)])
    scale = F32(D ** -0.5)
    acc = {}
    dq = np.zeros((B, H, Sp, Dp), F32)
    dk = np.zeros((B, KV, Sp, Dp), F32)
    dv = np.zeros_like(dk)
    BKV = B * KV
    for item in range(BKV * nQ):
        kt, bkv = divmod(item, BKV)
        b, kvh = divmod(bkv, KV)
        k0 = kt * KT
        K, V = kn[b, kvh, k0:k0 + KT], vn[b, kvh, k0:k0 + KT]
        acc_v = np.zeros((KT, Dp), F32)
        acc_k = np.zeros_like(acc_v)
        for bh, qi in _steps(item, B, H, KV, S):
            h, q0 = bh % H, qi * QT
            Q, dO = qn[b, h, q0:q0 + QT], don[b, h, q0:q0 + QT]
            s = np.zeros((QT, KT), F32)
            dp = np.zeros_like(s)
            for d in range(Dp):              # each dot in column order
                s = _fma(Q[:, d, None], K[None, :, d], s)
                dp = _fma(dO[:, d, None], V[None, :, d], dp)
            rows = np.arange(q0, q0 + QT)[:, None]
            keys = np.arange(k0, k0 + KT)[None, :]
            with np.errstate(over="ignore"):
                e = np.exp(_fma(s, scale, -ls[b, h, q0:q0 + QT, None]))
            p = np.where((keys <= rows) & (rows < S), e, F32(0)).astype(F32)
            ds = p * (dp - delta[b, h, q0:q0 + QT, None])
            step_v = np.zeros((KT, Dp), F32)
            step_k = np.zeros_like(step_v)
            for i in range(QT):              # the step's queries in order
                step_v = _fma(p[i, :, None], dO[i, None, :], step_v)
                step_k = _fma(ds[i, :, None], Q[i, None, :], step_k)
            acc_v = acc_v + step_v
            acc_k = acc_k + step_k
            share = np.zeros((QT, Dp), F32)
            for j in range(KT):              # the item's keys in order
                share = _fma(ds[:, j, None], K[j, None, :], share)
            if qi != kt:                     # to the accumulator's tile
                acc[bh, qi] = share if kt == 0 else acc[bh, qi] + share
            else:                            # the diagonal: the last
                total = share if kt == 0 else acc.pop((bh, qi)) + share
                dq[b, h, q0:q0 + QT] = total * scale
        dk[b, kvh, k0:k0 + KT] = acc_k * scale
        dv[b, kvh, k0:k0 + KT] = acc_v
    assert not acc                           # every tile finished
    return tuple(torch.from_numpy(np.ascontiguousarray(x[:, :, :S, :D]))
                 for x in (dq, dk, dv))


def _max_rel(got, want):
    g, w = got.numpy(), np.asarray(want, F32)
    return np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)


def _jax_grads(arrs):
    q, k, v, ct = (jnp.asarray(a, jnp.float32) for a in arrs)

    @jax.jit
    def grads(q, k, v, ct):
        out, vjp = jax.vjp(JRef.flash_attention_ref, q, k, v)
        return vjp(ct.astype(out.dtype))

    return grads(q, k, v, ct)


@pytest.mark.parametrize("D", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("S", [40, 100, 129])
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 1)])
def test_body_arithmetic_within_tolerance(rng, H, KV, S, D):
    """The emulated body against `flash_attention_bwd_plain` on the same
    (o, lse) and against jax.vjp of the reference's dense oracle, each
    gradient within 1e-5 x max|grad|; GQA and MQA, S ragged against the
    64-row tiles (one tile, two, three), D = 96 zero-padded to the body's
    128."""
    arrs = [rng.normal(size=(1, h, S, D)).astype(np.float32)
            for h in (H, KV, KV, H)]
    q, k, v, do = (torch.as_tensor(a) for a in arrs)
    o, lse = FA.flash_attention_fwd(q, k, v)
    got = emulate(q, k, v, o, lse, do)
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    assert all(g.dtype == torch.float32 for g in got)
    plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for g, p in zip(got, plain):
        assert _max_rel(g, p.numpy()) <= 1e-5
    for g, w in zip(got, _jax_grads(arrs)):
        assert _max_rel(g, np.asarray(w, F32)) <= 1e-5


# ---------------------------------------------------------------------------
# the barrier protocol
# ---------------------------------------------------------------------------


class _Mbar:
    """An mbarrier: a phase completes when `count` arrivals are in (a
    group of 128 threads counts as one, TMA bytes as one); a wait on
    parity P passes once the phase of that parity has completed.
    Arrivals count in `progress`, so that a hang is a run of steps with
    none."""

    def __init__(self, count, progress):
        self.count, self.pending, self.phases = count, 0, 0
        self.progress = progress

    def arrive(self):
        self.progress[0] += 1
        self.pending += 1
        assert self.pending <= self.count, "more arrivals than the phase"
        if self.pending == self.count:
            self.phases, self.pending = self.phases + 1, 0

    def done(self, parity):
        return (self.phases & 1) != parity


class _Named:
    """A named barrier of `units` groups of 128 threads: bar.arrive adds
    a group and goes on, bar.sync adds it and waits for the generation."""

    def __init__(self, units, progress):
        self.units, self.n, self.gen = units, 0, 0
        self.progress = progress

    def arrive(self):
        self.progress[0] += 1
        self.n += 1
        if self.n == self.units:
            self.gen, self.n = self.gen + 1, 0

    def sync(self):
        gen = self.gen
        self.arrive()
        while self.gen == gen:
            yield


# what the simulation models, as the source spells it
_PROTOCOL = [
    "mbar_init(full_kv, 1);", "mbar_init(empty_kv, CONSUMERS);",
    "mbar_init(full, 33);", "mbar_init(empty, CONSUMERS);",
    "mbar_init(staged, CONSUMERS);", "mbar_init(freed, 1);",
    "mbar_wait(empty_kv, (n & 1) ^ 1);", "mbar_wait(empty, (it & 1) ^ 1);",
    "mbar_wait(staged, n_sh & 1);", "wait_count(cnt, p_kt);",
    "mbar_arrive(freed);", "p_bh = qi == kt ? -1 : b * H + h;",
    "mbar_wait(full_kv, n & 1);", "mbar_wait(full, it & 1);",
    "bar_arrive(1);", "bar_sync(1);", "bar_arrive(4);",
    "if (grp == 0) bar_sync(4);", "mbar_arrive(empty);",
    "if (s == steps - 1) mbar_arrive(empty_kv);",
    "mbar_wait(freed, (n_sh & 1) ^ 1);", "mbar_arrive(staged);",
    "if (tid == 0) wait_count(sem + bh * nQ + qi, kt);",
    "named_sync(5, CONSUMERS);"]


def _simulate(B, H, KV, S, blocks, rng, *, fault=None):
    """`flash_bwd_f32_kernel`'s waits and arrivals per block (the
    producer warp, group 0 and group 1 of the compute threads, each group
    one agent), blocks sharing the ticket counter and the dq counters,
    under a random scheduler; a long run of steps with no arrival, no
    counter bump and no agent ending is a hang.  `fault`: "own_add", a
    diagonal step waits until the counter reads kt + 1 (an add no step
    makes); "reversed", the list hands out the last key tiles first; "no
    free", the producer never frees the share buffer.  Returns the items
    each block took."""
    BKV, G, nQ = B * KV, H // KV, -(-S // QT)
    nK = -(-S // KT)
    n_items = BKV * nK
    ticket, taken, progress = [0], [], [0]
    counters = {}

    def decode(item):
        kt, bkv = divmod(item, BKV)
        if fault == "reversed":
            kt = nK - 1 - kt
        return kt, bkv

    def block(bi):
        full_kv, empty_kv = _Mbar(1, progress), _Mbar(2, progress)
        full, empty = _Mbar(1, progress), _Mbar(2, progress)
        staged, freed = _Mbar(2, progress), _Mbar(1, progress)
        p_ready, ds_ready, diag = (_Named(2, progress) for _ in range(3))
        item_s = [None]

        def wait(bar, parity):
            while not bar.done(parity):
                yield

        def producer():
            it = n_sh = 0
            pend = None

            def add_share():
                nonlocal n_sh
                yield from wait(staged, n_sh & 1)
                bh, qi, kt = pend
                while counters.get((bh, qi), 0) < kt:
                    yield
                counters[bh, qi] = counters.get((bh, qi), 0) + 1
                progress[0] += 1
                if fault != "no free":
                    freed.arrive()
                n_sh += 1

            for n in range(10 ** 9):
                item = ticket[0]
                ticket[0] += 1
                yield from wait(empty_kv, (n & 1) ^ 1)
                if item >= n_items:
                    item_s[0] = -1
                    full_kv.arrive()
                    if pend is not None:
                        yield from add_share()
                    return
                taken.append((bi, item))
                kt, bkv = decode(item)
                b, kvh = divmod(bkv, KV)
                item_s[0] = item
                full_kv.arrive()
                for s in range(G * (nQ - kt)):
                    qi = nQ - 1 - s // G
                    yield from wait(empty, (it & 1) ^ 1)
                    full.arrive()
                    if pend is not None:
                        yield from add_share()
                    pend = None if qi == kt else (b * H + kvh * G + s % G,
                                                  qi, kt)
                    it += 1

        def group(g):
            it = n_sh = 0
            for n in range(10 ** 9):
                yield from wait(full_kv, n & 1)
                item = item_s[0]
                if item < 0:
                    return
                kt, bkv = decode(item)
                b, kvh = divmod(bkv, KV)
                steps = G * (nQ - kt)
                for s in range(steps):
                    qi = nQ - 1 - s // G
                    bh = b * H + kvh * G + s % G
                    yield from wait(full, it & 1)
                    if g == 0:
                        p_ready.arrive()             # P in its tile
                        empty.arrive()               # dv: dO read
                        yield from ds_ready.sync()   # dS^T in its tile
                    else:
                        yield from p_ready.sync()
                        ds_ready.arrive()
                        empty.arrive()               # dk: Q read
                    if s == steps - 1:
                        empty_kv.arrive()            # dq: K read
                    if qi != kt:
                        yield from wait(freed, (n_sh & 1) ^ 1)
                        staged.arrive()
                        n_sh += 1
                    elif kt > 0:
                        if g == 0:                   # thread 0's wait
                            need = kt + 1 if fault == "own_add" else kt
                            while counters.get((bh, qi), 0) < need:
                                yield
                        yield from diag.sync()
                    it += 1

        return [producer(), group(0), group(1)]

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
    return taken


def test_protocol_is_the_sources():
    """Every wait and arrival the simulation models is in the body."""
    body = _span()
    for stmt in _PROTOCOL:
        assert stmt in body, stmt


@pytest.mark.parametrize("B,H,KV,S,blocks", [
    (1, 2, 1, 64, 1), (1, 4, 2, 257, 2), (2, 4, 1, 200, 3),
    (1, 2, 2, 1, 4), (1, 8, 2, 300, 5), (2, 2, 1, 129, 8),
    (2, 4, 4, 64, 132)])
def test_barrier_protocol_completes(rng, B, H, KV, S, blocks):
    """The body's waits and arrivals end under random interleavings: no
    block hangs and every item is taken once (more blocks than items
    included)."""
    for _ in range(3):
        taken = _simulate(B, H, KV, S, blocks, rng)
        assert sorted(i for _, i in taken) == list(
            range(B * KV * -(-S // KT)))


@pytest.mark.parametrize("fault", ["own_add", "reversed", "no free"])
@pytest.mark.parametrize("B,H,KV,S,blocks", [(1, 2, 1, 200, 2),
                                             (1, 4, 2, 300, 3)])
def test_barrier_protocol_hangs_on_a_broken_wait(rng, B, H, KV, S, blocks,
                                                 fault):
    """The simulation sees a wait that can never be met: a diagonal step
    waiting for one add more than its tile gets, a list that hands out
    later key tiles first, or a share buffer never freed."""
    with pytest.raises(AssertionError, match="hangs"):
        _simulate(B, H, KV, S, blocks, rng, fault=fault)


# ---------------------------------------------------------------------------
# launch.bwd_ablate's variants of the body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n in BA.PATCHES
                                  if n.startswith("f32_")])
def test_f32_ablate_patches_touch_the_body_alone(name):
    """Each `f32_*` variant of `launch.bwd_ablate` applies and changes
    the float32 body's namespace and nothing else; the other variants
    leave that namespace as it is."""
    out = BA.variant_source(name)
    a = _SRC.index("namespace f32bwd {")
    b = _SRC.index("}  // namespace f32bwd")
    assert out != _SRC
    assert out[:a] == _SRC[:a]
    assert out.endswith(_SRC[b:])
    assert BA.body_of(name) == "f32"
    for other in BA.PATCHES:
        if not other.startswith("f32_"):
            assert _span(BA.variant_source(other)) == _span()


def test_f32_preset_runs_float32():
    """`--shape f32` is yi's shape in float32 operands, and its default
    variants are the float32 body's; `--shape wide_f32` (the wide shape
    in float32), `d512_f32` (D = 512 in float32) and `d2304_f32` (D =
    2304, two walks, in float32) run float32 too.  `--parent` takes the
    float32 presets up to D = 2048, whose bodies (f32bwd, f32widebwd, the
    cluster backward at one walk) take the scratch this wrapper
    allocates, and refuses D = 2304, where a parent before the walks runs
    simplebwd on another scratch."""
    assert BA.PRESETS["f32"] == (4, 32, 4, 2048, 128)
    assert BA.FLOAT32_PRESETS == ("f32", "wide_f32", "d512_f32", "d2304_f32")
    assert BA.NAMESPACES["f32"] == "f32bwd"
    assert {"f32_no_dq", "f32_no_exp"} <= set(BA.PATCHES)
    for shape in ("f32", "wide_f32", "d512_f32"):
        assert BA.parent_refusal(shape) is None
    with pytest.raises(SystemExit, match="D <= 2048"):
        BA.main(["--shape", "d2304_f32", "--parent", "x.cu"])
