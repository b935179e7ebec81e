"""A CPU model of the flash backward's D = 256 tensor-core body
(``csrc/flash_attention.cu``: namespace `widebwd`, `flash_bwd_kernel_d256`),
the bfloat16 body for 128 < D <= 256, and of the wrapper's routes.

The model follows the kernel, whose constants it reads from the source:

* a work item is (batch x KV head, key tile of KT = 64 keys); the list is
  key-tile-major (key tile 0 of every (batch, KV head) first) and blocks
  take items in list order from one counter; the grid is one block per SM,
  fewer if there are fewer items;
* an item walks its steps, (query head, 64-query tile), the query tiles
  from the last one down to the diagonal, the group's heads inner;
* consumer w scores queries 32 w .. + 31 of a step (S^T and dP^T in
  float32), rounds P^T and dS^T to bfloat16 into shared tiles, and once
  both halves are in adds dv += P^T dO and dk += dS^T Q for its 128
  columns and computes dq's share dS K for the same columns, which it
  stages in the step's Q and dO tiles; before the producer loads that
  slot again it adds the share to a float32 accumulator per (batch x
  head, query tile), under a counter per tile: key tile kt waits until it
  reads kt; the diagonal tile, the last, is not staged: its consumers
  wait for the counter and round the sum into dq.

Tolerances: the emulated arithmetic within 2e-2 x max|grad| of
`flash_attention_bwd_plain` and of jax.vjp of the reference (bfloat16
operands, P^T and dS^T rounded to bfloat16, as the other bfloat16
backward tests hold)."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JRef
from repro.models import attention as JA
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import bwd_ablate as BA

_SRC = (Path(FA.__file__).parent / "csrc" / "flash_attention.cu").read_text()
LOG2E = np.float32(1.4426950408889634)


def _span(src, ns="widebwd"):
    return src[src.index(f"namespace {ns} {{"):
               src.index(f"}}  // namespace {ns}")]


def _const(name, src=_SRC):
    """An int constant of the D = 256 backward body in `src`."""
    return int(re.search(rf"constexpr int {name} = (\d+);", _span(src))[1])


KT, QT, STAGES = (_const(n) for n in ("KT", "QT", "STAGES"))
WIDTH = _const("D")


def test_constants_match_the_wrapper():
    """The source's tiling is the one the wrapper's tables hold, and the
    shared memory the layout needs fits a block."""
    assert (KT, QT, WIDTH) == (64, 64, 256)
    assert FA.BWD_TILES[256] == (KT, QT)
    assert FA.BWD_QT == QT
    tile = 64 * WIDTH * 2                   # K, V, Q or dO, bfloat16
    # K, V, the Q / dO ring, P^T and dS^T twice, lse and Delta, the
    # staged shares' tiles, the item, the mbarriers, the alignment
    smem = (2 * tile + 2 * STAGES * tile + 4 * KT * QT * 2
            + 2 * STAGES * QT * 4 + STAGES * 16 + 16
            + 8 * (2 + 2 * STAGES) + 1024)
    assert smem == 231_520 <= 232_448
    assert "static_assert(SMEM <= 232448" in _span(_SRC)
    regs = [_const(n) for n in ("PRODUCER_REGS", "CONSUMER_REGS")]
    assert regs[0] * 128 + regs[1] * 256 <= 65536 // 384 // 8 * 8 * 384


# ---------------------------------------------------------------------------
# the wrapper's routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D,bf16,f32", [
    (8, ("padded", 16), ("padded", 16)),
    (16, ("in place", 16), ("in place", 16)),
    (100, ("padded", 128), ("padded", 128)),
    (120, ("padded", 128), ("padded", 128)),
    (128, ("in place", 128), ("in place", 128)),
    (130, ("padded", 256), ("padded", 256)),
    (160, ("in place", 256), ("in place", 256)),
    (192, ("in place", 256), ("in place", 256)),
    (250, ("padded", 256), ("padded", 256)),
    (256, ("in place", 256), ("in place", 256)),
    (264, ("cluster", 264), ("cluster", 264)),
    (512, ("cluster", 512), ("cluster", 512))])
def test_backward_route(D, bf16, f32):
    """bfloat16 at 128 < D <= 256 runs the D = 256 body, in place when D
    is a multiple of 8 (TMA's 16-byte rows), else zero-padded; D <= 128
    the bf16bwd bodies; float32 at D <= 128 the f32bwd bodies (other
    widths zero-padded to 16, 32, 64 or 128), at 128 < D <= 256 the
    f32widebwd body (in place when D % 4 == 0, else zero-padded to 256);
    both dtypes above 256 the cluster backward, clusters of the D = 256
    bodies on 256-column slices (in walks above 2048), here in place."""
    assert FA._backward_route(torch.bfloat16, D) == bf16
    assert FA._backward_route(torch.float32, D) == f32
    assert FA.BWD_HEAD_DIMS == (16, 32, 64, 128, 256)


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
            for s in range(G * (nQ - kt * KT // QT))]


def _simulate_adds(B, H, KV, S, blocks):
    """The work list on `blocks` persistent blocks, one step a tick, items
    handed out in list order as blocks free up; a step of key tile kt
    whose share is not its tile's first waits until the tile's counter
    reads kt.  Returns (adds per (bh, qi) in order, steps that waited a
    tick, and whether every wait pointed at an item already handed
    out)."""
    BKV, nQ = B * KV, -(-S // QT)
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
                # the add before is the same walk's step of item - BKV
                earlier = earlier and 0 <= item - BKV < nxt
                continue
            count[(bh, qi)] = count.get((bh, qi), 0) + 1
            adds.setdefault((bh, qi), []).append(kt)
            moved = True
            cur[i] = None if pos + 1 == len(steps) else (item, steps, pos + 1)
        assert moved, "no block could move: a wait that never ends"


@pytest.mark.parametrize("B,H,KV,S,blocks", [
    (4, 8, 2, 2048, 132),        # the smoke's wide shape on 132 SMs
    (4, 32, 4, 2048, 132), (1, 4, 4, 1, 132), (1, 8, 1, 257, 3),
    (2, 8, 2, 100, 132), (2, 16, 8, 1100, 132), (1, 4, 2, 700, 1),
    (3, 6, 3, 513, 7)])
def test_work_list_and_dq_add_order(B, H, KV, S, blocks):
    """Every (batch x head, 64-query tile) receives each key tile that has
    a causal pair with it exactly once, in ascending order (the last the
    diagonal tile); every wait points at an item earlier in the list (so
    taken earlier, by a running block); no wait lasts for ever; and at the
    smoke's wide shape the steps that wait are under 2 % of all steps."""
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
    if (B, H, KV, S, blocks) == (4, 8, 2, 2048, 132):
        assert n_steps == B * H * nQ * (nQ + 1) // 2
        assert waited < 0.02 * n_steps, (waited, n_steps)


# ---------------------------------------------------------------------------
# the body's arithmetic
# ---------------------------------------------------------------------------


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)) \
        .bfloat16().float().numpy()


def emulate(q, k, v, o, lse, do):
    """dq, dk, dv as the D = 256 body computes them from bfloat16 q, k, v,
    o, dO (B, H|KV, S, D) and float32 lse: the operands zero-filled to
    256 columns and to whole 64-row tiles, Delta in float32, each item's
    steps in the kernel's order, P^T and dS^T in float32 then rounded to
    bfloat16 before dv += P^T dO, dk += dS^T Q and dq's share dS K, the
    shares summed in float32 in the list's key-tile order, and the
    diagonal tile's sum scaled and rounded into dq."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G, nQ = H // KV, -(-S // QT)
    Sp = nQ * QT

    def fill(x):
        a = x.float().numpy()
        return np.pad(a, [(0, 0), (0, 0), (0, Sp - S), (0, WIDTH - D)])

    qn, kn, vn, don = (fill(x) for x in (q, k, v, do))
    delta = np.pad(np.einsum("bhsd,bhsd->bhs", o.float().numpy(),
                             do.float().numpy()).astype(np.float32),
                   [(0, 0), (0, 0), (0, Sp - S)])
    ls = np.pad(lse.numpy().astype(np.float32), [(0, 0), (0, 0),
                                                  (0, Sp - S)])
    scale = np.float32(D ** -0.5)
    sl2 = np.float32(D ** -0.5 * LOG2E)
    acc = {}
    dq = np.zeros((B, H, Sp, WIDTH), np.float32)
    dk = np.zeros((B, KV, Sp, WIDTH), np.float32)
    dv = np.zeros_like(dk)
    BKV = B * KV
    for item in range(BKV * -(-S // KT)):
        kt, bkv = divmod(item, BKV)
        b, kvh = divmod(bkv, KV)
        k0 = kt * KT
        K, V = kn[b, kvh, k0:k0 + KT], vn[b, kvh, k0:k0 + KT]
        dk_acc = np.zeros((KT, WIDTH), np.float32)
        dv_acc = np.zeros_like(dk_acc)
        keys = np.arange(k0, k0 + KT)[:, None]
        for bh, qi in _steps(item, B, H, KV, S):
            h = bh % H
            q0 = qi * QT
            Q, dO = qn[b, h, q0:q0 + QT], don[b, h, q0:q0 + QT]
            st = K @ Q.T                        # S^T, keys x queries
            dpt = V @ dO.T                      # dP^T
            p = np.exp2(st * sl2 - ls[b, h, q0:q0 + QT] * LOG2E)
            qs = np.arange(q0, q0 + QT)[None, :]
            p = np.where((keys > qs) | (qs >= S), np.float32(0), p)
            ds = p * (dpt - delta[b, h, q0:q0 + QT])
            pb, dsb = _bf16(p), _bf16(ds)
            dv_acc += pb @ dO
            dk_acc += dsb @ Q
            share = dsb.T @ K                   # queries x columns
            acc[bh, qi] = share if kt == 0 else acc[bh, qi] + share
            if kt == qi:                        # the diagonal: the last add
                dq[b, h, q0:q0 + QT] = acc.pop((bh, qi)) * scale
        dk[b, kvh, k0:k0 + KT] = dk_acc * scale
        dv[b, kvh, k0:k0 + KT] = dv_acc
    assert not acc                              # every tile finished
    return tuple(torch.from_numpy(np.ascontiguousarray(x[:, :, :S, :D]))
                 .bfloat16() for x in (dq, dk, dv))


def _max_rel(got, want):
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    return np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)


def _jax_grads(fn, arrs):
    q, k, v, ct = (jnp.asarray(a, jnp.bfloat16) for a in arrs)

    @jax.jit
    def grads(q, k, v, ct):
        out, vjp = jax.vjp(fn, q, k, v)
        return vjp(ct.astype(out.dtype))

    return grads(q, k, v, ct)


@pytest.mark.parametrize("D", [160, 192, 256])
@pytest.mark.parametrize("S", [40, 100, 129])
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 1)])
def test_body_arithmetic_within_tolerance(rng, H, KV, S, D):
    """The emulated body against `flash_attention_bwd_plain` on the same
    (o, lse) and against jax.vjp of the reference's dense oracle and of
    its chunked `attn_flash`, each gradient within 2e-2 x max|grad|; S
    ragged against the 64-row tiles (one tile, two, three), D read in
    place below the body's width."""
    B = 2
    arrs = [rng.normal(size=(B, h, S, D)).astype(np.float32)
            for h in (H, KV, KV, H)]
    q, k, v, do = (torch.as_tensor(a).bfloat16() for a in arrs)
    o, lse = FA.flash_attention_fwd(q, k, v)
    got = emulate(q, k, v, o, lse, do)
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for g, p in zip(got, plain):
        assert _max_rel(g, p.float().numpy()) <= 2e-2
    for want in (_jax_grads(JRef.flash_attention_ref, arrs),
                 _jax_grads(_attn_flash(S), arrs)):
        for g, w in zip(got, want):
            assert _max_rel(g, np.asarray(w, np.float32)) <= 2e-2


def _attn_flash(S):
    pos = jnp.arange(S)
    c = 16 if S % 16 == 0 else S

    def flash(qj, kj, vj):       # (B, H, S, D) <-> attn_flash's layout
        o_ = JA.attn_flash(*(x.transpose(0, 2, 1, 3) for x in (qj, kj, vj)),
                           pos, pos, causal=True, q_chunk=c, kv_chunk=c)
        return o_.transpose(0, 2, 1, 3)

    return flash


# ---------------------------------------------------------------------------
# the barrier protocol
# ---------------------------------------------------------------------------


class _Mbar:
    """An mbarrier: a phase completes when `count` arrivals are in (a
    TMA load's bytes count as one arrival); a wait on parity P passes once
    the phase of that parity has completed.  Arrivals count in `progress`
    (shared by a simulation's barriers and counters), so that a hang is a
    run of steps with none."""

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
    """A named barrier of the two consumer warpgroups (bar.sync, 256)."""

    def __init__(self):
        self.gen, self.units = 0, 0

    def sync(self):
        gen = self.gen
        self.units += 1
        if self.units == 2:
            self.gen, self.units = self.gen + 1, 0
        while self.gen == gen:
            yield


def _simulate(B, H, KV, S, blocks, rng, *, stages=STAGES, fault=None):
    """`flash_bwd_kernel_d256`'s waits and arrivals per block (the
    producer warp, the two consumers), blocks sharing the ticket counter
    and the dq counters, under a random scheduler; a long run of steps
    with no arrival, no counter bump and no agent ending is a hang.  The
    producer adds the share a slot's last step staged before it loads the
    slot again, and the staged shares of its last steps once the tickets
    have run out, and bumps the tile's counter once the adds are
    complete.  `fault`: "own_add", a consumer of a diagonal step waits
    until the counter reads kt + 1 (an add no step makes); "reversed", the
    list hands out the last key tiles first.  Returns the items each
    block took."""
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
        full = [_Mbar(1, progress) for _ in range(stages)]
        staged = [_Mbar(2, progress) for _ in range(stages)]
        exchange = _Named()
        item_s, meta = [None], [None] * stages

        def wait(bar, parity):
            while not bar.done(parity):
                yield

        def add_share(i):
            slot = i % stages
            yield from wait(staged[slot], (i // stages) & 1)
            bh, qi, kt, last = meta[slot]
            if last:
                return
            while counters.get((bh, qi), 0) < kt:
                yield
            counters[bh, qi] = counters.get((bh, qi), 0) + 1
            progress[0] += 1

        def producer():
            it = 0
            for n in range(10 ** 9):
                item = ticket[0]
                ticket[0] += 1
                yield from wait(empty_kv, (n & 1) ^ 1)
                if item >= n_items:
                    item_s[0] = -1
                    full_kv.arrive()
                    for i in range(max(it - stages, 0), it):
                        yield from add_share(i)
                    return
                taken.append((bi, item))
                kt, _ = decode(item)
                item_s[0] = item
                full_kv.arrive()
                for _ in range(G * (nQ - kt)):
                    if it >= stages:
                        yield from add_share(it - stages)
                    full[it % stages].arrive()
                    it += 1

        def consumer(w):
            it = 0
            for n in range(10 ** 9):
                yield from wait(full_kv, n & 1)
                item = item_s[0]
                if item < 0:
                    return
                kt, bkv = decode(item)
                b, kvh = divmod(bkv, KV)
                for s in range(G * (nQ - kt)):
                    slot = it % stages
                    qi = nQ - 1 - s // G
                    bh = b * H + kvh * G + s % G
                    yield from wait(full[slot], (it // stages) & 1)
                    yield from exchange.sync()  # both halves of P^T, dS^T
                    last = kt == qi
                    if w == 0:
                        meta[slot] = (bh, qi, kt, last)
                    staged[slot].arrive()       # Q and dO read, dq staged
                    if last and kt > 0:         # the sum of the others in
                        need = kt + 1 if fault == "own_add" else kt
                        while counters.get((bh, qi), 0) < need:
                            yield
                    it += 1
                empty_kv.arrive()

        return [producer(), consumer(0), consumer(1)]

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


# the kernel's ring and `bwd_ablate`'s one-slot variant of it, read from
# their sources
_STAGES = {n: _const("STAGES", BA.variant_source(n))
           for n in ("base", "wide_one_slot")}


def test_one_slot_variant_differs_in_the_ring_alone():
    assert _STAGES == {"base": 2, "wide_one_slot": 1}


@pytest.mark.parametrize("variant", list(_STAGES))
@pytest.mark.parametrize("B,H,KV,S,blocks", [
    (1, 2, 1, 64, 1), (1, 4, 2, 257, 2), (2, 4, 1, 200, 3),
    (1, 2, 2, 1, 4), (1, 8, 2, 300, 5), (2, 2, 1, 129, 8)])
def test_barrier_protocol_completes(rng, B, H, KV, S, blocks, variant):
    """The body's waits and arrivals end under random interleavings, as
    the kernel is and with `bwd_ablate`'s one-slot ring: no block hangs
    and every item is taken once (more blocks than items included)."""
    for _ in range(3):
        taken = _simulate(B, H, KV, S, blocks, rng,
                          stages=_STAGES[variant])
        assert sorted(i for _, i in taken) == list(
            range(B * KV * -(-S // KT)))


@pytest.mark.parametrize("fault", ["own_add", "reversed"])
@pytest.mark.parametrize("B,H,KV,S,blocks", [(1, 2, 1, 200, 2),
                                             (1, 4, 2, 300, 3)])
def test_barrier_protocol_hangs_on_a_broken_wait(rng, B, H, KV, S, blocks,
                                                 fault):
    """The simulation sees a wait that can never be met: a diagonal step
    waiting for one add more than its tile gets, or a list that hands out
    later key tiles first, so that the items a wait points at are never
    taken while every block waits."""
    with pytest.raises(AssertionError, match="hangs"):
        _simulate(B, H, KV, S, blocks, rng, fault=fault)


# ---------------------------------------------------------------------------
# launch.bwd_ablate's variants of the body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n in BA.PATCHES
                                  if n.startswith("wide_")])
def test_wide_ablate_patches_touch_the_body_alone(name):
    """Each `wide_*` variant of `launch.bwd_ablate` applies and changes
    the D = 256 body's namespace and nothing else; the other variants
    leave that namespace as it is."""
    out = BA.variant_source(name)
    a = _SRC.index("namespace widebwd {")
    b = _SRC.index("}  // namespace widebwd")
    assert out != _SRC
    assert out[:a] == _SRC[:a]
    assert out.endswith(_SRC[b:])
    for other in BA.PATCHES:
        if not other.startswith("wide_"):
            assert _span(BA.variant_source(other)) == _span(_SRC)


def test_ablate_presets_and_parent():
    """The presets name the D <= 128 body's shape, the wide one, the
    float32 bodies' (yi's shape and the wide one in float32) and the
    cluster backward's (D = 512 in both dtypes, and D = 2304 in walks),
    and `--parent` reads the other file as it is."""
    assert BA.PRESETS == {"yi": (4, 32, 4, 2048, 128),
                          "wide": (4, 8, 2, 2048, 256),
                          "f32": (4, 32, 4, 2048, 128),
                          "wide_f32": (4, 8, 2, 2048, 256),
                          "d512": (1, 8, 2, 2048, 512),
                          "d512_f32": (1, 8, 2, 2048, 512),
                          "d2304": (1, 2, 1, 2048, 2304),
                          "d2304_f32": (1, 2, 1, 2048, 2304)}
    assert BA.parse_shape("wide") == (4, 8, 2, 2048, 256)
    assert BA.parse_shape("1,2,1,64,160") == (1, 2, 1, 64, 160)
    with pytest.raises(ValueError):
        BA.parse_shape("1,2,3")
    path = Path(FA.__file__).parent / "csrc" / "flash_attention.cu"
    assert BA.variant_source("parent", str(path)) == _SRC
